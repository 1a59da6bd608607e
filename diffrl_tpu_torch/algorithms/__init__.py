from .eval_utils import batched_eval, policy_act_fn
from .shac import SHAC
from .bptt import BPTT
from .ppo import PPO
from .sac import SAC
from .runner import Runner
