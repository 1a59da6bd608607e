from .eval_utils import batched_eval, policy_act_fn
