from .builders import A2CNetwork
from .mlp import (MLP, ActorCriticPPO, ActorDeterministicMLP,
                  ActorStochasticMLP, CriticMLP, DoubleCriticMLP, SACActor)
