from .mlp import (MLP, ActorCriticPPO, ActorDeterministicMLP,
                  ActorStochasticMLP, CriticMLP, DoubleCriticMLP, SACActor)
