from .mlp import MLP, ActorDeterministicMLP, ActorStochasticMLP, CriticMLP
