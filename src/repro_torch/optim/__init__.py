"""Functional optimizers (:mod:`.optimizers`)."""
from .optimizers import Optimizer, adam, get_optimizer, rowwise_adagrad, sgd

__all__ = ["Optimizer", "adam", "get_optimizer", "rowwise_adagrad", "sgd"]
