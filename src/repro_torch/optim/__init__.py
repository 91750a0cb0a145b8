"""Functional optimizers (:mod:`.optimizers`)."""
from .optimizers import Optimizer, get_optimizer, rowwise_adagrad, sgd

__all__ = ["Optimizer", "get_optimizer", "rowwise_adagrad", "sgd"]
