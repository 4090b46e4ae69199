from . import optimizers
from .trainer import Model, Trainer

__all__ = ["optimizers", "Model", "Trainer"]
