from . import optimizers
from .bn_recal import recalibrate_batch_stats
from .trainer import Model, Trainer

__all__ = ["optimizers", "Model", "Trainer", "recalibrate_batch_stats"]
