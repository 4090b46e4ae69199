from . import checkpoint, coco_eval, convert, metrics
from .bridge import load_jax_params
from .checkpoint import TrainCheckpoint, load_weights, save_weights
from .coco_eval import CocoEvaluator, compute_map
from .convert import convert_by_order, load_pdparams, load_torch_weights
from .export import export_model, load_exported, save_exported
from .metrics import Accuracy, EmptyMetric, MeanIoU, Metric, TopKAccuracy

__all__ = ["checkpoint", "coco_eval", "convert", "metrics",
           "load_jax_params", "TrainCheckpoint", "load_weights",
           "save_weights", "CocoEvaluator", "compute_map",
           "convert_by_order", "load_pdparams", "load_torch_weights",
           "Accuracy", "EmptyMetric", "MeanIoU", "Metric", "TopKAccuracy",
           "export_model", "save_exported", "load_exported"]
