from .bridge import load_jax_params
from .metrics import Metric

__all__ = ["load_jax_params", "Metric"]
