from .bridge import load_jax_params

__all__ = ["load_jax_params"]
