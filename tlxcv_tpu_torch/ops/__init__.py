from .losses import cross_entropy, softmax_cross_entropy

__all__ = ["cross_entropy", "softmax_cross_entropy"]
