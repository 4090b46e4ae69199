from . import init

__all__ = ["init"]
