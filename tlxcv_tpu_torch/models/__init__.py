from .classification import *  # noqa: F401,F403
from .classification import __all__
