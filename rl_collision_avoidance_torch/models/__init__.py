from . import distributions
from .policy import CNNPolicy, load_policy

__all__ = ["CNNPolicy", "distributions", "load_policy"]
