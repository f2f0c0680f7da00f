from . import distributions
from .policy import CNNPolicy, MLPPolicy, load_policy

__all__ = ["CNNPolicy", "MLPPolicy", "distributions", "load_policy"]
