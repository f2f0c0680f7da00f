"""Stage-1 training (counterpart of ``rl_collision_avoidance_tpu/train``)."""
from .trainer import TrainConfig, Trainer, TrainState

__all__ = ["TrainConfig", "TrainState", "Trainer"]
