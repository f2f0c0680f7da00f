"""Training: stage 1, stage 2 and the circle fine-tune (counterpart of
``rl_collision_avoidance_tpu/train``)."""
from .trainer import TrainConfig, Trainer, TrainState

__all__ = ["TrainConfig", "TrainState", "Trainer"]
