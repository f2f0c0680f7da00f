"""The circle-50 evaluation (counterpart of ``rl_collision_avoidance_tpu/eval``)."""
from .circle import run_circle_eval

__all__ = ["run_circle_eval"]
