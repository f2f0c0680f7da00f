"""PyTorch/CUDA port of ``rl_collision_avoidance_tpu``.

A second package beside the JAX one, which stays the reference it is tested
against.  It imports torch and numpy only.  Entry points run on the CUDA
card unless the caller passes ``device="cpu"``; there every kernel's plain
PyTorch version runs instead.
"""
__version__ = "0.1.0"
