"""Runnable examples of the port (``python -m
rl_collision_avoidance_torch.examples.<name>``)."""
