"""GAE and clipped PPO (counterpart of ``rl_collision_avoidance_tpu/algo``)."""
from .gae import calculate_returns, generate_train_data
from .ppo import (Batch, PPOConfig, normalize_advantages, ppo_loss,
                  ppo_update)

__all__ = ["Batch", "PPOConfig", "calculate_returns", "generate_train_data",
           "normalize_advantages", "ppo_loss", "ppo_update"]
