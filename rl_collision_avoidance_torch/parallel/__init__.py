"""Multi-process training over ``torch.distributed`` (counterpart of
``rl_collision_avoidance_tpu/parallel``)."""
from .dist import (all_gather_flat, all_reduce_sum, arena_range,
                   broadcast_module, is_initialized, local_device, rank,
                   rank_seed, setup_distributed, teardown, world_size)

__all__ = ["all_gather_flat", "all_reduce_sum", "arena_range",
           "broadcast_module", "is_initialized", "local_device", "rank",
           "rank_seed", "setup_distributed", "teardown", "world_size"]
