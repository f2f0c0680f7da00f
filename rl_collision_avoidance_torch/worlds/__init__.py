from .spec import ResetMode, WorldSpec, get_world, mini, stage1

__all__ = ["ResetMode", "WorldSpec", "get_world", "mini", "stage1"]
