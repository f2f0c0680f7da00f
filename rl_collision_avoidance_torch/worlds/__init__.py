from .spec import (ResetMode, WorldSpec, circle, circle_tables, circle_train,
                   compile_world, get_world, mini, stage1, stage1_rect,
                   stage2, stage2_tables)

__all__ = ["ResetMode", "WorldSpec", "circle", "circle_tables",
           "circle_train", "compile_world", "get_world", "mini", "stage1",
           "stage1_rect", "stage2", "stage2_tables"]
