"""Arena rendering: the view the reference gets from the Stage GUI (the
``window`` block, ``worlds/stage1.world:53-75``) and its demo GIF.

Counterpart of ``rl_collision_avoidance_tpu/utils/render.py``: a matplotlib
figure of one arena (wall segments, robot discs with heading ticks, goals,
optionally one robot's lidar scan), a PNG of it, and a GIF of a trajectory.
Inputs may be tensors (on any device, any float dtype) or arrays; they are
moved to host numpy.  matplotlib, and PIL for the GIF, are imported inside
the functions only, so importing the package never needs them.
"""
from __future__ import annotations

import numpy as np
import torch


def _host(x) -> np.ndarray:
    """A tensor or array as a host numpy array (bf16 through float32)."""
    if isinstance(x, torch.Tensor):
        x = x.detach().cpu()
        return (x.float() if x.dtype == torch.bfloat16 else x).numpy()
    return np.asarray(x)


def render_arena(spec, pose, goal, scan=None, scan_robot: int = 0, ax=None):
    """pose (N, 3), goal (N, 2), optional scan (N, B) ranges in meters.
    Returns the matplotlib Axes."""
    import matplotlib
    matplotlib.use("Agg", force=False)
    import matplotlib.pyplot as plt
    from matplotlib.patches import Circle

    pose, goal = _host(pose), _host(goal)
    if ax is None:
        _, ax = plt.subplots(figsize=(7, 7))
    valid = _host(spec.seg_valid)
    for p, e in zip(_host(spec.seg_p)[valid], _host(spec.seg_e)[valid]):
        ax.plot([p[0], p[0] + e[0]], [p[1], p[1] + e[1]], "k-", lw=1)
    cmap = plt.cm.tab20(np.linspace(0, 1, len(pose)))
    for i, (x, y, th) in enumerate(pose):
        ax.add_patch(Circle((x, y), spec.robot_radius, color=cmap[i],
                            alpha=0.9))
        ax.plot([x, x + 2 * spec.robot_radius * np.cos(th)],
                [y, y + 2 * spec.robot_radius * np.sin(th)],
                color="black", lw=1)
        ax.plot(goal[i, 0], goal[i, 1], "*", color=cmap[i], markersize=8)
    if scan is not None:
        ranges = _host(scan)[scan_robot]
        x, y, th = pose[scan_robot]
        ang = th + np.linspace(-spec.fov / 2, spec.fov / 2, len(ranges))
        ax.plot(x + ranges * np.cos(ang), y + ranges * np.sin(ang), ".",
                color="red", markersize=1)
    ax.set_aspect("equal")
    return ax


def save_arena_png(path, spec, pose, goal, scan=None, scan_robot: int = 0):
    """:func:`render_arena` written to ``path`` as a PNG; returns ``path``."""
    import matplotlib.pyplot as plt

    ax = render_arena(spec, pose, goal, scan, scan_robot)
    ax.figure.savefig(path, dpi=120, bbox_inches="tight")
    plt.close(ax.figure)
    return path


def save_trajectory_gif(path, spec, poses, goal, every: int = 1,
                        duration_ms: int = 80):
    """Animate a trajectory, the reference's demo GIF (README.md:5): poses
    (T, N, 3), every ``every``-th step a frame; returns ``path``."""
    import io

    import matplotlib.pyplot as plt
    from PIL import Image

    frames = []
    poses = _host(poses)
    for t in range(0, len(poses), every):
        ax = render_arena(spec, poses[t], goal)
        buf = io.BytesIO()
        ax.figure.savefig(buf, format="png", dpi=80, bbox_inches="tight")
        plt.close(ax.figure)
        buf.seek(0)
        frames.append(Image.open(buf).convert("P"))
    frames[0].save(path, save_all=True, append_images=frames[1:],
                   duration=duration_ms, loop=0)
    return path
