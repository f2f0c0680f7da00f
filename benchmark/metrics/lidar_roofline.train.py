"""The lidar kernel's share of its roofline, percent: per launch the least
time of a frame of every robot (``counts.lidar_call``: each beam tests the
wall segments of its robot's cell, the mean over the positions of the
traced work, and the other robots' discs) over the device time of
``lidar_obs_kernel`` (``ops/csrc/lidar.cu``)."""
from benchmark import counts

KERNEL = "lidar_obs_kernel"


def read(ctx):
    tr = ctx.trace
    if tr is None or ctx.lidar_segments is None:
        return None
    times = [t1 - t0 for name, t0, t1 in tr.ops if KERNEL in name]
    if not times:
        return None
    least = len(times) * counts.lidar_call(
        ctx.world["n_robots"], ctx.robots, ctx.model["beams"],
        ctx.lidar_segments, len(ctx.world["segments"]))
    return 100.0 * least / (sum(times) / 1e6)
