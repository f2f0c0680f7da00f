"""The port's arena renderer (utils/render.py) against the JAX package's:
the same lines and patches from tensors as JAX's from arrays, a PNG and a
three-frame GIF written."""
import numpy as np
import pytest
import torch

from rl_collision_avoidance_tpu.worlds import stage1 as jstage1

from rl_collision_avoidance_torch.worlds import stage1


def _scene(seed=0, n=24, beams=512):
    rng = np.random.default_rng(seed)
    pose = np.concatenate([rng.uniform(-8, 8, (n, 2)),
                           rng.uniform(-np.pi, np.pi, (n, 1))], -1)
    return (pose.astype(np.float32),
            rng.uniform(-8, 8, (n, 2)).astype(np.float32),
            rng.uniform(0.2, 6.0, (n, beams)).astype(np.float32))


def _drawn(ax):
    """Every line's points, colour and style, and every patch's circle and
    colour."""
    lines = [(ln.get_xydata(), ln.get_color(), ln.get_linestyle(),
              ln.get_marker(), ln.get_linewidth()) for ln in ax.lines]
    patches = [(p.center, p.radius, tuple(p.get_facecolor()))
               for p in ax.patches]
    return lines, patches


@pytest.mark.parametrize("scan_dtype", [torch.float32, torch.bfloat16])
def test_render_arena_matches_jax(scan_dtype):
    """Tensors (the scan also in bf16, as an obs_dtype env keeps it) give
    the figure the JAX renderer draws from the same values as arrays."""
    pytest.importorskip("matplotlib")
    import matplotlib.pyplot as plt

    from rl_collision_avoidance_tpu.utils.render import render_arena as jrender
    from rl_collision_avoidance_torch.utils.render import render_arena

    pose, goal, scan = _scene()
    scan_t = torch.from_numpy(scan).to(scan_dtype)
    ax = render_arena(stage1(), torch.from_numpy(pose), torch.from_numpy(goal),
                      scan_t, scan_robot=3)
    ref = jrender(jstage1(), pose, goal, scan_t.float().numpy(), scan_robot=3)
    (lines, patches), (rlines, rpatches) = _drawn(ax), _drawn(ref)
    plt.close(ax.figure)
    plt.close(ref.figure)
    assert len(lines) == len(rlines) == 27 + 2 * 24 + 1
    assert len(patches) == len(rpatches) == 24
    for drawn, ref_drawn in zip(lines + patches, rlines + rpatches):
        for a, b in zip(drawn, ref_drawn):
            np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


def test_png_and_gif_written(tmp_path):
    pytest.importorskip("matplotlib")
    pytest.importorskip("PIL")
    from PIL import Image

    from rl_collision_avoidance_torch.utils.render import (save_arena_png,
                                                           save_trajectory_gif)

    pose, goal, scan = _scene(1, n=4, beams=64)
    spec = stage1()
    png = save_arena_png(tmp_path / "a.png", spec, torch.from_numpy(pose),
                         goal, torch.from_numpy(scan))
    with Image.open(png) as im:
        assert im.format == "PNG" and min(im.size) > 100
    poses = torch.from_numpy(pose)[None] + torch.linspace(0, 1, 3)[:, None,
                                                                   None]
    gif = save_trajectory_gif(tmp_path / "t.gif", spec, poses, goal)
    with Image.open(gif) as im:
        assert im.format == "GIF" and im.n_frames == 3
