"""counts.py against numbers worked out by hand."""
import json

import numpy as np
import pytest

from benchmark import counts, spec

MODEL = json.loads((spec.HERE / "configs" / "stage1.json").read_text())["model"]


def test_one_sample():
    # conv1: 255 outputs x 5 taps, less the padding tap of the first
    # output (the last one's taps end on beam 511); conv2: 128 outputs x 3
    # taps over 255 inputs, less a padding tap at each end.
    assert counts.trunk_layers(MODEL) == {"conv1": 32 * 3 * (255 * 5 - 1),
                                          "conv2": 32 * 32 * (128 * 3 - 2),
                                          "fc1": 256 * 4096}
    fwd = 2 * (122_304 + 391_168 + 1_048_576)
    assert counts.trunk_forward(MODEL) == fwd
    # gradients: weight gradients of all three, input gradients of fc1 and
    # conv2 only; no recomputed forward
    assert counts.trunk_grads(MODEL) == 2 * (2 * 1_048_576 + 2 * 391_168
                                             + 122_304)
    tail = 260 * 128 + 2 * 128 + 260 * 128 + 128
    assert counts.forward(MODEL) == 2 * fwd + 2 * tail
    assert counts.forward(MODEL, actor_only=True) == fwd + 2 * (260 * 128
                                                                + 2 * 128)
    assert counts.gradients(MODEL) == 2 * counts.trunk_grads(MODEL) + 4 * tail
    assert 2 * counts.trunk_weights(MODEL) + 2 * (260 * 128 + 128) \
        + 3 * 129 + 2 == 2_172_101


def test_one_launch():
    # the forward at 32,768 samples is bound by its operations
    ops = 2 * 32_768 * counts.trunk_forward(MODEL)
    assert counts.trunk_forward_call(MODEL, 32_768) == pytest.approx(
        ops / 67e12)
    # one lidar frame of 768 robots, 7 segments a beam, 23 other discs
    per_beam = 10 + 12 * 7 + 11 * 23
    assert counts.lidar_call(24, 768, 512, 7, 27) == pytest.approx(
        768 * 512 * per_beam / 67e12)


def test_update_of_stage1():
    config = json.loads((spec.HERE / "configs" / "stage1.json").read_text())
    s = counts.update_shape(config, {"world": "train", "arenas": 32})
    assert s == {"robots": 768, "acting_calls": 129, "batch": 32_768,
                 "minibatches": 6}
    f = counts.update_flops(config, {"world": "train", "arenas": 32})
    assert f == 129 * 768 * counts.forward(MODEL) + 6 * 32_768 * (
        counts.forward(MODEL) + counts.gradients(MODEL))


def test_cell_segments_is_the_programs_table():
    from rl_collision_avoidance_torch.engine.celltable import build_cell_table
    from rl_collision_avoidance_torch.worlds import get_world

    for name, cfg in (("stage1", "stage1"), ("circle", "circle50")):
        config = json.loads((spec.HERE / "configs" / f"{cfg}.json")
                            .read_text())
        world = next(w for w in config["worlds"].values()
                     if w["name"] in (name, "circle"))
        w = get_world(name)
        table = build_cell_table(w.seg_p, w.seg_e, w.seg_valid, w.max_range)
        mine = counts.CellSegments(world)
        assert mine.shape == table.shape
        np.testing.assert_array_equal(mine.counts, table.counts)
