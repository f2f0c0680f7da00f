"""The plain reference against the port on the CPU at a tiny size: a
whole run of the harness on ``mini`` (4 robots, 64 beams) and on one
circle arena, with the port's plain paths; and the eval weights as the
benchmark reads them against the port's own loader."""
import importlib.util
import json

import pytest
import torch

from benchmark import spec, traffic
from benchmark.reference import world as ref_world
from benchmark.tests import cells

_RUN = importlib.util.spec_from_file_location("benchmark_run",
                                              spec.HERE / "run.py")
run = importlib.util.module_from_spec(_RUN)
_RUN.loader.exec_module(run)
SEED = 2_345_678_901


def test_training_matches_the_reference(tmp_path):
    cell = cells.load(cells.make_root(tmp_path), "mini-train")
    res = run.run(cell, SEED, 0.5, False, "cpu")
    r = res["_readings"]
    assert res["correct"], res["checked"]
    assert r["loss_gap"] < 1e-5 and r["grad_gap"] < 1e-5
    assert r["change_gap"] < 1e-4 and r["change_gap_worst"] < 1e-2
    assert r["reset_rule_share"] == 0.0 and r["resets_drawn"] == 32
    assert res["attempted"] >= 1 and res["failed"] == 0
    assert res["_info"]["window"]["robot_steps"] == 32 * 8 * res["attempted"]
    assert list(res)[-3] == "checked"


def test_eval_matches_the_reference(tmp_path):
    cell = cells.load(cells.make_root(tmp_path), "circle-eval-1")
    res = run.run(cell, SEED, 0.1, False, "cpu")
    assert res["correct"], res["checked"]
    r = res["_readings"]
    assert r["robots"] == 50 and r["answer_mismatch"] == 0.0
    assert r["state_gap"] == 0.0 and r["action_gap"] < 1e-5
    assert r["rerun_mismatch"] == 0.0
    assert res["_info"]["window"]["env_steps"] == 600


@pytest.mark.parametrize("config", ["stage1", "circle50"])
def test_reset_rule_holds_the_ports_sampler(config):
    from rl_collision_avoidance_torch.engine.env import Env
    from rl_collision_avoidance_torch.worlds import get_world

    c = json.loads((spec.HERE / "configs" / f"{config}.json").read_text())
    world = ref_world.load(c, "train", "cpu")
    env = Env(get_world(world.name), device=torch.device("cpu"), seed=7)
    poses, goals = zip(*(env.sample_pose_goal(4) for _ in range(16)))
    assert ref_world.rule_breaks(world, poses, goals) == 0.0
    nearer = [0.5 * (p[..., :2] + g) for p, g in zip(poses, goals)]
    assert ref_world.rule_breaks(world, poses, nearer) == 1.0
    assert ref_world.rule_breaks(world, [], []) == 1.0


def test_npz_weights_are_the_ports():
    from rl_collision_avoidance_torch.models import load_policy

    model = json.loads((spec.HERE / "configs" / "circle50.json")
                       .read_text())["model"]
    path = spec.HERE / "data" / "circle_ft_params.npz"
    mine = traffic.npz_weights(path, model, "cpu")
    theirs = load_policy(path, device="cpu").state_dict()
    assert mine.keys() == theirs.keys()
    for k in mine:
        assert torch.equal(mine[k], theirs[k]), k
