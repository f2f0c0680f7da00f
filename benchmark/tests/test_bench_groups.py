"""The stage-2 configuration, its traffic kind ``train_groups`` and its
plain reference (``reference/groups.py``) against the port on the CPU at a
small size: the stage-2 map with 2 arenas of 44 robots and 64 beams,
seeded random weights, TF32 off."""
import copy
import dataclasses
import json
import math

import numpy as np
import pytest
import torch

from benchmark import check, counts, faults, spec
from benchmark.reference import env as ref_env
from benchmark.reference import groups as ref_groups
from benchmark.reference import world as ref_world
from benchmark.tests import cells

SEED = 3_123_456_789
BEAMS = 64
CONFIG = json.loads((spec.HERE / "configs" / "stage2.json").read_text())
LIMITS = json.loads((spec.HERE / "limits" / "stage2-train.json").read_text())
#: Poses, goals and distances: the port's physics and the reference's
#: round the same float32 operations in another order, so they may part
#: by a few ulps of a 20 m coordinate; the frames by as much again through
#: the ray casts (t = cross / cross).  Every bool and int field is equal.
ATOL = 1e-5


@pytest.fixture(autouse=True)
def no_tf32():
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def small_config() -> dict:
    c = copy.deepcopy(CONFIG)
    c["model"]["beams"] = BEAMS
    c["ppo"].update(horizon=16, minibatch_per_arena=352)
    return c


def port_world():
    from rl_collision_avoidance_torch.worlds import get_world

    return dataclasses.replace(get_world("stage2"), n_beams=BEAMS)


def driver():
    return spec.load_module(spec.HERE / "drivers" / "train_groups.py")


def make_cell(tmp_path, monkeypatch):
    """The cell ``stage2-small`` in a harness root under ``tmp_path``, and
    the trainer's world cut to 64 beams."""
    from rl_collision_avoidance_torch.train import trainer

    bench = cells.make_root(tmp_path)
    root = bench.parent
    (root / "configs" / "stage2.json").write_text(json.dumps(small_config()))
    (root / "traffic" / "train-groups-2arenas.json").write_text(json.dumps(
        {"kind": "train_groups", "world": "train", "arenas": 2}))
    (root / "limits" / "stage2-small.json").write_text(json.dumps(LIMITS))
    b = json.loads(bench.read_text())
    b["workloads"].append({"name": "stage2-small", "config": "stage2",
                           "traffic": "train-groups-2arenas", "chips": 1,
                           "why": "test"})
    bench.write_text(json.dumps(b))
    monkeypatch.setattr(trainer, "get_world", lambda name: port_world())
    return cells.load(bench, "stage2-small")


def one_checked_update(cell, monkeypatch):
    drv = driver()
    monkeypatch.setattr(drv, "CHECKED_UPDATES", 1)
    session = drv.Session(cell, SEED, "cpu")
    records = [session.unit()]
    window = session.tally(records)
    return session.readings(records), window


def test_configuration_is_the_ports_stage2():
    from rl_collision_avoidance_torch.engine import sampling
    from rl_collision_avoidance_torch.train import TrainConfig

    w = port_world()
    world = CONFIG["worlds"]["train"]
    seg = np.concatenate([w.seg_p, w.seg_e], axis=1)[w.seg_valid]
    np.testing.assert_array_equal(np.float32(world["segments"]), seg)
    k = w.n_fixed
    np.testing.assert_array_equal(np.float32(world["table_poses"]),
                                  w.init_pose_table[:k])
    np.testing.assert_array_equal(np.float32(world["table_goals"]),
                                  w.goal_table[:k])
    bounds = world["group_bounds"]
    assert bounds[0] == 0 and bounds[-1] == w.n_robots == world["n_robots"]
    assert bounds[-2] == k
    np.testing.assert_array_equal(
        np.repeat(np.arange(len(bounds) - 1), np.diff(bounds)), w.group_id)
    for key in ("robot_radius", "max_range", "dt", "goal_size",
                "omega_thresh", "timeout", "dist_prev_zero_on_reset"):
        assert world[key] == pytest.approx(getattr(w, key)), key
    assert world["reset"] == "group_tables_corridor"
    assert w.reset_mode.name == "TABLES_THEN_CORRIDOR"
    corridor = world["corridor"]
    assert corridor["candidates"] == sampling._K
    u = torch.rand((2, 4096), generator=torch.Generator().manual_seed(1))
    u[1, :3] = torch.tensor([0.0, 0.4, 0.99999994])
    np.testing.assert_allclose(
        driver().corridor_xy(corridor, u[0], u[1]).numpy(),
        sampling._corridor_xy(u[0], u[1]).numpy(), rtol=0, atol=2e-6)
    assert corridor["min_dist"] == 7.0      # engine/sampling.py's d >= 7.0

    a = 16
    cfg = TrainConfig.stage2(n_arenas=a)
    ppo = CONFIG["ppo"]
    assert cfg.world == world["name"] and cfg.horizon == ppo["horizon"]
    assert (cfg.gamma, cfg.lam) == (ppo["gamma"], ppo["lam"])
    assert cfg.ppo.batch_size == ppo["minibatch_per_arena"] * a
    for key in ("epochs", "clip_value", "coeff_entropy", "value_coeff",
                "learning_rate", "logstd_min"):
        assert getattr(cfg.ppo, key) == ppo[key], key
    traffic = json.loads((spec.HERE / "traffic"
                          / "train-groups-16arenas.json").read_text())
    assert traffic["arenas"] == a
    s = counts.update_shape(CONFIG, traffic)
    assert s == {"robots": 704, "acting_calls": 129, "batch": 8192,
                 "minibatches": 44}


def test_draws_keep_the_rule_bar_where_robots_stand():
    world = ref_world.load(CONFIG, "train", "cpu")
    gen = torch.Generator().manual_seed(SEED)
    poses, goals = zip(*(driver().pose_goal(CONFIG["worlds"]["train"], 4,
                                            gen) for _ in range(8)))
    away = [torch.full_like(p, -100.0) for p in poses]
    assert ref_groups.rule_breaks(world, poses, goals, away) == 0.0
    # a corridor pose drawn where its robot stands breaks the rule
    assert ref_groups.rule_breaks(world, poses, goals, poses) == pytest.approx(
        10 / 44)


def test_rule_holds_the_ports_sampler():
    from rl_collision_avoidance_torch.engine.env import Env

    world = ref_world.load(CONFIG, "train", "cpu")
    env = Env(port_world(), device=torch.device("cpu"), seed=7)
    gen = torch.Generator().manual_seed(8)
    samples = []
    for _ in range(16):
        stand = torch.rand((4, 44, 3), generator=gen) * 40.0 - 20.0
        samples.append((*env.sample_pose_goal(4, stand), stand))
    poses, goals, stands = map(list, zip(*samples))
    assert ref_groups.rule_breaks(world, poses, goals, stands) == 0.0
    assert ref_groups.rule_breaks(world, [], [], []) == 1.0
    # one corridor robot put down 6.9 m from its fresh pose: caught
    near = [s.clone() for s in stands]
    near[3][1, 40, :2] = poses[3][1, 40, :2] + torch.tensor([6.9, 0.0])
    assert ref_groups.rule_breaks(world, poses, goals, near) == \
        pytest.approx(1 / (16 * 4 * 44))
    # a goal pulled in to 6.9 m of its pose: caught
    short = [g.clone() for g in goals]
    short[0][0, 35] = poses[0][0, 35, :2] + torch.tensor([0.0, 6.9])
    assert ref_groups.rule_breaks(world, poses, short, stands) > 0.0


def test_chained_steps_through_group_resets_equal_the_reference():
    """40 chained steps of random actions on the same injected samples;
    robots start near the timeout, so groups finish one robot at a time,
    wait dead and reset, the corridor group included."""
    from rl_collision_avoidance_torch.engine.env import Env

    config = small_config()
    world = ref_world.load(config, "train", "cpu")
    env = Env(port_world(), device=torch.device("cpu"), use_kernels=False)
    gen = torch.Generator().manual_seed(SEED)
    draw = driver().pose_goal
    a = 2
    pose, goal = draw(config["worlds"]["train"], a, gen)
    mine, _ = env.reset(a, pose, goal)
    ref = ref_env.reset(world, pose, goal)
    steps = torch.randint(185, 201, (a, 44), generator=gen, dtype=torch.int32)
    mine.step, ref.step = steps.clone(), steps.clone()
    waited = resets = corridor_resets = 0
    for _ in range(40):
        action = torch.randn((a, 44, 2), generator=gen)
        rp, rg = draw(config["worlds"]["train"], a, gen)
        mine, _, reward, done, info = env.step(mine, action, rp, rg)
        ref, ref_reward, ref_done, ref_info = ref_groups.step(
            world, ref, action, rp, rg)
        for k in ("step", "dead"):
            assert torch.equal(getattr(mine, k), getattr(ref, k)), k
        assert torch.equal(done, ref_done)
        for k in ("valid", "reached", "crashed", "result"):
            assert torch.equal(getattr(info, k), ref_info[k]), k
        for k in ("pose", "goal", "dist", "speed", "scan_hist", "ep_return"):
            torch.testing.assert_close(getattr(mine, k), getattr(ref, k),
                                       rtol=0, atol=ATOL, msg=k)
        torch.testing.assert_close(reward, ref_reward, rtol=0, atol=ATOL)
        fresh = mine.step == 0
        resets += int(fresh.sum())
        corridor_resets += int(fresh[:, 34:].sum())
        waited += int((~info.valid).sum())
    assert resets > 44 and corridor_resets >= 10 and waited > 0


def test_one_checked_update_reads_inside_the_limits(tmp_path, monkeypatch):
    cell = make_cell(tmp_path, monkeypatch)
    readings, window = one_checked_update(cell, monkeypatch)
    correct, compared = check.judge(readings, cell.limits)
    assert correct, compared
    assert readings["reset_rule_share"] == 0.0
    assert readings["resets_drawn"] == 16
    assert readings["counts"]["program"] == readings["counts"]["reference"]
    assert readings["waiting"]["program"] == [
        float(n) for n in readings["waiting"]["reference"]]
    # the reference followed the program's states, step by step
    assert readings["state_gap"] < ATOL and readings["mismatch"] == [0]
    assert set(readings["state_gaps"][0]) == {"xy", "heading", "goal",
                                              "dist", "speed"}
    assert readings["mismatch_share"] == 0.0
    assert readings["frame_share"] == 0.0
    assert window["robot_steps"] == 16 * 88
    assert 0.0 <= window["waiting_share"] <= 1.0


def test_wrong_resets_lift_the_rule_share(tmp_path, monkeypatch):
    cell = make_cell(tmp_path, monkeypatch)
    with faults.wrong_resets():
        readings, _ = one_checked_update(cell, monkeypatch)
    correct, compared = check.judge(readings, cell.limits)
    assert not correct
    assert readings["reset_rule_share"] > cell.limits["reset_rule_share"]
    assert {k for k, v in compared.items() if v["value"] > v["limit"]} == \
        {"reset_rule_share"}


@pytest.mark.parametrize("fault, caught", [
    # the reference follows the program's scans, so the losses agree and
    # the frame check alone catches a lidar off by one beam
    ("rolled_lidar", {"frame_share"}),
    # a robot reset alone where the reference keeps it dead for its group
    ("group_of_one", {"mismatch_share"}),
    # a heading off by a twentieth of the turn, its frames cast there
    ("heading_drift", {"state_gap"})])
def test_a_stage2_fault_fails_correct(tmp_path, monkeypatch, fault, caught):
    """Each fault of the stage-2 step fails ``correct`` by its own number
    and by no other."""
    from benchmark import calibrate_groups

    cell = make_cell(tmp_path, monkeypatch)
    with calibrate_groups.FAULTS[fault]():
        readings, _ = one_checked_update(cell, monkeypatch)
    correct, compared = check.judge(readings, cell.limits)
    assert not correct
    assert {k for k, v in compared.items() if v["value"] > v["limit"]} \
        == caught, compared


def test_a_program_without_the_waiting_count(tmp_path, monkeypatch):
    """The parent's trainer returns no ``waiting``: the tally leaves the
    share out and nothing raises."""
    from rl_collision_avoidance_torch.train import trainer

    step = trainer.Trainer.train_step

    def without(self, *args, **kwargs):
        state, m = step(self, *args, **kwargs)
        m.pop("waiting")
        return state, m

    monkeypatch.setattr(trainer.Trainer, "train_step", without)
    cell = make_cell(tmp_path, monkeypatch)
    readings, window = one_checked_update(cell, monkeypatch)
    assert "waiting_share" not in window
    assert readings["waiting"]["program"] == [None]
    assert not math.isnan(readings["loss_gap"])
