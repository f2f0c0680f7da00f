"""The trace reduction and the per-layer readers on a synthetic trace:
device operations attributed to the innermost span, busy time as a
union, idle gaps named by the host's innermost event, and each reader's
arithmetic (or nothing, where its kernels or spans are missing)."""
import importlib.util

import pytest
from torch.autograd import DeviceType

from benchmark import counts, spec, trace
from benchmark.tests import cells

_RUN = importlib.util.spec_from_file_location("benchmark_run",
                                              spec.HERE / "run.py")
run = importlib.util.module_from_spec(_RUN)
_RUN.loader.exec_module(run)


class Event:
    def __init__(self, name, t0, t1, device=False, span=False, thread=1):
        self._v = (name, t0 * 1000, t1 * 1000, device, span, thread)

    def name(self):
        return self._v[0]

    def start_ns(self):
        return self._v[1]

    def end_ns(self):
        return self._v[2]

    def device_type(self):
        return DeviceType.CUDA if self._v[3] else DeviceType.CPU

    def is_user_annotation(self):
        return self._v[4]

    def start_thread_id(self):
        return self._v[5]


EVENTS = [Event(trace.WINDOW, 0, 100),
          Event("rollout", 0, 40), Event("aten::mul", 5, 15),
          Event("rollout", 10, 40, device=True, span=True),
          Event("ppo_forward", 50, 80, device=True, span=True),
          Event("twin_trunks_grads", 60, 80, device=True, span=True),
          Event("(anonymous namespace)::lidar_obs_kernel(float)", 10, 20,
                device=True),
          Event("void trunk::gemm_kernel<true, true, 1>(trunk::Gemm)", 30,
                40, device=True),
          Event("void trunk::gemm_kernel<true, false, 3>(trunk::Gemm)", 50,
                60, device=True),
          Event("void (anonymous namespace)::conv_bwd_kernel<float>()", 60,
                80, device=True),
          Event("elementwise", 70, 75, device=True)]


def test_reduce():
    tr = trace.reduce(EVENTS)
    assert tr.window_us == 100 and tr.busy_us == 50
    assert tr.phase_of(("rollout", "ppo_forward", "twin_trunks_grads")) == [
        "rollout", "rollout", "ppo_forward", "twin_trunks_grads",
        "twin_trunks_grads"]
    # gaps: 0-10 (aten::mul at 5), 20-30 (rollout at 25), 40-50, 80-100
    assert tr.gaps["aten::mul"] == pytest.approx(10e-6)
    assert tr.gaps["rollout"] == pytest.approx(10e-6)
    assert tr.gaps["host outside the program's ops"] == pytest.approx(30e-6)
    assert tr.op_seconds(1)[0][1] == pytest.approx(20e-6)


def test_readers(tmp_path):
    cell = cells.load(cells.make_root(tmp_path), "mini-train")
    tr = trace.reduce(EVENTS)
    window = {"units": 10, "robot_steps": 2560, "env_steps": 320,
              "failed": 0}
    traced = {"units": 1, "robot_steps": 256, "env_steps": 32, "failed": 0}
    ctx = run.Context(cell, window, 2.0, tr, traced, 4.0)
    out = run.per_layer(cell, ctx)
    assert out["device_idle.train"]["value"] == pytest.approx(50.0)
    assert out["rollout_device_ms.train"]["value"] == pytest.approx(0.02)
    assert out["ppo_device_ms.train"]["value"] == pytest.approx(0.035)
    assert out["ops_per_update.train"]["value"] == 5
    s = counts.update_shape(cell.config, cell.traffic)
    model = cell.config["model"]
    fwd = (s["acting_calls"] * counts.trunk_forward_call(model, s["robots"])
           + s["minibatches"] * counts.trunk_forward_call(model, s["batch"]))
    assert out["trunk_fwd_roofline.train"]["value"] == pytest.approx(
        100 * fwd / 20e-6)
    bwd = s["minibatches"] * counts.trunk_grads_call(model, s["batch"])
    assert out["trunk_bwd_roofline.train"]["value"] == pytest.approx(
        100 * bwd / 25e-6)
    assert "lidar_roofline.train" in out and "mfu.train" in out
    # a renamed kernel or span reads nothing
    bare = trace.reduce([Event(trace.WINDOW, 0, 10),
                         Event("other", 1, 2, device=True)])
    out = run.per_layer(cell, run.Context(cell, window, 2.0, bare, traced,
                                          4.0))
    assert not {"trunk_fwd_roofline.train", "trunk_bwd_roofline.train",
                "lidar_roofline.train", "rollout_device_ms.train",
                "ppo_device_ms.train"} & set(out)
    assert out["ops_per_update.train"]["value"] == 1


def test_units_record_positions(tmp_path):
    cell = cells.load(cells.make_root(tmp_path), "mini-train")
    session = cell.driver().Session(cell, 5, "cpu")
    poses = []
    session.unit(poses)
    assert len(poses) == cell.config["ppo"]["horizon"] == 32
    assert tuple(poses[0].shape) == (2, 4, 3)
    assert "step" not in vars(session.trainer.env)     # unwrapped again
