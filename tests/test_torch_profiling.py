"""Tracing and the NaN guard of the port (utils/profiling.py), as the JAX
package's: ``Trainer.train(profile_dir=)`` and the CLI's ``--profile``
leave a trace, ``nan_debug`` raises at a NaN-producing backward; and the
CLI's ``bench`` subcommand and ``bench --scaling``.  The ``span`` gate:
no ``record_function`` is entered while no profiler runs, the acting
step's and ``Env.step``'s spans are in a trace, and tracing changes no
number of a rollout.  The reset sampler's span ``env_sample`` and what it
does to the benchmark's idle readers, and ``train_step``'s ``waiting``
count."""
import contextlib
import json
import sys

import pytest
import torch

from rl_collision_avoidance_torch import bench, cli
from rl_collision_avoidance_torch.algo import PPOConfig
from rl_collision_avoidance_torch.engine.env import Env
from rl_collision_avoidance_torch.eval import circle
from rl_collision_avoidance_torch.models import CNNPolicy
from rl_collision_avoidance_torch.train import TrainConfig, Trainer
from rl_collision_avoidance_torch.utils import profiling
from rl_collision_avoidance_torch.utils.profiling import (nan_debug, span,
                                                          trace)
from rl_collision_avoidance_torch.worlds import get_world


def _trace_names(path) -> set:
    return {e.get("name") for e in json.loads(path.read_text())["traceEvents"]}


def test_train_with_profile_dir_leaves_a_trace(tmp_path):
    cfg = TrainConfig(world="mini", n_arenas=1, horizon=4,
                      ppo=PPOConfig(batch_size=8, epochs=1))
    state = Trainer(cfg, device="cpu").train(updates=3,
                                             profile_dir=str(tmp_path))
    assert state.update == 3
    path = tmp_path / "rank0.pt.trace.json"
    assert path.is_file()
    assert {"rollout", "gae", "ppo_forward", "adam"} <= _trace_names(path)


def test_cli_profile_flag(tmp_path):
    cli.main(["train-stage1", "--device", "cpu", "--world", "mini",
              "--updates", "2", "--batch-size", "256", "--log-dir",
              str(tmp_path / "log"), "--profile", str(tmp_path / "trace")])
    assert (tmp_path / "trace" / "rank0.pt.trace.json").is_file()


def test_trace_writes_even_when_the_block_raises(tmp_path):
    with pytest.raises(ValueError):
        with trace(str(tmp_path)):
            torch.ones(3).sum()
            raise ValueError("stop")
    assert (tmp_path / "rank0.pt.trace.json").is_file()


def test_nan_debug_raises_on_a_nan_backward():
    x = torch.tensor([-1.0, 4.0], requires_grad=True)
    with nan_debug():
        with pytest.raises(RuntimeError, match="nan"):
            torch.sqrt(x).sum().backward()
    assert not torch.is_anomaly_enabled()
    torch.sqrt(x).sum().backward()     # outside the block: no check
    assert torch.isnan(x.grad[0])


def test_cli_bench_forwards(monkeypatch):
    seen = []
    monkeypatch.setattr(bench, "main", seen.append)
    cli.main(["bench", "--train", "--arenas", "4"])
    assert seen == [["--train", "--arenas", "4"]]


def test_bench_scaling_prints_its_json_line(capsys):
    bench.main(["--scaling", "2", "--steps", "32", "--warmup", "4"])
    out = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert out["metric"] == "cpu_scaling_efficiency_2proc"
    assert out["device"] == "cpu" and out["value"] > 0
    assert out["steps_per_s_2proc"] > 0 and out["steps_per_s_1proc"] > 0


@pytest.mark.parametrize("flags", [["--train"], ["--bf16", "--world", "mini"],
                                   ["--footprint", "rect"]],
                         ids=["train", "bf16 and world", "footprint"])
def test_bench_scaling_refuses_flags_it_ignores(flags, capsys):
    """--scaling times random-policy acting on mini: a flag that would set
    another configuration is refused, not silently dropped."""
    with pytest.raises(SystemExit):
        bench.main(["--scaling", "2", *flags])
    err = capsys.readouterr().err
    assert "--scaling" in err
    assert all(f in err for f in flags if f.startswith("--"))


def _mini_update_trainer():
    cfg = TrainConfig(world="mini", n_arenas=1, horizon=4, seed=3,
                      ppo=PPOConfig(batch_size=8, epochs=1))
    return Trainer(cfg, device="cpu")


def _eval_call(monkeypatch, max_steps=2):
    """One short ``run_episodes`` call on one arena of the 50-robot circle,
    its every-``CHECK_EVERY`` check run at each step."""
    monkeypatch.setattr(circle, "CHECK_EVERY", 1)
    torch.manual_seed(0)
    policy = CNNPolicy(3, 512).eval()
    env = Env(get_world("circle"), device="cpu", seed=0)
    return circle.run_episodes(policy, env, 1, max_steps)


@pytest.fixture
def port_ranges(monkeypatch):
    """The names of the ``record_function`` ranges the port's own modules
    build from now on (torch's own, such as the optimizer's, not
    counted)."""
    seen = []
    init = torch.autograd.profiler.record_function.__init__

    def counted(self, name, *args, **kwargs):
        if sys._getframe(1).f_globals.get("__name__", "").startswith(
                "rl_collision_avoidance_torch"):
            seen.append(name)
        init(self, name, *args, **kwargs)

    monkeypatch.setattr(torch.autograd.profiler.record_function, "__init__",
                        counted)
    return seen


def test_span_without_a_profiler_is_the_shared_no_op():
    assert span("act_step") is span("env_step") is profiling._OFF
    assert isinstance(span("x"), contextlib.nullcontext)
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]):
        assert isinstance(span("x"), torch.profiler.record_function)
    assert span("x") is profiling._OFF


def test_no_record_function_without_a_profiler(port_ranges, monkeypatch):
    trainer = _mini_update_trainer()
    trainer.train_step(trainer.init_state())
    _eval_call(monkeypatch)
    assert port_ranges == []
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]):
        with span("x"):       # the count sees the port's ranges
            pass
    assert port_ranges == ["x"]


def test_update_trace_holds_the_acting_and_env_spans(tmp_path):
    trainer = _mini_update_trainer()
    state = trainer.init_state()
    with trace(str(tmp_path)):
        trainer.train_step(state)
    names = _trace_names(tmp_path / "rank0.pt.trace.json")
    assert {"rollout", "gae", "act_step", "act_policy", "env_step",
            "env_physics", "env_reset", "env_lidar", "ppo_forward",
            "adam"} <= names
    assert "eval_check" not in names


def test_eval_trace_holds_the_acting_and_env_spans(tmp_path, monkeypatch):
    with trace(str(tmp_path)):
        _eval_call(monkeypatch)
    names = _trace_names(tmp_path / "rank0.pt.trace.json")
    assert {"act_step", "act_policy", "env_step", "env_physics",
            "env_lidar", "eval_check"} <= names
    assert "env_reset" not in names       # the circle never resets


def test_a_traced_rollout_is_bit_equal(tmp_path):
    """A rollout on injected noise and resets, with robots near the
    timeout so that resets land inside it, gives the same bits traced."""
    trainer = _mini_update_trainer()
    state = trainer.init_state()
    env = trainer.env
    state.env_state.step = torch.tensor([[146, 147, 148, 149]],
                                        dtype=torch.int32)
    gen = torch.Generator().manual_seed(7)
    horizon, n = trainer.cfg.horizon, env.n_robots
    noise = torch.randn((horizon, n, 2), generator=gen)
    resets = [env.sample_pose_goal(1) for _ in range(horizon)]
    plain = trainer._rollout(state, noise, resets)
    with trace(str(tmp_path)):
        traced = trainer._rollout(state, noise, resets)
    (s0, traj0, v0), (s1, traj1, v1) = plain, traced
    assert traj0.keys() == traj1.keys()
    for k in traj0:
        assert torch.equal(traj0[k], traj1[k]), k
    assert bool(traj0["done"].any())
    assert torch.equal(v0, v1)
    for k, x in vars(s0).items():
        assert torch.equal(x, getattr(s1, k)), k


def _events(path) -> list:
    return [e for e in json.loads(path.read_text())["traceEvents"]
            if e.get("ph") == "X"]


@pytest.mark.parametrize("world", ["mini", "stage2"])
def test_env_sample_nests_inside_env_reset(tmp_path, world):
    """On the plain path the env's own reset draw (stage 1's disc sampler;
    stage 2's tables and corridor sampler) is traced as ``env_sample``
    inside ``env_reset``; an injected sample draws nothing."""
    env = Env(get_world(world), device="cpu", seed=0)
    state, _ = env.reset(1)
    action = torch.zeros((1, env.n_robots, 2))
    with trace(str(tmp_path / "own")):
        env.step(state, action)
    events = _events(tmp_path / "own" / "rank0.pt.trace.json")
    (sample,) = [e for e in events if e["name"] == "env_sample"]
    (reset,) = [e for e in events if e["name"] == "env_reset"]
    assert sample["tid"] == reset["tid"]
    assert reset["ts"] <= sample["ts"]
    assert sample["ts"] + sample["dur"] <= reset["ts"] + reset["dur"]
    with trace(str(tmp_path / "given")):
        env.step(state, action, *env.sample_pose_goal(1))
    names = _trace_names(tmp_path / "given" / "rank0.pt.trace.json")
    assert "env_reset" in names and "env_sample" not in names


@pytest.mark.parametrize("world", ["stage2", "mini"])
def test_waiting_counts_the_robot_steps_dead_for_their_group(world):
    """``train_step``'s ``waiting`` is the rollout's count of ``~valid``
    robot-steps: stage 2's finished robots waiting for their group, none
    where robots reset alone."""
    if world == "stage2":
        cfg = TrainConfig.stage2(n_arenas=1, horizon=8,
                                 ppo=PPOConfig(batch_size=176, epochs=1))
    else:
        cfg = TrainConfig(world=world, n_arenas=1, horizon=8,
                          ppo=PPOConfig(batch_size=16, epochs=1))
    trainer = Trainer(cfg, device="cpu")
    state = trainer.init_state()
    n, timeout = trainer.env.n_robots, trainer.spec.timeout
    # stage 2: robot 0 times out at the first step and waits for the rest
    # of its group; mini: every robot times out there and resets alone
    steps = torch.zeros((1, n), dtype=torch.int32)
    steps[0, :1 if world == "stage2" else n] = timeout
    state.env_state.step = steps
    seen, batch = [], trainer._batch

    def counted(traj, last_value):
        seen.append(int((~traj["valid"]).sum()))
        return batch(traj, last_value)

    trainer._batch = counted
    _, metrics = trainer.train_step(state)
    assert seen == [metrics["waiting"]]
    if world == "stage2":
        assert metrics["waiting"] >= cfg.horizon - 1
    else:
        assert metrics["waiting"] == 0 and metrics["episodes"] >= n


def _idle_trace(kernels: bool, sample_span: str):
    """One acting step's device operations, each tagged with the innermost
    range it was launched in, and each range's device-side extent as
    kineto builds it: from the first to the last operation launched
    while it was the innermost range.  ``kernels``: ``Env.step``'s kernel
    path, on which ``env_step`` launches nothing itself; the plain path
    launches its masks and results directly in it.  The reset sampler's
    two operations are launched in ``sample_span``."""
    from benchmark import trace as tracing

    ops = [("act_policy", 10, 12), ("act_step", 15, 16)]
    ops += [] if kernels else [("env_step", 18, 19)]
    ops += [("env_physics", 22, 24), (sample_span, 30, 31),
            (sample_span, 35, 36), ("env_reset", 40, 41),
            ("env_lidar", 44, 47)]
    ops += [] if kernels else [("env_step", 49, 50)]
    ops += [("act_step", 55, 56)]
    extents = {}
    for name, t0, t1 in ops:
        lo, hi = extents.get(name, (t0, t1))
        extents[name] = (min(lo, t0), max(hi, t1))
    return tracing.Trace(
        ops=[(f"kernel{i}", t0, t1) for i, (_, t0, t1) in enumerate(ops)],
        spans=[(n, lo, hi) for n, (lo, hi) in extents.items()],
        window_us=60.0, busy_us=0.0, gaps={})


@pytest.mark.parametrize("kernels", [False, True], ids=["plain", "kernels"])
def test_env_sample_span_and_the_idle_readers(kernels):
    """The idle readers on a step traced without and with ``env_sample``
    (``benchmark/idle.py``, the span lists of ``metrics/``).
    ``step_idle_ms`` reads the same either way.  ``env_idle_ms`` reads the
    same where ``env_step`` has device work of its own (the plain path);
    on the kernel path ``env_step`` has none and ``env_reset``'s extent
    starts at its own launch, so the sampler's idle moves from
    ``env_idle_ms`` to ``sample_idle_ms``: their sum is the old reading."""
    from benchmark import idle, spec

    spans = {m: spec.load_module(spec.HERE / "metrics" / f"{m}.py").SPANS
             for m in ("step_idle_ms.train", "env_idle_ms.train",
                       "sample_idle_ms.train")}
    before = _idle_trace(kernels, "env_reset")
    after = _idle_trace(kernels, "env_sample")
    read = lambda tr, m: idle.span_ms(tr, spans[m])
    assert read(before, "sample_idle_ms.train") is None
    sampled = read(after, "sample_idle_ms.train")
    assert sampled == pytest.approx((30 - 24 + 35 - 31) / 1e3)
    assert read(after, "step_idle_ms.train") == pytest.approx(
        read(before, "step_idle_ms.train"))
    env_before = read(before, "env_idle_ms.train")
    env_after = read(after, "env_idle_ms.train")
    if kernels:
        assert env_after + sampled == pytest.approx(env_before)
    else:
        assert env_after == pytest.approx(env_before)
