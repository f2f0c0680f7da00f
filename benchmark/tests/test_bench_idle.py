"""The idle readers (``benchmark/idle.py``, ``metrics/step_idle_ms.*``,
``metrics/env_idle_ms.*``) on a synthetic trace of two acting steps whose
device-side spans are built as kineto builds them: each from the first to
the last operation launched while it was the innermost open range, so the
outer ``rollout`` span holds only the first observation and the bootstrap.
The older readers still read what they read on it."""
import random

import pytest

from benchmark import idle, trace
from benchmark.tests import cells
from benchmark.tests.test_bench_trace import EVENTS, Event, run

STEP = ("act_step", "act_policy", "env_step", "env_physics", "env_reset",
        "env_lidar")
ENV = ("env_step", "env_physics", "env_reset", "env_lidar")
NEW = ("step_idle_ms.train", "env_idle_ms.train", "step_idle_ms.eval",
       "env_idle_ms.eval")

# (span the op was launched in, start us, end us), in launch order
OPS = [("rollout", 10, 12),                  # first observation
       ("act_policy", 20, 25), ("act_step", 30, 32), ("env_step", 40, 41),
       ("env_physics", 45, 50), ("env_reset", 55, 56), ("env_lidar", 60, 65),
       ("env_step", 70, 71), ("act_step", 75, 76),
       ("act_policy", 90, 95), ("act_step", 97, 98), ("env_step", 100, 101),
       ("env_physics", 103, 104), ("env_lidar", 106, 110),
       ("act_step", 116, 117),
       ("rollout", 150, 160),                # bootstrap
       ("gae", 162, 163), ("ppo_forward", 170, 180),
       ("twin_trunks_grads", 185, 190)]
# idle before each op after the first (us), and the span that ends it
GAPS = [(8, "act_policy"), (5, "act_step"), (8, "env_step"),
        (4, "env_physics"), (5, "env_reset"), (4, "env_lidar"),
        (5, "env_step"), (4, "act_step"), (14, "act_policy"),
        (2, "act_step"), (2, "env_step"), (2, "env_physics"),
        (2, "env_lidar"), (6, "act_step"), (33, None), (2, None), (7, None),
        (5, None)]


def kineto_events():
    """The window, each op, and each span instance's device-side extent
    over the ops launched directly in it."""
    events = [Event(trace.WINDOW, 0, 200)]
    instances = {}
    for i, (where, t0, t1) in enumerate(OPS):
        events.append(Event(f"kernel{i}", t0, t1, device=True))
        step = 0 if t0 < 85 else 1
        key = (where, 0 if where == "rollout" else step)
        lo, hi = instances.get(key, (t0, t1))
        instances[key] = (min(lo, t0), max(hi, t1))
    for (name, _), (lo, hi) in instances.items():
        events.append(Event(name, lo, hi, device=True, span=True))
    return events


def test_the_synthetic_spans_are_kinetos():
    tr = trace.reduce(kineto_events())
    spans = {(n, lo, hi) for n, lo, hi in tr.spans}
    assert ("rollout", 10, 160) in spans         # obs to bootstrap
    assert ("act_step", 30, 76) in spans         # its direct ops alone
    assert ("env_step", 40, 71) in spans
    assert ("act_policy", 20, 25) in spans       # outside act_step's extent
    # every gap between ops is one of GAPS
    at, got = OPS[0][2], []
    for _, t0, t1 in OPS[1:]:
        got.append(max(0, t0 - at))
        at = max(at, t1)
    assert got == [g for g, _ in GAPS]


def test_by_span_gives_each_gap_to_the_op_that_ends_it():
    tr = trace.reduce(kineto_events())
    want = {}
    for gap, name in GAPS:
        key = name if name in STEP else None
        want[key] = want.get(key, 0.0) + gap / 1e3
    got = idle.by_span(tr, STEP)
    assert got.keys() == want.keys()
    for k, v in want.items():
        assert got[k] == pytest.approx(v), k


@pytest.mark.parametrize("seed", range(20))
def test_by_span_is_phase_of_over_the_gaps(seed):
    """The sweep gives each gap-ending op ``Trace.phase_of``'s span, on
    random nested and overlapping spans with ties in length."""
    rnd = random.Random(seed)
    ops, at = [], 0.0
    for _ in range(60):
        t0 = at + rnd.choice((0.0, 0.5, 2.0))
        at = t0 + rnd.choice((0.5, 1.0, 3.0))
        ops.append(("op", t0, at))
    spans = []
    for _ in range(25):
        lo = rnd.choice(ops)[1]
        hi = lo + rnd.choice((0.0, 1.0, 2.0, 5.0, 20.0))
        spans.append((rnd.choice(("a", "b", "c", "d")), lo, hi))
    tr = trace.Trace(ops=ops, spans=spans, window_us=at, busy_us=0.0,
                     gaps={})
    names = ("a", "b", "c")
    phases, want, end = tr.phase_of(names), {}, ops[0][2]
    for (_, t0, t1), ph in zip(ops[1:], phases[1:]):
        if t0 > end:
            want[ph] = want.get(ph, 0.0) + (t0 - end) / 1e3
        end = max(end, t1)
    got = idle.by_span(tr, names)
    assert got.keys() == want.keys()
    for k, v in want.items():
        assert got[k] == pytest.approx(v), k


@pytest.mark.parametrize("cell_name,kind", [("mini-train", "train"),
                                            ("circle-eval-1", "eval")])
def test_idle_readers(tmp_path, cell_name, kind):
    cell = cells.load(cells.make_root(tmp_path), cell_name)
    tr = trace.reduce(kineto_events())
    window = {"units": 10, "robot_steps": 2560, "env_steps": 320,
              "failed": 0}
    traced = {"units": 1, "robot_steps": 256, "env_steps": 2, "failed": 0}
    out = run.per_layer(cell, run.Context(cell, window, 2.0, tr, traced, 4.0))
    step_us = sum(g for g, name in GAPS if name in STEP)
    env_us = sum(g for g, name in GAPS if name in ENV)
    assert (step_us, env_us) == (71, 32)
    assert out[f"step_idle_ms.{kind}"]["value"] == pytest.approx(
        step_us / 1e3 / 2)
    assert out[f"env_idle_ms.{kind}"]["value"] == pytest.approx(
        env_us / 1e3 / 2)
    assert out[f"step_idle_ms.{kind}"]["unit"] == "ms"
    if kind == "train":
        # the nested spans leave the rollout's device time where it was:
        # every op from the first observation to the bootstrap
        rollout_us = sum(t1 - t0 for _, t0, t1 in OPS[:16])
        assert out["rollout_device_ms.train"]["value"] == pytest.approx(
            rollout_us / 1e3)
        assert out["ppo_device_ms.train"]["value"] == pytest.approx(
            (10 + 5) / 1e3)
        assert out["ops_per_update.train"]["value"] == len(OPS)


@pytest.mark.parametrize("cell_name", ["mini-train", "circle-eval-1"])
def test_idle_readers_read_nothing_without_their_spans(tmp_path, cell_name):
    """A program without the step's spans (the parent of this reader)."""
    cell = cells.load(cells.make_root(tmp_path), cell_name)
    traced = {"units": 1, "robot_steps": 256, "env_steps": 32, "failed": 0}
    window = {"units": 10, "robot_steps": 2560, "env_steps": 320,
              "failed": 0}
    out = run.per_layer(cell, run.Context(cell, window, 2.0,
                                          trace.reduce(EVENTS), traced, 4.0))
    assert not set(NEW) & set(out)
    assert out                               # the older readers still read
