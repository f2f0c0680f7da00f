"""The acting step's CUDA graphs (``utils/graphs.py``) off the card: the
key, the launch counts of a captured kernel, what the eval and the trainer
keep (with the capture stubbed out), and the CPU path, which runs every
step eagerly, captures nothing and keeps nothing.  The graphed step
against the eager one is ``tests/test_torch_gpu.py``'s."""
import gc
import types
import weakref

import pytest
import torch

from rl_collision_avoidance_torch.algo import PPOConfig
from rl_collision_avoidance_torch.engine.env import Env
from rl_collision_avoidance_torch.eval import circle
from rl_collision_avoidance_torch.models import CNNPolicy
from rl_collision_avoidance_torch.train import TrainConfig, Trainer
from rl_collision_avoidance_torch.train.trainer import _Acting
from rl_collision_avoidance_torch.utils import graphs
from rl_collision_avoidance_torch.utils.metrics import MetricLogger
from rl_collision_avoidance_torch.worlds import get_world


def _policy_and_inputs(batch=4, beams=64):
    torch.manual_seed(0)
    policy = CNNPolicy(3, beams)
    return policy, (torch.zeros(batch, 3, beams), torch.zeros(batch, 2),
                    torch.zeros(batch, 2))


def _reassign(policy):
    policy.logstd = torch.nn.Parameter(policy.logstd.detach().clone())


CHANGES = {
    "batch": lambda policy, x: (policy, (torch.zeros(5, 3, 64), *x[1:])),
    "scans_dtype": lambda policy, x: (
        policy, (x[0].to(torch.bfloat16), *x[1:])),
    "policy_dtype": lambda policy, x: (
        setattr(policy, "dtype", torch.bfloat16) or policy, x),
    "parameter_reassigned": lambda policy, x: (_reassign(policy) or policy,
                                               x),
}


@pytest.mark.parametrize("change", sorted(CHANGES))
def test_key_changes_with_what_a_capture_depends_on(change):
    """A new batch, scans dtype, policy compute dtype or a parameter put in
    a new tensor each give a new key."""
    policy, x = _policy_and_inputs()
    before = graphs.key(policy, *x)
    policy, x = CHANGES[change](policy, x)
    assert graphs.key(policy, *x) != before


def test_key_holds_across_in_place_writes():
    """load_state_dict and an optimizer step write the parameters in place:
    the key, and so the kept graph, stay."""
    policy, x = _policy_and_inputs()
    before = graphs.key(policy, *x)
    other = CNNPolicy(3, 64)
    policy.load_state_dict(other.state_dict())
    assert graphs.key(policy, *x) == before
    opt = torch.optim.Adam(policy.parameters())
    policy(*x)[0].sum().backward()
    opt.step()
    assert graphs.key(policy, *x) == before
    assert not torch.equal(policy.critic.bias, other.critic.bias)


def test_a_captured_launch_counts_at_each_replay():
    """A launch counted while a step is captured is kept, not counted: the
    capture launches nothing.  Each replay then counts it.  (A stand-in
    graph here: nothing is captured on the CPU.)"""
    counted = []
    count = lambda *args: counted.append(args)
    graphs.launched(count, "k", 4)
    assert counted == [("k", 4)]
    with graphs.recorded_launches() as kept:
        graphs.launched(count, "k", 8)
    assert counted == [("k", 4)] and kept == [(count, ("k", 8))]
    graphs.launched(count, "k", 4)
    assert len(counted) == 2
    step = graphs.Step(lambda: None, "cpu")
    replayed = []
    step.graph = types.SimpleNamespace(replay=lambda: replayed.append(1))
    step.launches = kept
    step()
    step()
    assert replayed == [1, 1] and counted[2:] == [("k", 8), ("k", 8)]


@pytest.fixture
def kept_on_the_cpu(monkeypatch):
    """Steps kept as on the card, without a capture: ``captured_on`` reads
    True and a Step's capture does nothing (so it never runs)."""
    monkeypatch.setattr(graphs, "captured_on", lambda device: True)
    monkeypatch.setattr(graphs.Step, "_capture", lambda self, device: None)


def _circle_obs(arenas):
    env = Env(get_world("circle"), device="cpu", seed=0)
    return env.reset(arenas)[1]


def test_the_eval_keeps_a_step_per_policy_and_layout(kept_on_the_cpu):
    """The eval keeps one step for each policy and layout of its inputs: the
    same again is the kept one, another arena count is kept beside it, and
    a parameter put in a new tensor replaces the one for its layout."""
    torch.manual_seed(0)
    policy = CNNPolicy(3, 512)
    one, two = _circle_obs(1), _circle_obs(2)
    first = circle._episodes(policy, one)
    assert circle._episodes(policy, one) is first
    other = circle._episodes(policy, two)
    assert other is not first and circle._episodes(policy, one) is first
    _reassign(policy)
    again = circle._episodes(policy, one)
    assert again is not first and circle._episodes(policy, two) is not other
    assert len(circle._KEPT[policy]) == 2


def test_the_eval_steps_go_with_their_policy(kept_on_the_cpu):
    """A kept eval step holds no reference to its policy, which goes when
    its caller drops it, and its steps with it."""
    torch.manual_seed(0)
    policy = CNNPolicy(3, 512)
    circle._episodes(policy, _circle_obs(1))
    assert policy in circle._KEPT
    kept, gone = len(circle._KEPT), weakref.ref(policy)
    del policy
    gc.collect()
    assert gone() is None and len(circle._KEPT) < kept


def test_the_trainer_keeps_the_last_acting_step(kept_on_the_cpu):
    """The trainer keeps the acting step of its last rollout while its key
    holds, and a new one replaces it."""
    tr = Trainer(TrainConfig(world="mini", n_arenas=1, horizon=3, seed=1,
                             ppo=PPOConfig(batch_size=6, epochs=1)),
                 device="cpu")
    policy = tr.init_state().policy
    _, one = tr.env.reset(1)
    _, two = tr.env.reset(2)
    first = tr._acting_for(policy, one)
    assert tr._acting_for(policy, one) is first
    other = tr._acting_for(policy, two)
    assert other is not first and tr._acting[1] is other
    assert tr._acting_for(policy, one) is not first


def test_a_step_runs_eagerly_on_the_cpu():
    calls = []
    step = graphs.Step(lambda: calls.append(1) or len(calls), "cpu")
    counts = (graphs.captures, graphs.replays)
    assert step.graph is None
    assert (step(), step()) == (1, 2)
    assert (graphs.captures, graphs.replays) == counts


def test_the_acting_step_index_wraps_at_the_horizon():
    """The trainer's acting step writes the trajectory at its device-side
    index and advances it modulo the horizon (a capture's warm-up runs
    steps too), so a step past the horizon writes slot 0 again."""
    env = Env(get_world("mini"), device="cpu", seed=0)
    _, obs = env.reset(1)
    torch.manual_seed(0)
    policy = CNNPolicy(env.frames, obs.scans.shape[-1])
    acting = _Acting(policy, obs, horizon=2)
    for i, v in enumerate((0.5, -0.5, 0.25)):
        acting.goal.fill_(v)
        acting.noise.fill_(v)
        with torch.no_grad():
            action = acting.step()
        assert int(acting.t) == (i + 1) % 2
    assert torch.equal(acting.traj["goal"][0],
                       torch.full_like(acting.traj["goal"][0], 0.25))
    assert torch.equal(acting.traj["goal"][1],
                       torch.full_like(acting.traj["goal"][1], -0.5))
    assert torch.equal(acting.traj["action"][0], action)


def test_cpu_rollout_and_eval_capture_nothing(tmp_path):
    """On the CPU the trainer and the eval run their steps eagerly: no
    capture, no replay, nothing kept, and each rollout has trajectory
    buffers of its own; the training log's line reports the counts."""
    counts = (graphs.captures, graphs.replays)
    tr = Trainer(TrainConfig(world="mini", n_arenas=1, horizon=3, seed=1,
                             ppo=PPOConfig(batch_size=6, epochs=1)),
                 device="cpu")
    state = tr.init_state()
    _, traj0, _ = tr._rollout(state)
    _, traj1, _ = tr._rollout(state)
    assert traj0["scans"] is not traj1["scans"]
    assert not torch.equal(traj0["action"], traj1["action"])
    torch.manual_seed(0)
    env = Env(get_world("circle"), device="cpu", seed=0)
    circle.run_episodes(CNNPolicy(3, 512).eval(), env, 1, 2)
    assert (graphs.captures, graphs.replays) == counts
    assert tr._acting is None and len(circle._KEPT) == 0
    logger = MetricLogger(str(tmp_path), stdout=False)
    tr.train(state, updates=1, log_fn=logger.log_update)
    line = (tmp_path / "output.log").read_text()
    assert "graphs 0 captured, 0 replayed" in line
