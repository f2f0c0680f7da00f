"""The reset samplers as a draw, then a map (engine/sampling.py), on the
CPU: each generator form is its uniforms, drawn from the same generator,
through its ``*_from`` map, and ``Env.sample_pose_goal`` draws the uniforms
of its world's reset mode in one documented order from the env's
generator.  The card's sampler kernel is held to the same maps on the same
uniforms in tests/test_torch_gpu.py."""
import copy

import pytest
import torch

from rl_collision_avoidance_torch.engine import sampling
from rl_collision_avoidance_torch.engine.env import Env
from rl_collision_avoidance_torch.worlds import get_world
from rl_collision_avoidance_torch.worlds.spec import ResetMode

K = sampling._K


def _clone(g: torch.Generator) -> torch.Generator:
    twin = torch.Generator()
    twin.set_state(g.get_state())
    return twin


def _rand(g, *shape):
    return torch.rand(shape, generator=g)


def _standing(shape, seed):
    """Positions spread over the stage-2 map, some in its corridor."""
    g = torch.Generator().manual_seed(seed)
    return torch.rand((*shape, 2), generator=g) * 40.0 - 20.0


SAMPLERS = {
    "stage1_poses": (
        lambda g: sampling.stage1_poses((4, 6), 9.0, g, "cpu"),
        lambda g: sampling.stage1_poses_from(_rand(g, 3, 4, 6), 9.0)),
    "stage1_goals": (
        lambda g: sampling.stage1_goals(_standing((4, 6), 1) * 0.4, 9.0,
                                        8.0, 10.0, g),
        lambda g: sampling.stage1_goals_from(
            _rand(g, 2, 4, 6, K), _standing((4, 6), 1) * 0.4, 9.0, 8.0,
            10.0)),
    "corridor_poses": (
        lambda g: sampling.corridor_poses(_standing((4, 6), 2), g),
        lambda g: sampling.corridor_poses_from(_rand(g, 3, 4, 6, K),
                                               _standing((4, 6), 2))),
    "corridor_goals": (
        lambda g: sampling.corridor_goals(_standing((4, 6), 3), g),
        lambda g: sampling.corridor_goals_from(_rand(g, 2, 4, 6, K),
                                               _standing((4, 6), 3)))}


@pytest.mark.parametrize("name", SAMPLERS)
def test_generator_form_is_the_draw_then_the_map(name):
    drawn, mapped = SAMPLERS[name]
    g = torch.Generator().manual_seed(7)
    twin = _clone(g)
    assert torch.equal(drawn(g), mapped(twin))
    assert torch.equal(_rand(g, 5), _rand(twin, 5))   # as many draws


def _want(env, a, g, cur_xy):
    """The sample of ``env``'s world from generator ``g``, its uniforms
    drawn in the order Env._draw documents and mapped by sampling.py."""
    spec, n = env.spec, env.n_robots
    if spec.reset_mode is ResetMode.RANDOM_DISC:
        pose = sampling.stage1_poses_from(_rand(g, 3, a, n),
                                          spec.spawn_radius)
        goal = sampling.stage1_goals_from(
            _rand(g, 2, a, n, K), pose[..., :2], spec.spawn_radius,
            spec.goal_dist_min, spec.goal_dist_max)
        return pose, goal
    table = torch.as_tensor(spec.init_pose_table)
    goal = torch.as_tensor(spec.goal_table).expand(a, n, 2)
    pose = (sampling.table_poses_from(_rand(g, a, n, 2), table,
                                      spec.pose_jitter)
            if spec.pose_jitter > 0.0 else table.expand(a, n, 3))
    if spec.reset_mode is ResetMode.TABLES_THEN_CORRIDOR and \
            spec.n_fixed < n:
        rpose = sampling.corridor_poses_from(_rand(g, 3, a, n, K), cur_xy)
        rgoal = sampling.corridor_goals_from(_rand(g, 2, a, n, K),
                                             rpose[..., :2])
        fixed = (torch.arange(n) < spec.n_fixed)[:, None]
        pose = torch.where(fixed, pose, rpose)
        goal = torch.where(fixed, goal, rgoal)
    return pose, goal


#: (world, given standing poses): the three reset modes (stage 2 with
#: and without where its robots stand; circle_train jitters its tables).
MODES = [("stage1", False), ("stage2", True), ("stage2", False),
         ("circle_train", False), ("circle", False)]


@pytest.mark.parametrize("world,standing", MODES)
def test_env_sample_is_its_draws_then_the_maps(world, standing):
    env = Env(get_world(world), device="cpu", seed=3)
    assert env._sampler is None            # the CPU keeps the plain maps
    a, n = 3, env.n_robots
    cur = None
    if standing:
        xy = _standing((a, n), 4)
        cur = torch.cat([xy, torch.zeros((a, n, 1))], dim=-1)
    twin = _clone(env.generator)
    pose, goal = env.sample_pose_goal(a, cur)
    want = _want(env, a, twin, torch.zeros((a, n, 2)) if cur is None
                 else cur[..., :2])
    assert pose.shape == (a, n, 3) and goal.shape == (a, n, 2)
    assert torch.equal(pose, want[0]) and torch.equal(goal, want[1])
    assert torch.equal(_rand(env.generator, 5), _rand(twin, 5))
    # fresh tensors: writing them leaves the tables and the next sample
    before = copy.deepcopy((env.spec.init_pose_table, env.spec.goal_table))
    pose.add_(1.0)
    goal.add_(1.0)
    if env.spec.reset_mode is not ResetMode.RANDOM_DISC:
        assert torch.equal(env._pose_table,
                           torch.as_tensor(before[0]))
        assert torch.equal(env._goal_table, torch.as_tensor(before[1]))


@pytest.mark.parametrize("world,standing", MODES)
def test_env_draws_are_the_maps_inputs(world, standing):
    """Env._draw's uniforms through Env._sample_plain are the sample, and
    the uniforms have the shapes env_cuda.sample takes."""
    env = Env(get_world(world), device="cpu", seed=5)
    spec, a, n = env.spec, 2, env.n_robots
    cur = torch.zeros((a, n, 3)) if standing else None
    twin = _clone(env.generator)
    u_pose, u_goal, u_jitter = env._draw(a)
    disc = spec.reset_mode is ResetMode.RANDOM_DISC
    corridor = disc or (spec.reset_mode is ResetMode.TABLES_THEN_CORRIDOR
                        and spec.n_fixed < n)
    assert (None if u_pose is None else tuple(u_pose.shape)) == (
        ((3, a, n) if disc else (3, a, n, K)) if corridor else None)
    assert (None if u_goal is None else tuple(u_goal.shape)) == (
        (2, a, n, K) if corridor else None)
    assert (None if u_jitter is None else tuple(u_jitter.shape)) == (
        (a, n, 2) if spec.pose_jitter > 0.0 else None)
    got = env._sample_plain(a, u_pose, u_goal, u_jitter, cur)
    twin_env = Env(spec, device="cpu")
    twin_env.generator = twin
    want = twin_env.sample_pose_goal(a, cur)
    assert all(torch.equal(x, y) for x, y in zip(got, want))
