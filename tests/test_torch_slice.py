"""The acting slice end to end on mini: the port's act_step (policy forward,
Gaussian sample, env step) against the same chain through the JAX package,
with the same weights, sampling noise and reset draws.  The two sides carry
their own states for all steps; each step's new lidar frame is held as
``torch_parity`` says, everything else at ``ATOL``."""
import jax
import jax.numpy as jnp
import numpy as np
import torch

from rl_collision_avoidance_tpu.engine.env import Env as JEnv
from rl_collision_avoidance_tpu.models import CNNPolicy as JCNNPolicy
from rl_collision_avoidance_tpu.worlds import mini as jmini

from rl_collision_avoidance_torch.bench import act_step
from rl_collision_avoidance_torch.engine.env import Env
from rl_collision_avoidance_torch.models import CNNPolicy
from rl_collision_avoidance_torch.utils.params import jax_params_to_torch
from rl_collision_avoidance_torch.worlds import mini
from torch_parity import ATOL, assert_frame_matches_jax

STEPS = 5


def _draw(jenv, keys, pose):
    k = jax.vmap(lambda key: jax.random.split(key, 2))(keys)[:, 1]
    return tuple(torch.tensor(np.asarray(x))
                 for x in jenv._sample_pose_goal(k, pose))


def test_acting_steps_match_jax():
    spec, jspec, arenas = mini(), jmini(), 3
    n, beams = spec.n_robots, spec.n_beams
    jenv = JEnv(jspec, lidar_mode="pallas")
    model = JCNNPolicy()
    params = model.init(jax.random.PRNGKey(1), jnp.zeros((1, 3, beams)),
                        jnp.zeros((1, 2)), jnp.zeros((1, 2)))
    env = Env(spec, device="cpu")
    policy = CNNPolicy(beams=beams)
    policy.load_state_dict(jax_params_to_torch(jax.device_get(params)))

    keys = jax.random.split(jax.random.PRNGKey(2), arenas)
    jstate, jobs = jenv.reset(keys)
    state, obs = env.reset(arenas, *_draw(jenv, keys,
                                          jnp.zeros((arenas, n, 3))))

    @jax.jit
    def jax_step(state, obs, noise):
        flat = lambda x: x.reshape(arenas * n, *x.shape[2:])
        _, mean, logstd = model.apply(params, flat(obs.scans), flat(obs.goal),
                                      flat(obs.speed))
        action = (mean + jnp.exp(logstd) * noise).reshape(arenas, n, 2)
        return (action, *jenv.step(state, action))

    rng = np.random.default_rng(0)
    for _ in range(STEPS):
        noise = rng.standard_normal((arenas * n, 2)).astype(np.float32)
        rp, rg = _draw(jenv, jstate.key, jstate.pose)
        ja, jstate, jobs, jr, jd, _ = jax_step(jstate, jobs, noise)
        a, state, obs, r, d, _ = act_step(env, policy, state, obs,
                                          torch.from_numpy(noise),
                                          reset_pose=rp, reset_goal=rg)
        np.testing.assert_allclose(a.numpy(), np.asarray(ja), atol=ATOL)
        np.testing.assert_allclose(r.numpy(), np.asarray(jr), atol=ATOL)
        np.testing.assert_array_equal(d.numpy(), np.asarray(jd))
        for f in ("goal", "speed"):
            np.testing.assert_allclose(getattr(obs, f).numpy(),
                                       np.asarray(getattr(jobs, f)),
                                       atol=ATOL, err_msg=f)
        assert_frame_matches_jax(env, obs.scans[..., -1, :].numpy(),
                                 np.asarray(jobs.scans[..., -1, :]),
                                 state.pose.numpy())
        np.testing.assert_allclose(state.pose.numpy(),
                                   np.asarray(jstate.pose), atol=ATOL)
