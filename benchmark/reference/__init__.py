"""The benchmark's plain reference: the collision-avoidance env, the
twin-trunk actor-critic, GAE, clipped PPO and Adam in plain PyTorch.

It follows the published description (arXiv:1709.10082 and the
``Acmece/rl-collision-avoidance`` scripts that each configuration file
names) with the constants of ``benchmark/configs/<config>.json``.  It
imports nothing of the program under test and nothing of JAX, and takes
no table, weight or state that the program made: the lidar is a dense
ray cast against every wall segment of the configuration's own copy of
the geometry, the convolutions are ``F.conv1d``, and TF32 is off.
Departures from the reference scripts, all of them the program's
documented behaviour that the configuration states: batched arenas,
fixed-shape samplers (the benchmark draws their samples), and dead robots
kept in the rollout with weight 0.
"""
