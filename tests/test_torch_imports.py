"""What the port may import and load: no JAX, flax, PIL, matplotlib or JAX
package, the world geometry as committed literals, and chip_smoke.py's
refusals."""
import os
import shutil
import subprocess
import sys
from pathlib import Path

import numpy as np

from rl_collision_avoidance_tpu.worlds import stage1 as jstage1

from rl_collision_avoidance_torch.ops import build
from rl_collision_avoidance_torch.worlds import stage1

ROOT = Path(__file__).resolve().parents[1]
FORBIDDEN = ("jax", "flax", "PIL", "matplotlib", "rl_collision_avoidance_tpu")
NO_CARD = {**os.environ, "CUDA_VISIBLE_DEVICES": ""}

_SLICE = """
import sys
import torch
import chip_smoke
from rl_collision_avoidance_torch import bench, cli
from rl_collision_avoidance_torch.algo import gae, ppo
from rl_collision_avoidance_torch.engine.env import Env
from rl_collision_avoidance_torch.eval import run_circle_eval
from rl_collision_avoidance_torch.examples import make_results
from rl_collision_avoidance_torch.examples import train_curriculum
from rl_collision_avoidance_torch.models import MLPPolicy, load_policy
from rl_collision_avoidance_torch.ops import build, lidar_cuda, trunk_cuda
from rl_collision_avoidance_torch.train import TrainConfig, Trainer
from rl_collision_avoidance_torch.utils import checkpoint, device, metrics
from rl_collision_avoidance_torch.utils import params, profiling, render
from rl_collision_avoidance_torch.utils.running_stats import RunningMeanStd
from rl_collision_avoidance_torch.worlds import circle, stage1, stage2
from rl_collision_avoidance_torch.worlds import compile_world, png

env = Env(stage1(), device="cpu")
policy = load_policy("results/stage1_params.npz", device="cpu")
state, obs = env.reset(1)
gen = torch.Generator().manual_seed(0)
state, obs, stats = bench.run_acting(env, policy, state, obs, 2, gen)
assert bool(stats["finite"])
trainer = Trainer(TrainConfig(world="mini", horizon=4,
                              ppo=ppo.PPOConfig(batch_size=8, epochs=1)),
                  device="cpu")
_, m = trainer.train_step(trainer.init_state())
assert all(v == v for v in m.values())
env2 = Env(stage2(), device="cpu")
state, obs = env2.reset(1)
env2.step(state, torch.zeros(1, 44, 2))
ft = load_policy("results/circle_ft_params.npz", device="cpu")
assert run_circle_eval(ft, max_steps=2)["n_robots"] == 50
bf16 = Trainer(TrainConfig(world="mini", horizon=4,
                           ppo=ppo.PPOConfig(batch_size=8, epochs=1),
                           policy_dtype=torch.bfloat16,
                           obs_store_dtype=torch.bfloat16), device="cpu")
_, m = bf16.train_step(bf16.init_state())
assert all(v == v for v in m.values())
assert int(compile_world("stage1").seg_valid.sum()) == 27   # rink.png
assert int(compile_world("stage2").seg_valid.sum()) == 166  # testenv.png
s1, o1 = env.reset1()
env.step1(s1, torch.zeros(24, 2))
MLPPolicy(1540)(torch.zeros(3, 1540))
RunningMeanStd.create((2,), device="cpu").update(torch.ones(4, 2))
assert make_results.select_score({"success_rate_mean": 1.0,
                                  "collisions_mean": 0.0}) == 1.0
print(sorted(m for m in sys.modules
             if m.split(".")[0] in {FORBIDDEN!r}))
"""


def _run(args, cwd=ROOT, env=None):
    return subprocess.run([sys.executable, *args], cwd=cwd, env=env,
                          capture_output=True, text=True, timeout=300)


def test_port_imports_nothing_of_jax():
    """Importing the port and chip_smoke.py, and running the stage-1 acting
    slice, a training update, a stage-2 env step, two circle-eval steps, a
    bf16 training update (bf16 policy and scans), the world compiler on
    both bitmaps, reset1/step1, an MLPPolicy forward, a RunningMeanStd
    update and the results pipeline's selection score on the CPU, loads
    none of JAX, flax, PIL, matplotlib or the JAX package."""
    code = _SLICE.replace("{FORBIDDEN!r}", repr(set(FORBIDDEN)))
    proc = _run(["-c", code], env=NO_CARD)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip().splitlines()[-1] == "[]", proc.stdout


def test_stage1_geometry_table_is_the_jax_build():
    mine, ref = stage1(), jstage1()
    for name in ("seg_p", "seg_e", "seg_valid"):
        a, b = getattr(mine, name), getattr(ref, name)
        assert a.dtype == b.dtype, name
        np.testing.assert_array_equal(a, b, err_msg=name)
    assert int(mine.seg_valid.sum()) == 27 and mine.n_segments == 128


def test_entry_points_need_a_card_unless_told():
    code = ("from rl_collision_avoidance_torch.engine import Env\n"
            "from rl_collision_avoidance_torch.worlds import mini\n"
            "Env(mini(), device='cpu')\n"
            "try:\n    Env(mini())\nexcept RuntimeError as e:\n"
            "    print('raised', e)\n")
    proc = _run(["-c", code], env=NO_CARD)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.startswith("raised no CUDA device"), proc.stdout


def test_chip_smoke_fails_without_a_card():
    proc = _run(["chip_smoke.py"], env=NO_CARD)
    assert proc.returncode != 0
    assert '"ok": true' not in proc.stdout


def test_chip_smoke_fails_without_the_port(tmp_path):
    shutil.copy(ROOT / "chip_smoke.py", tmp_path / "chip_smoke.py")
    proc = _run(["chip_smoke.py"], cwd=tmp_path, env=NO_CARD)
    assert proc.returncode != 0
    assert '"ok": true' not in proc.stdout


def test_build_is_one_plain_nvcc_call_for_sm_90a():
    flags = " ".join(build.NVCC_FLAGS)
    assert "arch=compute_90a,code=sm_90a" in flags
    assert "fast_math" not in flags and "fast-math" not in flags
    assert {p.name for p in build.sources()} == {"lidar.cu", "trunk_fwd.cu",
                                             "trunk_bwd.cu", "env_step.cu"}
    assert build.BUILD_ROOT == ROOT / "rl_collision_avoidance_torch" / "_build"
    assert "rl_collision_avoidance_torch/_build/" in (
        ROOT / ".gitignore").read_text().splitlines()
