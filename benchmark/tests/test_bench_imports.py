"""The import boundary: no run loads JAX or the JAX package, compared by
whole top-level name, and the reference loads nothing of the program."""
import ast
import importlib.util
import subprocess
import sys

from benchmark import spec

_RUN = importlib.util.spec_from_file_location("benchmark_run",
                                              spec.HERE / "run.py")
run = importlib.util.module_from_spec(_RUN)
_RUN.loader.exec_module(run)


def test_whole_top_level_names():
    ok = {"rl_collision_avoidance_torch": 1,
          "rl_collision_avoidance_torch.train.trainer": 1,
          "jaxtyping": 1, "numpy": 1}
    assert run.forbidden_modules(ok) == []
    for bad in ("jax", "jax.numpy", "jaxlib.xla_client", "flax.linen",
                "rl_collision_avoidance_tpu",
                "rl_collision_avoidance_tpu.engine.env"):
        assert run.forbidden_modules({**ok, bad: 1}) == [bad.split(".")[0]]


def _imports(path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


def test_reference_imports_nothing_of_the_program():
    for path in (spec.HERE / "reference").glob("*.py"):
        for name in _imports(path):
            assert name.split(".")[0] in ("torch", "numpy", "math",
                                          "dataclasses", "__future__"), \
                (path.name, name)
    code = ("import sys; sys.path.insert(0, %r); "
            "import benchmark.reference.train, benchmark.reference.circle; "
            "bad = [m for m in sys.modules if m.split('.')[0] in "
            "('rl_collision_avoidance_torch', 'rl_collision_avoidance_tpu', "
            "'jax', 'jaxlib', 'flax')]; print(bad); assert not bad"
            % str(spec.REPO))
    subprocess.run([sys.executable, "-c", code], check=True, timeout=120)


def test_harness_imports_no_jax():
    for path in spec.HERE.rglob("*.py"):
        for name in _imports(path):
            assert run.forbidden_modules({name: 1}) == [], (path, name)
