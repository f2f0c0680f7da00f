"""The benchmark of the PyTorch/CUDA port (``rl_collision_avoidance_torch``)
on one H100: ``run.py`` runs one cell of ``BENCHMARK.json``."""
