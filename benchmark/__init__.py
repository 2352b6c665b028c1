"""The benchmark of tdax_torch, the PyTorch/CUDA port, on NVIDIA H100.

``BENCHMARK.json`` at the repository's root lists its configurations,
traffic mixes, cells and metrics; ``benchmark.run`` runs one cell once
(see its docstring).  Everything that measures lives here: the traffic
generator (``inputs``), the seeded weights (``weights``), the jobs of
the program's entry points (``jobs/``), the yardstick (``roofline``,
``work``), the trace reduction (``trace``), one reader per per-layer
metric (``layer_metrics/``) and the plain f32 reference that decides
``correct`` (``reference/``), which imports nothing of the program.
"""
