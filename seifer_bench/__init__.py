"""The benchmark of the PyTorch and CUDA port (``repro_torch``).

``run.py`` runs one cell of ``BENCHMARK.json`` once and prints its result
line.  Everything a cell is made of is found by name: its configuration in
``configs/<config>.json``, its traffic in ``traffic/<traffic>.json``, the
entry it drives in ``entries/<entry>.py`` and each per-layer metric's
reader in ``metrics/<metric>.py``.  ``lib/`` holds the yardstick (frozen
copies of the work counts and of the arrival generator, the profiler's
reduction, the result line) and ``reference/`` the plain PyTorch models
that decide ``correct``.  Nothing here imports ``jax`` or the JAX package,
and ``reference/`` imports nothing of ``repro_torch``.
"""
