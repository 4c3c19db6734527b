"""The benchmark of the PyTorch and CUDA port (``surface_multigrid_code_torch``).

``python3 -m portbench.run --workload NAME --seed N --seconds S --trace 0|1``
runs one cell once (``run.py``); ``README.md`` says how cells,
configurations and metrics are added as files. Nothing here imports
``jax``, ``jaxlib`` or the JAX package, and ``reference/`` imports nothing
of the port.
"""
