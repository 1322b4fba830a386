"""The benchmark of the PyTorch/CUDA port (``mindaudio_torch``).

One invocation runs one cell of ``BENCHMARK.json`` once and prints one JSON
line::

    python -m portbench.run --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Everything that belongs to one configuration, one cell or one per-layer
metric sits in a file of its own, found by its name: ``configs/<config>.json``,
``workloads/<cell>.json``, ``drivers/<kind>.py``, ``families/<family>.py``,
``metrics/<metric>.py``. ``work/`` counts operations and bytes from shapes,
``reference/`` is the plain PyTorch reference that decides ``correct``.
Nothing here imports JAX or the JAX package.
"""
