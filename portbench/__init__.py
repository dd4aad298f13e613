"""The benchmark of krust_tpu_torch, the PyTorch and CUDA port, on NVIDIA GPUs.

    python -m portbench.run --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Cells, configurations, traffic mixes and per-layer metrics are found by the
names ``BENCHMARK.json`` gives them: ``configs/<name>.json``,
``traffic/<name>.json``, ``metrics/<name>.py`` and ``entries/<name>.py``.
The reference (``reference.py``) is plain PyTorch and imports nothing of
the port; nothing here imports JAX or the JAX package.
"""
