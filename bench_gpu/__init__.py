"""The benchmark of ``redis_hnsw_tpu_torch``, the PyTorch and CUDA port.

Each cell of ``BENCHMARK.json`` at the repository root is one run of
``python3 -m bench_gpu.run``. Everything that belongs to one
configuration, traffic mix, metric or kernel bound is a file of its own
here, found by the name ``BENCHMARK.json`` gives it: ``configs/``,
``traffic/``, ``metrics/``, ``bounds/``; and so is each generator
(``gen/``), each metric's plain reference (``reference/``) and each
traffic driver (``loops/``), named by a configuration or a mix.
Nothing here imports JAX or the JAX package ``redis_hnsw_tpu``;
``reference/`` imports nothing of the port either.
"""
