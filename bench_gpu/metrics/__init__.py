"""One reader per metric of ``BENCHMARK.json``, ``metrics/<name>.py``,
each a ``read(run)`` that returns the metric's value from a finished
run (:class:`bench_gpu.record.Run`), or None where the run has nothing
for it to read."""
