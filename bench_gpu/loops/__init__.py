"""Traffic drivers, one file a loop kind, ``loops/<loop>.py``, named by a
traffic mix's ``loop`` key. Each has ``refusal(traffic)`` (why it cannot
drive this mix, or None) and ``serve(client, index, inputs, traffic,
seconds, tracer, cuda, t0)``, which sends the window's requests and
returns a :class:`bench_gpu.record.Window`."""
