"""card_wait_ms: ms a request the host spent blocked on the card (the
port's ``card_wait`` span: a fetch window's event wait, the certified
tier's synchronous reruns' copies), from the port's record of each
``search_batch``, over the window's requests outside the profiled
part."""

from bench_gpu.request_log import mean_ms


def read(run):
    return mean_ms(run, "card_wait_ns")
