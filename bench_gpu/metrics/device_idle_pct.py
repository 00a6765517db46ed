"""device_idle_pct: the share of the traced part of the window in which no
operation ran on the card (the union of the profiler's device
intervals), in percent."""


def read(run):
    t = run.trace
    if t is None or t.device_events == 0 or t.window_s <= 0:
        return None
    return 100.0 * (1.0 - t.busy_s / t.window_s)
