"""select_bins_roofline: kernel D's (bounds/select_bins.py) least time over
its device time in the traced part of the window, in percent."""


def read(run):
    return None if run.trace is None else run.trace.roofline_pct(
        "select_bins")
