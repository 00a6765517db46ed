"""kernels_roofline: over the traced part of the window, the least time of
every launch of a port kernel that has a bound file, summed, over the
device time of all the port's hand-written kernels, in percent."""


def read(run):
    return None if run.trace is None else run.trace.roofline_pct()
