"""setup_s: process start to the window's first send, host clock: torch
and the port imported, kernels built or found built, inputs made, the
index loaded, the table uploaded and the warm-up requests served."""


def read(run):
    return run.setup_s
