"""scan_topk_hamming_roofline: kernel A′'s (bounds/scan_topk_hamming.py)
least time over its device time in the traced part of the window, in
percent."""


def read(run):
    return None if run.trace is None else run.trace.roofline_pct(
        "scan_topk_hamming")
