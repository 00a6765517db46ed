"""qps: queries answered in the window over the window's seconds (first
send to last reply, host clock). A request that failed answers none."""


def read(run):
    if run.window_s <= 0:
        return None
    return run.answered_queries / run.window_s
