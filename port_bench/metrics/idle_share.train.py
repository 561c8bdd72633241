"""Percent of the traced window with nothing running on the card."""


def read(run):
    t = run.trace_result
    if t is None or t.window_s <= 0:
        return None
    return 100.0 * (1.0 - t.busy_s / t.window_s)
