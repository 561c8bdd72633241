"""Median milliseconds of a served forward on the card (the CUDA graph's
replay with its input copies and output clones), CUDA events around each
forward over the window."""

import statistics


def read(run):
    spans = run.spans.get('replay')
    return 1e3 * statistics.median(spans) if spans else None
