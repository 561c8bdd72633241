"""Mean host milliseconds of the port's input path per step (gate, warps,
colour chain, mask) over the window."""


def read(run):
    spans = run.spans.get('input')
    return 1e3 * sum(spans) / len(spans) if spans else None
