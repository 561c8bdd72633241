"""Mean host milliseconds of each call into the trainer's step (no sync
inside: the time the host spends dispatching one step), over the
window."""


def read(run):
    spans = run.spans.get('step')
    return 1e3 * sum(spans) / len(spans) if spans else None
