"""Percent of the server's batch slots filled by requests over the window:
served / batches / batch size, the server's own counters."""


def read(run):
    c = run.counters
    if not c.get('batches'):
        return None
    return 100.0 * c['served'] / c['batches'] / c['batch_size']
