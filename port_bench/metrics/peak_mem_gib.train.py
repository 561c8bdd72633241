"""The card's peak allocated memory over the run, GiB."""


def read(run):
    return run.memory_peak / 2 ** 30 if run.memory_peak else None
