"""Share of the traced step or wave in which no device operation ran."""
from bench.harness import readings


def read(r):
    return readings.idle_share(r)
