"""tenants.converge_ms: the cold route's packed converge of the docs a
tick opens (``converge.dispatch`` and ``converge.fetch``, the fetch
being the wait for the card), milliseconds a tick."""

from benchmark.harness import readers


def read(r):
    return readers.span_ms_per(r, ["converge.dispatch", "converge.fetch"],
                               "ticks")
