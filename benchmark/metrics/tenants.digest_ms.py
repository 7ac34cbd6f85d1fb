"""tenants.digest_ms: the multi-tenant server's ``digest`` span (a
read: the doc's canonical digest, computed once a converged state),
milliseconds a read."""

from benchmark.harness import readers


def read(r):
    return readers.span_ms_per(r, ["digest"], "reads")
