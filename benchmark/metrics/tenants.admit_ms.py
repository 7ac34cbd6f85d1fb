"""tenants.admit_ms: the multi-tenant server's ``prepare`` lane
(admission: decoding the pending deltas and probing their
admissibility), milliseconds a tick."""

from benchmark.harness import readers


def read(r):
    return readers.lane_ms_per(r, "prepare", "ticks")
