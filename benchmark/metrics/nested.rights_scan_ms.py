"""nested.rights_scan_ms: the ``pack.rights.scan`` span (the per-segment
loop over origin groups that holds a right-bearing row: the walks,
the conflict-scan replays; inside ``pack.rights``), milliseconds a
replay. Absent where the program has no such span."""

from benchmark.harness import readers


def read(r):
    return readers.span_ms_per(r, ["pack.rights.scan"], "replays")
