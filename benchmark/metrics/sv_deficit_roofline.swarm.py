"""sv_deficit_roofline.swarm: the deficit kernel's share of its
operation roofline over the traced window (the INT32 operations its
launches need at 16.7 T/s, from the counters ``sv_deficit.cells``,
``.entries`` and ``.pairs``, over the profiled device time of its two
kernels), percent. Absent where the program has no such counters."""

from benchmark.harness import fleet_counts


def read(r):
    return fleet_counts.roofline_pct(
        fleet_counts.sv_deficit_s(r["counters"]),
        fleet_counts.SV_DEFICIT, r["window"])
