"""ds_mask_roofline.swarm: the delete-set kernel's share of its byte
roofline over the traced window (14 bytes an item and 24 a range, from
the counters ``ds_mask.items`` and ``ds_mask.ranges``, at 3.35 TB/s,
over the profiled device time of its four kernels), percent. Absent
where the program has no such counters."""

from benchmark.harness import fleet_counts


def read(r):
    return fleet_counts.roofline_pct(fleet_counts.ds_mask_s(r["counters"]),
                                     fleet_counts.DS_MASK, r["window"])
