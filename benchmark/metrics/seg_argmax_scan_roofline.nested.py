"""seg_argmax_scan_roofline.nested: the scan kernel's share of its byte
roofline over the traced window of the workspace's replays (bytes its
live rows need at 3.35 TB/s over its profiled device time), percent."""

from benchmark.harness import readers


def read(r):
    return readers.roofline(r, "seg_argmax_scan")
