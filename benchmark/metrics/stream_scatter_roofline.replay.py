"""stream_scatter_roofline.replay: the scatter kernel's share of its
byte roofline over the traced window (bytes its in-range targets need at
3.35 TB/s over its profiled device time), percent."""

from benchmark.harness import readers


def read(r):
    return readers.roofline(r, "stream_scatter")
