"""nested.converge_ms: the packed converge's ``converge.dispatch`` and
``converge.fetch`` spans (the upload, the launches, and the fetch that
waits for the card), milliseconds a replay."""

from benchmark.harness import readers


def read(r):
    return readers.span_ms_per(
        r, ["converge.dispatch", "converge.fetch"], "replays")
