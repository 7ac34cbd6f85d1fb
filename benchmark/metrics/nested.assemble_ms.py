"""nested.assemble_ms: the replay assembly's ``gather`` (with the host
re-order of hard segments inside it), ``materialize`` and ``compact``
spans, milliseconds a replay."""

from benchmark.harness import readers


def read(r):
    return readers.span_ms_per(
        r, ["gather", "materialize", "compact"], "replays")
