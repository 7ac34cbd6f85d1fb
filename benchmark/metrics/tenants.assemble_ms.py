"""tenants.assemble_ms: the cold route's assembly of the docs a tick
opens (``gather`` and ``materialize``: each doc's converged state built
from the kernels' outputs), milliseconds a tick."""

from benchmark.harness import readers


def read(r):
    return readers.span_ms_per(r, ["gather", "materialize"], "ticks")
