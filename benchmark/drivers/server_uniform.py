"""The open-loop multi-tenant server of :mod:`benchmark.drivers.server`
under YCSB's ``requestdistribution=uniform``: a read targets a record
drawn uniformly among those acknowledged so far, so no record is hot.

Everything else is the server driver's: the configuration's shares,
records and fields, the mix's ``rate`` and ``check_reads``, the
schedule (each kind its own stream of fixed gaps), the warm-up ticks,
the window and the check. An update, where the shares hold any,
targets a record drawn uniformly among the loaded ones. A read's draw
is one of the same set of shuffled mid-quantiles for every seed,
scaled to the records acknowledged when the read is served.
"""

from __future__ import annotations

from typing import Dict

from benchmark.drivers import server
from benchmark.harness import stats


class Driver(server.Driver):

    def __init__(self, config: Dict, mix: Dict, seed: int, device: str,
                 seconds: float, program=None):
        # Zipf with a constant of 0 is uniform over the loaded records
        uniform = dict(config, requestdistribution="zipfian",
                       zipfian_constant=0.0)
        super().__init__(uniform, mix, seed, device, seconds,
                         program=program)
        self.u = stats.shuffled_quantiles(len(self.due), stats.rng_of(seed, 5))

    def _target(self, i: int) -> int:
        return min(int(self.u[i] * (self.newest + 1)), self.newest)
