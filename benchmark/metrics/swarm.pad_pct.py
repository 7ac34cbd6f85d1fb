"""swarm.pad_pct: of the [R, N] replica layout's slots (counter
``fleet.slots``, R x N a round, N the power-of-two bucket of the
largest peer), the share that holds no row (1 - ``fleet.ops_converged``
/ ``fleet.slots``), percent. Absent where the program has no such
counter."""


def read(r):
    slots = r["counters"].get("fleet.slots")
    if not slots:
        return None
    return 100.0 * (1.0 - r["counters"].get("fleet.ops_converged", 0)
                    / slots)
