"""tenants.tick_ms: the multi-tenant server's tick wall time (admission
to the SLO stamps: the tick timeline's ``wall_s``), milliseconds a
tick."""


def read(r):
    n = r["counts"].get("ticks")
    if not n or not r["timeline"]:
        return None
    return 1e3 * sum(t["wall_s"] for t in r["timeline"]) / n
