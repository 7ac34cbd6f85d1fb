"""nested.hard_rows_pct: of the right-bearing sequence rows staging saw
(counter ``rights.rows``), the share in segments it sent to the host
re-order at gather (``rights.hard_rows``), percent; 0 where none went
there. Absent where the program has no such counters."""


def read(r):
    rows = r["counters"].get("rights.rows")
    if not rows:
        return None
    return 100.0 * r["counters"].get("rights.hard_rows", 0) / rows
