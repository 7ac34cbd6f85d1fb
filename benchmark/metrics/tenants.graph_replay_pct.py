"""tenants.graph_replay_pct: of the cold route's packed converges on the
card in the traced window of the server (counter
``converge.graph{path}``), the share that replayed a captured signature
rather than capturing a new one, percent. Absent where the program has
no such counter."""

REPLAY = 'converge.graph{path="replay"}'
CAPTURE = 'converge.graph{path="capture"}'


def read(r):
    replay = r["counters"].get(REPLAY, 0)
    total = replay + r["counters"].get(CAPTURE, 0)
    if not total:
        return None
    return 100.0 * replay / total
