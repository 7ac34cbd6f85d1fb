"""Metrics export: Prometheus text exposition + JSON snapshot.

The port's copy of ``crdt_tpu.obs.export``: the same exposition, byte
for byte, for the same report.

Both read the ONE shared schema — ``Tracer.report()`` — so a scrape,
a committed ``BENCH_OUT.json``, and an interactive ``report()`` all
describe the same numbers with the same names:

- counters  -> ``# TYPE <ns>_<name> counter`` (labels preserved:
  a tracer key ``name{k="v"}`` exposes as-is after sanitization)
- gauges    -> ``# TYPE <ns>_<name> gauge``
- spans     -> ``# TYPE <ns>_<name>_seconds histogram`` with the
  tracer's log-2 bucket edges as cumulative ``_bucket{le="..."}``
  series plus ``_sum`` / ``_count``

Metric names are sanitized to the Prometheus charset
(``[a-zA-Z_:][a-zA-Z0-9_:]*``): every other character becomes ``_``,
a leading digit gets a ``_`` prefix. Dots in span names (the
``converge.dispatch`` registry convention) therefore export as
``converge_dispatch``.

Sanitization is LOSSY, so two distinct tracer keys can land on one
Prometheus series (``a.b-c`` and ``a.b_c`` both export ``a_b_c``;
a counter and a gauge sharing one raw name would even emit duplicate
``# TYPE`` lines — a fatal exposition parse error). Round 18 closes
that hazard: colliding names are detected across all three sections
and EVERY colliding member is disambiguated deterministically with a
crc32 suffix of its (section, raw-name) pair — order-independent, so
the same report always exports the same series (pinned in
tests/test_obs.py). Collision-free names export exactly as before.
"""

from __future__ import annotations

import json
import re
import zlib
from typing import Any, Dict, Optional, Tuple

_INVALID = re.compile(r"[^a-zA-Z0-9_:]")


def sanitize_metric_name(name: str) -> str:
    """Sanitize one metric name to the Prometheus charset."""
    out = _INVALID.sub("_", name)
    if not out or out[0].isdigit():
        out = "_" + out
    return out


def _split_labels(key: str) -> Tuple[str, str]:
    """``name{k="v"}`` -> (name, '{k="v"}'); plain names pass through."""
    if key.endswith("}") and "{" in key:
        name, _, rest = key.partition("{")
        return name, "{" + rest
    return key, ""


def _final_names(report: Dict[str, Any], ns: str) -> Dict[Tuple[str, str], str]:
    """Map every (section, raw-base-name) to its exported series
    name, disambiguating sanitization collisions. Label variants of
    ONE raw name share one series name (that is grouping, not a
    collision); two DIFFERENT raw names — or one raw name in two
    sections, which would duplicate the TYPE line — landing on the
    same sanitized output each get a deterministic ``_<crc32>``
    suffix keyed on their own (section, raw) pair."""
    wanted: Dict[str, set] = {}
    for section, suffix in (
        ("counters", ""), ("gauges", ""), ("spans", "_seconds"),
    ):
        for key in report.get(section, {}):
            # span keys export whole (labels folded into the name,
            # as ever); counter/gauge labels split off and regroup
            raw = key if section == "spans" else _split_labels(key)[0]
            final = f"{ns}_{sanitize_metric_name(raw)}{suffix}"
            wanted.setdefault(final, set()).add((section, raw))
    out: Dict[Tuple[str, str], str] = {}
    for final, members in wanted.items():
        if len(members) == 1:
            ((section, raw),) = members
            out[(section, raw)] = final
        else:
            for section, raw in members:
                tag = zlib.crc32(
                    f"{section}:{raw}".encode()
                ) & 0xFFFFFFFF
                out[(section, raw)] = f"{final}_{tag:08x}"
    return out


def to_prometheus(report: Optional[Dict[str, Any]] = None,
                  *, namespace: str = "crdt") -> str:
    """Render a ``Tracer.report()`` dict (default: the process-global
    tracer's) in Prometheus text exposition format 0.0.4."""
    if report is None:
        from crdt_tpu_torch.obs.tracer import get_tracer

        report = get_tracer().report()
    ns = sanitize_metric_name(namespace)
    finals = _final_names(report, ns)
    lines = []
    for section, mtype in (("counters", "counter"), ("gauges", "gauge")):
        # ONE TYPE line per base metric name, all label sets grouped
        # under it (a duplicate TYPE line is a fatal exposition parse
        # error); rows sort by FINAL name so disambiguated label
        # variants stay adjacent under their one TYPE line
        rows = []
        for key, value in report.get(section, {}).items():
            raw, labels = _split_labels(key)
            rows.append((finals[(section, raw)], labels, value))
        last_name = None
        for name, labels, value in sorted(rows):
            if name != last_name:
                lines.append(f"# TYPE {name} {mtype}")
                last_name = name
            lines.append(f"{name}{labels} {value}")
    for key, span in report.get("spans", {}).items():
        name = finals[("spans", key)]
        lines.append(f"# TYPE {name} histogram")
        cum = 0
        finite = {
            le: n for le, n in span.get("buckets", {}).items()
            if le != "+Inf"
        }
        for le in sorted(finite, key=float):
            cum += finite[le]
            lines.append(f'{name}_bucket{{le="{le}"}} {cum}')
        lines.append(f'{name}_bucket{{le="+Inf"}} {span["count"]}')
        lines.append(f"{name}_sum {span['total_s']}")
        lines.append(f"{name}_count {span['count']}")
    return "\n".join(lines) + ("\n" if lines else "")


def snapshot_json(report: Optional[Dict[str, Any]] = None) -> str:
    """The JSON snapshot: ``Tracer.report()`` serialized verbatim (the
    same object ``bench.py`` embeds under ``"tracer"``)."""
    if report is None:
        from crdt_tpu_torch.obs.tracer import get_tracer

        report = get_tracer().report()
    return json.dumps(report, sort_keys=True)
