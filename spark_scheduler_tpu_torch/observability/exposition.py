"""Prometheus text exposition of a MetricRegistry snapshot.

The registry's native output is push: JSON lines per reporter tick
(metrics/registry.py emit). This renders the same snapshot as the
Prometheus text format (version 0.0.4) so a scrape-based stack can pull
GET /metrics directly: dotted names become underscore names, tags become
labels, histograms render as summaries (quantile series + _count + _sum).
"""

from __future__ import annotations

import re

_NAME_OK = re.compile(r"[^a-zA-Z0-9_:]")
_LABEL_OK = re.compile(r"[^a-zA-Z0-9_]")

# Histogram stat -> quantile label (min/max/mean ride their own suffixes).
_QUANTILES = (("p50", "0.5"), ("p95", "0.95"), ("p99", "0.99"))


def prefers_prometheus(accept: str) -> bool:
    """Does this Accept header PREFER a text exposition over JSON?
    Minimal q-value parse: the highest q among text/plain +
    application/openmetrics-text must beat application/json's (a client
    listing `application/json, text/plain;q=0.1` keeps JSON — a bare
    substring test would hand it unparseable text)."""
    q_text = q_json = 0.0
    for part in (accept or "").split(","):
        fields = part.split(";")
        mtype = fields[0].strip().lower()
        q = 1.0
        for f in fields[1:]:
            f = f.strip()
            if f.startswith("q="):
                try:
                    q = float(f[2:])
                except ValueError:
                    q = 0.0
        if mtype in ("text/plain", "application/openmetrics-text"):
            q_text = max(q_text, q)
        elif mtype == "application/json":
            q_json = max(q_json, q)
    return q_text > q_json


def _metric_name(name: str) -> str:
    out = _NAME_OK.sub("_", name)
    if out and out[0].isdigit():
        out = "_" + out
    return out


def _labels(tags: dict[str, str]) -> str:
    if not tags:
        return ""
    parts = []
    for k in sorted(tags):
        v = str(tags[k]).replace("\\", "\\\\").replace('"', '\\"')
        v = v.replace("\n", "\\n")
        parts.append(f'{_LABEL_OK.sub("_", k)}="{v}"')
    return "{" + ",".join(parts) + "}"


def render_prometheus(snapshot: dict, extra_gauges: dict | None = None) -> str:
    """`snapshot` is MetricRegistry.snapshot(); `extra_gauges` is
    {name: value} for serving-layer stats that live outside the registry
    (the predicate batcher's counters)."""
    lines: list[str] = []
    for name in sorted(snapshot):
        entries = snapshot[name]
        if not entries:
            continue
        pname = _metric_name(name)
        kind = entries[0]["kind"]
        if kind == "histogram":
            lines.append(f"# TYPE {pname} summary")
            for e in entries:
                tags = e["tags"]
                for stat, q in _QUANTILES:
                    if stat in e:
                        lines.append(
                            f"{pname}{_labels({**tags, 'quantile': q})}"
                            f" {e[stat]}"
                        )
                count = e.get("count", 0)
                lines.append(f"{pname}_count{_labels(tags)} {count}")
                # The exact running sum (monotone); mean*count only as a
                # fallback for foreign snapshot shapes.
                total = e.get("sum", e.get("mean", 0.0) * count)
                lines.append(f"{pname}_sum{_labels(tags)} {total}")
                for stat in ("min", "max"):
                    if stat in e:
                        lines.append(
                            f"{pname}_{stat}{_labels(tags)} {e[stat]}"
                        )
        else:
            lines.append(
                f"# TYPE {pname} {'counter' if kind == 'counter' else 'gauge'}"
            )
            for e in entries:
                lines.append(f"{pname}{_labels(e['tags'])} {e['value']}")
    for name in sorted(extra_gauges or {}):
        pname = _metric_name(name)
        lines.append(f"# TYPE {pname} gauge")
        lines.append(f"{pname} {extra_gauges[name]}")
    return "\n".join(lines) + "\n"
