"""CLI for observability dumps: pretty-print a snapshot or diff two.

Usage:
    python -m repro_torch.obs show  obs_snapshot/metrics.json
    python -m repro_torch.obs diff  before.json after.json

``show`` prints one line a series (counters and gauges: the value;
histograms: count, p50/p90/p99, max).  ``diff`` prints only the series
that changed, with counter deltas and histogram p50 movement.  The dump's
schema is ``repro.obs``'s, so either package's CLI reads either package's
dump.
"""
from __future__ import annotations

import argparse
import json
import sys


def _load(path: str) -> dict:
    with open(path) as fh:
        snap = json.load(fh)
    if "metrics" not in snap:
        raise SystemExit("%s: not a metrics snapshot (no 'metrics' key)" % path)
    return snap["metrics"]


def _fmt_val(v: float) -> str:
    if isinstance(v, int):
        return str(v)
    if v == 0:
        return "0"
    if abs(v) >= 1e-3:
        return "%.4g" % v
    return "%.3e" % v


def _series_key(s: dict) -> str:
    labels = s.get("labels") or {}
    if not labels:
        return ""
    return "{" + ",".join("%s=%s" % kv for kv in labels.items()) + "}"


def _show(path: str) -> int:
    metrics = _load(path)
    rows = []
    for name in sorted(metrics):
        entry = metrics[name]
        for s in entry["series"]:
            label = name + _series_key(s)
            if entry["type"] == "histogram":
                detail = ("count=%d p50=%s p90=%s p99=%s max=%s" % (
                    s["count"], _fmt_val(s["p50"]), _fmt_val(s["p90"]),
                    _fmt_val(s["p99"]), _fmt_val(s["max"])))
            else:
                detail = _fmt_val(s["value"])
            rows.append((label, entry["type"], entry["unit"], detail))
    if not rows:
        print("(no series recorded)")
        return 0
    width = max(len(r[0]) for r in rows)
    for label, kind, unit, detail in rows:
        print("%-*s  %-9s %-8s %s" % (width, label, kind, unit, detail))
    return 0


def _index(metrics: dict) -> dict:
    out = {}
    for name, entry in metrics.items():
        for s in entry["series"]:
            out[name + _series_key(s)] = (entry["type"], s)
    return out


def _diff(path_a: str, path_b: str) -> int:
    a, b = _index(_load(path_a)), _index(_load(path_b))
    keys = sorted(set(a) | set(b))
    changed = []
    for key in keys:
        kind_a, sa = a.get(key, (None, None))
        kind_b, sb = b.get(key, (None, None))
        kind = kind_b or kind_a
        if kind == "histogram":
            ca = sa["count"] if sa else 0
            cb = sb["count"] if sb else 0
            if ca == cb and sa and sb and sa["sum"] == sb["sum"]:
                continue
            p50a = _fmt_val(sa["p50"]) if sa else "-"
            p50b = _fmt_val(sb["p50"]) if sb else "-"
            changed.append((key, "count %+d (%d -> %d), p50 %s -> %s"
                            % (cb - ca, ca, cb, p50a, p50b)))
        else:
            va = sa["value"] if sa else 0
            vb = sb["value"] if sb else 0
            if va == vb:
                continue
            if kind == "counter":
                changed.append((key, "%+d (%d -> %d)" % (vb - va, va, vb)))
            else:
                changed.append((key, "%s -> %s" % (_fmt_val(va), _fmt_val(vb))))
    if not changed:
        print("(no differences)")
        return 0
    width = max(len(k) for k, _ in changed)
    for key, detail in changed:
        print("%-*s  %s" % (width, key, detail))
    return 0


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(prog="python -m repro_torch.obs",
                                     description=__doc__.split("\n", 1)[0])
    sub = parser.add_subparsers(dest="cmd", required=True)
    p_show = sub.add_parser("show", help="pretty-print a metrics snapshot")
    p_show.add_argument("path")
    p_diff = sub.add_parser("diff", help="diff two metrics snapshots")
    p_diff.add_argument("path_a")
    p_diff.add_argument("path_b")
    args = parser.parse_args(argv)
    if args.cmd == "show":
        return _show(args.path)
    return _diff(args.path_a, args.path_b)


if __name__ == "__main__":
    sys.exit(main())
