"""Telemetry stream reporter:
``python -m repro_torch.obs.report run.jsonl``.

Reads one schema-v1 JSONL stream (validating every line) and prints the
story a human needs from a training run:

* throughput — steps, wall time, steps/s from the device-step spans;
* where the time went — per-span-name totals/means and share of wall,
  with the queue-dry (device-stall) time called out;
* cache behavior over time — per-window feature/topology hit rates and
  local/peer/PCIe byte deltas from the snapshots;
* refresh activity — online cache-manager counters, when present.

``--json`` emits the same digest as machine-readable JSON (what the
tests and CI consume); a nonzero exit means the stream failed schema
validation.
"""
from __future__ import annotations

import argparse
import json
import sys
from typing import Dict, List

from repro_torch.obs.metrics import quantile_from_counts
from repro_torch.obs.schema import TelemetrySchemaError, validate_line


def load_stream(path: str) -> List[dict]:
    lines = []
    with open(path) as f:
        for i, raw in enumerate(f):
            raw = raw.strip()
            if not raw:
                continue
            try:
                obj = json.loads(raw)
            except json.JSONDecodeError as e:
                raise TelemetrySchemaError(
                    f"{path}:{i + 1}: not JSON ({e})") from e
            try:
                validate_line(obj)
            except TelemetrySchemaError as e:
                raise TelemetrySchemaError(f"{path}:{i + 1}: {e}") from e
            lines.append(obj)
    if not lines or lines[0]["kind"] != "meta":
        raise TelemetrySchemaError(
            f"{path}: stream must start with a meta line")
    return lines


def digest(lines: List[dict]) -> dict:
    """Fold a validated stream into the report's numbers."""
    meta = lines[0]
    spans = [ln for ln in lines if ln["kind"] == "span"]
    snaps = [ln for ln in lines if ln["kind"] == "snapshot"]

    by_name: Dict[str, dict] = {}
    for s in spans:
        agg = by_name.setdefault(s["name"], {"count": 0, "total_s": 0.0,
                                             "max_s": 0.0})
        agg["count"] += 1
        agg["total_s"] += s["dur_us"] / 1e6
        agg["max_s"] = max(agg["max_s"], s["dur_us"] / 1e6)
    for agg in by_name.values():
        agg["mean_s"] = agg["total_s"] / max(agg["count"], 1)

    steps = [s for s in spans if s["name"] == "device_step"]
    wall_s = 0.0
    if spans:
        t_lo = min(s["ts_us"] for s in spans)
        t_hi = max(s["ts_us"] + s["dur_us"] for s in spans)
        wall_s = (t_hi - t_lo) / 1e6
    loop = by_name.get("train_loop", {})
    loop_s = loop.get("total_s", wall_s)

    final_counters: Dict[str, float] = {}
    windows = []
    for sn in snaps:
        for key, c in sn["counters"].items():
            final_counters[key] = c["total"]
        cs = sn["counters"]

        def delta(key, cs=cs):
            return cs.get(key, {"delta": 0})["delta"]

        freq, fhit = delta("traffic.feature_requests"), \
            delta("traffic.feature_hits")
        treq, thit = delta("traffic.topo_requests"), \
            delta("traffic.topo_hits")
        windows.append({
            "step": sn["step"], "from_step": sn["from_step"],
            "feat_hit_rate": fhit / freq if freq else None,
            "topo_hit_rate": thit / treq if treq else None,
            "local_bytes": delta("traffic.feat_bytes{tier=local}"),
            "peer_bytes": delta("traffic.feat_bytes{tier=peer}"),
            "pcie_bytes": delta("traffic.feat_bytes{tier=pcie}"),
            "host_sample_syncs": delta("traffic.host_sample_syncs"),
        })

    # every histogram in the final snapshot (cumulative counts), digested
    # to p50/p99 by linear interpolation within the fixed buckets — the
    # human-readable form of the latency/step-time/build-time tracks
    histograms: Dict[str, dict] = {}
    if snaps:
        for key, h in snaps[-1].get("hists", {}).items():
            count = h.get("count", sum(h["counts"]))
            histograms[key] = {
                "count": count,
                "sum": h.get("sum", 0.0),
                "mean": (h.get("sum", 0.0) / count) if count else None,
                "p50": quantile_from_counts(h["edges"], h["counts"], 0.50),
                "p99": quantile_from_counts(h["edges"], h["counts"], 0.99),
            }

    dry_s = final_counters.get("prefetch.queue_dry_s", 0.0)
    refresh = {k.split(".", 1)[1]: v for k, v in final_counters.items()
               if k.startswith("refresh.")}
    straggler = {k.split(".", 1)[1]: v for k, v in final_counters.items()
                 if k.startswith("straggler.")}
    resilience = {k: v for k, v in final_counters.items()
                  if k.startswith(("fault.", "recovery.", "checkpoint."))}
    return {
        "run": meta["run"], "window": meta["window"],
        "device_steps": len(steps),
        "device_step_s": sum(s["dur_us"] for s in steps) / 1e6,
        "steps_per_s": (len(steps) / loop_s if loop_s > 0 and steps
                        else None),
        "wall_s": wall_s, "train_loop_s": loop_s,
        "queue_dry_s": dry_s,
        "spans": by_name, "windows": windows, "histograms": histograms,
        "final_counters": final_counters, "refresh": refresh,
        "straggler": straggler, "resilience": resilience,
        "n_spans": len(spans), "n_snapshots": len(snaps),
    }


def _fmt_rate(r) -> str:
    return "   --" if r is None else f"{100 * r:5.1f}"


def _fmt_mb(b) -> str:
    return f"{b / 1e6:10.3f}"


def print_report(d: dict, out=None) -> None:
    # resolve stdout at call time, not def time, so redirection works
    w = (sys.stdout if out is None else out).write
    w(f"telemetry run {d['run']!r}: {d['n_spans']} spans, "
      f"{d['n_snapshots']} snapshots (window={d['window']} steps)\n\n")
    if d["device_steps"]:
        sps = d["steps_per_s"]
        w(f"throughput: {d['device_steps']} device steps in "
          f"{d['train_loop_s']:.3f} s"
          + (f" -> {sps:.2f} steps/s\n" if sps else "\n"))
        stall_pct = 100 * d["queue_dry_s"] / max(d["train_loop_s"], 1e-9)
        w(f"stall: queue-dry (device waiting on host) "
          f"{d['queue_dry_s']:.3f} s = {stall_pct:.1f}% of the loop\n\n")
    w("where the time went (per span name):\n")
    w(f"  {'span':<18}{'count':>7}{'total s':>10}{'mean ms':>10}"
      f"{'max ms':>10}{'% wall':>8}\n")
    for name, a in sorted(d["spans"].items(),
                          key=lambda kv: -kv[1]["total_s"]):
        pct = 100 * a["total_s"] / max(d["wall_s"], 1e-9)
        w(f"  {name:<18}{a['count']:>7}{a['total_s']:>10.3f}"
          f"{1e3 * a['mean_s']:>10.3f}{1e3 * a['max_s']:>10.3f}"
          f"{pct:>8.1f}\n")
    if d["windows"]:
        w("\ncache/traffic windows (hit %, byte deltas):\n")
        w(f"  {'steps':<12}{'feat%':>6}{'topo%':>6}{'local MB':>11}"
          f"{'peer MB':>11}{'pcie MB':>11}{'host syncs':>11}\n")
        for win in d["windows"]:
            rng = f"{win['from_step']}-{win['step']}"
            w(f"  {rng:<12}{_fmt_rate(win['feat_hit_rate'])}"
              f"{_fmt_rate(win['topo_hit_rate'])}"
              f"{_fmt_mb(win['local_bytes'])}{_fmt_mb(win['peer_bytes'])}"
              f"{_fmt_mb(win['pcie_bytes'])}"
              f"{win['host_sample_syncs']:>11}\n")
    if d.get("histograms"):
        w("\nhistograms (interpolated quantiles):\n")
        w(f"  {'histogram':<26}{'count':>8}{'mean ms':>10}{'p50 ms':>10}"
          f"{'p99 ms':>10}\n")
        for name, h in sorted(d["histograms"].items()):
            def ms(v):
                return "      --" if v is None else f"{1e3 * v:8.3f}"
            w(f"  {name:<26}{h['count']:>8}{ms(h['mean']):>10}"
              f"{ms(h['p50']):>10}{ms(h['p99']):>10}\n")
    if d["refresh"]:
        w("\nonline cache refresh: "
          + ", ".join(f"{k}={v:g}" for k, v in sorted(d["refresh"].items()))
          + "\n")
    if d.get("straggler"):
        w("stragglers: "
          + ", ".join(f"{k}={v:g}"
                      for k, v in sorted(d["straggler"].items()))
          + "\n")
    if d.get("resilience"):
        w("faults/recovery: "
          + ", ".join(f"{k}={v:g}"
                      for k, v in sorted(d["resilience"].items()))
          + "\n")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.obs.report",
        description="Summarize a repro_torch telemetry JSONL stream.")
    ap.add_argument("jsonl", help="telemetry stream written by "
                                  "train_gnn(telemetry=...)")
    ap.add_argument("--json", action="store_true",
                    help="emit the digest as JSON instead of the report")
    args = ap.parse_args(argv)
    try:
        lines = load_stream(args.jsonl)
    except (TelemetrySchemaError, OSError) as e:
        print(f"error: {e}", file=sys.stderr)
        return 1
    d = digest(lines)
    if args.json:
        json.dump(d, sys.stdout, indent=2, sort_keys=True)
        sys.stdout.write("\n")
    else:
        print_report(d)
    return 0


if __name__ == "__main__":
    sys.exit(main())
