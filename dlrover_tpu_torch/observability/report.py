"""Post-mortem incident report: a job's fault→recovery anatomy as text,
from a journal dump or a flight-recorder bundle.

    python -m dlrover_tpu_torch.observability.report <journal.json|bundle dir>

The port's copy of ``dlrover_tpu/observability/report.py``, whole, and its
text is the reference's for the same input. It takes the master's
``GET /events`` payload saved to a file (``EventJournal.to_json()``) or a
bundle directory (``observability/flight_recorder.py``; its
``journal.json`` is read) and prints one incident table (MTTR/MTTD,
winning rung, rollback) and a goodput waterfall (seconds lost per phase,
summed over incidents) — the offline twin of ``GET /incidents``. A bundle
holding ``memory.json`` (``observability/memory.py``) adds the
OOM-forensics section: the category waterfall against its peak
watermarks, the reconciled headroom line and the per-step watermark
table.
"""

import argparse
import json
import os
import sys
from typing import Dict, List, Optional

from dlrover_tpu_torch.observability.incidents import (
    RESOLVED,
    Incident,
    stitch_journal_dict,
)
from dlrover_tpu_torch.observability.journal import Phase


def load_journal(source: str) -> Dict:
    """A journal dict from ``EventJournal.to_json()`` output or a bundle
    directory containing journal.json."""
    path = source
    if os.path.isdir(path):
        path = os.path.join(path, "journal.json")
    with open(path) as f:
        payload = json.load(f)
    if "events" not in payload:
        raise ValueError(
            f"{path} has no 'events' key — not a journal dump")
    return payload


def load_memory(source: str) -> Optional[Dict]:
    """``memory.json`` from a bundle directory; None for plain journal
    dumps and for bundles captured without a memory snapshot."""
    if not os.path.isdir(source):
        return None
    path = os.path.join(source, "memory.json")
    if not os.path.isfile(path):
        return None
    with open(path) as f:
        return json.load(f)


def _fmt(value: Optional[float], suffix: str = "s") -> str:
    return "-" if value is None else f"{value:.2f}{suffix}"


def _fmt_bytes(n: float) -> str:
    n = float(n)
    for unit in ("B", "KiB", "MiB", "GiB"):
        if abs(n) < 1024.0 or unit == "GiB":
            return f"{int(n)}B" if unit == "B" else f"{n:.1f}{unit}"
        n /= 1024.0
    return f"{n:.1f}GiB"


def render_report(incidents: List[Incident], now_t: float) -> str:
    """The incident table + goodput waterfall as one printable string
    (deterministic for a given journal — golden-tested)."""
    lines: List[str] = []
    resolved = sum(1 for i in incidents if i.resolution == RESOLVED)
    lines.append(
        f"incident report: {len(incidents)} incident(s), "
        f"{resolved} resolved, journal window {now_t:.2f}s"
    )
    if not incidents:
        lines.append("no incidents: every journal window second was "
                     "fault-free")
        return "\n".join(lines)
    header = (f"{'id':>4}  {'node':>6}  {'status':<10} {'rung':<8} "
              f"{'mttr':>9} {'mttd':>8} {'rollback':>8} {'recompute':>9} "
              f"resolution")
    lines.append(header)
    lines.append("-" * len(header))
    for inc in incidents:
        rollback = ("-" if inc.rollback_steps is None
                    else str(inc.rollback_steps))
        lines.append(
            f"{inc.incident_id:>4}  {str(inc.node_id):>6}  "
            f"{inc.status:<10} {inc.rung:<8} {_fmt(inc.mttr_s):>9} "
            f"{_fmt(inc.mttd_s):>8} {rollback:>8} "
            f"{_fmt(inc.recompute_s):>9} {inc.resolution}"
        )
        for failed in inc.rungs_failed:
            lines.append(
                f"      rung {failed.get('rung', '?')} aborted: "
                f"{failed.get('reason', '?')}"
            )
        cf = inc.counterfactual
        if cf is not None:
            saved_s = cf.get("goodput_saved_s")
            lines.append(
                "      counterfactual: brain preempt ckpt "
                f"(hit={cf.get('hit')}) saved {cf.get('steps_saved', 0)} "
                f"step(s) vs last periodic"
                + (f" (~{saved_s:.2f}s goodput)" if saved_s else "")
            )
    totals = {phase: 0.0 for phase in Phase.ALL}
    for inc in incidents:
        for phase, seconds in inc.phases.items():
            totals[phase] = totals.get(phase, 0.0) + seconds
    loss = {p: s for p, s in totals.items()
            if p not in (Phase.PRODUCTIVE, Phase.SERVING) and s > 0.0}
    lines.append("")
    lines.append("goodput waterfall (seconds lost per phase, all "
                 "incidents):")
    if not loss:
        lines.append("  (none)")
    else:
        widest = max(loss.values())
        for phase in Phase.ALL:
            seconds = loss.get(phase)
            if seconds is None:
                continue
            bar = "#" * max(1, round(24 * seconds / widest))
            lines.append(f"  {phase:<12} {seconds:>8.2f}  {bar}")
        lines.append(f"  {'total':<12} {sum(loss.values()):>8.2f}")
    return "\n".join(lines)


def render_memory(snap: Dict) -> str:
    """The OOM-forensics section from a bundle's memory.json: category
    waterfall vs peak watermarks, the reconciled headroom line, and the
    per-step watermark table (deterministic — golden-tested)."""
    lines: List[str] = []
    lines.append("device memory (HBM ledger at capture):")
    cats = {str(c): int(b) for c, b in (snap.get("categories") or
                                        {}).items()}
    marks = {str(c): int(b) for c, b in (snap.get("watermarks") or
                                         {}).items()}
    live = [c for c in sorted(cats, key=lambda c: (-cats[c], c))
            if cats[c] or marks.get(c, 0)]
    if not live:
        lines.append("  (ledger empty)")
    else:
        widest = max(cats[c] for c in live) or 1
        for cat in live:
            bar = "#" * max(1, round(24 * cats[cat] / widest)) \
                if cats[cat] else ""
            lines.append(
                f"  {cat:<13} {_fmt_bytes(cats[cat]):>10}  "
                f"(peak {_fmt_bytes(marks.get(cat, 0))})  {bar}".rstrip()
            )
    rec = snap.get("reconcile") or {}
    if rec.get("limit_bytes"):
        frac = float(rec.get("headroom_frac", 1.0))
        lines.append(
            f"  limit {_fmt_bytes(rec['limit_bytes'])}, "
            f"headroom {_fmt_bytes(rec.get('headroom_bytes', 0))} "
            f"({100.0 * frac:.1f}%), "
            f"unattributed {_fmt_bytes(rec.get('unattributed_bytes', 0))}"
        )
    rows = snap.get("step_watermarks") or []
    if rows:
        cols = [c for c in sorted(
            {c for row in rows for c in row if c != "step"})
            if any(int(row.get(c, 0)) for row in rows)]
        lines.append("")
        lines.append(f"step watermarks (last {len(rows)} step(s)):")
        header = f"  {'step':>6}  " + "  ".join(f"{c:>12}" for c in cols)
        lines.append(header)
        for row in rows:
            lines.append(
                f"  {int(row.get('step', 0)):>6}  "
                + "  ".join(f"{_fmt_bytes(int(row.get(c, 0))):>12}"
                            for c in cols)
            )
    return "\n".join(lines)


def main(argv: Optional[List[str]] = None) -> int:
    parser = argparse.ArgumentParser(
        prog="python -m dlrover_tpu_torch.observability.report",
        description="Render incident forensics from a journal dump or "
                    "flight-recorder bundle.",
    )
    parser.add_argument("source",
                        help="journal.json path or bundle directory")
    parser.add_argument(
        "--step-time-s", type=float, default=None,
        help="seconds per training step, for rollback→recompute and "
             "counterfactual goodput conversion (offline journals carry "
             "no live EWMA)",
    )
    args = parser.parse_args(argv)
    try:
        journal = load_journal(args.source)
    except (OSError, ValueError, json.JSONDecodeError) as e:
        print(f"error: {e}", file=sys.stderr)
        return 2
    incidents = stitch_journal_dict(journal,
                                    step_time_s=args.step_time_s)
    print(render_report(incidents,
                        float(journal.get("now_t", 0.0))))
    try:
        memory = load_memory(args.source)
    except (OSError, ValueError, json.JSONDecodeError) as e:
        print(f"error: memory.json unreadable: {e}", file=sys.stderr)
        return 2
    if memory is not None:
        print()
        print(render_memory(memory))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
