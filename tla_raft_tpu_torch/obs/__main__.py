"""CLI: ``python -m tla_raft_tpu_torch.obs`` — telemetry reporting tools
(the port's copy of ``tla_raft_tpu/obs/__main__.py``).

    python -m tla_raft_tpu_torch.obs report RUN_DIR [BASELINE_RUN_DIR] [--json]
    python -m tla_raft_tpu_torch.obs trace  RUN_DIR [-o OUT.json]
    python -m tla_raft_tpu_torch.obs metrics ROOT

``report`` renders a per-level table (wall, new states, launches, read
waits, grows) from a run directory's ``events.jsonl``; with a second run
dir it prints the two runs side by side with per-level and total deltas
(the overhead/regression A/B view).  ``trace`` exports the Chrome
trace-event JSON timeline (load it in https://ui.perfetto.dev), merging
any ``--profile`` capture (the profiler's host lanes and the card's
kernels) beside the host lanes.  ``metrics`` pretty-prints a service
root's ``metrics.json``.  (The reference's ``trend`` reads the JAX
package's benchmark series; the port's comes with its benchmark.)

Runs missing optional event kinds (no superstep windows at
``--superstep 1``, no tier events on untiered runs, no capture without
``--profile``) degrade to blank columns/absent tracks — never an error.
"""

from __future__ import annotations

import argparse
import json
import os
import sys

from . import metrics as obs_metrics
from . import tracefile
from .telemetry import EVENTS_NAME, read_events


def _events_path(run_dir: str) -> str:
    return (
        run_dir if run_dir.endswith(".jsonl")
        else os.path.join(run_dir, EVENTS_NAME)
    )


def summarize_events(events: list[dict]) -> dict:
    """Per-level table + run totals from a raw event stream (the
    post-hoc twin of TelemetryHub.snapshot, for ``report``)."""
    levels: list[dict] = []
    cur = dict(dispatches=0, fetches=0, fetch_wait_s=0.0, grows=0,
               redos=0, checkpoint_s=0.0, tier_wait_s=0.0)
    boundary = 0.0
    totals = dict(
        events=len(events), levels=0, dispatches=0, fetches=0,
        fetch_wait_s=0.0, compiles=0, compile_s=0.0, checkpoints=0,
        checkpoint_s=0.0, grows=0, redos=0, supersteps=0,
        superstep_levels=0, watchdog_trips=0, wall_s=0.0,
        distinct=0, generated=0,
        # optional-kind columns: stay zero on runs without the
        # subsystem (untiered, --superstep 1, no --profile) and the
        # renderers blank them out rather than erroring
        tier_demotions=0, tier_probes=0, tier_wait_s=0.0,
        programs_profiled=0, pre_oom_forecasts=0,
        lock_waits=0, lock_wait_s=0.0,
    )
    locks: dict[str, dict] = {}
    for doc in events:
        try:
            t = float(doc.get("t", 0.0))
        except (TypeError, ValueError):
            t = 0.0
        k = doc.get("ev")
        totals["wall_s"] = max(totals["wall_s"], t)
        if k == "run_begin":
            boundary = t
        elif k == "dispatch":
            cur["dispatches"] += 1
            totals["dispatches"] += 1
        elif k == "fetch":
            cur["fetches"] += 1
            totals["fetches"] += 1
            cur["fetch_wait_s"] += float(doc.get("s") or 0.0)
            totals["fetch_wait_s"] += float(doc.get("s") or 0.0)
        elif k == "grow":
            cur["grows"] += 1
            totals["grows"] += 1
        elif k == "redo":
            cur["redos"] += 1
            totals["redos"] += 1
        elif k == "compile":
            totals["compiles"] += 1
            totals["compile_s"] += float(doc.get("s") or 0.0)
        elif k == "checkpoint":
            totals["checkpoints"] += 1
            cur["checkpoint_s"] += float(doc.get("s") or 0.0)
            totals["checkpoint_s"] += float(doc.get("s") or 0.0)
        elif k == "superstep_commit":
            totals["supersteps"] += 1
            totals["superstep_levels"] += int(doc.get("levels") or 0)
        elif k == "watchdog_trip":
            totals["watchdog_trips"] += 1
        elif k == "tier_demote":
            totals["tier_demotions"] += 1
            cur["tier_wait_s"] += float(doc.get("s") or 0.0)
            totals["tier_wait_s"] += float(doc.get("s") or 0.0)
        elif k == "tier_probe":
            totals["tier_probes"] += 1
            cur["tier_wait_s"] += float(doc.get("s") or 0.0)
            totals["tier_wait_s"] += float(doc.get("s") or 0.0)
        elif k == "program_profile":
            totals["programs_profiled"] += 1
        elif k == "lock_held":
            locks[str(doc.get("name"))] = dict(
                n=int(doc.get("n") or 0),
                wait_s=float(doc.get("wait_s") or 0.0),
                held_s=float(doc.get("held_s") or 0.0),
                max_wait_s=float(doc.get("max_wait_s") or 0.0),
                max_held_s=float(doc.get("max_held_s") or 0.0),
            )
        elif k == "lock_wait":
            totals["lock_waits"] += 1
            totals["lock_wait_s"] += float(doc.get("wait_s") or 0.0)
        elif k == "pre_oom_forecast":
            totals["pre_oom_forecasts"] += 1
        elif k == "level_commit":
            levels.append(dict(
                level=int(doc.get("level") or 0),
                seconds=round(t - boundary, 4),
                n_new=int(doc.get("n_new") or 0),
                **{kk: (round(v, 4) if isinstance(v, float) else v)
                   for kk, v in cur.items()},
            ))
            totals["levels"] += 1
            totals["distinct"] = int(doc.get("distinct") or 0)
            totals["generated"] = int(doc.get("generated") or 0)
            boundary = t
            cur = dict(dispatches=0, fetches=0, fetch_wait_s=0.0,
                       grows=0, redos=0, checkpoint_s=0.0,
                       tier_wait_s=0.0)
    for k in ("fetch_wait_s", "compile_s", "checkpoint_s", "wall_s",
              "tier_wait_s", "lock_wait_s"):
        totals[k] = round(totals[k], 4)
    rep = dict(levels=levels, totals=totals)
    if locks:
        rep["locks"] = locks
    return rep


def _print_table(tag: str, rep: dict, out) -> None:
    t = rep["totals"]
    # optional-subsystem columns degrade to blank, never error: a
    # --superstep 1 run has no windows, an untiered run no tier waits
    tiered = bool(t.get("tier_demotions") or t.get("tier_probes"))
    print(f"== {tag}: {t['levels']} levels, {t['distinct']:,} distinct, "
          f"wall {t['wall_s']:.2f}s ==", file=out)
    print(f"{'lvl':>4} {'new':>10} {'sec':>9} {'disp':>5} "
          f"{'fetch':>5} {'wait_s':>8} {'grow':>4} {'redo':>4}"
          + (f" {'tier_s':>8}" if tiered else ""),
          file=out)
    for lv in rep["levels"]:
        tier_col = (
            f" {lv.get('tier_wait_s', 0.0):>8.3f}" if tiered else ""
        )
        print(
            f"{lv['level']:>4} {lv['n_new']:>10,} {lv['seconds']:>9.3f} "
            f"{lv['dispatches']:>5} {lv['fetches']:>5} "
            f"{lv['fetch_wait_s']:>8.3f} {lv['grows']:>4} "
            f"{lv['redos']:>4}" + tier_col,
            file=out,
        )
    print(
        f"totals: {t['dispatches']} dispatches "
        f"({t['levels'] / max(t['dispatches'], 1):.2f} levels/dispatch), "
        f"{t['fetches']} fetches ({t['fetch_wait_s']:.3f}s wait), "
        f"{t['compiles']} compiles ({t['compile_s']:.1f}s), "
        f"{t['checkpoints']} checkpoints ({t['checkpoint_s']:.3f}s), "
        f"{t['grows']} grows / {t['redos']} redos, "
        f"{t['supersteps']} supersteps / {t['superstep_levels']} levels",
        file=out,
    )
    extras = []
    if tiered:
        extras.append(
            f"tiered: {t.get('tier_demotions', 0)} demotions, "
            f"{t.get('tier_probes', 0)} probes "
            f"({t.get('tier_wait_s', 0.0):.3f}s wait)"
        )
    if t.get("programs_profiled"):
        extras.append(
            f"device cost: {t['programs_profiled']} program profiles"
        )
    if t.get("pre_oom_forecasts"):
        extras.append(
            f"PRE-OOM forecasts: {t['pre_oom_forecasts']}"
        )
    if t.get("lock_waits"):
        extras.append(
            f"lock contention: {t['lock_waits']} slow acquire(s) "
            f"({t.get('lock_wait_s', 0.0):.3f}s blocked)"
        )
    if extras:
        print("        " + "; ".join(extras), file=out)
    # GRAFT_TSAN lock profile: one row per instrumented lock, worst
    # offenders (by total hold) first
    if rep.get("locks"):
        print(f"{'lock':<36} {'acq':>7} {'wait_s':>9} {'max_w':>8} "
              f"{'held_s':>9} {'max_h':>8}", file=out)
        rows = sorted(
            rep["locks"].items(), key=lambda kv: -kv[1]["held_s"]
        )
        for name, st in rows:
            print(
                f"{name:<36} {st['n']:>7} {st['wait_s']:>9.4f} "
                f"{st['max_wait_s']:>8.4f} {st['held_s']:>9.4f} "
                f"{st['max_held_s']:>8.4f}",
                file=out,
            )


def _cmd_report(args) -> int:
    events, dropped = read_events(_events_path(args.run_dir))
    if not events:
        print(f"{args.run_dir}: no readable events", file=sys.stderr)
        return 2
    rep = summarize_events(events)
    if dropped:
        rep["totals"]["torn_lines"] = dropped
    if args.baseline:
        bev, bdropped = read_events(_events_path(args.baseline))
        if not bev:
            print(f"{args.baseline}: no readable events",
                  file=sys.stderr)
            return 2
        brep = summarize_events(bev)
        if args.json:
            print(json.dumps(dict(run=rep, baseline=brep)))
            return 0
        _print_table(args.run_dir, rep, sys.stdout)
        print()
        _print_table(args.baseline, brep, sys.stdout)
        print()
        aw, bw = rep["totals"]["wall_s"], brep["totals"]["wall_s"]
        print("== compare (run vs baseline) ==")
        print(f"wall: {aw:.2f}s vs {bw:.2f}s "
              f"({100 * (aw - bw) / max(bw, 1e-9):+.2f}%)")
        n = min(len(rep["levels"]), len(brep["levels"]))
        for la, lb in zip(rep["levels"][:n], brep["levels"][:n]):
            ds = la["seconds"] - lb["seconds"]
            print(
                f"  level {la['level']:>3}: {la['seconds']:>8.3f}s vs "
                f"{lb['seconds']:>8.3f}s ({ds:+.3f}s), "
                f"disp {la['dispatches']} vs {lb['dispatches']}"
            )
        return 0
    if args.json:
        print(json.dumps(rep))
    else:
        _print_table(args.run_dir, rep, sys.stdout)
        if dropped:
            print(f"(torn tail: {dropped} undecodable line(s) dropped)")
    return 0


def _cmd_trace(args) -> int:
    src = _events_path(args.run_dir)
    run_dir = (
        args.run_dir if os.path.isdir(args.run_dir)
        else os.path.dirname(args.run_dir) or "."
    )
    out = args.out or os.path.join(run_dir, "trace.json")
    stats = tracefile.export(
        src, out, run_dir=run_dir,
        max_device_events=args.max_device_events,
    )
    if stats["events"] == 0:
        print(f"{src}: no readable events", file=sys.stderr)
        return 2
    print(
        f"wrote {stats['trace_events']} trace events "
        f"(from {stats['events']} run events"
        + (f", {stats['dropped']} torn" if stats["dropped"] else "")
        + (f", {stats['device_events']} device-lane events merged"
           if stats.get("device_events") else "")
        + f") to {stats['out']} — load in https://ui.perfetto.dev"
    )
    if stats.get("device_dropped"):
        print(
            f"(device lanes truncated: {stats['device_dropped']} "
            "shortest slices dropped — raise --max-device-events to "
            "keep them)"
        )
    return 0


def _cmd_metrics(args) -> int:
    doc = obs_metrics.load(args.root)
    if doc is None:
        print(f"{args.root}: no readable metrics.json", file=sys.stderr)
        return 2
    if args.json:
        print(json.dumps(doc))
    else:
        obs_metrics.render(doc)
    return 0


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="tla_raft_tpu_torch.obs")
    sub = p.add_subparsers(dest="cmd", required=True)

    pr = sub.add_parser("report", help="per-level telemetry table")
    pr.add_argument("run_dir",
                    help="run dir holding events.jsonl (or the file)")
    pr.add_argument("baseline", nargs="?", default=None,
                    help="second run dir to compare against")
    pr.add_argument("--json", action="store_true")

    pt = sub.add_parser("trace", help="export Chrome trace JSON")
    pt.add_argument("run_dir")
    pt.add_argument("-o", "--out", default=None)
    pt.add_argument("--max-device-events", type=int,
                    default=tracefile.MAX_DEVICE_EVENTS,
                    help="profiler-lane merge budget (shortest slices "
                         "drop first past it; 0 = unbounded)")

    pm = sub.add_parser("metrics", help="render a service metrics.json")
    pm.add_argument("root")
    pm.add_argument("--json", action="store_true")

    args = p.parse_args(argv)
    if args.cmd == "report":
        return _cmd_report(args)
    if args.cmd == "trace":
        return _cmd_trace(args)
    return _cmd_metrics(args)


if __name__ == "__main__":
    sys.exit(main())
