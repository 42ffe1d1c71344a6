"""CLI: ``python -m tla_raft_tpu_torch.check`` — the port's checker.

Runs the BFS check of the Raft spec (engine/bfs.py) and prints the same
TLC-shaped lines as the JAX package's ``tla_raft_tpu.check``: per-level
progress, the verdict (with the counterexample trace on a violation), the
state counts and, with ``--json``, one summary line with the keys
distinct, generated, depth, level_sizes and violation.  The constants come
from TLC's ``Raft.cfg`` (``--config``, the reference's entry, as in
``myrun.sh``; the spec file beside it is validated against the compiled
semantics), or without one from the Raft.cfg defaults; ``--servers``,
``--vals``, ``--max-election`` and ``--max-restart`` override either.

    python -m tla_raft_tpu_torch.check --config Raft.cfg --log raft.log   # the launcher's line
    python -m tla_raft_tpu_torch.check --config Raft.cfg --max-depth 20 --json
    python -m tla_raft_tpu_torch.check --max-depth 12 --json          # on the card
    python -m tla_raft_tpu_torch.check --servers 2 --vals 1 \\
        --max-election 1 --max-restart 1 --device cpu                # plain torch
    python -m tla_raft_tpu_torch.check --max-depth 22 --dev-bytes 64e6  # tiered store
    python -m tla_raft_tpu_torch.check --servers 5 --max-depth 16     # 5 servers
    python -m tla_raft_tpu_torch.check --servers 7 --max-depth 9      # 7 servers
    python -m tla_raft_tpu_torch.check --max-depth 23 --canon expand  # delta-hash fingerprints
    python -m tla_raft_tpu_torch.check --max-depth 22 --no-mxu-expand # legacy per-lane kernels
    python -m tla_raft_tpu_torch.check --max-depth 20 --audit 64      # sampled re-expansion
    python -m tla_raft_tpu_torch.check --max-depth 25 --no-hashstore  # the sorted visited store

    python -m tla_raft_tpu_torch.check --max-depth 22 --checkpoint-dir ck  # delta log
    python -m tla_raft_tpu_torch.check --max-depth 22 --checkpoint-dir ck --recover ck
    python -m tla_raft_tpu_torch.check --max-depth 26 --fpstore-dir fps    # external store
    python -m tla_raft_tpu_torch.check --mesh 8 --device cpu --servers 2 --vals 1 \
        --max-election 1 --max-restart 1                              # an 8-shard CPU mesh
    python -m tla_raft_tpu_torch.check --mesh 1 --max-depth 16 --json  # a 1-GPU mesh
    python -m tla_raft_tpu_torch.check --mesh 8 --device cpu --mesh-deep --fpstore-dir fps \
        --seg-rows 128 --cap-x 512 --max-depth 8                      # the sharded deep sweep
    python -m tla_raft_tpu_torch.check --max-depth 20 --checkpoint-dir run --progress \
        --profile 2 --json                      # the run record: run/events.jsonl, run/profile/
    python -m tla_raft_tpu_torch.obs report run; python -m tla_raft_tpu_torch.obs trace run

Everything the run prints goes to stdout and to ``--log`` (default
``raft.log``, ``-`` for none), as the reference tees it (check.py:40,
:984).  The flight recorder (obs/telemetry.py) is on unless ``--telemetry
0`` or ``TLA_RAFT_TELEMETRY=0``: its events land in the checkpoint
directory's ``events.jsonl`` (or ``TLA_RAFT_TELEMETRY_DIR``'s; in memory
without either), its aggregates in the ``--json`` line's ``telemetry``
block.  ``--workers N`` is accepted and ignored, as the reference does for
``myrun.sh``.

Exit code 0 when no error was found, 1 on a violation, 2 when the spec
beside the cfg differs from the compiled semantics (or on --dev-bytes with
--checkpoint-dir and no --fpstore-dir, on a TLA_RAFT_DEV_BYTES /
TLA_RAFT_FSEG_BYTES setting the port does not run, on --mesh-deep without
--mesh or without --fpstore-dir, on --mesh with --checkpoint-dir,
--recover, --audit, --prewarm 1 or, under all_to_all without --fpstore-dir,
--no-hashstore, and on --mesh N past the visible GPUs), 4 on an integrity
fail-stop, 75 on a preemption
(SIGTERM/SIGINT: the run stops at a level boundary, resumable with
--recover) — the reference's, check.py:1015-1275.
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import json
import os
import sys
import time

from .config import MSG_TYPE_NAMES, ROLE_NAMES, RaftConfig

MUTATIONS = ("median-bug", "double-vote", "legacy-append", "become-follower")


class Tee:
    """Write to every stream (stdout and the ``--log`` file; check.py:40)."""

    def __init__(self, *streams):
        self.streams = streams

    def write(self, s):
        for st in self.streams:
            st.write(s)

    def flush(self):
        for st in self.streams:
            st.flush()


def format_state(cfg: RaftConfig, st) -> str:
    """Pretty-print one OState, TLA-style (the reference's format)."""

    def server_fn(vals, fmt=str):
        return "[" + ", ".join(f"s{i + 1} |-> {fmt(v)}" for i, v in enumerate(vals)) + "]"

    def fmt_vote(v):
        return f"s{v}" if v else "None"

    def fmt_log(log):
        return "<<" + ", ".join(
            f"[term |-> {t}, val |-> {'v%d' % v if v else 'None'}]" for t, v in log) + ">>"

    def fmt_row(r):
        return "[" + ", ".join(f"s{j + 1} |-> {x}" for j, x in enumerate(r)) + "]"

    def fmt_msg(m):
        t = MSG_TYPE_NAMES[m[0]]
        if m[0] == 0:
            return (f"[type |-> {t}, src |-> s{m[1]}, dst |-> s{m[2]}, term |-> {m[3]}, "
                    f"lastLogIndex |-> {m[4]}, lastLogTerm |-> {m[5]}]")
        if m[0] == 1:
            return f"[type |-> {t}, src |-> s{m[1]}, dst |-> s{m[2]}, term |-> {m[3]}]"
        if m[0] == 2:
            ent = ", ".join(f"[term |-> {et}, val |-> v{ev}]" for et, ev in m[6])
            return (f"[type |-> {t}, src |-> s{m[1]}, dst |-> s{m[2]}, term |-> {m[3]}, "
                    f"prevLogIndex |-> {m[4]}, prevLogTerm |-> {m[5]}, "
                    f"entries |-> <<{ent}>>, leaderCommit |-> {m[7]}]")
        return (f"[type |-> {t}, src |-> s{m[1]}, dst |-> s{m[2]}, term |-> {m[3]}, "
                f"prevLogIndex |-> {m[4]}, succ |-> {'TRUE' if m[5] else 'FALSE'}]")

    lines = [
        f"/\\ votedFor = {server_fn(st.voted_for, fmt_vote)}",
        f"/\\ currentTerm = {server_fn(st.current_term)}",
        f"/\\ role = {server_fn(st.role, lambda r: ROLE_NAMES[r])}",
        f"/\\ logs = {server_fn(st.logs, fmt_log)}",
        f"/\\ matchIndex = {server_fn(st.match_index, fmt_row)}",
        f"/\\ nextIndex = {server_fn(st.next_index, fmt_row)}",
        f"/\\ commitIndex = {server_fn(st.commit_index)}",
        "/\\ msgs = {" + ",\n            ".join(fmt_msg(m) for m in sorted(st.msgs)) + "}",
        f"/\\ electionCount = {st.election_count}",
        f"/\\ restartCount = {st.restart_count}",
        "/\\ valSent = [" + ", ".join(
            f"v{i + 1} |-> {'None' if v == 0 else 'FALSE'}" for i, v in enumerate(st.val_sent)
        ) + "]",
    ]
    return "\n".join(lines)


def trace_doc(cfg: RaftConfig, trace) -> list[dict]:
    """Serializable counterexample trace (the reference's check.py:99): one
    ``{action, state}`` dict per step, states rendered as ``print_trace``
    shows them, so the sweep service's ``result.json`` trace block is
    byte-equal to what the CLI prints for the same run."""
    return [dict(action="Initial predicate" if action == "Init" else action,
                 state=format_state(cfg, st)) for action, st in trace]


def print_trace(cfg: RaftConfig, trace, out) -> None:
    print("The behavior up to this point is:", file=out)
    for i, step in enumerate(trace_doc(cfg, trace)):
        print(f"\nSTATE {i + 1}: <{step['action']}>", file=out)
        print(step["state"], file=out)


def _report_preempted(e, out) -> int:
    """Preemption is a resumable outcome, not an error: say where the
    durable state sits and exit 75 (EX_TEMPFAIL; check.py:122)."""
    print(f"Preempted: {e}.", file=out)
    if e.checkpoint_dir:
        print(f"Resume with --recover {e.checkpoint_dir}", file=out)
    return 75


def _telemetry_blocks(out: dict, hub) -> dict:
    """The hub's ``telemetry`` block, and its ``hbm`` gauge at the top level
    beside the counts it prices (check.py:298-310)."""
    if hub is not None:
        tel = hub.snapshot()
        if "straggler" in out:
            tel["straggler"] = out["straggler"]
        out["telemetry"] = tel
        if "hbm" in tel:
            out["hbm"] = tel["hbm"]
    return out


def summarize(res, seconds: float, chk, hub=None) -> dict:
    """CheckResult -> the ``--json`` summary (the reference's keys:
    check.py:236-310), plus the levels each route committed, the grouped
    levels' records and, once the tiered store demoted or probed, its
    stats; with a telemetry hub its ``telemetry`` and ``hbm`` blocks."""
    out = dict(
        ok=res.ok,
        distinct=res.distinct,
        generated=res.generated,
        depth=res.depth,
        level_sizes=list(res.level_sizes),
        mxu=chk.use_mxu,
        canon=chk.canon,
        megakernel=chk.megakernel,
        superstep=chk.superstep_span,
        seconds=round(seconds, 3),
        violation=res.violation[0] if res.violation else None,
        device=str(chk.device),
        routes=dict(chk.routes),
        hashstore=chk.use_hashstore,
        pipeline=chk.pipeline,
        pipeline_window=chk.pipeline_window if chk.pipeline else 0,
        prewarm=chk.prewarm,
        presize=chk.presize,
    )
    if chk.degraded_at is not None:
        out["degraded_at"] = chk.degraded_at
    if chk.audit_stats.get("levels"):
        out["audit"] = dict(chk.audit_stats)
    if chk._ss_stats["supersteps"]:
        out["superstep_stats"] = {k: int(v) for k, v in sorted(chk._ss_stats.items())}
    if chk.group_log:
        out["grouped"] = dict(levels=len(chk.group_log), cap_g=chk.cap_g,
                              lanes=sum(g["lanes"] for g in chk.group_log),
                              ungrouped_lanes=sum(g["ungrouped_lanes"] for g in chk.group_log))
    if chk.host_store is not None:
        st, hs = chk.host_store, chk.host_stats
        out["host_store"] = dict(
            entries=len(st), runs=st.num_runs, bloom_skips=st.bloom_skips,
            mem_budget_entries=st.mem_budget_entries, paged_out=chk.paged_out,
            dev_budget=chk.dev_budget,
            **{k: (round(v, 6) if isinstance(v, float) else v) for k, v in hs.items()
               if k != "level_log"})
        if hs["level_log"]:
            # the last level's attempt that committed: its groups, and those
            # of them loaded from partial records
            out["host_store"]["last_level"] = {
                k: hs["level_log"][-1][k] for k in ("level", "groups", "saved", "graph_groups",
                                                    "new")}
    tiered = chk.tiered
    if tiered is not None and (tiered.stats["demotions"] or tiered.stats["probes"]):
        out["tiered"] = dict(tiered.stats, dev_bytes=tiered.dev_bytes,
                             generations=len(tiered.gens), soft_seats=chk.tier_soft_seats,
                             probe_wait_s=round(tiered.stats["probe_wait_s"], 6))
    return _telemetry_blocks(out, hub)


def summarize_mesh(res, seconds: float, chk, hub=None) -> dict:
    """The ``--json`` summary of a mesh run: the reference's keys for a
    ``ShardedChecker`` (check.py:221-297: no megakernel or superstep, the
    ``straggler`` block once a level ran), plus the shard devices, the
    exchange mode, the final capacities and the reactive grows; for the
    deep sweep its segment rows, the per-device peak frontier rows, the
    sieve's capacity and the exchange's byte ledger (``ExchangeMeter``)."""
    out = dict(
        ok=res.ok, distinct=res.distinct, generated=res.generated, depth=res.depth,
        level_sizes=list(res.level_sizes), mxu=chk.use_mxu, megakernel=None, superstep=None,
        seconds=round(seconds, 3), violation=res.violation[0] if res.violation else None,
        device=str(chk.devices[0]), mesh=chk.D, exchange=chk.exchange, cap_x=chk.cap_x,
        cap_w=chk.cap_w, vcap=chk.vcap if chk.use_hashstore else None,
        reactive_grows=chk.reactive_grows,
        exchange_copies=sum(lv["exchange_copies"] for lv in chk.level_log),
    )
    if chk.deep:
        out.update(vcap=None, deep=True, seg_rows=chk.seg_rows, peak_dev_rows=chk.peak_dev_rows,
                   scap=chk.scap, sieve=chk.sieve, compress=chk.compress,
                   exchange_ledger=chk.meter.summary())
    if chk.host_stores is not None:
        out["host_store"] = dict(entries=[len(s) for s in chk.host_stores],
                                 runs=sum(s.num_runs for s in chk.host_stores))
        if not chk.deep:
            out["host_store"]["host_filter_s"] = round(chk.host_seconds, 6)
    if chk.skew.levels:
        out["straggler"] = chk.skew.summary()
    return _telemetry_blocks(out, hub)


def summary_public(summary: dict) -> dict:
    """The JSON-serializable view of a :func:`run_check` summary
    (check.py:311): the ``_res`` / ``_chk`` / ``_hub`` keys stripped."""
    return {k: v for k, v in summary.items() if not k.startswith("_")}


def run_check(cfg: RaftConfig, *, max_depth: int | None = None, chunk: int | None = None,
              checkpoint_dir: str | None = None, checkpoint_every: int = 1,
              recover: str | None = None, device=None, canon: str = "late",
              use_hashstore: bool | None = None, use_mxu: bool | None = None,
              megakernel: bool | None = None, superstep: int | None = None, audit: int = 0,
              audit_retries: int = 3, dev_bytes: int | None = None, progress=None, out=None,
              install_signals: bool = False, config_path: str | None = None,
              fpstore_dir: str | None = None, warm_bytes: int | None = None, mesh: int = 0,
              exchange: str = "all_to_all", cap_x: int = 4096, mesh_deep: bool = False,
              seg_rows: int = 1 << 15, sieve: bool = True, compress: bool = True,
              pipeline: bool | None = None, pipeline_window: int | None = None,
              prewarm: bool | None = None, telemetry: bool | None = None,
              profile: int = 0) -> dict:
    """One in-process check -> the ``--json`` summary dict (check.py:316):
    the programmatic entry the sweep service and the tests call.  ``out``
    (a stream, or None) receives the CLI's informational lines, ``progress``
    is the per-level callback.  Raises ``resilience.Preempted`` on a
    preemption (the CLI's exit 75) and propagates engine errors; the
    ``_res`` / ``_chk`` keys carry the raw result and checker
    (``summary_public`` strips them).  ``config_path`` names the cfg file
    the constants came from in the ``Config`` line.  ``fpstore_dir`` puts
    the visited set in the native external store there (check.py:664-680),
    its RAM buffer ``warm_bytes // 8`` fingerprints (``TLA_RAFT_WARM_BYTES``
    when not given; the native 64 MiB default when neither is set); the
    store is cleared unless the run recovers.  ``mesh`` N >= 1 runs the
    ``ShardedChecker`` over N shards (``make_mesh(N, device)``: the first N
    GPUs, or N shards of the CPU) with ``exchange`` and ``cap_x``
    (check.py:686-733); ``fpstore_dir`` then holds one store per owner.
    ``mesh_deep`` runs the sharded deep sweep there (``seg_rows``,
    ``sieve``, ``compress``: check.py:700-757).  ``pipeline`` and
    ``pipeline_window`` set the async pipeline (None: the environment's
    ``TLA_RAFT_PIPELINE`` / ``TLA_RAFT_PIPELINE_WINDOW``), ``prewarm`` the
    single-device engine's forecast prewarm (None: ``TLA_RAFT_PREWARM``,
    else on on the card, off on the CPU); a mesh takes no prewarm.

    ``telemetry`` (None: ``TLA_RAFT_TELEMETRY``, on) installs the
    process-wide flight recorder (obs/telemetry.py) for the run
    (check.py:389-411, :470-476): every level, graph launch, device read,
    capture, checkpoint commit and grow/redo lands in ``<checkpoint_dir>/
    events.jsonl`` (``TLA_RAFT_TELEMETRY_DIR``'s without a checkpoint
    directory; in memory without either), and the summary carries the
    ``telemetry`` block (and ``hbm``) and the hub under ``_hub``.  A hub an
    outer caller installed is used as it is, never re-anchored or closed.
    ``profile`` N > 0 captures the first N dispatch windows with
    ``torch.profiler`` into ``<run dir>/profile/`` (analysis/devprof.py),
    stopped on every exit."""
    with _run_hub(telemetry, cfg, checkpoint_dir=checkpoint_dir, recover=recover, mesh=mesh,
                  mesh_deep=mesh_deep, device=device) as hub:
        from . import resilience
        from .engine.bfs import TorchChecker
        from .obs import telemetry as obs_telemetry

        if install_signals:
            # SIGTERM/SIGINT finish the level, flush, and raise Preempted
            resilience.install_signal_handlers()
        if warm_bytes is None and os.environ.get("TLA_RAFT_WARM_BYTES"):
            warm_bytes = int(float(os.environ["TLA_RAFT_WARM_BYTES"]))
        t0 = time.monotonic()
        if mesh:
            if prewarm:
                raise ValueError(PREWARM_MESH_REFUSAL)
            return _run_mesh(cfg, t0, hub=hub, profile=profile, pipeline=pipeline,
                             pipeline_window=pipeline_window,
                             max_depth=max_depth, chunk=chunk, checkpoint_dir=checkpoint_dir,
                             checkpoint_every=checkpoint_every, recover=recover, device=device,
                             canon=canon, use_hashstore=use_hashstore, use_mxu=use_mxu,
                             progress=progress, out=out, config_path=config_path,
                             fpstore_dir=fpstore_dir, warm_bytes=warm_bytes, mesh=mesh,
                             exchange=exchange, cap_x=cap_x, dev_bytes=dev_bytes,
                             mesh_deep=mesh_deep, seg_rows=seg_rows, sieve=sieve, compress=compress)
        host_store = None
        if fpstore_dir:
            from .native import HostFPStore

            host_store = HostFPStore(
                fpstore_dir, mem_budget_entries=max(warm_bytes // 8, 1) if warm_bytes else 0)
            if not recover:
                # run files a crashed earlier process left behind
                host_store.clear()
        chk = TorchChecker(cfg, device=device, chunk=chunk, progress=progress,
                           megakernel=megakernel, superstep=superstep,
                           store_bytes=int(dev_bytes) if dev_bytes else None, canon=canon,
                           use_mxu=use_mxu, audit=audit, audit_retries=audit_retries,
                           use_hashstore=use_hashstore, host_store=host_store, pipeline=pipeline,
                           pipeline_window=pipeline_window, prewarm=prewarm)
        if out is not None:
            print(f"tla-raft-tpu-torch checker: device={chk.device}", file=out)
            where = f" {config_path}" if config_path else ""
            print(f"Config{where}: {cfg.describe()}; {chk.K} slots, chunk {chk.chunk}", file=out)
            if host_store is not None:
                print(f"Native FP store: {fpstore_dir}", file=out)
            elif not chk.use_hashstore:
                print("Visited store: sorted (level dedup by radix sort, merged per level)",
                      file=out)
            if chk.store_bytes:
                print(f"Tiered visited store: hot slab budget {chk.store_bytes:,} B (demotions "
                      "spill to host generations)", file=out)
            if checkpoint_dir and checkpoint_every:
                print(f"Checkpoints: delta log in {checkpoint_dir}"
                      + (f" (resuming from {recover})" if recover else ""), file=out)
        prof = _start_profiler(profile, hub, checkpoint_dir, chk.device, out)
        try:
            res = chk.run(max_depth=max_depth, checkpoint_dir=checkpoint_dir,
                          checkpoint_every=checkpoint_every, resume_from=recover)
        finally:
            _stop_profiler(prof, out)
        if hub is not None:
            obs_telemetry.run_end(ok=res.ok, distinct=res.distinct, generated=res.generated,
                                  depth=res.depth)
        summary = summarize(res, time.monotonic() - t0, chk, hub=hub)
        summary["_res"] = res
        summary["_chk"] = chk
        summary["_hub"] = hub
        return summary


@contextlib.contextmanager
def _run_hub(telemetry, cfg, *, checkpoint_dir, recover, mesh, mesh_deep, device):
    """The run's flight recorder (check.py:389-411, :470-476): None with
    telemetry off; the hub an outer caller installed, left as it is; else a
    hub of the run's own (its run dir ``checkpoint_dir``, else
    ``TLA_RAFT_TELEMETRY_DIR``, else in memory), anchored by ``run_begin``,
    installed for the run and closed after it."""
    from .obs import telemetry as obs_telemetry

    if not (obs_telemetry.enabled_by_env() if telemetry is None else bool(telemetry)):
        yield None
        return
    hub = obs_telemetry.current()
    if hub is not None:
        yield hub
        return
    hub = obs_telemetry.TelemetryHub(
        run_dir=checkpoint_dir or os.environ.get("TLA_RAFT_TELEMETRY_DIR") or None)
    obs_telemetry.install(hub)
    try:
        obs_telemetry.run_begin(config=cfg.describe(), backend="torch", mesh=mesh,
                                mesh_deep=mesh_deep, recover=bool(recover),
                                device=str(device or "cuda"))
        yield hub
    finally:
        obs_telemetry.install(None)
        hub.close()


def _start_profiler(windows: int, hub, checkpoint_dir, device, out):
    """``--profile N`` (check.py:601-652): a capture of the first N dispatch
    windows into ``<run dir>/profile/``, or the reference's message when
    there is no hub (no ``profile_begin`` anchor, no stream to merge into)
    or no run dir; a profiler that cannot start is reported, not fatal."""
    if not windows or int(windows) <= 0:
        return None

    def say(msg):
        if out is not None:
            print(msg, file=out)

    prof_dir = checkpoint_dir or os.environ.get("TLA_RAFT_TELEMETRY_DIR")
    if hub is None:
        say("--profile needs telemetry on (the profile_begin event anchors the device-lane "
            "merge; flag ignored)")
        return None
    if not prof_dir:
        say("--profile needs --checkpoint-dir (or TLA_RAFT_TELEMETRY_DIR): the device trace "
            "lands beside events.jsonl (flag ignored)")
        return None
    from .analysis import devprof

    prof = devprof.ProfilerCapture(prof_dir, int(windows), cuda=device.type == "cuda")
    if not prof.start():
        say(f"Profiler: could not start ({prof.error}); no trace")
        return None
    devprof.install_profiler(prof)
    say(f"Profiler: capturing {prof.windows} dispatch window(s) -> {prof.trace_dir}")
    return prof


def _stop_profiler(prof, out) -> None:
    """Stop a capture that is still open (every exit: done, raised or
    preempted) and uninstall it."""
    if prof is None:
        return
    from .analysis import devprof

    prof.stop()
    devprof.install_profiler(None)
    if prof.failed and out is not None:
        print(f"Profiler: failed ({prof.error}); no trace", file=out)


def _run_mesh(cfg, t0, *, max_depth, chunk, checkpoint_dir, checkpoint_every, recover, device,
              canon, use_hashstore, use_mxu, progress, out, config_path, fpstore_dir,
              warm_bytes, mesh, exchange, cap_x, dev_bytes, mesh_deep, seg_rows, sieve,
              compress, pipeline, pipeline_window, hub, profile) -> dict:
    """``run_check``'s mesh branch (check.py:686-757), the deep sweep's
    ``Exchange:`` lines included."""
    from .obs import telemetry as obs_telemetry
    from .parallel import ShardedChecker, make_mesh

    if out is not None and dev_bytes:
        print("--dev-bytes applies to the single-device engine's hot slab; mesh out-of-core "
              "runs tier through the owner-sharded external stores (--fpstore-dir) with "
              "--warm-bytes bounding their RAM (flag ignored)", file=out)
    chk = ShardedChecker(cfg, make_mesh(mesh, device=device), cap_x=cap_x, exchange=exchange,
                         progress=progress, canon=canon, host_store_dir=fpstore_dir or None,
                         use_hashstore=use_hashstore, use_mxu=use_mxu, warm_bytes=warm_bytes,
                         chunk=chunk, deep=mesh_deep, seg_rows=seg_rows, sieve=sieve,
                         compress=compress, pipeline=pipeline, pipeline_window=pipeline_window)
    if out is not None:
        print(f"tla-raft-tpu-torch checker: device={chk.devices[0]}, mesh of {chk.D} "
              f"shard(s) ({exchange})", file=out)
        where = f" {config_path}" if config_path else ""
        print(f"Config{where}: {cfg.describe()}; {chk.K} slots, chunk {chk.chunk}", file=out)
        if fpstore_dir:
            print(f"Native FP store (owner-sharded x{mesh}): {fpstore_dir}", file=out)
    prof = _start_profiler(profile, hub, checkpoint_dir, chk.devices[0], out)
    try:
        res = chk.run(max_depth=max_depth, checkpoint_dir=checkpoint_dir,
                      checkpoint_every=checkpoint_every, resume_from=recover)
    finally:
        _stop_profiler(prof, out)
    if hub is not None:
        obs_telemetry.run_end(ok=res.ok, distinct=res.distinct, generated=res.generated,
                              depth=res.depth)
    if out is not None and mesh_deep and chk.meter.levels:
        # the run's exchange ledger: the sieve-and-compress bytes against
        # what the uncompressed exchange would have moved (check.py:734-757)
        s = chk.meter.summary()
        print(f"Exchange: {s['exchanged_bytes']:,} fp bytes over {s['levels']} levels "
              f"(uncompressed equivalent {s['raw_bytes']:,}; reduction {s['reduction']}x; "
              f"sieved {s['sieved']:,} of {s['candidates']:,} candidates)", file=out)
        for lv in s["per_level"]:
            print(f"  level {lv['level']}: {lv['exchanged_bytes']:,} B (raw "
                  f"{lv['raw_bytes']:,} B, x{lv['reduction']}), sieved "
                  f"{lv['n_sieved']:,}/{lv['n_candidates']:,}", file=out)
    summary = summarize_mesh(res, time.monotonic() - t0, chk, hub=hub)
    summary["_res"] = res
    summary["_chk"] = chk
    summary["_hub"] = hub
    return summary


# the mesh's level loops capture their programs in line (check.py:1109-1111)
PREWARM_MESH_REFUSAL = ("--prewarm applies to the single-device engine only; the mesh level "
                        "loops capture their programs in line")

# the reference's message, printed as it prints it (check.py:1113-1117)
DEEP_STORE_REFUSAL = ("--mesh-deep requires --fpstore-dir (the sharded deep sweep filters "
                      "through per-owner external stores)")


def mesh_refusal(args) -> str | None:
    """Why the CLI refuses a mesh run it cannot honor, or None: the deep
    sweep needs a mesh and the per-owner stores (check.py:1052, :1113), the
    mesh's checkpoints and sorted shards are not ported, and --audit and
    --prewarm belong to the single-device engine (check.py:719, :1109)."""
    from .parallel.sharded import CHECKPOINT_REFUSAL, SORTED_REFUSAL

    if args.mesh_deep and not args.mesh:
        return ("--mesh-deep requires --mesh N (the sharded deep sweep runs on a device "
                "mesh)")
    if not args.mesh:
        return None
    if args.mesh_deep and not args.fpstore_dir:
        return DEEP_STORE_REFUSAL
    if args.prewarm:
        return PREWARM_MESH_REFUSAL
    if (args.checkpoint_dir and args.checkpoint_every) or args.recover:
        return CHECKPOINT_REFUSAL
    if args.audit:
        return ("--audit applies to the single-device engine; mesh runs keep the always-on "
                "conservation checks (count reconciliation, store occupancy)")
    if args.no_hashstore and args.exchange == "all_to_all" and not args.fpstore_dir:
        return SORTED_REFUSAL
    return None


def _mxu_arg(args):
    """--mxu-expand / --no-mxu-expand -> use_mxu (None: TLA_RAFT_MXU)."""
    if args.no_mxu_expand:
        return False
    if args.mxu_expand is None:
        return None
    return bool(args.mxu_expand)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description="Raft model checker (PyTorch + CUDA port)")
    ap.add_argument("--config", default=None,
                    help="TLC .cfg file (the single source of truth for constants; default: "
                         "the Raft.cfg constants built in)")
    ap.add_argument("--spec", default=None,
                    help="TLA+ spec file to validate against the compiled semantics (default: "
                         "Raft.tla next to the cfg, if there is one; '' skips)")
    ap.add_argument("--invariant", action="append", default=None,
                    help="override INVARIANT (repeatable; ~Name negates)")
    ap.add_argument("--no-symmetry", action="store_true")
    ap.add_argument("--no-view", action="store_true")
    ap.add_argument("--servers", type=int, default=None, help="override |Servers|")
    ap.add_argument("--vals", type=int, default=None, help="override |Vals|")
    ap.add_argument("--max-election", type=int, default=None)
    ap.add_argument("--max-restart", type=int, default=None)
    ap.add_argument("--max-depth", type=int, default=None)
    ap.add_argument("--mutate", action="append", default=[], choices=MUTATIONS,
                    help="compile in a planted semantic bug (repeatable)")
    ap.add_argument("--chunk", type=int, default=None,
                    help="parents per guard launch (default: the largest power of two at or "
                         "below 16,384 * 696 / K, at most 16,384: 16,384 at 3 servers, 4,096 "
                         "at 5, 2,048 at 7)")
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    ap.add_argument("--megakernel", type=int, choices=(0, 1), default=None,
                    help="the fused level: one CUDA graph launch and one read per level "
                         "(default on; 0 selects the staged chain)")
    ap.add_argument("--superstep", type=int, default=None, metavar="N",
                    help="up to N fused levels per CUDA graph launch and read (default 4; "
                         "1 selects the per-level fused program)")
    ap.add_argument("--dev-bytes", type=float, default=None, metavar="BYTES",
                    help="device budget for the hot visited tier (the hash slab): past it the "
                         "slab demotes whole generations to host RAM instead of growing; "
                         "0/unset = unbounded, and the counts are the same either way "
                         "(env: TLA_RAFT_STORE_BYTES)")
    ap.add_argument("--canon", choices=("late", "expand"), default="late",
                    help="candidate canonicalization: 'late' fingerprints the compacted "
                         "candidates (default), 'expand' every fan-out lane by the dense "
                         "expand's delta hash")
    ap.add_argument("--mxu-expand", type=int, choices=(0, 1), default=None,
                    help="the matrix forms' kernels K1/K2 (default on; 0 selects the legacy "
                         "per-lane kernels: the same counts; env: TLA_RAFT_MXU)")
    ap.add_argument("--no-mxu-expand", action="store_true",
                    help="shorthand for --mxu-expand 0")
    ap.add_argument("--audit", type=int, default=0, metavar="N",
                    help="every level, re-expand N deterministic new rows through the legacy "
                         "kernels and cross-check guard and fingerprints; a mismatch rewinds to "
                         "the last checkpoint (with --checkpoint-dir) and fail-stops with exit "
                         "4 after --audit-retries strikes, or at once without checkpoints")
    ap.add_argument("--audit-retries", type=int, default=3, metavar="R",
                    help="fail-stop after R reproducible audit mismatches (default 3)")
    ap.add_argument("--no-hashstore", action="store_true",
                    help="the sort-based visited store (lexsort + searchsorted + sorted merge) "
                         "instead of the hash slab; the same counts (env: TLA_RAFT_HASHSTORE=0)")
    ap.add_argument("--fpstore-dir", default=None,
                    help="the native external-memory fingerprint store rooted at this directory "
                         "(TLC's states/ spill analog): the visited set on the host, per group "
                         "of chunks deduped on the card and filtered against the store")
    ap.add_argument("--warm-bytes", type=float, default=None, metavar="BYTES",
                    help="on --fpstore-dir: the store's in-RAM buffer before it spills a sorted "
                         "run to disk (unset: the native 64 MiB default; env: "
                         "TLA_RAFT_WARM_BYTES)")
    ap.add_argument("--cap-x", type=int, default=4096,
                    help="per-shard candidate capacity a level on --mesh (grows on demand)")
    ap.add_argument("--mesh", type=int, default=0,
                    help="run over an N-shard mesh, one GPU a shard (0 = one device; with "
                         "--device cpu, N shards of the CPU)")
    ap.add_argument("--exchange", choices=("all_to_all", "all_gather"), default="all_to_all",
                    help="the mesh's fingerprint exchange")
    ap.add_argument("--mesh-deep", action="store_true",
                    help="the sharded deep sweep: the frontier 1/D across the shards as "
                         "segment lists, the sieve-and-compress fingerprint exchange "
                         "(requires --mesh and --fpstore-dir)")
    ap.add_argument("--seg-rows", type=int, default=1 << 15,
                    help="rows per frontier segment per shard (--mesh-deep)")
    ap.add_argument("--no-sieve", action="store_true",
                    help="--mesh-deep: no pre-routing visited sieve")
    ap.add_argument("--no-compress", action="store_true",
                    help="--mesh-deep: fetch raw u64 fingerprints instead of the delta-packed "
                         "stream")
    ap.add_argument("--checkpoint-dir", default=None,
                    help="write a per-level delta-log checkpoint (delta_NNNN.npz, and the "
                         "hslab.npz slab snapshot at its cadence) here")
    ap.add_argument("--checkpoint-every", type=int, default=1,
                    help="0 disables checkpointing; any other value records every level (the "
                         "replay chain cannot skip levels)")
    ap.add_argument("--recover", default=None,
                    help="resume from a checkpoint directory (delta log); corrupt, torn or "
                         "unmanifested records are quarantined or adopted and the run resumes "
                         "from the last good contiguous prefix")
    ap.add_argument("--no-pipeline", action="store_true",
                    help="turn the async pipeline off: every device-to-host read serial "
                         "(counts are the same either way; env TLA_RAFT_PIPELINE=0)")
    ap.add_argument("--pipeline-window", type=int, default=None, metavar="N",
                    help="read groups the async pipeline keeps in flight (default 2; 0 = "
                         "serial; env TLA_RAFT_PIPELINE_WINDOW)")
    ap.add_argument("--prewarm", type=int, choices=(0, 1), default=None,
                    help="the forecast prewarm: build and capture the forecast levels' "
                         "programs on a thread of their own ahead of the levels (default: on "
                         "on the card, off on the CPU; env TLA_RAFT_PREWARM; single-device "
                         "engine only: refused with --mesh)")
    ap.add_argument("--fault", action="append", default=None, metavar="SITE:ACTION[@N]",
                    help="deterministic fault injection (repeatable): kill/torn/flip/fail/pause "
                         "at a named site's Nth hit, e.g. delta.commit:kill@3 (env "
                         "TLA_RAFT_FAULT takes the same grammar)")
    ap.add_argument("--coverage", action="store_true", help="print per-action counts")
    ap.add_argument("--json", action="store_true", help="print a JSON summary line")
    ap.add_argument("--log", default="raft.log",
                    help="also write everything printed to this file (default raft.log, as "
                         "the launcher tees it; '-' for none)")
    ap.add_argument("--progress", action="store_true",
                    help="a live one-line progress display on stderr (states/s, frontier, "
                         "slab load, levels per launch, forecast ETA to the fixpoint); the "
                         "per-level Progress lines go to the log")
    ap.add_argument("--telemetry", type=int, choices=(0, 1), default=None,
                    help="the run's flight recorder (obs/telemetry.py): typed run events "
                         "appended to events.jsonl in the checkpoint directory, and the "
                         "telemetry block in --json.  Default on; 0 turns it off.  Host-side "
                         "only: the same launches, reads and counts either way (env "
                         "TLA_RAFT_TELEMETRY)")
    ap.add_argument("--profile", type=int, default=0, metavar="N",
                    help="capture the first N dispatch windows (a superstep, a level or a "
                         "launch group, each ending in one device read) with torch.profiler "
                         "into <checkpoint-dir>/profile/; `python -m tla_raft_tpu_torch.obs "
                         "trace` merges its lanes beside the host lanes.  Default off; the "
                         "counts are the same either way")
    ap.add_argument("--workers", type=int, default=None,
                    help="accepted for the launcher's line (TLC's -workers); ignored")
    args = ap.parse_args(argv)

    logf = open(args.log, "w") if args.log and args.log != "-" else None
    out = Tee(sys.stdout, logf) if logf else sys.stdout
    try:
        return _main(args, out)
    finally:
        if logf:
            logf.close()


def _main(args, out) -> int:
    """``main`` after the arguments, printing to ``out`` (stdout, teed to
    the log file when there is one): every exit, refusals and fail-stops
    too, lands in the log."""
    from . import resilience
    from .resilience.integrity import IntegrityError

    if args.fault:
        resilience.fault_install(",".join(args.fault))
    cfg = RaftConfig()
    if args.config:
        from .cfgparse import load_raft_config

        cfg = load_raft_config(args.config)
    overrides = {}
    for key, val in (("invariants", tuple(args.invariant or ())),
                     ("symmetry", False if args.no_symmetry else None),
                     ("use_view", False if args.no_view else None),
                     ("mutations", tuple(args.mutate)), ("n_servers", args.servers),
                     ("n_vals", args.vals), ("max_election", args.max_election),
                     ("max_restart", args.max_restart)):
        if val is not None and val != ():
            overrides[key] = val
    if overrides:
        cfg = dataclasses.replace(cfg, **overrides)
    t0 = time.monotonic()
    # the spec beside the cfg must be the one the semantics were compiled
    # from (check.py:1061-1076)
    spec = args.spec
    if spec is None and args.config:
        cand = os.path.join(os.path.dirname(os.path.abspath(args.config)), "Raft.tla")
        spec = cand if os.path.exists(cand) else None
    if spec:
        from .tla_frontend import validate_spec

        problems = validate_spec(spec)
        if problems:
            for pr in problems:
                print(f"SPEC MISMATCH: {pr}", file=out)
            print("Refusing to check a spec that diverges from the compiled semantics "
                  "(pass --spec '' to skip).", file=out)
            return 2
        print(f"Spec {spec}: structure matches compiled semantics.", file=out)
    if args.dev_bytes and args.checkpoint_dir and args.checkpoint_every and not args.fpstore_dir:
        # with --fpstore-dir the budget builds no tier (bfs.py:4131)
        print("Refusing --dev-bytes with --checkpoint-dir: resuming a tiered run needs the "
              "tiered store's resume rebuild, which the port does not have yet (run without "
              "one of the two).", file=out)
        return 2
    from .engine.bfs import segment_settings_refusal

    why = mesh_refusal(args) or segment_settings_refusal(bool(args.fpstore_dir))
    if why == DEEP_STORE_REFUSAL:
        print(why, file=out)
        return 2
    if why:
        print(f"Refusing: {why}.", file=out)
        return 2

    pline = None
    if args.progress:
        from .obs.progress import ProgressLine

        pline = ProgressLine(stream=sys.stderr)

    def progress(s):
        rate = s["distinct"] / max(s["elapsed"], 1e-9)
        line = (f"Progress: level {s['level']}, frontier {s['frontier']}, "
                f"distinct {s['distinct']}, generated {s['generated']}, "
                f"{rate:,.0f} states/s")
        if pline is not None:
            # the live line on stderr (check.py:1081-1106); the grep-able
            # Progress lines go to stdout and the log as without it, printed
            # between two paints so a terminal that shows both streams keeps
            # the live line below them
            pline.clear()
            print(line, file=out, flush=True)
            pline.write(s)
            return
        print(line, file=out, flush=True)

    try:
        summary = run_check(
            cfg, max_depth=args.max_depth, chunk=args.chunk,
            checkpoint_dir=args.checkpoint_dir, checkpoint_every=args.checkpoint_every,
            recover=args.recover, device=args.device, canon=args.canon,
            use_hashstore=False if args.no_hashstore else None, use_mxu=_mxu_arg(args),
            megakernel=None if args.megakernel is None else bool(args.megakernel),
            superstep=args.superstep, audit=args.audit, audit_retries=args.audit_retries,
            dev_bytes=int(args.dev_bytes) if args.dev_bytes else None, progress=progress,
            out=out, install_signals=True, config_path=args.config,
            fpstore_dir=args.fpstore_dir,
            warm_bytes=int(args.warm_bytes) if args.warm_bytes else None, mesh=args.mesh,
            exchange=args.exchange, cap_x=args.cap_x, mesh_deep=args.mesh_deep,
            seg_rows=args.seg_rows, sieve=not args.no_sieve, compress=not args.no_compress,
            pipeline=False if args.no_pipeline else None, pipeline_window=args.pipeline_window,
            prewarm=None if args.prewarm is None else bool(args.prewarm),
            telemetry=None if args.telemetry is None else bool(args.telemetry),
            profile=args.profile)
    except resilience.Preempted as e:
        return _report_preempted(e, out)
    except ValueError as e:
        if not args.mesh:
            raise
        # a mesh the run cannot have: too few visible GPUs, or a mode the
        # port's mesh refuses (parallel/sharded.py)
        print(f"Refusing: {e}.", file=out)
        return 2
    except IntegrityError as e:
        # an audit fail-stop or a conservation check is no model verdict:
        # exit 4 (check.py:1188-1197)
        print(f"Integrity fail-stop: {e}", file=out)
        return 4
    finally:
        if pline is not None:
            pline.done()  # the live line ends on every exit
    res, chk, hub = summary["_res"], summary["_chk"], summary["_hub"]
    dt = time.monotonic() - t0
    print(file=out)
    if hub is not None and hub.path:
        print(f"Telemetry: {hub.n_events} events -> {hub.path} (timeline: python -m "
              f"tla_raft_tpu_torch.obs trace {os.path.dirname(hub.path)})", file=out)
    if res.ok:
        print("Model checking completed. No error has been found.", file=out)
    else:
        kind, trace = res.violation
        print(f"Error: {kind}.", file=out)
        if trace is not None:
            print_trace(cfg, trace, out)
    print(f"{res.generated} states generated, {res.distinct} distinct states found, "
          f"depth {res.depth}.", file=out)
    coll = res.distinct * max(res.distinct - 1, 0) / 2.0**65
    print(f"The probability of a fingerprint collision is calculated to be {coll:.3g}.",
          file=out)
    if args.coverage and res.action_counts:
        print("Action coverage (transitions fired):", file=out)
        for name, n in sorted(res.action_counts.items(), key=lambda kv: -kv[1]):
            print(f"  {name}: {n}", file=out)
    print(f"Finished in {dt:.1f}s ({res.distinct / max(dt, 1e-9):,.0f} distinct states/s).",
          file=out)
    if args.json:
        line = (summarize_mesh(res, dt, chk, hub=hub) if args.mesh
                else summarize(res, dt, chk, hub=hub))
        print(json.dumps(line), file=out)
    return 0 if res.ok else 1


if __name__ == "__main__":
    sys.exit(main())
