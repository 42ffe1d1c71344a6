"""Sweep-service CLI of the port: submit / status / results / run.

    python -m tla_raft_tpu_torch.service submit  --root Q --config Raft.cfg \
        [--servers N] [--vals N] [--max-election N] [--max-restart N] \
        [--max-depth N] [--invariant I]... [--mutate M]... [--chunk N] \
        [--count N] [--max-queue N] [--json]
    python -m tla_raft_tpu_torch.service status  --root Q [--job ID] [--json]
    python -m tla_raft_tpu_torch.service results --root Q JOB [--json]
    python -m tla_raft_tpu_torch.service run     --root Q [--once] [--poll S] \
        [--max-idle S] [--no-batch] [--min-bucket N] [--lease-ttl S] \
        [--admit-configs N] [--admit-bytes B] [--device cpu]

The port of ``tla_raft_tpu/service/__main__.py``; the queue directory is
the reference's, so either package's CLI serves it.  ``run`` drives the
card unless ``--device cpu`` is given.  ``run --supervise``, ``run
--worker`` (the pool) and ``chaos`` are not in the port yet: they exit 2
and say so.

``results`` emits the same ``--json`` summary schema ``check.py``
produces (one JSON object per line), so sweep tooling parses one
format whether a config ran through the service or standalone.
A run killed mid-pass leaves its jobs' leases behind; the next pass
requeues the dead worker's stale-leased jobs and resumes them from their
checkpoint dirs (the job's delta log, or the bucket's bstate snapshot).
``submit --max-queue N`` is admission control at the front door: when
the pending backlog is already >= N, the submission is rejected with
exit 75 (EX_TEMPFAIL — retry later), mirroring the preemption code so
sweep drivers reuse one backoff path.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import sys


def _build_cfg(args):
    from ..config import RaftConfig

    if args.config and os.path.exists(args.config):
        from ..cfgparse import load_raft_config

        cfg = load_raft_config(args.config)
    else:
        cfg = RaftConfig()
    over = {}
    if args.servers is not None:
        over["n_servers"] = args.servers
    if args.vals is not None:
        over["n_vals"] = args.vals
    if args.max_election is not None:
        over["max_election"] = args.max_election
    if args.max_restart is not None:
        over["max_restart"] = args.max_restart
    if args.invariant:
        over["invariants"] = tuple(args.invariant)
    if args.mutate:
        over["mutations"] = tuple(args.mutate)
    if args.no_symmetry:
        over["symmetry"] = False
    if args.no_view:
        over["use_view"] = False
    return dataclasses.replace(cfg, **over) if over else cfg


def _cmd_submit(args) -> int:
    from .queue import JobQueue

    q = JobQueue(args.root)
    if args.max_queue:
        pending = len(q.pending())
        if pending >= args.max_queue:
            print(
                f"submit rejected: {pending} pending >= --max-queue "
                f"{args.max_queue} (backpressure; retry later)",
                file=sys.stderr,
            )
            return 75
    cfg = _build_cfg(args)
    options = {}
    if args.chunk is not None:
        options["chunk"] = args.chunk
    if args.backend != "jax":
        options["backend"] = args.backend
    if args.dev_bytes:
        # tiered job: the worker runs it with a hot-slab device budget
        # (store/tiered.py) — the scheduler can pack configs whose
        # visited sets exceed HBM; they route sequential (the batched
        # bucket core shares ONE slab across tenants)
        options["dev_bytes"] = int(args.dev_bytes)
    if args.warm_bytes:
        options["warm_bytes"] = int(args.warm_bytes)
    jids = []
    for _ in range(args.count):
        jids.append(
            q.submit(cfg, max_depth=args.max_depth, options=options)
        )
    if args.json:
        print(json.dumps(dict(submitted=jids, config=cfg.describe())))
    else:
        for j in jids:
            print(j)
    return 0


def _cmd_status(args) -> int:
    from .queue import JobQueue

    q = JobQueue(args.root)
    if args.metrics:
        # the daemon's per-pass atomic snapshot (obs/metrics.py):
        # queue depth, lease ages, jobs/hour, poisoned count
        from ..obs import metrics as obs_metrics

        doc = obs_metrics.load(args.root)
        if doc is None:
            print(f"{args.root}: no readable metrics.json "
                  "(daemon not run yet?)", file=sys.stderr)
            return 2
        if args.json:
            print(json.dumps(doc))
        else:
            obs_metrics.render(doc)
        return 0
    if args.job:
        try:
            st = q.load_state(args.job)
        except FileNotFoundError as e:
            print(e, file=sys.stderr)
            return 2
        doc = dict(job_id=args.job, **st)
        if args.json:
            print(json.dumps(doc))
        else:
            print(f"{args.job}: {st['status']} "
                  f"(attempt {st.get('attempt')}, "
                  f"worker {st.get('worker')})")
        return 0
    c = q.counts()
    if args.json:
        print(json.dumps(c))
    else:
        for k, v in c.items():
            print(f"{k:>10}: {v}")
    return 0


def _cmd_results(args) -> int:
    from .queue import JobQueue

    q = JobQueue(args.root)
    res = q.load_result(args.job)
    if res is None:
        try:
            st = q.load_state(args.job)
        except FileNotFoundError as e:
            print(e, file=sys.stderr)
            return 2
        print(
            f"job {args.job}: no result yet (status {st['status']})",
            file=sys.stderr,
        )
        return 4
    if args.json:
        print(json.dumps(res))
    else:
        verdict = "OK" if res.get("ok") else (
            res.get("violation") or "FAILED"
        )
        print(
            f"{args.job}: {verdict} — {res.get('distinct')} distinct, "
            f"{res.get('generated')} generated, depth {res.get('depth')}"
        )
    return 0 if res.get("ok") else 1


def _not_ported(what: str) -> int:
    print(f"{what} is not in the port yet (the reference's tla_raft_tpu.service has it)",
          file=sys.stderr)
    return 2


def _cmd_run(args) -> int:
    if args.supervise:
        return _not_ported("run --supervise")
    if args.worker:
        return _not_ported("run --worker (the worker pool)")
    from .. import resilience
    from .daemon import Scheduler
    from .queue import JobQueue

    resilience.install_signal_handlers()
    q = JobQueue(
        args.root, lease_ttl=args.lease_ttl,
        max_attempts=args.retry_budget,
    )
    sched = Scheduler(
        q, batch=not args.no_batch, min_bucket=args.min_bucket,
        admit_configs=args.admit_configs, admit_bytes=args.admit_bytes,
        device=args.device,
    )
    if args.progress:
        def line(s):
            print(f"[progress] level {s['level']}: frontier {s['frontier']}, "
                  f"distinct {s['distinct']}, generated {s['generated']}"
                  + (f", configs alive {s['configs_alive']}" if "configs_alive" in s else ""),
                  file=sys.stderr, flush=True)

        sched.progress = line

    try:
        if args.once:
            stats = sched.run_once()
        else:
            stats = sched.serve(poll=args.poll, max_idle=args.max_idle)
    except resilience.Preempted as e:
        print(f"[service] preempted: {e}", file=sys.stderr)
        return 75
    print(json.dumps(dict(stats, counts=q.counts())))
    return 0


def main(argv=None) -> int:
    argv = list(sys.argv[1:] if argv is None else argv)
    p = argparse.ArgumentParser(prog="tla_raft_tpu_torch.service")
    sub = p.add_subparsers(dest="cmd", required=True)

    ps = sub.add_parser("submit", help="enqueue a checking job")
    ps.add_argument("--root", required=True)
    ps.add_argument("--config", default=None,
                    help="TLC .cfg file (default: built-in reference "
                         "constants)")
    ps.add_argument("--backend", choices=("jax", "oracle"), default="jax")
    ps.add_argument("--servers", type=int, default=None)
    ps.add_argument("--vals", type=int, default=None)
    ps.add_argument("--max-election", type=int, default=None)
    ps.add_argument("--max-restart", type=int, default=None)
    ps.add_argument("--max-depth", type=int, default=None)
    ps.add_argument("--invariant", action="append", default=None)
    ps.add_argument("--mutate", action="append", default=None,
                    choices=("median-bug", "double-vote",
                             "legacy-append", "become-follower"))
    ps.add_argument("--no-symmetry", action="store_true")
    ps.add_argument("--no-view", action="store_true")
    ps.add_argument("--dev-bytes", type=float, default=None,
                    help="device-memory budget for the job's hot "
                         "visited tier: lets the scheduler pack "
                         "configs whose visited sets exceed HBM "
                         "(tiered store — the job runs sequentially)")
    ps.add_argument("--warm-bytes", type=float, default=None,
                    help="host-RAM budget for the job's warm tier")
    ps.add_argument("--chunk", type=int, default=None,
                    help="sequential-path chunk override")
    ps.add_argument("--count", type=int, default=1,
                    help="submit N identical jobs")
    ps.add_argument("--max-queue", type=int, default=0, metavar="N",
                    help="admission control: reject the submission "
                         "with exit 75 (EX_TEMPFAIL, retry later) when "
                         "the pending backlog is already >= N")
    ps.add_argument("--json", action="store_true")

    pt = sub.add_parser("status", help="queue or per-job status")
    pt.add_argument("--root", required=True)
    pt.add_argument("--job", default=None)
    pt.add_argument("--metrics", action="store_true",
                    help="render the daemon's metrics.json snapshot "
                         "(queue depth, lease ages, jobs/h, poisoned)")
    pt.add_argument("--json", action="store_true")

    pr = sub.add_parser("results", help="print a job's summary")
    pr.add_argument("--root", required=True)
    pr.add_argument("job")
    pr.add_argument("--json", action="store_true")

    pd = sub.add_parser("run", help="run the scheduler daemon")
    pd.add_argument("--root", required=True)
    pd.add_argument("--once", action="store_true",
                    help="one pass over the pending queue, then exit")
    pd.add_argument("--poll", type=float, default=2.0)
    pd.add_argument("--max-idle", type=float, default=None,
                    help="exit after this many idle seconds")
    pd.add_argument("--no-batch", action="store_true",
                    help="disable config-batched execution (A/B lever; "
                         "every job runs sequentially)")
    pd.add_argument("--min-bucket", type=int, default=None,
                    help="smallest bucket worth batching (default: the "
                         "regime's autotuned plan, else 2)")
    pd.add_argument("--lease-ttl", type=float, default=30.0,
                    help="seconds without a heartbeat before a "
                         "worker's claim is presumed dead")
    pd.add_argument("--retry-budget", type=int, default=3, metavar="N",
                    help="poison-job quarantine: a job whose worker "
                         "dies N times is failed with its accumulated "
                         "failure log and moved to failed/ instead of "
                         "being requeued forever (default 3)")
    pd.add_argument("--supervise", type=int, default=0, metavar="N",
                    help="relaunch a crashed/preempted scheduler up "
                         "to N times (not in the port yet: exit 2)")
    pd.add_argument("--progress", action="store_true",
                    help="live one-line progress for the in-flight "
                         "bucket/job (states/s, configs alive, ETA)")
    pd.add_argument("--worker", default=None, metavar="NAME",
                    help="join the worker pool under NAME (not in the "
                         "port yet: exit 2)")
    pd.add_argument("--admit-configs", type=int, default=None,
                    metavar="N",
                    help="admission control: claim at most N configs "
                         "per batched bucket; the tail stays pending "
                         "for peers (default: env "
                         "TLA_RAFT_ADMIT_CONFIGS, 0 = unlimited)")
    pd.add_argument("--admit-bytes", type=float, default=None,
                    metavar="B",
                    help="admission control: defer tiered jobs whose "
                         "declared dev_bytes exceed this worker's "
                         "device budget (default: env "
                         "TLA_RAFT_ADMIT_BYTES, 0 = unlimited)")

    pd.add_argument("--device", default=None,
                    help="cuda (default) or cpu: where the scheduler's "
                         "checks run")
    sub.add_parser("chaos", help="the multi-worker fault campaign (not in "
                                 "the port yet: exit 2)", add_help=False)

    args, extra = p.parse_known_args(argv)
    if extra and args.cmd != "chaos":
        p.error(f"unrecognized arguments: {' '.join(extra)}")
    if args.cmd == "submit":
        return _cmd_submit(args)
    if args.cmd == "status":
        return _cmd_status(args)
    if args.cmd == "results":
        return _cmd_results(args)
    if args.cmd == "chaos":
        return _not_ported("chaos")
    return _cmd_run(args)


if __name__ == "__main__":
    sys.exit(main())
