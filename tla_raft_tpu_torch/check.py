"""CLI: ``python -m tla_raft_tpu_torch.check`` — the port's checker.

Runs the BFS check of the Raft spec (engine/bfs.py) with the given
constants and prints the same TLC-shaped lines as the JAX package's
``tla_raft_tpu.check``: per-level progress, the verdict (with the
counterexample trace on a violation), the state counts and, with
``--json``, one summary line with the keys distinct, generated, depth,
level_sizes and violation.

    python -m tla_raft_tpu_torch.check --max-depth 12 --json          # on the card
    python -m tla_raft_tpu_torch.check --servers 2 --vals 1 \\
        --max-election 1 --max-restart 1 --device cpu                # plain torch

Exit code 0 when no error was found, 1 on a violation.
"""

from __future__ import annotations

import argparse
import json
import sys
import time

from .config import MSG_TYPE_NAMES, ROLE_NAMES, RaftConfig

MUTATIONS = ("median-bug", "double-vote", "legacy-append", "become-follower")


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


def print_trace(cfg: RaftConfig, trace, out) -> None:
    print("The behavior up to this point is:", file=out)
    for i, (action, st) in enumerate(trace):
        name = "Initial predicate" if action == "Init" else action
        print(f"\nSTATE {i + 1}: <{name}>", file=out)
        print(format_state(cfg, st), file=out)


def summarize(res, seconds: float, device) -> dict:
    """CheckResult -> the ``--json`` summary (the reference's core keys)."""
    return dict(
        ok=res.ok,
        distinct=res.distinct,
        generated=res.generated,
        depth=res.depth,
        level_sizes=list(res.level_sizes),
        seconds=round(seconds, 3),
        violation=res.violation[0] if res.violation else None,
        device=str(device),
    )


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description="Raft model checker (PyTorch + CUDA port)")
    ap.add_argument("--servers", type=int, default=3)
    ap.add_argument("--vals", type=int, default=2)
    ap.add_argument("--max-election", type=int, default=3)
    ap.add_argument("--max-restart", type=int, default=3)
    ap.add_argument("--max-depth", type=int, default=None)
    ap.add_argument("--mutate", action="append", default=[], choices=MUTATIONS,
                    help="compile in a planted semantic bug (repeatable)")
    ap.add_argument("--chunk", type=int, default=16384, help="parents per guard launch")
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    ap.add_argument("--coverage", action="store_true", help="print per-action counts")
    ap.add_argument("--json", action="store_true", help="print a JSON summary line")
    args = ap.parse_args(argv)

    from .engine.bfs import TorchChecker

    out = sys.stdout
    cfg = RaftConfig(
        n_servers=args.servers, n_vals=args.vals, max_election=args.max_election,
        max_restart=args.max_restart, mutations=tuple(args.mutate),
    )
    t0 = time.monotonic()

    def progress(s):
        rate = s["distinct"] / max(s["elapsed"], 1e-9)
        print(f"Progress: level {s['level']}, frontier {s['frontier']}, "
              f"distinct {s['distinct']}, generated {s['generated']}, "
              f"{rate:,.0f} states/s", file=out, flush=True)

    chk = TorchChecker(cfg, device=args.device, chunk=args.chunk, progress=progress)
    print(f"tla-raft-tpu-torch checker: device={chk.device}", file=out)
    print(f"Config: {cfg.describe()}", file=out)
    res = chk.run(max_depth=args.max_depth)
    dt = time.monotonic() - t0
    print(file=out)
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
        print(json.dumps(summarize(res, dt, chk.device)), file=out)
    return 0 if res.ok else 1


if __name__ == "__main__":
    sys.exit(main())
