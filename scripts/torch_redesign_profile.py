#!/usr/bin/env python3
"""Where the time of two port kernels goes on the GPU, kernel launch by
kernel launch (torch.profiler's device times, averaged over calls):

* ``level_dedup`` over the reference constants' level-25 lanes against the
  store after level 24 (the inputs ``chip_smoke.py``'s sorted kernels phase
  times, from its capture run);
* K3 with its factored message part at 7 servers over one chunk of
  candidates of a depth-9 frontier (the scale kernels phase's shapes).

    python scripts/torch_redesign_profile.py [--reps N]

One JSON line a kernel, then the card's name and power limit.  Exits 2
without a CUDA device.
"""

import argparse
import importlib.util
import json
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def _by_kernel(prof, reps: int) -> dict:
    """Device milliseconds a call, by kernel name."""
    out = {}
    for e in prof.key_averages():
        us = getattr(e, "device_time_total", None)
        if us is None:
            us = getattr(e, "cuda_time_total", 0)
        if us > 0 and not e.key.startswith(("aten::", "cuda")):
            out[e.key.split("(")[0]] = us / reps / 1e3
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--reps", type=int, default=3)
    args = ap.parse_args()
    sys.path.insert(0, str(ROOT))
    spec = importlib.util.spec_from_file_location("chip_smoke", ROOT / "chip_smoke.py")
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)
    import torch

    if not torch.cuda.is_available():
        print("torch_redesign_profile: no CUDA device", file=sys.stderr)
        return 2
    from torch.profiler import ProfilerActivity, profile

    from tla_raft_tpu_torch import kernels
    from tla_raft_tpu_torch.config import RaftConfig
    from tla_raft_tpu_torch.engine import bfs
    from tla_raft_tpu_torch.engine.bfs import TorchChecker

    kernels.build_all()
    reps = args.reps

    def run(fn) -> dict:
        for _ in range(2):
            fn()
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
        by = _by_kernel(prof, reps)
        return dict(ms_a_call_by_kernel=by, ms_a_call=sum(by.values()))

    cv, cf, cp, store = cs.capture_sorted_inputs(cs.DEPTH_DEFAULT, cs.CHUNK).pop("level_dedup")
    rec = run(lambda: bfs.level_dedup(cv, cf, cp, store))
    print(json.dumps(dict(kernel="level_dedup", lanes=cv.shape[0],
                          live_lanes=int((cv != -1).sum()), store_slots=store.shape[0],
                          reps=reps, **rec)), flush=True)
    cv = cf = cp = store = None
    torch.cuda.empty_cache()

    chk = TorchChecker(RaftConfig(n_servers=7), device="cuda")
    chk.run(max_depth=9)
    fr, mx, K, B, G = chk.frontier, chk.mx, chk.K, chk.chunk, chk.cap_x
    real = cs._frontier_rows(fr, torch.arange(min(B, fr.voted_for.shape[0]), device="cuda"))
    nb = real.voted_for.shape[0]
    valid, _m, _a = mx.guards(chk.inflate(real))
    payload = (torch.arange(nb, device="cuda")[:, None] * K
               + torch.arange(K, device="cuda")).reshape(-1)
    lanes, lane, _o = bfs.compact_payloads(valid.reshape(-1), payload, G)
    live = int(lane.sum())
    children = mx.materialize(real, torch.div(lanes, K, rounding_mode="floor").clamp(0, nb - 1),
                              lanes % K)[0]
    cnt = torch.tensor(live, device="cuda")
    out = (torch.empty(G, dtype=torch.int64, device="cuda"),
           torch.empty(G, dtype=torch.int64, device="cuda"))
    rec = run(lambda: kernels.fingerprints(chk.fpr, children, out=out, cnt=cnt))
    print(json.dumps(dict(kernel="msg_hash_factored", servers=7, lanes=live, reps=reps, **rec)),
          flush=True)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=False)
    print(smi.stdout.strip() or "nvidia-smi: no output")
    return 0


if __name__ == "__main__":
    sys.exit(main())
