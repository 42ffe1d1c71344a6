#!/usr/bin/env python3
"""The default path to depth 25 on the GPU with the forecast prewarm and
the presize on and off, alternating in one process (``chip_smoke.py``'s
``phase_default`` arms): after a staged run to depth 20 (the warm-up the
smoke's default phase follows), a default-settings run, then ``--pairs``
pairs of on and off runs.  Each run prints ``chip_smoke``'s default and
``prewarm`` lines (captures and seconds by thread, recaptures by cause,
hits, misses, slab grows, the wall) and whether its launch counts are the
expected ones; then one line of the walls by arm, and the card's name and
power limit.

    python scripts/torch_prewarm_arms.py [--pairs N]

Exits 2 without a CUDA device, 1 if a run failed its checks.
"""

import argparse
import json
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--pairs", type=int, default=3)
    args = ap.parse_args()
    sys.path.insert(0, str(ROOT))
    import torch

    if not torch.cuda.is_available():
        print("torch_prewarm_arms: no CUDA device", file=sys.stderr)
        return 2
    import chip_smoke as cs
    from tla_raft_tpu_torch import kernels

    kernels.build_all()
    cs.phase_staged(cs.DEPTH, cs.CHUNK)
    arms = [("default", None)]
    for i in range(1, args.pairs + 1):
        arms += [(f"on{i}", cs.PREWARM_ON), (f"off{i}", cs.PREWARM_OFF)]
    failed = 0
    for name, env in arms:
        kernels.reset_launches()
        try:
            cs.phase_default(cs.DEPTH_DEFAULT, cs.CHUNK, name, env)
        except cs.Failed as e:
            print(json.dumps(dict(arm=name, failed=str(e))), flush=True)
            failed += 1
            continue
        counts = kernels.launch_counts()
        exact = all(counts[k] == v for k, v in cs.EXPECT[name].items())
        failed += not exact
        print(json.dumps(dict(arm=name, exact_counts=exact)), flush=True)
    print(json.dumps(dict(walls=cs.WALLS.get("default_arms"))), flush=True)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=False)
    print(smi.stdout.strip() or "nvidia-smi: no output")
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main())
