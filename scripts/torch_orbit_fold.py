#!/usr/bin/env python3
"""Orbit pruning at 7 servers to depth 15 on the GPU (``chip_smoke.py``'s
orbit run, ``_orbit_run``), with the tied fold's device time (K3's indexed
mode, ``orbit_fold``) summed over the run: one JSON line, then the card's
name and power limit.

    python scripts/torch_orbit_fold.py [--tree DIR] [--depth N]

``--tree`` runs the ``tla_raft_tpu_torch`` package of another checkout (a
parent commit unpacked with ``git archive``, say) under this checkout's
``chip_smoke.py``, so two trees are measured by the same code in one call;
each builds its kernels into its own ``build/kernels``.  Exits 2 without a
CUDA device.
"""

import argparse
import importlib.util
import json
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--tree", default=str(ROOT), help="checkout whose package runs")
    ap.add_argument("--depth", type=int, default=15)
    args = ap.parse_args()
    tree = Path(args.tree).resolve()
    sys.path.insert(0, str(tree))
    spec = importlib.util.spec_from_file_location("chip_smoke", ROOT / "chip_smoke.py")
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)
    import torch

    if not torch.cuda.is_available():
        print("torch_orbit_fold: no CUDA device", file=sys.stderr)
        return 2
    from tla_raft_tpu_torch import kernels

    kernels.build_all()
    _chk, res, rec = cs._orbit_run(7, args.depth, True, [])
    print(json.dumps(dict(
        tree=str(tree), package=str(Path(kernels.__file__).parents[1]), depth=res.depth,
        distinct=res.distinct, generated=res.generated, seconds=rec["seconds"],
        fold_device_ms=rec["fold_device_ms"], fold_timed_launches=rec["fold_timed_launches"],
        fold_graph_captures=rec["fold_graph_captures"],
        orbit_fold_launches=rec["launches"].get("orbit_fold", 0))), flush=True)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=False)
    print(smi.stdout.strip() or "nvidia-smi: no output")
    return 0


if __name__ == "__main__":
    sys.exit(main())
