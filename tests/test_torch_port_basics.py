"""The PyTorch port's foundations: import hygiene, the default device and
the unsigned-in-int64 helpers (tla_raft_tpu_torch/u64.py)."""

import torch_threads  # noqa: F401  (one torch thread a worker)
import ast
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from tla_raft_tpu.ops import fingerprint as ref_fp
from tla_raft_tpu.ops import hashstore as ref_hs
from tla_raft_tpu_torch import u64
from tla_raft_tpu_torch.config import RaftConfig
from tla_raft_tpu_torch.engine.bfs import TorchChecker

ROOT = Path(__file__).resolve().parent.parent
PORT_FILES = sorted((ROOT / "tla_raft_tpu_torch").rglob("*.py")) + [ROOT / "chip_smoke.py"]
FORBIDDEN = ("jax", "jaxlib", "tla_raft_tpu")


def _imported_modules(path: Path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            yield node.module


@pytest.mark.parametrize("path", PORT_FILES, ids=lambda p: str(p.relative_to(ROOT)))
def test_no_jax_or_reference_import(path):
    """Whole module names: ``tla_raft_tpu_torch`` is not ``tla_raft_tpu``."""
    for mod in _imported_modules(path):
        top = mod.split(".")[0]
        assert top not in FORBIDDEN, f"{path.name} imports {mod}"


def test_package_import_loads_neither_jax_nor_reference():
    code = (
        "import sys\n"
        "import tla_raft_tpu_torch.engine.bfs, tla_raft_tpu_torch.check, "
        "tla_raft_tpu_torch.carry, tla_raft_tpu_torch.kernels, "
        "tla_raft_tpu_torch.obs.__main__, tla_raft_tpu_torch.analysis.devprof\n"
        "bad = [m for m in sys.modules if m.split('.')[0] in ('jax', 'jaxlib', 'tla_raft_tpu')]\n"
        "print(bad)\n"
        "sys.exit(1 if bad else 0)\n"
    )
    env = dict(os.environ, PYTHONPATH=str(ROOT))
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stdout + out.stderr


def test_default_device_is_the_card():
    """No device means CUDA; without it the checker raises instead of
    quietly running on the CPU."""
    if torch.cuda.is_available():
        assert TorchChecker(RaftConfig(2, 1, 1, 1)).device.type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="CUDA"):
            TorchChecker(RaftConfig(2, 1, 1, 1))


def _no_device_calls():
    from tla_raft_tpu_torch import carry
    from tla_raft_tpu_torch.models.raft import init_batch
    from tla_raft_tpu_torch.ops.fingerprint import Fingerprinter
    from tla_raft_tpu_torch.ops.hashstore import DeviceHashStore, make_slab
    from tla_raft_tpu_torch.ops.dense_expand import DenseExpand
    from tla_raft_tpu_torch.ops.msg_universe import get_universe
    from tla_raft_tpu_torch.ops.mxu_expand import MXUExpand
    from tla_raft_tpu_torch.ops.successor import GuardTables

    cfg = RaftConfig(2, 1, 1, 1)
    return {
        "Fingerprinter": lambda: Fingerprinter(cfg).C_planes,
        "MXUExpand": lambda: MXUExpand(cfg).W,
        "DenseExpand": lambda: DenseExpand(cfg, get_universe(cfg)).SELP,
        "GuardTables": lambda: GuardTables(cfg).any_to,
        "init_batch": lambda: init_batch(cfg).role,
        "make_slab": lambda: make_slab(1024),
        "DeviceHashStore": lambda: DeviceHashStore().slab,
        "carry.slab": lambda: carry.slab(np.zeros(1024, np.uint64)),
    }


@pytest.mark.parametrize("name", sorted(_no_device_calls()))
def test_every_entry_point_defaults_to_the_card(name):
    """Ops, state constructors and carry functions called without a device
    put their tensors on the card, and raise where there is none."""
    make = _no_device_calls()[name]
    if torch.cuda.is_available():
        assert make().device.type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="CUDA"):
            make()


EDGE_U64 = np.array(
    [0, 1, 2**31, 2**32 - 1, 2**32, 2**63 - 1, 2**63, 2**63 + 1, 2**64 - 1], np.uint64
)


def _u64_samples():
    rng = np.random.default_rng(11)
    r = rng.integers(0, 2**64 - 1, 4096, dtype=np.uint64, endpoint=True)
    return np.concatenate([EDGE_U64, r])


def test_u64_shift_and_order_match_numpy():
    a = _u64_samples()
    b = np.roll(a, 7)
    ta = torch.from_numpy(a.view(np.int64))
    tb = torch.from_numpy(b.view(np.int64))
    for k in (0, 1, 7, 27, 30, 31, 32, 63):
        got = u64.srl(ta, k).numpy().view(np.uint64)
        assert np.array_equal(got, a >> np.uint64(k)), k
    assert np.array_equal((u64.ukey(ta) < u64.ukey(tb)).numpy(), a < b)
    m = np.stack([a, b])
    assert np.array_equal(u64.umin(torch.from_numpy(m.view(np.int64)), 0).numpy().view(np.uint64),
                          m.min(0))
    assert u64.SENT == int(np.uint64(2**64 - 1).view(np.int64))


def test_mix64_matches_reference():
    a = _u64_samples()
    got = u64.mix64(torch.from_numpy(a.view(np.int64))).numpy().view(np.uint64)
    want = ref_hs.mix64(a)
    assert np.array_equal(got, want)
    assert np.array_equal(u64.mix64_np(a), want)


def test_mix32_eff_and_plane_combine_match_reference():
    rng = np.random.default_rng(5)
    x = np.concatenate([
        np.array([0, 1, 127, 128, 255, 2**31 - 1, 2**31, 2**32 - 1], np.uint32),
        rng.integers(0, 2**32, 4096, dtype=np.uint64).astype(np.uint32),
    ])
    tx = torch.from_numpy(x.astype(np.int64))
    assert np.array_equal(u64._mix32(tx).numpy().astype(np.uint32), ref_fp._mix32(x))
    assert np.array_equal(u64._mix32_np(x), ref_fp._mix32(x))
    assert np.array_equal(u64._eff_u32(tx).numpy().astype(np.uint32), ref_fp._eff_u32(x))
    assert np.array_equal(u64._u32_to_i8_planes(x), ref_fp._u32_to_i8_planes(x))
    planes = rng.integers(-127 * 5000, 127 * 5000, (512, 4)).astype(np.int64)
    want = ref_fp._combine_planes_u32(planes.astype(np.int32))
    got = u64._combine_planes_u32(torch.from_numpy(planes)).numpy().astype(np.uint32)
    assert np.array_equal(got, want)
