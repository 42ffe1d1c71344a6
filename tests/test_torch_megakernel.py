"""The port's per-level fused program (engine/megakernel.py, B11) against
the reference's (tla_raft_tpu/engine/megakernel.py) on the CPU, where the
fused level runs its plain twins: whole runs of the ``superstep=1`` arm
against ``JaxChecker(megakernel=True, superstep=1)``, one level from a
carried frontier and slab against ``build_level_program`` (every ctrl
slot, mult, fps/pidx/slot and the slab), every grow-and-redo class, the
staged arm against the reference's staged chain, and the CLI's three
arms.  All outputs are integers: equality is exact."""

import jax.numpy as jnp
import numpy as np
import pytest

import tla_raft_tpu.ops.hashstore as ref_hs
from tla_raft_tpu.config import RaftConfig as RefConfig
from tla_raft_tpu.engine import megakernel as ref_mk
from tla_raft_tpu.engine.bfs import JaxChecker
from tla_raft_tpu_torch import carry
from tla_raft_tpu_torch.config import RaftConfig
from tla_raft_tpu_torch.engine import megakernel as mk
from tla_raft_tpu_torch.engine.bfs import TorchChecker
from tla_raft_tpu_torch.models.raft import Frontier
from tla_raft_tpu_torch.ops import hashstore as hs

S2 = (2, 1, 1, 1)
S3V1 = (3, 1, 1, 1)
CHUNK = {S2: 64, S3V1: 256}


def _port(args, **kw):
    kw.setdefault("chunk", CHUNK[args])
    return TorchChecker(RaftConfig(*args), device="cpu", **kw)


@pytest.fixture(scope="module")
def ref_fused():
    """The reference's per-level fused arm on both configs, run once."""
    out = {}
    for args in (S2, S3V1):
        chk = JaxChecker(RefConfig(*args), chunk=CHUNK[args], megakernel=True, superstep=1)
        out[args] = (chk.run(), dict(chk._mega_stats))
    return out


@pytest.mark.parametrize("args", [S2, S3V1], ids=["s2", "s3v1"])
def test_fused_arm_equals_reference(ref_fused, args):
    ref, ref_stats = ref_fused[args]
    chk = _port(args, superstep=1)
    got = chk.run()
    assert got == ref  # ok, counts, level sizes, no violation, action counts
    assert chk.routes == dict(superstep=0, fused=got.depth, grouped=0, staged=0)
    # every level, the fixpoint-discovery one included, ran fused
    assert chk._mega_stats["levels"] == ref_stats["levels"] == got.depth + 1


@pytest.fixture(scope="module")
def carried_level():
    """The reference's fused arm on (3,1,1,1) to depth 7: the last level's
    parents and slab as it saw them, and its budgets."""
    ref = JaxChecker(RefConfig(*S3V1), chunk=64, megakernel=True, superstep=1)
    calls = []
    orig = ref._expand_level_mega

    def spy(frontier, n_f, max_depth, level_sizes):
        calls.append((frontier, n_f, ref.hstore.slab))
        return orig(frontier, n_f, max_depth, level_sizes)

    ref._expand_level_mega = spy
    ref.run(max_depth=7)
    frontier, n_f, slab = calls[-1]
    return ref, frontier, n_f, slab


@pytest.mark.parametrize("cap_out", [256, 64], ids=["clean", "cap-out-overflow"])
def test_one_level_equals_build_level_program(carried_level, cap_out):
    ref, frontier, n_f, slab = carried_level
    prog_ref = ref_mk.build_level_program(ref, donate=False)
    (new_fr, slab2, ctrl, mult, fps, pidx, slot) = prog_ref(
        frontier, slab, jnp.asarray(n_f, jnp.int64), jnp.zeros((1,), jnp.uint64),
        cap_out=cap_out,
    )
    ctrl = np.asarray(ctrl)
    n_new = int(ctrl[mk.CTRL_N_NEW])

    cap_f = frontier.voted_for.shape[0]
    port = _port(S3V1, chunk=64, cap_x=ref.cap_x, cap_m=ref.cap_m, superstep=1)
    slab_np = np.asarray(slab)
    port.hstore = hs.DeviceHashStore(len(slab_np), int((slab_np != hs.SENT_U64).sum()), "cpu")
    port.hstore.slab = carry.slab(slab_np, "cpu")
    prog = mk.LevelProgram(port, ("test",), cap_f, cap_out, mk.DEFAULT_ROUNDS)
    fr = carry.frontier({f: np.asarray(getattr(frontier, f)) for f in Frontier._fields}, "cpu")
    mk.copy_rows(prog.fr_in, fr, cap_f)
    prog.run(n_f)

    got = prog.ctrl.numpy()
    assert np.array_equal(prog.mult.numpy(), np.asarray(mult))
    assert np.array_equal(prog.fps_out.numpy().view(np.uint64), np.asarray(fps))
    assert np.array_equal(prog.pidx.numpy().view(np.uint32), np.asarray(pidx))
    assert np.array_equal(prog.slot.numpy().view(np.uint16), np.asarray(slot))
    if n_new <= cap_out:
        assert np.array_equal(got, ctrl)  # all 8 slots
        assert np.array_equal(carry.slab_to_numpy(port.hstore.slab), np.asarray(slab2))
        for f in Frontier._fields:
            assert np.array_equal(getattr(prog.fr_out, f).numpy()[:n_new],
                                  np.asarray(getattr(new_fr, f))[:n_new]), f
    else:
        # the port inserts in place and gives an overflowed level's claims
        # back in the same program, so its slab (and live count) is the
        # slab as it was; the reference's pending slab is dropped instead
        keep = [i for i in range(mk.CTRL_LEN) if i != mk.CTRL_SLAB_LIVE]
        assert np.array_equal(got[keep], ctrl[keep])
        assert got[mk.CTRL_SLAB_LIVE] == port.hstore.count
        assert np.array_equal(carry.slab_to_numpy(port.hstore.slab), slab_np)


def test_cap_x_overflow_grows_and_redoes():
    chk = _port(S2, cap_x=16, superstep=1)
    res = chk.run()
    assert (res.distinct, res.generated, res.depth) == (50, 97, 12)
    assert chk._mega_stats["redo_x"] > 0 and chk.cap_x > 16


def test_cap_m_overflow_grows_and_redoes():
    chk = _port(S3V1, cap_m=4, superstep=1)
    res = chk.run()
    assert (res.distinct, res.depth) == (545, 19)
    assert chk._mega_stats["redo_m"] > 0 and chk.cap_m > 4


def test_slab_overflow_grows_and_redoes(monkeypatch):
    """A 16-slot slab that only grows on a probe overflow (the reference's
    MIN_CAP = 16 drill, tests/test_megakernel.py): the fused level gives
    its claims back, grows and redoes, on both packages alike."""
    for mod in (hs, ref_hs):
        monkeypatch.setattr(mod, "MIN_CAP", 16)
        monkeypatch.setattr(mod.DeviceHashStore, "need_grow", lambda self, extra=0: False)
    ref = JaxChecker(RefConfig(*S2), chunk=64, megakernel=True, superstep=1)
    want = ref.run()
    chk = _port(S2, superstep=1)
    got = chk.run()
    assert got == want
    assert chk._mega_stats["redo_slab"] > 0
    assert chk._mega_stats["redo_slab"] == ref._mega_stats["redo_slab"]


def test_cap_out_overflow_redoes_once_exactly(monkeypatch):
    """An under-sized output capacity redoes once, with the exact count."""
    orig = TorchChecker._mega_cap_out

    def tiny_guess(self, n_f, level_sizes, max_depth, n_lanes, floor):
        return orig(self, 1, [1], None, n_lanes, floor)

    monkeypatch.setattr(TorchChecker, "_mega_cap_out", tiny_guess)
    chk = _port(S2, chunk=2, superstep=1)
    res = chk.run()
    assert (res.distinct, res.depth) == (50, 12)
    assert chk._mega_stats["redo_out"] > 0


def test_mat_slice_width_matches_reference():
    for cap_out in (64, 256, 384, 1024, 1536, 3 * 2048, 65536):
        for chunk in (16, 64, 128):
            assert mk.mat_slice_width(cap_out, chunk) == ref_mk.mat_slice_width(cap_out, chunk)


@pytest.fixture(scope="module")
def ref_staged():
    return {args: JaxChecker(RefConfig(*args), chunk=CHUNK[args], megakernel=False,
                             superstep=1).run() for args in (S2, S3V1)}


@pytest.mark.parametrize("args", [S2, S3V1], ids=["s2", "s3v1"])
def test_staged_arm_equals_reference(ref_staged, args):
    chk = _port(args, megakernel=False)
    assert chk.run() == ref_staged[args]
    assert chk.routes["fused"] == chk.routes["superstep"] == 0
    assert chk.graph_stats["programs"] == 0


@pytest.mark.parametrize("arm", [[], ["--superstep", "1"], ["--megakernel", "0"]],
                         ids=["superstep", "fused", "staged"])
def test_cli_three_arms(capsys, arm):
    import json

    from tla_raft_tpu_torch import check

    rc = check.main(["--servers", "2", "--vals", "1", "--max-election", "1",
                     "--max-restart", "1", "--device", "cpu", "--chunk", "256", "--json", *arm])
    assert rc == 0
    summary = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert (summary["distinct"], summary["generated"], summary["depth"]) == (50, 97, 12)
    assert summary["megakernel"] is (arm != ["--megakernel", "0"])
    assert summary["superstep"] == (4 if not arm else 1)
    assert ("superstep_stats" in summary) is (not arm)
    if not arm:
        assert summary["superstep_stats"] == dict(levels=13, ring_stops=0, stops=0,
                                                  supersteps=4)
