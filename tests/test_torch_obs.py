"""The port's run record against the reference's on the CPU: the flight
recorder (``tla_raft_tpu_torch/obs/telemetry.py``) and its hooks on the
main path, the progress line and its ETA math, the Chrome-trace export, the
``obs`` tools, the ``--profile`` window (``analysis/devprof.py``) and the
CLI's ``--log`` / ``--progress`` / ``--telemetry`` / ``--workers``.

The reference's ``run_check`` and the port's ``run_check(device="cpu")``
run the same small config with run dirs: their ``level_commit`` events
carry the same (level, n_new, distinct, generated, slab_cap), their
``run_end`` events agree, and each package's reader reads the other's
``events.jsonl``.  Telemetry on and off give the same counts, reads and
launches; both packages heal the same torn tails the same way.  Every
compared output is an integer or a string: equality is exact."""

import torch_threads  # noqa: F401  (one torch thread a worker)
import contextlib
import glob
import io
import json
import os
import shutil

import numpy as np
import pytest

import tla_raft_tpu.check as ref_check
from tla_raft_tpu.config import RaftConfig as RefConfig
from tla_raft_tpu.obs import progress as ref_progress
from tla_raft_tpu.obs import telemetry as ref_tel
from tla_raft_tpu_torch import check, kernels, resilience
from tla_raft_tpu_torch import device as D
from tla_raft_tpu_torch.config import RaftConfig
from tla_raft_tpu_torch.obs import metrics as obs_metrics
from tla_raft_tpu_torch.obs import progress
from tla_raft_tpu_torch.obs import telemetry as tel
from tla_raft_tpu_torch.obs import tracefile
from tla_raft_tpu_torch.obs.__main__ import main as obs_main
from tla_raft_tpu_torch.obs.__main__ import summarize_events
from tla_raft_tpu_torch.resilience import faults

S2 = (2, 1, 1, 1)
S2_ARGS = ["--servers", "2", "--vals", "1", "--max-election", "1", "--max-restart", "1"]
# the port's arms of the single-device engine: supersteps (the default), the
# per-level fused program, the staged chain
ARMS = {"default": {}, "fused": dict(superstep=1), "staged": dict(megakernel=False)}


def _commits(events) -> list:
    return [(e["level"], e["n_new"], e["distinct"], e["generated"], e["slab_cap"])
            for e in events if e["ev"] == "level_commit"]


def _of(events, kind) -> list:
    return [e for e in events if e["ev"] == kind]


def _strip(e: dict) -> dict:
    return {k: v for k, v in e.items() if k not in ("t", "wall")}


_RUNS: dict = {}


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """arm -> (reference summary, its run dir, port summary, its run dir),
    each arm run once a module, on first use."""

    def get(arm):
        if arm not in _RUNS:
            kw = ARMS[arm]
            rd = str(tmp_path_factory.mktemp(f"ref_{arm}"))
            pd = str(tmp_path_factory.mktemp(f"port_{arm}"))
            ref = ref_check.run_check(RefConfig(*S2), chunk=64, checkpoint_dir=rd,
                                      telemetry=True, **kw)
            port = check.run_check(RaftConfig(*S2), chunk=64, checkpoint_dir=pd, device="cpu",
                                   telemetry=True, **kw)
            _RUNS[arm] = (ref, rd, port, pd)
        return _RUNS[arm]

    return get


def _events(d: str, reader=tel) -> list:
    events, dropped = reader.read_events(os.path.join(d, tel.EVENTS_NAME))
    assert dropped == 0
    return events


# -- event parity with the reference ---------------------------------------------------


@pytest.mark.parametrize("arm", sorted(ARMS))
def test_level_commit_events_equal_the_references(runs, arm):
    """The same (level, n_new, distinct, generated, slab_cap) a level on
    every arm, the slab's capacity included (the port keeps the
    reference's slab layout and growth)."""
    ref, rd, port, pd = runs(arm)
    want, got = _commits(_events(rd, ref_tel)), _commits(_events(pd))
    assert got == want and len(got) == port["depth"] == 12
    assert [c[1] for c in got] == port["level_sizes"][1:]


@pytest.mark.parametrize("arm", sorted(ARMS))
def test_run_begin_and_run_end_agree(runs, arm):
    ref, rd, port, pd = runs(arm)
    rev, pev = _events(rd, ref_tel), _events(pd)
    assert [_strip(e) for e in _of(pev, "run_end")] == [_strip(e) for e in _of(rev, "run_end")]
    assert _of(pev, "run_end")[0]["distinct"] == port["distinct"] == ref["distinct"] == 50
    rb, pb = _of(rev, "run_begin")[0], _of(pev, "run_begin")[0]
    assert (pb["config"], pb["mesh"], pb["recover"]) == (rb["config"], rb["mesh"], rb["recover"])
    # levels opened before they commit, ascending; superstep windows paired
    assert [e["level"] for e in _of(pev, "level_begin")] == sorted(
        {e["level"] for e in _of(pev, "level_begin")})
    assert len(_of(pev, "superstep_begin")) == len(_of(pev, "superstep_commit")) == (
        port.get("superstep_stats", {}).get("supersteps", 0))


@pytest.mark.parametrize("arm", sorted(ARMS))
def test_each_package_reads_the_others_stream(runs, arm):
    """Each line carries its CRC the same way: the reference's reader reads
    the port's ``events.jsonl`` whole and the port's the reference's."""
    _ref, rd, _port, pd = runs(arm)
    for d in (rd, pd):
        path = os.path.join(d, tel.EVENTS_NAME)
        a, b = ref_tel.read_events(path), tel.read_events(path)
        assert a == b and a[1] == 0 and len(a[0]) > 20
        with open(path) as fh:
            lines = fh.read().splitlines()
        assert [tel.decode_line(x) for x in lines] == [ref_tel.decode_line(x) for x in lines]
        assert all(tel.encode_event(ref_tel.decode_line(x)) == x for x in lines)


@pytest.mark.parametrize("arm", sorted(ARMS))
def test_hub_snapshot_agrees_with_the_stream(runs, arm):
    """The ``--json`` ``telemetry`` block and ``obs report``'s post-hoc
    totals read the same bookkeeping."""
    _ref, _rd, port, pd = runs(arm)
    t, rep = port["telemetry"], summarize_events(_events(pd))["totals"]
    assert t["levels"] == rep["levels"] == port["depth"]
    assert len(t["level_seconds"]) == len(t["dispatches_per_level"]) == t["levels"]
    assert (t["dispatches"], t["fetches"], t["checkpoints"]) == (
        rep["dispatches"], rep["fetches"], rep["checkpoints"])
    assert t["level_new"] == port["level_sizes"][1:]
    assert t["checkpoints"] >= port["depth"] and t["file"] == os.path.join(pd, "events.jsonl")
    assert t["slab_cap"] > 0 and "hslab" in port["hbm"]["buffers"]
    if arm == "default":
        # one graph launch and one read a superstep window
        assert t["dispatches"] == t["fetches"] == t["supersteps"] < t["levels"]
    else:
        assert t["supersteps"] == 0 and t["fetches"] >= t["levels"]


def test_hooks_are_no_ops_without_a_hub():
    assert tel.current() is None
    tel.dispatch("x")
    tel.level_commit(1, 1, 1, 1)
    tel.fetch_done(0.1, 8)
    assert tel.current() is None


# -- telemetry on and off --------------------------------------------------------------


def _run_arm(on: bool, kw: dict, d=None):
    D.READS.clear()
    kernels.reset_launches()
    s = check.run_check(RaftConfig(*S2), chunk=64, device="cpu", telemetry=on,
                        checkpoint_dir=d, **kw)
    chk = s["_chk"]
    return dict(counts=(s["ok"], s["distinct"], s["generated"], s["depth"], s["level_sizes"]),
                reads=dict(D.READS), launches=kernels.launch_counts(),
                launch_log=[list(x) for x in chk.graph_stats["launch_log"]],
                routes=dict(chk.routes), redos=dict(chk.redos),
                telemetry="telemetry" in s)


@pytest.mark.parametrize("arm", sorted(ARMS))
def test_telemetry_on_and_off_make_the_same_run(tmp_path, arm):
    """With the recorder on (a run dir) and off: the same counts, level
    sizes, counted reads, launches, routes and redos."""
    on = _run_arm(True, ARMS[arm], str(tmp_path / "on"))
    off = _run_arm(False, ARMS[arm])
    assert on.pop("telemetry") and not off.pop("telemetry")
    assert on == off
    assert on["counts"][1:4] == (50, 97, 12) and sum(on["reads"].values()) > 0


def test_telemetry_env_turns_it_off(monkeypatch, tmp_path):
    """``TLA_RAFT_TELEMETRY=0`` is the default's off switch; without a
    checkpoint dir ``TLA_RAFT_TELEMETRY_DIR`` names the run dir."""
    monkeypatch.setenv("TLA_RAFT_TELEMETRY", "0")
    s = check.run_check(RaftConfig(*S2), chunk=64, device="cpu", max_depth=3)
    assert "telemetry" not in s and s["_hub"] is None
    monkeypatch.delenv("TLA_RAFT_TELEMETRY")
    monkeypatch.setenv("TLA_RAFT_TELEMETRY_DIR", str(tmp_path))
    s = check.run_check(RaftConfig(*S2), chunk=64, device="cpu", max_depth=3)
    assert s["telemetry"]["file"] == str(tmp_path / "events.jsonl")
    assert _commits(_events(str(tmp_path)))[-1][:2] == (3, 1)


def test_an_outer_hub_is_used_and_left_open(tmp_path):
    """A hub installed by the caller records the run and stays installed."""
    with tel.TelemetryHub(run_dir=str(tmp_path)) as hub:
        s = check.run_check(RaftConfig(*S2), chunk=64, device="cpu", max_depth=4)
        assert tel.current() is hub and s["_hub"] is hub
    assert tel.current() is None
    assert [c[0] for c in _commits(_events(str(tmp_path)))] == [1, 2, 3, 4]


# -- torn tails -----------------------------------------------------------------------


def _stream(n: int = 5) -> bytes:
    lines = [tel.encode_event(dict(t=0.5 * i, ev="level_commit", level=i + 1, n_new=10 * i,
                                   distinct=1 + i, generated=2 * i, slab_cap=0))
             for i in range(n)]
    return ("\n".join(lines) + "\n").encode()


TORN = {
    "clean": lambda b: b,
    "torn_line": lambda b: b + b'{"t":9.9,"ev":"level_commit","n_new":',
    "corrupt_interior": lambda b: b[:20] + b"X" + b[21:],
    "unterminated": lambda b: b.rstrip(b"\n"),
    "blank_lines": lambda b: b.replace(b"\n", b"\n\n", 2),
    "garbage_tail": lambda b: b + b"\x00\xff not json\n",
}


@pytest.mark.parametrize("case", sorted(TORN))
def test_torn_tails_heal_as_the_references(tmp_path, case):
    """Both packages read the same events from a torn stream, heal it to
    the same bytes, and a resumed port hub appends after the last good
    line (tests/test_obs.py:84's cases, and more)."""
    data = TORN[case](_stream())
    a, b = tmp_path / "a.jsonl", tmp_path / "b.jsonl"
    a.write_bytes(data)
    b.write_bytes(data)
    assert tel.read_events(str(a)) == ref_tel.read_events(str(b))
    assert tel._heal_tail(str(a)) == ref_tel._heal_tail(str(b))
    assert a.read_bytes() == b.read_bytes()
    events, dropped = tel.read_events(str(a))
    assert dropped == 0
    with tel.TelemetryHub(path=str(a)) as hub:
        hub.emit("run_begin")
    assert hub.healed_lines == 0
    after, dropped = ref_tel.read_events(str(a))
    assert dropped == 0 and after[:-1] == events and after[-1]["ev"] == "run_begin"
    # the resumed hub's clock starts past the stream's last timestamp
    assert after[-1]["t"] >= max([e["t"] for e in events] or [0.0])


def test_rotation_is_followed_by_both_readers(tmp_path):
    """Past ``TLA_RAFT_TELEMETRY_BYTES`` the stream rotates at a level
    boundary; both readers splice the chain oldest first."""
    path = str(tmp_path / "events.jsonl")
    with tel.TelemetryHub(path=path, max_bytes=400) as hub:
        for i in range(12):
            tel.level_commit(i + 1, i, i, i)
    assert hub.rotations >= 2 and len(tel.rotated_paths(path)) == hub.rotations
    got, ref = tel.read_events(path), ref_tel.read_events(path)
    assert got == ref and [e["level"] for e in got[0]] == list(range(1, 13))


# -- the CLI ------------------------------------------------------------------------


def _cli(tmp_path, args, name="port", ref=False):
    """One in-process CLI run with ``--log``: (rc, stdout, stderr, log text)."""
    log = tmp_path / f"{name}.log"
    out, err = io.StringIO(), io.StringIO()
    main = ref_check.main if ref else check.main
    with contextlib.redirect_stdout(out), contextlib.redirect_stderr(err):
        rc = main(list(args) + ["--log", str(log)])
    return rc, out.getvalue(), err.getvalue(), log.read_text()


def _verdict_lines(out: str) -> list:
    keep = ("Model checking completed", "Error:", "states generated",
            "The probability of a fingerprint collision")
    return [x for x in out.splitlines() if x.startswith(keep) or "states generated" in x]


def _stable(out: str) -> list:
    """The output without its times (the Finished line, the rates of the
    Progress lines, the --json line's seconds and telemetry blocks)."""
    lines = []
    for x in out.splitlines():
        if x.startswith("Finished in"):
            continue
        if x.startswith("Progress: level"):
            x = x.rsplit(", ", 1)[0]
        if x.startswith("{"):
            doc = json.loads(x)
            x = {k: v for k, v in doc.items() if k not in ("seconds", "telemetry", "hbm")}
        lines.append(x)
    return lines


@pytest.fixture(scope="module")
def cfg_file(tmp_path_factory):
    from test_cfgparse import REFERENCE_CFG

    p = tmp_path_factory.mktemp("cfg") / "Raft.cfg"
    p.write_text(REFERENCE_CFG)
    return p


@pytest.fixture(scope="module")
def cli_base(cfg_file, tmp_path_factory):
    """The reference's CLI and the port's plain CLI run once a module."""
    d = tmp_path_factory.mktemp("cli")
    args = ["--config", str(cfg_file), *S2_ARGS, "--json"]
    ref = _cli(d, args, "ref", ref=True)
    port = _cli(d, args + ["--device", "cpu", "--chunk", "64"])
    return args, ref, port


@pytest.mark.parametrize("flags", [[], ["--workers", "4"], ["--progress"],
                                   ["--telemetry", "0"], ["--progress", "--telemetry", "0"]],
                         ids=["plain", "workers", "progress", "telemetry-0", "progress-off"])
def test_cli_log_is_stdout_and_the_verdict_is_the_references(cli_base, tmp_path, flags):
    """``--log`` holds what stdout shows; the verdict, count and collision
    lines equal the reference CLI's on the same cfg; ``--workers 4``,
    ``--progress`` and ``--telemetry 0`` change nothing else (``--progress``
    adds the live line on stderr; the Progress lines stay in the log)."""
    args, (rrc, rout, _rerr, rlog), (prc, pout, _perr, plog) = cli_base
    rc, out, err, log = _cli(tmp_path, args + ["--device", "cpu", "--chunk", "64"] + flags)
    assert rc == prc == rrc == 0
    assert log == out and plog == pout and rlog == rout
    assert _verdict_lines(out) == _verdict_lines(rout) and len(_verdict_lines(out)) == 3
    assert _stable(out) == _stable(pout)
    assert sum(x.startswith("Progress: level") for x in log.splitlines()) == 12
    assert ("ETA" in err and "level 12" in err) == ("--progress" in flags)
    summary = json.loads(out.strip().splitlines()[-1])
    assert ("telemetry" in summary) == ("--telemetry" not in flags)


def _preempt(monkeypatch):
    monkeypatch.setattr(resilience, "install_signal_handlers", lambda: None)
    resilience.request_preempt()


@pytest.mark.parametrize("case,rc,needle", [
    ("refusal", 2, "requires --mesh N"),
    ("preempted", 75, "Resume with --recover"),
    ("integrity", 4, "Integrity fail-stop: audit mismatch"),
])
def test_every_exit_lands_in_the_log(tmp_path, monkeypatch, case, rc, needle):
    """Refusals (2), a preemption (75) and an integrity fail-stop (4) print
    into the log as well as stdout."""
    args = S2_ARGS + ["--device", "cpu", "--chunk", "64"]
    if case == "refusal":
        args += ["--mesh-deep"]
    elif case == "preempted":
        args += ["--checkpoint-dir", str(tmp_path / "ck")]
        _preempt(monkeypatch)
    else:
        args += ["--audit", "8", "--fault", "tensor.flip:flip@4"]
    try:
        got, out, _err, log = _cli(tmp_path, args)
    finally:
        resilience.clear_preempt()
        faults.reset()
    assert got == rc and needle in out and log == out


# -- the obs tools -------------------------------------------------------------------


def test_obs_report(runs, capsys):
    _ref, _rd, port, pd = runs("default")
    assert obs_main(["report", pd]) == 0
    out = capsys.readouterr().out
    assert f"{port['depth']} levels, 50 distinct" in out and "totals:" in out
    assert obs_main(["report", pd, "--json"]) == 0
    rep = json.loads(capsys.readouterr().out)
    assert [lv["n_new"] for lv in rep["levels"]] == port["level_sizes"][1:]
    assert obs_main(["report", pd, runs("staged")[3]]) == 0
    assert "== compare (run vs baseline) ==" in capsys.readouterr().out
    assert obs_main(["report", str(pd) + "/nothing"]) == 2


def _check_trace(doc: dict, depth: int) -> None:
    per_tid_open, levels = {}, set()
    for e in doc["traceEvents"]:
        if e["ph"] == "M" or e.get("pid", 1) >= tracefile.DEVICE_PID_BASE:
            continue
        assert e["ts"] >= 0
        if e["ph"] == "X":
            assert e["dur"] >= 0
            if e["tid"] == 1 and e["name"].startswith("level "):
                levels.add(int(e["name"].split()[1]))
        elif e["ph"] in ("B", "E"):
            per_tid_open[e["tid"]] = per_tid_open.get(e["tid"], 0) + (1 if e["ph"] == "B" else -1)
            assert per_tid_open[e["tid"]] >= 0
    assert all(v == 0 for v in per_tid_open.values())
    assert levels == set(range(1, depth + 1))


@pytest.mark.parametrize("arm", sorted(ARMS))
def test_obs_trace(runs, tmp_path, capsys, arm):
    """``obs trace`` writes Perfetto-valid JSON: matched B/E pairs,
    non-negative times, every committed level on the level track."""
    _ref, _rd, port, pd = runs(arm)
    out = tmp_path / "trace.json"
    assert obs_main(["trace", pd, "-o", str(out)]) == 0
    assert "trace events" in capsys.readouterr().out
    _check_trace(json.loads(out.read_text()), port["depth"])


def test_obs_metrics(tmp_path, capsys):
    m = obs_metrics.Metrics()
    m.counter("jobs_done").inc(2)
    m.commit(str(tmp_path))
    assert obs_main(["metrics", str(tmp_path)]) == 0
    assert "jobs_done" in capsys.readouterr().out
    assert obs_main(["metrics", str(tmp_path / "none")]) == 2


@pytest.fixture(scope="module")
def profiled(tmp_path_factory):
    d = str(tmp_path_factory.mktemp("profiled"))
    out = io.StringIO()
    s = check.run_check(RaftConfig(*S2), chunk=64, device="cpu", checkpoint_dir=d, profile=1,
                        out=out)
    return s, d, out.getvalue()


def test_profile_window_on_the_cpu(profiled, runs):
    """``--profile 1``: ``profile_begin``/``profile_end`` around one window
    (a superstep's read), the trace beside them, the counts the run's."""
    s, d, out = profiled
    events = _events(d)
    begin, end = _of(events, "profile_begin"), _of(events, "profile_end")
    assert len(begin) == len(end) == 1 and end[0]["windows"] == 1
    assert begin[0]["file"] == os.path.join(d, "profile", "torch_trace.0.json")
    assert os.path.exists(begin[0]["file"]) and "Profiler: capturing 1" in out
    assert s["telemetry"]["profile_windows"] == 1
    port = runs("default")[2]
    assert [s[k] for k in ("distinct", "generated", "level_sizes")] == [
        port[k] for k in ("distinct", "generated", "level_sizes")]


def test_profile_lanes_merge_on_the_hub_clock(profiled, tmp_path):
    """The profiler's lanes merge beside the host lanes: its anchor marker
    lands on the ``profile_begin`` event's time; copying the run dir
    elsewhere still finds the capture."""
    _s, d, _out = profiled
    moved = tmp_path / "moved"
    shutil.copytree(d, moved)
    os.remove(moved / "profile" / "torch_trace.0.json")
    shutil.copy(os.path.join(d, "profile", "torch_trace.0.json"), moved / "profile")
    for run_dir in (d, str(moved)):
        out = str(tmp_path / "t.json")
        st = tracefile.export(os.path.join(run_dir, "events.jsonl"), out, run_dir=run_dir)
        assert st["device_events"] > 0 and st["device_dropped"] == 0
        doc = json.load(open(out))
        begin = next(e for e in doc["traceEvents"] if e["name"] == "profiler start")
        anchor = [e for e in doc["traceEvents"] if e["name"] == begin["args"]["anchor"]]
        assert len(anchor) == 1 and anchor[0]["pid"] >= tracefile.DEVICE_PID_BASE
        assert abs(anchor[0]["ts"] - begin["ts"]) <= 1


@pytest.mark.parametrize("telemetry,ckdir,needle", [
    (True, False, "--profile needs --checkpoint-dir"),
    (False, True, "--profile needs telemetry on"),
])
def test_profile_refusals_are_the_references(tmp_path, telemetry, ckdir, needle):
    out = io.StringIO()
    s = check.run_check(RaftConfig(*S2), chunk=64, device="cpu", max_depth=3, profile=2,
                        telemetry=telemetry, out=out,
                        checkpoint_dir=str(tmp_path / "ck") if ckdir else None)
    assert needle in out.getvalue() and s["depth"] == 3
    assert not glob.glob(str(tmp_path / "**" / "torch_trace*"), recursive=True)


# -- the progress line ------------------------------------------------------------------


def _sizes(seed: int) -> list:
    g = np.random.default_rng(seed)
    n = int(g.integers(1, 30))
    up = np.cumprod(g.uniform(1.0, 3.0, n // 2 + 1))
    down = up[-1] * np.cumprod(g.uniform(0.2, 1.0, n - n // 2))
    out = [int(x) for x in np.concatenate([up, down])][:n]
    if seed % 3 == 0:
        out[g.integers(0, n)] = 0  # a zero level is skipped by the forecast
    return out


@pytest.mark.parametrize("seed", range(8))
def test_eta_math_equals_the_references(seed):
    sizes = _sizes(seed)
    rate = float(np.random.default_rng(100 + seed).uniform(1, 1e6))
    for k in range(len(sizes) + 1):
        pre = sizes[:k]
        assert progress.forecast_remaining_states(pre) == ref_progress.forecast_remaining_states(
            pre)
        eta = progress.eta_seconds(pre, rate)
        assert eta == ref_progress.eta_seconds(pre, rate)
        assert progress.fmt_eta(eta) == ref_progress.fmt_eta(eta)


def test_progress_line_renders_as_the_references(runs):
    snap = runs("default")[2]["telemetry"]
    a, b = progress.ProgressLine(stream=io.StringIO()), ref_progress.ProgressLine(
        stream=io.StringIO())
    for i, n in enumerate(_sizes(5)):
        stats = dict(level=i + 1, frontier=n, distinct=10 * n + i, generated=20 * n,
                     elapsed=0.5 + i)
        assert a.update(stats, snap=snap) == b.update(stats, snap=snap)
    assert "lvl/disp" in a.last_line and "slab" in a.last_line
    a.write(stats, snap=snap)
    a.clear()
    a.done()
    assert a.stream.getvalue().endswith("\r")


# -- resume -----------------------------------------------------------------------


def _deltas(d: str) -> list:
    out = []
    for f in sorted(glob.glob(os.path.join(d, "delta_*.npz"))):
        with np.load(f) as z:
            out.append((os.path.basename(f), {k: z[k].copy() for k in z.files}))
    return out


def test_resume_with_a_stream_gives_the_same_delta_records(runs, tmp_path):
    """A run stopped at depth 6, its ``events.jsonl`` torn, then resumed
    from its directory: the uninterrupted run's delta records; the stream
    healed, monotonic, two ``run_begin`` anchors and every level committed
    once."""
    _ref, _rd, port, pd = runs("default")
    d = str(tmp_path / "ck")
    check.run_check(RaftConfig(*S2), chunk=64, device="cpu", checkpoint_dir=d, max_depth=6)
    with open(os.path.join(d, tel.EVENTS_NAME), "ab") as fh:
        fh.write(b'{"t":1.0,"ev":"level_com')
    s = check.run_check(RaftConfig(*S2), chunk=64, device="cpu", checkpoint_dir=d, recover=d)
    assert s["level_sizes"] == port["level_sizes"]
    want, got = _deltas(pd), _deltas(d)
    assert [n for n, _ in got] == [n for n, _ in want]
    for (n, x), (_, y) in zip(want, got):
        assert sorted(x) == sorted(y) and all(np.array_equal(x[k], y[k]) for k in x), n
    events = _events(d)
    ts = [e["t"] for e in events]
    assert ts == sorted(ts) and len(_of(events, "run_begin")) == 2
    assert [c[0] for c in _commits(events)] == list(range(1, 13))
    assert [_strip(e) for e in _of(events, "run_begin")][1]["recover"] is True
