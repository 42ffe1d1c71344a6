"""Checkpoint integrity: digests, per-directory manifests, atomic writes
(the port's copy of ``tla_raft_tpu/resilience/manifest.py``, with the same
bytes, digests and manifest schema, so either package verifies the other's
directories).

Every checkpoint artifact this project writes (``delta_*.npz`` +
``hslab.npz``, ``partial_*.npz``, ``mdelta_*.npz`` + ``sieve_slab.npz``,
monoliths) commits through ONE helper — :func:`commit_npz` — which:

1. writes the payload to ``.tmp_<name>`` in the target directory,
2. digests the tmp bytes (xxh64 when the interpreter carries the
   xxhash wheel, else hashlib's blake2b truncated to 64 bits — the
   algorithm rides in the manifest entry, so mixed-environment dirs
   verify correctly),
3. ``os.replace``-renames tmp -> final (atomic on POSIX),
4. records ``{digest, algo, bytes, kind, depth}`` in the directory's
   ``MANIFEST.json`` and commits THAT atomically too.

The manifest is the durability layer's source of trust, not of truth:
a record that fails its digest is quarantined and the run resumes from
the surviving contiguous prefix (resilience/recover.py); the replay
chain itself remains the only authority on contents.  Besides the
artifact table the manifest pins a **schema version**, the **run
config fingerprint** (a digest of the semantic run configuration —
spec constants, fingerprint definition, mesh width, exchange/canon
mode; NOT tunables like chunk size), so two different runs can never
silently interleave their logs in one directory, and a **contiguous-
depth watermark** — the deepest level whose whole record prefix is
manifested — maintained incrementally and recomputed after healing.

Fault-injection sites (resilience/faults.py) fire between every pair
of steps above, which is what makes the crash matrix in
the crash-matrix tests exhaustive per artifact kind.
"""

from __future__ import annotations

import hashlib
import json
import os
import re
import time

import numpy as np

from ..obs import telemetry as _obs
from . import faults

SCHEMA_VERSION = 1


MANIFEST_NAME = "MANIFEST.json"
TMP_PREFIX = ".tmp_"

try:  # the baked image may or may not carry the xxhash wheel; gate it
    import xxhash as _xxhash
except ImportError:  # pragma: no cover - environment-dependent
    _xxhash = None

_DIGEST_CHUNK = 8 << 20


def _hasher(algo: str | None = None):
    """(algo_name, hasher) — prefer xxh64, fall back to blake2b/64."""
    if algo in (None, "xxh64") and _xxhash is not None:
        return "xxh64", _xxhash.xxh64()
    if algo == "xxh64":  # recorded by an env that had the wheel
        raise LookupError("xxh64 unavailable")
    return "blake2b64", hashlib.blake2b(digest_size=8)


def digest_file(path: str, algo: str | None = None) -> tuple[str, str]:
    """Streamed digest of a file's bytes: (algo, hexdigest)."""
    name, h = _hasher(algo)
    with open(path, "rb") as fh:
        while True:
            chunk = fh.read(_DIGEST_CHUNK)
            if not chunk:
                break
            h.update(chunk)
    return name, h.hexdigest()


def run_config_fingerprint(cfg, **extra) -> str:
    """Digest of the SEMANTIC run configuration.

    Covers the spec constants (every RaftConfig field) plus whatever
    the engine passes in ``extra`` (engine kind, fingerprint
    definition, mesh width, exchange/canon modes).  Deliberately
    excludes tunables (chunk, cap_x, seg_rows): a resume may retune
    them freely without invalidating the log.
    """
    import dataclasses

    doc = dict(dataclasses.asdict(cfg))
    doc.update(extra)
    blob = json.dumps(doc, sort_keys=True, default=str).encode()
    name, h = _hasher()
    h.update(blob)
    return f"{name}:{h.hexdigest()}"


class RunMismatch(ValueError):
    """The directory's manifest belongs to a different run config."""


# parsed-manifest cache keyed by (mtime_ns, size): the per-group
# partial writer and per-level delta/hslab writers each load-commit the
# same file many times per level — without the cache that is a fresh
# JSON parse of every accumulated entry per commit (quadratic over a
# level's groups).  Entry dicts are never mutated in place (record()
# replaces them wholesale), so shallow copies keep cache and instances
# independent.
_DOC_CACHE: dict[str, tuple[tuple[int, int], dict]] = {}


def _stat_key(path: str) -> tuple[int, int]:
    st = os.stat(path)
    return (st.st_mtime_ns, st.st_size)


class Manifest:
    """The per-checkpoint-directory integrity ledger."""

    def __init__(self, ckdir: str):
        self.ckdir = ckdir
        self.path = os.path.join(ckdir, MANIFEST_NAME)
        self.exists = False
        self.schema = SCHEMA_VERSION
        self.run_fp: str | None = None
        self.watermark = 0
        self.artifacts: dict[str, dict] = {}

    @classmethod
    def load(cls, ckdir: str) -> "Manifest":
        m = cls(ckdir)
        try:
            key = _stat_key(m.path)
        except OSError:
            return m
        cached = _DOC_CACHE.get(m.path)
        if cached is not None and cached[0] == key:
            data = cached[1]
        else:
            try:
                with open(m.path, encoding="utf-8") as fh:
                    data = json.load(fh)
            except (OSError, ValueError):
                # a torn manifest is recoverable state, not a fatal
                # error: treat the directory as legacy/unmanifested and
                # let the healer rebuild the ledger from what verifies
                return m
            _DOC_CACHE[m.path] = (key, data)
        m.exists = True
        m.schema = int(data.get("schema", SCHEMA_VERSION))
        m.run_fp = data.get("run_fp")
        m.watermark = int(data.get("watermark", 0))
        m.artifacts = dict(data.get("artifacts", {}))
        return m

    # -- mutation ------------------------------------------------------

    def bind_run(self, run_fp: str | None,
                 accept: tuple[str, ...] = ()):
        """Pin (or check) the directory's run config fingerprint.

        ``accept`` lists LEGACY fingerprint variants of the same
        semantic run (fields since removed from the digest — e.g. the
        mesh device count, dropped when resume went elastic): a
        manifest bound to one of them MIGRATES to ``run_fp`` in place
        instead of refusing a valid log.  The rebinding persists on the
        next commit (every heal/append commits)."""
        if run_fp is None:
            return
        if self.run_fp is None or self.run_fp in accept:
            self.run_fp = run_fp
        elif self.run_fp != run_fp:
            raise RunMismatch(
                f"{self.ckdir} was checkpointed by a different run "
                f"configuration (manifest {self.run_fp}, this run "
                f"{run_fp}) — two runs' logs must not interleave; "
                "clear the directory or resume with the matching "
                "configuration"
            )

    def record(self, name: str, *, kind: str, depth: int, algo: str,
               digest: str, nbytes: int):
        self.artifacts[name] = dict(
            kind=kind, depth=int(depth), algo=algo, digest=digest,
            bytes=int(nbytes),
        )
        if kind in ("delta", "mdelta"):
            self.watermark = self._contiguous_depth()

    def forget(self, name: str):
        if self.artifacts.pop(name, None) is not None:
            self.watermark = self._contiguous_depth()

    def _contiguous_depth(self) -> int:
        depths = sorted(
            e["depth"] for e in self.artifacts.values()
            if e.get("kind") in ("delta", "mdelta")
        )
        if not depths:
            return 0
        hi = depths[0]
        for d in depths[1:]:
            if d != hi + 1:
                break
            hi = d
        return hi

    def commit(self):
        """Atomically persist the ledger."""
        tmp = os.path.join(self.ckdir, TMP_PREFIX + MANIFEST_NAME)
        doc = dict(
            schema=self.schema,
            run_fp=self.run_fp,
            watermark=self.watermark,
            artifacts=dict(sorted(self.artifacts.items())),
        )
        os.makedirs(self.ckdir, exist_ok=True)
        with open(tmp, "w", encoding="utf-8") as fh:
            json.dump(doc, fh, indent=1)
            fh.write("\n")
        faults.fire("manifest.commit", tmp)
        os.replace(tmp, self.path)
        self.exists = True
        try:
            _DOC_CACHE[self.path] = (
                _stat_key(self.path),
                dict(doc, artifacts=dict(doc["artifacts"])),
            )
        except OSError:  # racing unlink: just drop the cache entry
            _DOC_CACHE.pop(self.path, None)

    # -- verification --------------------------------------------------

    def verify(self, name: str) -> str:
        """One artifact's integrity status.

        ``ok``           digest matches (or legacy dir: readable file)
        ``missing``      manifested but not on disk
        ``unmanifested`` on disk but unknown to a manifest that exists
        ``corrupt``      digest mismatch or unreadable npz
        """
        path = os.path.join(self.ckdir, name)
        entry = self.artifacts.get(name)
        on_disk = os.path.exists(path)
        if not on_disk:
            return "missing" if entry is not None else "unmanifested"
        if entry is None:
            if not self.exists:
                # legacy (pre-manifest) directory: fall back to a
                # structural read check so torn zips still quarantine
                return "ok" if npz_readable(path) else "corrupt"
            return "unmanifested"
        try:
            algo, dig = digest_file(path, entry.get("algo"))
        except LookupError:
            # recorded with a digest algo this interpreter lacks:
            # keep the record if it is structurally readable
            return "ok" if npz_readable(path) else "corrupt"
        if dig != entry.get("digest"):
            return "corrupt"
        return "ok"


def npz_readable(path: str) -> bool:
    import zipfile

    try:
        with np.load(path) as z:
            for k in z.files:
                z[k]
        return True
    except (OSError, ValueError, KeyError, EOFError, zipfile.BadZipFile):
        return False


def commit_npz(
    ckdir: str,
    name: str,
    arrays: dict,
    *,
    kind: str,
    depth: int = -1,
    run_fp: str | None = None,
    compressed: bool = False,
    manifest: bool = True,
) -> str:
    """The one atomic checkpoint writer (see module docstring).

    Every checkpoint producer of the port routes through here: no other
    module writes a checkpoint with ``np.savez``/``os.replace``.
    """
    t0 = time.monotonic()
    os.makedirs(ckdir, exist_ok=True)
    tmp = os.path.join(ckdir, TMP_PREFIX + name)
    save = np.savez_compressed if compressed else np.savez
    save(tmp, **arrays)
    faults.fire(f"{kind}.tmp", tmp)
    algo, dig = digest_file(tmp)
    nbytes = os.path.getsize(tmp)
    final = os.path.join(ckdir, name)
    os.replace(tmp, final)
    faults.fire(f"{kind}.commit", final)
    if manifest:
        m = Manifest.load(ckdir)
        m.bind_run(run_fp)
        m.record(name, kind=kind, depth=depth, algo=algo, digest=dig,
                 nbytes=nbytes)
        m.commit()
    _obs.checkpoint(kind, name, time.monotonic() - t0, nbytes)
    return final


def commit_json(
    ckdir: str,
    name: str,
    doc: dict,
    *,
    kind: str,
    depth: int = -1,
    run_fp: str | None = None,
    manifest: bool = True,
) -> str:
    """The atomic JSON twin of :func:`commit_npz`.

    The sweep service's queue records (job specs, state transitions,
    leases, result summaries) are JSON documents, not arrays — but they
    are checkpoint artifacts all the same: a torn ``state.json`` is a
    stuck job, a torn ``result.json`` is a lost verdict.  Same steps:
    tmp write -> digest -> ``os.replace`` -> manifest entry, with the
    same ``<kind>.tmp`` / ``<kind>.commit`` fault sites so the crash
    matrix covers the queue exactly like the delta log.  Pass
    ``manifest=False`` for high-churn records whose loss is benign
    (worker lease heartbeats): the write stays atomic but skips the
    per-directory ledger commit.
    """
    t0 = time.monotonic()
    os.makedirs(ckdir, exist_ok=True)
    tmp = os.path.join(ckdir, TMP_PREFIX + name)
    with open(tmp, "w", encoding="utf-8") as fh:
        json.dump(doc, fh, indent=1, sort_keys=True, default=str)
        fh.write("\n")
    faults.fire(f"{kind}.tmp", tmp)
    algo, dig = digest_file(tmp)
    nbytes = os.path.getsize(tmp)
    final = os.path.join(ckdir, name)
    os.replace(tmp, final)
    faults.fire(f"{kind}.commit", final)
    if manifest:
        m = Manifest.load(ckdir)
        m.bind_run(run_fp)
        m.record(name, kind=kind, depth=depth, algo=algo, digest=dig,
                 nbytes=nbytes)
        m.commit()
    if manifest and kind != "metrics":
        # skip the periodic-housekeeping writers: the metrics snapshot
        # is the telemetry system writing about itself, and
        # manifest=False marks high-churn records (lease heartbeats,
        # every ttl/3 per job from the beater thread) — recording
        # either would grow the event stream one non-progress line per
        # tick forever and inflate the checkpoint aggregates
        _obs.checkpoint(kind, name, time.monotonic() - t0, nbytes)
    return final


def load_json_verified(ckdir: str, name: str):
    """Load a JSON artifact, digest-checked against the directory's
    manifest when an entry exists (``commit_json``'s read side).

    Returns the parsed document, or ``None`` when the file is missing
    OR fails verification/parsing — queue readers treat a torn or
    corrupt record exactly like an absent one (the state machine
    re-derives it from the surviving records; nothing here is the
    source of truth, matching the manifest-layer contract).
    """
    path = os.path.join(ckdir, name)
    m = Manifest.load(ckdir)
    status = m.verify(name)
    if status in ("missing", "corrupt"):
        return None
    if status == "unmanifested" and not os.path.exists(path):
        return None
    try:
        with open(path, encoding="utf-8") as fh:
            return json.load(fh)
    except (OSError, ValueError):
        return None


def adopt_file(ckdir: str, name: str, *, kind: str, depth: int = -1,
               run_fp: str | None = None) -> None:
    """Manifest an artifact that landed by copy rather than through
    :func:`commit_npz` (the ``base.npz`` monolith a delta-appending
    resume anchors into its directory)."""
    path = os.path.join(ckdir, name)
    algo, dig = digest_file(path)
    faults.fire(f"{kind}.commit", path)
    m = Manifest.load(ckdir)
    m.bind_run(run_fp)
    m.record(name, kind=kind, depth=depth, algo=algo, digest=dig,
             nbytes=os.path.getsize(path))
    m.commit()


_DEPTH_RE = re.compile(r"_(\d{4,})\.npz$")


def artifact_depth(name: str) -> int:
    """Level number encoded in a delta/mdelta record name (-1 if none)."""
    m = _DEPTH_RE.search(name)
    return int(m.group(1)) if m else -1
