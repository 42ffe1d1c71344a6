"""Parser for the TLC model-configuration grammar of the Raft spec.

The port's own copy of ``tla_raft_tpu/cfgparse.py`` (the port imports
nothing of the JAX package; tests/test_torch_settings.py holds the two
equal).  TLC's ``Raft.cfg`` is the single source of truth for constants
and checker directives; this module parses the subset of the TLC
cfg grammar it uses — ``CONSTANTS`` (integer bindings, self-named model
values, set literals), ``SYMMETRY``, ``VIEW``, ``INIT``, ``NEXT``,
``INVARIANT`` — plus ``\\*`` comments, and lowers the result to a
:class:`~tla_raft_tpu_torch.config.RaftConfig`.

Honored quirks of the reference cfg (SURVEY.md §5 "config system"):
  * ``MaxTerm = 3`` (Raft.cfg:2) is vestigial — no ``CONSTANT MaxTerm``
    exists in the spec; it is recorded in ``max_term_cfg`` and never used.
  * ``s4``/``s5`` are declared but absent from ``Servers`` (Raft.cfg:16-17);
    declared-but-unused model values are legal and ignored.
  * the commented ``SYMMETRY symmValues`` (Raft.cfg:28) refers to an
    undefined operator; comments are stripped before parsing so it never
    resolves — matching TLC.
"""

from __future__ import annotations

import dataclasses
import re

from .config import RaftConfig

_DIRECTIVES = {
    "CONSTANTS",
    "CONSTANT",
    "SYMMETRY",
    "VIEW",
    "INIT",
    "NEXT",
    "INVARIANT",
    "INVARIANTS",
    "SPECIFICATION",
    "PROPERTY",
    "PROPERTIES",
    "CONSTRAINT",
    "CONSTRAINTS",
}


@dataclasses.dataclass
class TLCConfigFile:
    """Raw parse of a .cfg file, before lowering to RaftConfig."""

    constants: dict[str, object]  # name -> int | str (model value) | frozenset
    symmetry: str | None = None
    view: str | None = None
    init: str | None = None
    next: str | None = None
    invariants: tuple[str, ...] = ()


def _strip_comments(text: str) -> str:
    # TLC cfg comments: \* to end of line (and (* *) blocks, unused here).
    text = re.sub(r"\(\*.*?\*\)", " ", text, flags=re.S)
    return "\n".join(line.split("\\*")[0] for line in text.splitlines())


def _parse_value(tok: str) -> object:
    tok = tok.strip()
    if re.fullmatch(r"-?\d+", tok):
        return int(tok)
    if tok.startswith("{"):
        inner = tok.strip()[1:-1].strip()
        if not inner:
            return frozenset()
        return frozenset(t.strip() for t in inner.split(","))
    return tok  # model value / identifier


def parse_cfg(text: str) -> TLCConfigFile:
    text = _strip_comments(text)
    tokens: list[str] = []
    # Tokenize keeping set literals together.
    for raw_line in text.splitlines():
        line = raw_line.strip()
        if not line:
            continue
        tokens.append(line)

    cfg = TLCConfigFile(constants={})
    mode: str | None = None
    buf = " ".join(tokens)
    # Split on directive keywords while keeping them.
    parts = re.split(r"\b(" + "|".join(sorted(_DIRECTIVES, key=len, reverse=True)) + r")\b", buf)
    it = iter(parts)
    lead = next(it, "")
    if lead.strip():
        raise ValueError(f"unexpected text before first directive: {lead!r}")
    for directive, body in zip(it, it):
        body = body.strip()
        if directive in ("CONSTANTS", "CONSTANT"):
            for name, val in re.findall(r"(\w+)\s*=\s*(\{[^}]*\}|\S+)", body):
                cfg.constants[name] = _parse_value(val)
        elif directive == "SYMMETRY":
            cfg.symmetry = body.split()[0]
        elif directive == "VIEW":
            cfg.view = body.split()[0]
        elif directive == "INIT":
            cfg.init = body.split()[0]
        elif directive == "NEXT":
            cfg.next = body.split()[0]
        elif directive in ("INVARIANT", "INVARIANTS"):
            cfg.invariants = cfg.invariants + tuple(body.split())
        else:
            raise ValueError(f"unsupported directive {directive}")
        mode = directive
    del mode
    return cfg


def load_cfg(path: str) -> TLCConfigFile:
    with open(path) as f:
        return parse_cfg(f.read())


def to_raft_config(cfg: TLCConfigFile, *, symmetry_override: bool | None = None) -> RaftConfig:
    """Lower a parsed cfg to the static RaftConfig the kernels compile for."""
    c = cfg.constants
    servers = c.get("Servers")
    vals = c.get("Vals")
    if not isinstance(servers, frozenset) or not servers:
        raise ValueError("cfg must bind Servers to a non-empty set")
    if not isinstance(vals, frozenset) or not vals:
        raise ValueError("cfg must bind Vals to a non-empty set")
    if cfg.init != "Init" or cfg.next != "Next":
        raise ValueError(
            "this framework compiles the Raft spec family; INIT/NEXT must be "
            f"Init/Next (got {cfg.init}/{cfg.next})"
        )
    symmetry = cfg.symmetry is not None
    if cfg.symmetry not in (None, "symmServers"):
        raise ValueError(f"unknown SYMMETRY operator {cfg.symmetry}")
    if cfg.view not in (None, "view"):
        raise ValueError(f"unknown VIEW operator {cfg.view}")
    if symmetry_override is not None:
        symmetry = symmetry_override
    max_term = c.get("MaxTerm")
    return RaftConfig(
        n_servers=len(servers),
        n_vals=len(vals),
        max_election=int(c.get("MaxElection", 3)),
        max_restart=int(c.get("MaxRestart", 3)),
        symmetry=symmetry,
        use_view=cfg.view == "view",
        invariants=cfg.invariants or ("Inv",),
        max_term_cfg=int(max_term) if isinstance(max_term, int) else None,
    )


def load_raft_config(path: str, **kw) -> RaftConfig:
    return to_raft_config(load_cfg(path), **kw)
