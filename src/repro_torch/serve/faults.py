"""Deterministic fault injection for the serving runtime.

The port of ``repro/serve/faults.py``: the same fault classes, fired at the
same injection sites (``ProgramCache._read``, the program build in
``ProgramCache._compile``, the engine's decode step and its logits).

The hardened engine (docs/serving.md, "Failure modes & degraded
operation") claims a set of invariants — corrupt cache entries are
quarantined and recompiled around, failing compiles retry and then
degrade to the VM oracle, a NaN'd decode slot fails alone, a hung step
trips the request deadline instead of wedging ``run()``.  Claims about
failure behavior are worthless untested, and the real triggers (disk
corruption, an out-of-memory build, fp overflow) are not reproducible on demand — so
this module makes every fault class *injectable*, deterministically,
at explicit hook points:

* :class:`CacheFault` — corrupt/truncate/delete AOT-cache entry files
  just before ``ProgramCache._read`` opens them,
* :class:`CompileFault` — make the first N program builds raise
  :class:`InjectedCompileError` (or sleep, simulating a hang) inside
  ``ProgramCache`` / the fallback ladder,
* :class:`DecodeNaN` — overwrite one slot's logits with NaN/inf after a
  chosen decode step (or a chosen prefill admission),
* :class:`StepDelay` — sleep before decode steps, so deadlines fire.

Usage (the chaos corpus, ``tests/test_torch_serve_chaos.py``):

    plan = FaultPlan(seed=0, compile_fault=CompileFault(kind="raise", count=1))
    with inject_faults(plan):
        engine.run()
    assert plan.fired["compile"] == 1

Every hook is a module-level function whose fast path is a single
``_ACTIVE is None`` check — **zero overhead when no plan is armed**, and
production code paths never import anything else from here.  Plans are
explicit (fire at step K / first N attempts) rather than sampled, so a
chaos run is exactly reproducible; the ``seed`` only feeds the garbage
bytes written by :class:`CacheFault`.
"""

from __future__ import annotations

import contextlib
import os
import random
import time
from dataclasses import dataclass, field

__all__ = [
    "CacheFault",
    "CompileFault",
    "DecodeNaN",
    "StepDelay",
    "FaultPlan",
    "InjectedFault",
    "InjectedCompileError",
    "inject_faults",
    "active",
    "on_cache_read",
    "on_compile",
    "on_decode_step",
    "poison_logits",
]


class InjectedFault(Exception):
    """Base of every exception raised by an armed fault plan."""


class InjectedCompileError(InjectedFault):
    """An injected program-build failure (stands in for OOM, backend bugs)."""


@dataclass
class CacheFault:
    """Damage program-cache entry files as they are about to be read.

    ``mode``: ``garbage`` (overwrite with random bytes), ``truncate``
    (cut the file to ``keep_bytes``), or ``delete``.  ``count`` bounds
    how many distinct files are damaged (``None`` = all)."""

    mode: str = "garbage"
    count: int | None = None
    keep_bytes: int = 16


@dataclass
class CompileFault:
    """Fail (or hang) the first ``count`` program-build attempts.

    ``kind="raise"`` raises :class:`InjectedCompileError`;
    ``kind="hang"`` sleeps ``hang_s`` (a *finite* stand-in for a hung
    compile — the engine's deadline layer must absorb it)."""

    kind: str = "raise"
    count: int = 1
    hang_s: float = 0.0


@dataclass
class DecodeNaN:
    """Overwrite slot ``slot``'s logits with ``value`` at one point.

    ``site="decode"``: fires when the engine's global decode-step
    counter equals ``step`` (0-based).  ``site="prefill"``: fires on the
    ``step``-th admission (0-based) instead."""

    step: int = 0
    slot: int = 0
    value: float = float("nan")
    site: str = "decode"


@dataclass
class StepDelay:
    """Sleep ``delay_s`` before every ``every``-th decode step."""

    delay_s: float = 0.05
    every: int = 1


@dataclass
class FaultPlan:
    """One deterministic chaos scenario: which faults fire, where, when.

    ``fired`` counts hook activations per site (``cache`` / ``compile``
    / ``decode_nan`` / ``delay``) so tests can assert the fault actually
    happened — a chaos test whose fault never fired proves nothing."""

    seed: int = 0
    cache_fault: CacheFault | None = None
    compile_fault: CompileFault | None = None
    decode_nan: DecodeNaN | None = None
    step_delay: StepDelay | None = None
    fired: dict[str, int] = field(default_factory=dict)

    def __post_init__(self) -> None:
        self._rng = random.Random(self.seed)
        self._damaged: set[str] = set()
        self._compile_attempts = 0
        self._steps_seen = 0

    def _fire(self, site: str) -> None:
        self.fired[site] = self.fired.get(site, 0) + 1


_ACTIVE: FaultPlan | None = None


def active() -> FaultPlan | None:
    """The armed plan, or None (the production state)."""
    return _ACTIVE


@contextlib.contextmanager
def inject_faults(plan: FaultPlan):
    """Arm ``plan`` for the dynamic extent of the block (not thread-safe
    by design: chaos runs are single-process, single-engine)."""
    global _ACTIVE
    prev = _ACTIVE
    _ACTIVE = plan
    try:
        yield plan
    finally:
        _ACTIVE = prev


# ---------------------------------------------------------------------------
# Hook points — called from engine.py / torch_backend.py; no-ops when disarmed
# ---------------------------------------------------------------------------


def on_cache_read(path: str) -> None:
    """Hook: ``ProgramCache._read`` is about to open ``path``."""
    if _ACTIVE is None or _ACTIVE.cache_fault is None:
        return
    cf = _ACTIVE.cache_fault
    if path in _ACTIVE._damaged:
        return  # damage each file once: the re-written entry stays clean
    if cf.count is not None and len(_ACTIVE._damaged) >= cf.count:
        return
    _ACTIVE._damaged.add(path)
    _ACTIVE._fire("cache")
    if cf.mode == "delete":
        with contextlib.suppress(OSError):
            os.unlink(path)
        return
    if cf.mode == "truncate":
        with contextlib.suppress(OSError), open(path, "r+b") as f:
            f.truncate(cf.keep_bytes)
        return
    size = max(os.path.getsize(path), 1)
    with contextlib.suppress(OSError), open(path, "wb") as f:
        f.write(bytes(_ACTIVE._rng.getrandbits(8) for _ in range(min(size, 256))))


def on_compile(tag: str) -> None:
    """Hook: a program-build attempt (``tag`` names the call site)."""
    if _ACTIVE is None or _ACTIVE.compile_fault is None:
        return
    cf = _ACTIVE.compile_fault
    if _ACTIVE._compile_attempts >= cf.count:
        return
    _ACTIVE._compile_attempts += 1
    _ACTIVE._fire("compile")
    if cf.kind == "hang":
        time.sleep(cf.hang_s)
        return
    raise InjectedCompileError(f"injected compile failure at {tag}")


def on_decode_step(bucket: int) -> None:
    """Hook: the engine is about to run one decode step at ``bucket``."""
    if _ACTIVE is None or _ACTIVE.step_delay is None:
        return
    sd = _ACTIVE.step_delay
    _ACTIVE._steps_seen += 1
    if sd.every > 0 and _ACTIVE._steps_seen % sd.every == 0:
        _ACTIVE._fire("delay")
        time.sleep(sd.delay_s)


def poison_logits(logits, step: int, *, site: str = "decode"):
    """Hook: maybe overwrite one slot's logits; returns the (possibly
    modified) tensor — a new one: the caller's is never written.  ``step`` is
    the engine's 0-based ordinal for the site (decode-step counter, or
    admissions-so-far for prefill)."""
    if _ACTIVE is None or _ACTIVE.decode_nan is None:
        return logits
    dn = _ACTIVE.decode_nan
    if dn.site != site or dn.step != step:
        return logits
    _ACTIVE._fire("decode_nan")
    out = logits.clone()
    if site == "prefill":
        # prefill logits are (1, S, V): poison the whole row grid
        out[:] = dn.value
    else:
        out[dn.slot] = dn.value
    return out
