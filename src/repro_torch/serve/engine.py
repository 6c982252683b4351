"""Continuous-batching serve engine over the compiled Myia decode path.

The port of ``repro/serve/engine.py``: the same lifecycle, error taxonomy,
bucket policy and telemetry, on torch tensors on the parameters' device.  The
engine owns each bucket's KV cache, so an admission writes the prompt's K/V
rows into its slot's lane in place; the decode graph itself stays functional
(``where(wcol, …)`` returns new caches).

Lifecycle (see docs/serving.md for the full walkthrough):

1. **submit** — requests enter a per-bucket FIFO queue.  A request's
   bucket is the smallest power-of-two ≥ ``prompt_len + max_new`` (so a
   request's cache never migrates: its KV length is fixed at admission).
   Bucketing bounds the number of compiled specializations at
   O(log max_len) — *not* O(distinct lengths) and *not* O(generated
   tokens).  Admission control happens here: an oversized prompt, a
   non-positive token budget, or a full queue (``max_queue``) yields a
   **rejected terminal status** — never an exception out of ``submit``
   and never a request that can wedge the run loop.
2. **admit** — each bucket owns one slot batch (``n_slots`` lanes of a
   (B, L, D) KV cache).  When a slot is free, the next queued request of
   that bucket is prefilled alone at (1, L) — one compiled prefill per
   bucket — its K/V rows are written into the slot lane, and its first
   token is sampled from the prompt's last-row logits.
3. **step** — all active slots of a batch advance together through ONE
   compiled decode graph call (per-slot positions/done only enter as
   mask *values*, never shapes).  Finished slots (per-slot done mask:
   ``generated == max_new``) free immediately and the queue refills them
   mid-flight — continuous batching, not static batching.
4. **drain** — ``run()`` loops admit→step across buckets until queues
   and slots are empty, returning per-request generations + TTFT + a
   terminal ``status``.

Failure containment (docs/serving.md, "Failure modes & degraded
operation"): every request ends in exactly one structured terminal
status — ``ok`` / ``rejected`` / ``timeout`` / ``failed`` — and no
single request can take the engine down:

* **deadlines** — a request carrying ``deadline_s`` (or the engine's
  ``default_deadline_s``) that exceeds it, queued or running, is
  retired with status ``timeout`` (:class:`DeadlineExceeded` taxonomy)
  and its partial tokens; its slot frees immediately,
* **step budget** — ``run()`` computes a hard bound on decode steps
  from the submitted work (override with ``step_budget``); exhausting
  it fails the stragglers and *returns* — the loop provably terminates,
* **NaN/inf sentinel** — non-finite logits on an active lane fail only
  that lane (status ``failed``, :class:`NumericalFault`); the rest of
  the batch decodes on, bit-identical to the unpoisoned run,
* **admission/step exceptions** — an exception inside a compiled call
  fails the affected request(s), never the process.

Compilation accounting: the engine counts one compilation per
(program, bucket) pair it instantiates — the floor is
``2 × |buckets in use|`` (prefill + decode).  With a :class:`ProgramCache`
attached, those compilations are durable: a warm process restart rebuilds
the stored programs and builds none (``programs_built`` 0, asserted by
``tests/test_torch_program_cache.py``).  The chaos corpus
(``tests/test_torch_serve_chaos.py``) drives every fault class above
through ``repro_torch.serve.faults`` and pins the invariants.
"""

from __future__ import annotations

import itertools
import time
from collections import deque
from typing import Any, Sequence

import numpy as np
import torch

from repro_torch.core import api
from repro_torch.obs import metrics as obs_metrics, trace as obs_trace
from . import faults
from .model import (
    ServeLMDims,
    build_decode_step,
    build_prefill,
    causal_mask,
    decode_masks,
    finite_lanes,
)

__all__ = [
    "Request",
    "ServeEngine",
    "ServeError",
    "RequestRejected",
    "DeadlineExceeded",
    "NumericalFault",
    "bucket_for",
    "oracle_generate",
    "request_telemetry",
]


class ServeError(Exception):
    """Base of the serving fault taxonomy.  The engine never lets these
    escape ``run()`` — they become per-request terminal statuses — but
    the classes give failures a name and a machine-readable ``reason``."""

    reason = "serve_error"


class RequestRejected(ServeError):
    """Refused at admission: oversize, zero budget, or queue full."""

    reason = "rejected"


class DeadlineExceeded(ServeError):
    """The request outlived its deadline (queued or mid-generation)."""

    reason = "deadline"


class NumericalFault(ServeError):
    """Non-finite logits on the request's lane (NaN/inf sentinel)."""

    reason = "nonfinite_logits"


def bucket_for(total_len: int, *, min_bucket: int = 16, max_bucket: int = 4096) -> int:
    """Smallest power-of-two bucket ≥ ``total_len`` (≥ ``min_bucket``)."""
    if total_len > max_bucket:
        raise ValueError(f"request length {total_len} exceeds max bucket {max_bucket}")
    b = min_bucket
    while b < total_len:
        b *= 2
    return b


class Request:
    """One generation request: a prompt, a token budget, a deadline."""

    __slots__ = (
        "rid", "prompt", "max_new", "bucket", "submitted_at",
        "first_token_at", "deadline_s", "status", "error", "reason",
    )

    def __init__(
        self,
        rid: int,
        prompt: Sequence[int],
        max_new: int,
        bucket: int | None,
        deadline_s: float | None = None,
    ) -> None:
        self.rid = rid
        self.prompt = list(int(t) for t in prompt)
        self.max_new = int(max_new)
        self.bucket = bucket
        self.submitted_at = time.monotonic()
        self.first_token_at: float | None = None
        self.deadline_s = deadline_s
        self.status = "queued"
        self.error: str | None = None
        self.reason: str | None = None

    def expired(self, now: float) -> bool:
        return self.deadline_s is not None and (now - self.submitted_at) > self.deadline_s


class _SlotBatch:
    """One bucket's lanes: a (n_slots, L, D) KV cache + per-slot state."""

    def __init__(self, engine: "ServeEngine", bucket: int) -> None:
        B, D = engine.n_slots, engine.dims.d_model
        self.bucket = bucket
        self.engine = engine
        self.kcache = torch.zeros((B, bucket, D), dtype=torch.float32, device=engine.device)
        self.vcache = torch.zeros((B, bucket, D), dtype=torch.float32, device=engine.device)
        self.tok = np.zeros((B,), np.int32)
        self.pos = np.zeros((B,), np.int64)
        self.active: list[Request | None] = [None] * B
        self.out: list[list[int]] = [[] for _ in range(B)]

    def free_slot(self) -> int | None:
        for i, r in enumerate(self.active):
            if r is None:
                return i
        return None

    @property
    def n_active(self) -> int:
        return sum(r is not None for r in self.active)

    def admit(self, req: Request, slot: int) -> list[tuple[Request, list[int]]]:
        eng = self.engine
        L = self.bucket
        if obs_trace.active() is not None:
            admitted_at = time.monotonic()
            obs_trace.mark(
                "serve.admitted", ts=admitted_at, rid=req.rid, bucket=L, slot=slot
            )
            eng._observe_ms("serve.queue_ms", L, admitted_at - req.submitted_at)
        padded = np.zeros((1, L), np.int32)
        padded[0, : len(req.prompt)] = req.prompt
        with obs_trace.span("serve.prefill", rid=req.rid, bucket=L, slot=slot):
            logits, k, v = eng._call("prefill", L, eng._prefill_fn)(
                *eng.params, torch.from_numpy(padded).to(eng.device),
                causal_mask(L, eng.device),
            )
        logits = faults.poison_logits(logits, eng.admissions, site="prefill")
        eng.admissions += 1
        row = logits[0, len(req.prompt) - 1]
        if not bool(finite_lanes(row[None])[0]):
            eng.slot_faults += 1
            eng._finish(req, NumericalFault, "non-finite prefill logits")
            return [(req, [])]
        first = int(torch.argmax(row))
        req.first_token_at = time.monotonic()
        if obs_trace.active() is not None:
            obs_trace.mark("serve.first_token", ts=req.first_token_at, rid=req.rid)
            eng._observe_ms(
                "serve.ttft_ms", L, req.first_token_at - req.submitted_at
            )
        # the engine owns the caches: the slot's lane is written in place
        self.kcache[slot].copy_(k[0])
        self.vcache[slot].copy_(v[0])
        self.tok[slot] = first
        self.pos[slot] = len(req.prompt)
        self.out[slot] = [first]
        self.active[slot] = req
        req.status = "running"
        eng.tokens_generated += 1
        if req.max_new <= 1:
            self.active[slot] = None
            eng._finish(req, None, None)
            return [(req, self.out[slot])]
        return []

    def fail_all(
        self, exc: type[ServeError], msg: str, *, reason: str | None = None
    ) -> list[tuple[Request, list[int]]]:
        """Retire every active lane with ``status=failed`` (containment
        path for an exception out of the shared decode call, or budget
        exhaustion).  Partial tokens are preserved in the results."""
        eng = self.engine
        done: list[tuple[Request, list[int]]] = []
        for s, req in enumerate(self.active):
            if req is None:
                continue
            eng._finish(req, exc, msg)
            if reason is not None:
                req.reason = reason
            self.active[s] = None
            done.append((req, self.out[s]))
        return done

    def step(self) -> list[tuple[Request, list[int]]]:
        if self.n_active == 0:
            return []
        eng = self.engine
        sp = obs_trace.span(
            "serve.decode_step", bucket=self.bucket, n_active=self.n_active
        )
        with sp:
            finished = self._step_body()
        if sp is not obs_trace.NULL_SPAN:
            eng._observe_ms("serve.decode_step_ms", self.bucket, sp.dur_s)
        return finished

    def _step_body(self) -> list[tuple[Request, list[int]]]:
        eng = self.engine
        faults.on_decode_step(self.bucket)
        wcol, amask = decode_masks(self.pos, self.bucket, eng.device)
        logits, self.kcache, self.vcache = eng._call("decode", self.bucket, eng._decode_fn)(
            *eng.params, torch.from_numpy(self.tok).to(eng.device), self.kcache,
            self.vcache, wcol, amask,
        )
        logits = faults.poison_logits(logits, eng.steps, site="decode")
        finite = finite_lanes(logits)  # the sentinel, before the argmax
        nxt = torch.argmax(logits, dim=-1).to(torch.int32).cpu().numpy()
        eng.steps += 1
        now = time.monotonic()
        finished: list[tuple[Request, list[int]]] = []
        for s, req in enumerate(self.active):
            if req is None:
                continue
            if not bool(finite[s]):
                # NaN/inf sentinel: fail ONLY the poisoned lane — the
                # batch's other lanes never see its values (attention,
                # MLP and argmax are all lane-local) and decode on
                eng.slot_faults += 1
                eng._finish(
                    req, NumericalFault, f"non-finite logits at step {eng.steps - 1}"
                )
                self.active[s] = None
                finished.append((req, self.out[s]))
                continue
            self.out[s].append(int(nxt[s]))
            self.tok[s] = nxt[s]
            self.pos[s] += 1
            eng.tokens_generated += 1
            if len(self.out[s]) >= req.max_new:
                eng._finish(req, None, None)
                self.active[s] = None  # slot frees mid-flight
                finished.append((req, self.out[s]))
            elif req.expired(now):
                eng._finish(
                    req, DeadlineExceeded, f"deadline {req.deadline_s}s exceeded"
                )
                self.active[s] = None
                finished.append((req, self.out[s]))
        return finished


class ServeEngine:
    """Bucketed continuous-batching inference over compiled Myia graphs, on
    the device the parameters live on.

    Robustness knobs (all optional — defaults preserve the PR-5
    behavior): ``max_queue`` bounds the total queued requests
    (backpressure: over it, ``submit`` rejects), ``default_deadline_s``
    applies to requests submitted without an explicit deadline, and
    ``step_budget`` overrides the computed per-``run()`` decode-step
    bound."""

    def __init__(
        self,
        dims: ServeLMDims,
        params: tuple,
        *,
        n_slots: int = 4,
        min_bucket: int = 16,
        max_bucket: int = 4096,
        program_cache: Any = None,
        fuse: bool = False,
        max_queue: int | None = None,
        default_deadline_s: float | None = None,
        step_budget: int | None = None,
        trace: Any = None,
    ) -> None:
        self.dims = dims
        self.params = tuple(params)
        #: where the caches live and the programs run: the parameters' device
        self.device = self.params[0].device
        self.n_slots = int(n_slots)
        self.min_bucket = int(min_bucket)
        self.max_bucket = int(max_bucket)
        self.program_cache = program_cache
        self.max_queue = max_queue
        self.default_deadline_s = default_deadline_s
        self.step_budget = step_budget
        #: engine-owned tracer (``repro_torch.obs.trace.Tracer``); armed for the
        #: extent of every ``submit``/``run`` call so lifecycle spans land
        #: without the caller managing a ``tracing(...)`` block.  An
        #: ambient tracer armed by the caller works too — ``trace=None``
        #: simply defers to it.
        self.trace = trace
        #: per-bucket latency histograms (TTFT / time-in-queue /
        #: decode-step), populated only while a tracer is armed — the
        #: disarmed serve hot path does zero telemetry work
        self.telemetry = obs_metrics.MetricsRegistry()
        opts = api.CompileOptions(program_cache=program_cache, fuse=fuse)
        self._prefill_fn = api.myia(build_prefill(dims), options=opts)
        self._decode_fn = api.myia(build_decode_step(dims, self.n_slots), options=opts)
        self._queues: dict[int, deque[Request]] = {}
        self._batches: dict[int, _SlotBatch] = {}
        self._rids = itertools.count()
        self._specs_seen: set[tuple[str, int]] = set()
        #: requests that reached a terminal state (any status) — results
        #: rows are built from here; rejected-at-submit land immediately
        self._done: dict[int, Request] = {}
        #: rejected-at-submit requests awaiting their results row (drained
        #: by the next ``run()`` so a later run does not re-report them)
        self._unreported: list[Request] = []
        self.compilations: dict[str, int] = {"prefill": 0, "decode": 0}
        self.tokens_generated = 0
        self.steps = 0
        self.admissions = 0
        self.slot_faults = 0
        self.admit_failures = 0
        self.step_failures = 0
        self.queue_peak = 0
        self.budget_exhausted = 0
        self.last_step_budget: int | None = None
        self.rejected = {"oversize": 0, "zero_budget": 0, "queue_full": 0}
        self.status_counts = {"ok": 0, "rejected": 0, "timeout": 0, "failed": 0}

    # -- telemetry ---------------------------------------------------------
    def _observe_ms(self, name: str, bucket: int, value_s: float) -> None:
        """Record ``value_s`` (seconds) into the per-bucket latency
        histogram ``name.b<bucket>`` — call sites gate on an armed tracer,
        so this never runs in the disarmed configuration."""
        self.telemetry.histogram(f"{name}.b{bucket}").observe(value_s * 1e3)

    # -- compiled-call bookkeeping ----------------------------------------
    def _call(self, kind: str, bucket: int, fn: Any) -> Any:
        spec = (kind, bucket)
        if spec not in self._specs_seen:
            self._specs_seen.add(spec)
            self.compilations[kind] += 1
        return fn

    @property
    def buckets_in_use(self) -> list[int]:
        return sorted(self._batches)

    @property
    def total_compilations(self) -> int:
        return sum(self.compilations.values())

    def compilation_floor(self) -> int:
        """What the bucket policy predicts: prefill + decode per bucket."""
        return 2 * len(self._batches)

    # -- terminal bookkeeping ----------------------------------------------
    def _finish(
        self, req: Request, exc: type[ServeError] | None, msg: str | None
    ) -> None:
        """Move ``req`` to its terminal status exactly once."""
        if req.rid in self._done:
            return
        if exc is None:
            req.status, req.reason, req.error = "ok", None, None
        elif exc is RequestRejected:
            req.status, req.reason, req.error = "rejected", RequestRejected.reason, msg
        elif exc is DeadlineExceeded:
            req.status, req.reason, req.error = "timeout", DeadlineExceeded.reason, msg
        else:
            req.status = "failed"
            req.reason = getattr(exc, "reason", ServeError.reason)
            req.error = msg
        self.status_counts[req.status] += 1
        self._done[req.rid] = req
        obs_trace.mark(
            "serve.terminal", rid=req.rid, status=req.status, reason=req.reason
        )

    def _reject(self, req: Request, kind: str, msg: str) -> int:
        self.rejected[kind] += 1
        # the taxonomy reason is refined to the admission-control kind so
        # callers can tell a full queue from a hopeless request
        self._finish(req, RequestRejected, msg)
        req.reason = kind
        self._unreported.append(req)
        return req.rid

    def _result_row(self, req: Request, tokens: list[int]) -> dict:
        return {
            "tokens": list(tokens),
            "ttft_s": (
                None
                if req.first_token_at is None
                else req.first_token_at - req.submitted_at
            ),
            "bucket": req.bucket,
            "status": req.status,
            "reason": req.reason,
            "error": req.error,
        }

    @property
    def queued(self) -> int:
        return sum(len(q) for q in self._queues.values())

    # -- request lifecycle -------------------------------------------------
    def submit(
        self, prompt: Sequence[int], max_new: int, *, deadline_s: float | None = None
    ) -> int:
        """Admit a request; always returns a rid, never raises.

        Hopeless or unadmittable requests (token budget ≤ 0, total
        length over ``max_bucket``, queue at ``max_queue``) reach the
        terminal status ``rejected`` immediately — visible in the
        ``run()`` results and ``status_counts`` — instead of leaking
        ``ValueError`` to the caller or wedging the run loop."""
        if deadline_s is None:
            deadline_s = self.default_deadline_s
        rid = next(self._rids)
        total = len(prompt) + max(int(max_new), 0)
        req = Request(rid, prompt, max_new, bucket=None, deadline_s=deadline_s)
        with obs_trace.tracing(self.trace):
            obs_trace.mark(
                "serve.submit",
                ts=req.submitted_at,
                rid=rid,
                prompt_len=len(req.prompt),
                max_new=req.max_new,
            )
            if max_new <= 0:
                return self._reject(
                    req, "zero_budget", f"max_new={max_new} requests no tokens"
                )
            if total > self.max_bucket:
                return self._reject(
                    req,
                    "oversize",
                    f"prompt+max_new={total} exceeds max bucket {self.max_bucket}",
                )
            if self.max_queue is not None and self.queued >= self.max_queue:
                return self._reject(
                    req, "queue_full", f"queue at capacity ({self.max_queue})"
                )
        req.bucket = bucket_for(
            total, min_bucket=self.min_bucket, max_bucket=self.max_bucket
        )
        self._queues.setdefault(req.bucket, deque()).append(req)
        self.queue_peak = max(self.queue_peak, self.queued)
        return rid

    def _default_step_budget(self) -> int:
        """A provable upper bound on useful decode steps for the pending
        work: serialized, every request needs < ``max_new`` steps (the
        first token comes from prefill), so 2× the sum plus slack can
        only be exhausted by a liveness bug or an injected hang — the
        run loop then *fails the stragglers and returns* instead of
        spinning."""
        pending = sum(r.max_new for q in self._queues.values() for r in q)
        for b in self._batches.values():
            for s, r in enumerate(b.active):
                if r is not None:
                    pending += max(r.max_new - len(b.out[s]), 1)
        return 2 * pending + 16 * (len(self._queues) + len(self._batches) + 1)

    def run(self, *, step_budget: int | None = None) -> dict[int, dict]:
        """Drain all queues; returns ``{rid: {tokens, ttft_s, bucket,
        status, reason, error}}`` — one terminal row per submitted rid,
        including requests rejected at ``submit`` time.  Guaranteed to
        terminate: bounded by the step budget even under injected hangs,
        poisoned numerics, or compiled-call exceptions."""
        with obs_trace.tracing(self.trace):
            return self._run_body(step_budget)

    def _run_body(self, step_budget: int | None) -> dict[int, dict]:
        results: dict[int, dict] = {}

        def record(pairs: list[tuple[Request, list[int]]]) -> None:
            for req, toks in pairs:
                results[req.rid] = self._result_row(req, toks)

        record([(req, []) for req in self._unreported])  # rejected at submit
        self._unreported.clear()
        budget = (
            step_budget
            if step_budget is not None
            else (self.step_budget or self._default_step_budget())
        )
        self.last_step_budget = budget
        steps_used = 0

        while any(self._queues.values()) or any(
            b.n_active for b in self._batches.values()
        ):
            # admission: fill every free slot from its bucket's queue
            for bucket, q in self._queues.items():
                if not q:
                    continue
                batch = self._batches.get(bucket)
                if batch is None:
                    batch = self._batches[bucket] = _SlotBatch(self, bucket)
                while q:
                    if q[0].expired(time.monotonic()):
                        req = q.popleft()
                        self._finish(
                            req, DeadlineExceeded,
                            f"deadline {req.deadline_s}s exceeded in queue",
                        )
                        record([(req, [])])
                        continue
                    slot = batch.free_slot()
                    if slot is None:
                        break
                    req = q.popleft()
                    try:
                        record(batch.admit(req, slot))
                    except Exception as e:  # compiled call blew up: contain
                        self.admit_failures += 1
                        self._finish(req, ServeError, f"admission failed: {e!r}")
                        record([(req, [])])
            # one decode step per active batch
            for batch in self._batches.values():
                if batch.n_active == 0 or steps_used >= budget:
                    continue
                steps_used += 1
                try:
                    record(batch.step())
                except Exception as e:  # shared decode call blew up
                    self.step_failures += 1
                    record(batch.fail_all(ServeError, f"decode step failed: {e!r}"))
            if steps_used >= budget and any(
                b.n_active for b in self._batches.values()
            ):
                # budget exhausted with work still active: a liveness
                # fault (hang, runaway request).  Fail the stragglers,
                # return — run() must never spin forever.
                self.budget_exhausted += 1
                msg = f"step budget ({budget}) exhausted"
                for batch in self._batches.values():
                    record(batch.fail_all(ServeError, msg, reason="step_budget"))
                for q in self._queues.values():
                    while q:
                        req = q.popleft()
                        self._finish(req, ServeError, msg)
                        req.reason = "step_budget"
                        record([(req, [])])
                break
        return results

    # -- introspection -----------------------------------------------------
    def stats(self) -> dict:
        out = {
            "n_slots": self.n_slots,
            "min_bucket": self.min_bucket,
            "buckets_in_use": self.buckets_in_use,
            "compilations": dict(self.compilations),
            "total_compilations": self.total_compilations,
            "compilation_floor": self.compilation_floor(),
            "tokens_generated": self.tokens_generated,
            "decode_steps": self.steps,
            # robustness / backpressure telemetry
            "statuses": dict(self.status_counts),
            "rejected": dict(self.rejected),
            "queued": self.queued,
            "queue_peak": self.queue_peak,
            "slot_faults": self.slot_faults,
            "admit_failures": self.admit_failures,
            "step_failures": self.step_failures,
            "budget_exhausted": self.budget_exhausted,
            "last_step_budget": self.last_step_budget,
        }
        if self.program_cache is not None:
            out["program_cache"] = self.program_cache.stats.as_dict()
        telemetry = self.telemetry.as_dict()
        if telemetry:
            out["telemetry"] = telemetry
        return out


def request_telemetry(tracer: Any) -> dict[int, dict]:
    """Rebuild per-request lifecycle timings from a tracer's serve spans.

    Returns ``{rid: {status, reason, bucket, ttft_ms, queue_ms, gen_ms}}``
    assembled purely from the ``serve.submit`` / ``serve.admitted`` /
    ``serve.first_token`` / ``serve.terminal`` marks the engine emits.
    Because the submit and first-token marks carry the engine's own
    ``time.monotonic()`` readings (``Request.submitted_at`` /
    ``first_token_at``), the derived ``ttft_ms`` equals the engine's
    reported ``ttft_s`` exactly — not approximately (pinned by
    ``tests/test_torch_obs.py``).  Timings a request never
    reached (e.g. TTFT of a rejected request) are ``None``."""
    rows: dict[int, dict] = {}

    def row(rid: int) -> dict:
        return rows.setdefault(
            rid,
            {
                "rid": rid,
                "status": None,
                "reason": None,
                "bucket": None,
                "submitted_t": None,
                "ttft_ms": None,
                "queue_ms": None,
                "gen_ms": None,
                "_first_token_t": None,
            },
        )

    for e in tracer.events:
        if e.kind != "mark" or not e.name.startswith("serve."):
            continue
        rid = e.attrs.get("rid")
        if rid is None:
            continue
        r = row(rid)
        if e.name == "serve.submit":
            r["submitted_t"] = e.t0
        elif e.name == "serve.admitted":
            r["bucket"] = e.attrs.get("bucket")
            if r["submitted_t"] is not None:
                r["queue_ms"] = (e.t0 - r["submitted_t"]) * 1e3
        elif e.name == "serve.first_token":
            r["_first_token_t"] = e.t0
            if r["submitted_t"] is not None:
                r["ttft_ms"] = (e.t0 - r["submitted_t"]) * 1e3
        elif e.name == "serve.terminal":
            r["status"] = e.attrs.get("status")
            r["reason"] = e.attrs.get("reason")
            if r["_first_token_t"] is not None:
                r["gen_ms"] = (e.t0 - r["_first_token_t"]) * 1e3
    for r in rows.values():
        del r["_first_token_t"]
    return rows


def oracle_generate(
    dims: ServeLMDims, params: tuple, prompt: Sequence[int], max_new: int, *, fns=None
) -> list[int]:
    """The pre-runtime serving path, kept as the differential oracle:
    greedy decode by **full-prefix recompute** — every step re-runs the
    whole forward at the grown length, one specialization per length,
    O(T²) total work, on the parameters' device.  ``fns`` (a dict) can be
    shared across calls to reuse the per-length MyiaFunctions."""
    fns = {} if fns is None else fns
    dev = params[0].device
    tokens = [int(t) for t in prompt]
    out: list[int] = []
    for _ in range(max_new):
        t = len(tokens)
        fn = fns.get(t)
        if fn is None:
            fn = fns[t] = api.myia(build_prefill(dims))
        logits, _k, _v = fn(
            *params, torch.tensor([tokens], dtype=torch.int32, device=dev),
            causal_mask(t, dev),
        )
        nxt = int(torch.argmax(logits[0, -1]))
        out.append(nxt)
        tokens.append(nxt)
    return out
