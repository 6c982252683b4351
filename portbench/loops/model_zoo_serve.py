"""Serving the model zoo's dense decoder in batches: a closed loop that submits the next
batch of ``batch`` requests of one prompt length as soon as the last one is done, each
request prefilled by ``repro_torch.launch.serve.serve_prefill`` and given ``gen`` greedy
tokens by ``serve_decode``, as ``launch.serve --compiler torch`` serves a batch.

The window serves whole rounds of the mix (each round the same batches in an order
drawn from the seed, so every seed serves the same work) and ends at the round boundary
at or after ``--seconds``.  A request's time to first token runs from its batch's
submission to its first token on the host.  Set-up makes the weights and every prompt
on the device and serves one batch of each prompt length, which builds and warms every
kernel the window runs.
"""

from __future__ import annotations

import gc
import statistics
import time

import torch

from portbench.lib import common, traffic, weights
from portbench.reference import internlm2 as ref
from portbench.reference import quant

from .model_zoo_train import check_layout, model_config


class Cell:
    def __init__(self, ctx) -> None:
        self.ctx = ctx
        self.conf = ctx.found["config"]
        self.mix = ctx.found["traffic"]

    def make_params(self) -> dict:
        return weights.zoo_params(self.conf["model"], self.conf["init_std"], self.ctx.seed,
                                  self.ctx.device)

    def setup(self) -> None:
        from repro_torch.models.model import abstract_params

        phases = common.Phases(self.ctx.device)
        phases.mark("imports")
        self.cfg = model_config(self.conf)
        self.params = self.make_params()
        check_layout(self.params, abstract_params(self.cfg))
        vocab = self.conf["model"]["vocab"]
        self.prompts = traffic.serve_prompts(self.mix, vocab, self.ctx.seed, self.ctx.device)
        self.rounds = traffic.serve_rounds(self.mix, self.ctx.seed)
        self.served = []  # (length, prompt set, tokens (batch, gen) on the host)
        phases.mark("weights and prompts")
        for length, _ in self.mix["round"]:
            self.serve_batch(length, 0, None)
            phases.mark(f"first batch of {length}")
        self.served.clear()
        common.note("set-up:", phases.line())

    def serve_batch(self, length: int, index: int, spans) -> list[float]:
        """One batch: its requests' times to first token (s)."""
        from repro_torch.launch import serve as program

        gen = self.mix["gen"]
        t = t0 = time.time_ns()
        sets = self.prompts[length]
        prompts = sets[index % sets.shape[0]]
        if spans is not None:
            t = spans.mark("batch_made", t)
        logits, caches = program.serve_prefill(self.cfg, self.params, prompts, length + gen)
        torch.argmax(logits, dim=-1).cpu()
        first = time.time_ns()
        if spans is not None:
            t = spans.mark("prefill_call", t)
        fed, _ = program.serve_decode(self.cfg, self.params, logits, caches, length, gen)
        self.served.append((length, index % sets.shape[0], fed.cpu()))
        if spans is not None:
            spans.mark("decode_call", t)
        return [(first - t0) / 1e9] * prompts.shape[0]

    def window(self, seconds: float) -> dict:
        spans = self.ctx.spans
        ttft, used = [], {}
        start = time.time_ns()
        limit = start + int(seconds * 1e9)
        end = start
        for lengths in self.rounds:
            for length in lengths:
                ttft += self.serve_batch(length, used.get(length, 0), spans)
                used[length] = used.get(length, 0) + 1
            end = time.time_ns()
            if end >= limit:
                break
        else:
            raise common.CellError("the mix's rounds ran out before the window closed")
        B, gen = self.mix["batch"], self.mix["gen"]
        for name in ("prefill_call", "decode_call"):
            times = [(b - a) / 1e9 for n, a, b in spans.items if n == name]
            common.note(f"window {(end - start) / 1e9:.4f} s, {len(times)} batches; "
                        f"{name} s quartiles {common.quartiles(times)}")
        tokens = sum(B * (length + gen) for length, _, _ in self.served)
        self.counts = {"start": start, "end": end, "batches": [s[0] for s in self.served],
                       "batch": B, "gen": gen}
        return {
            "e2e": {
                "serve_tokens_per_s": tokens / ((end - start) / 1e9),
                "serve_ttft_ms_p95": 1e3 * statistics.quantiles(ttft, n=20)[18],
            },
            "attempted": len(ttft),
            "failed": 0,
        }

    def release(self) -> None:
        self.params = None
        gc.collect()
        if self.ctx.device.type == "cuda":
            torch.cuda.empty_cache()

    def sample(self) -> list[tuple[torch.Tensor, torch.Tensor]]:
        """(prompt, served tokens) of ``check_requests`` finished requests drawn from the
        seed: a quarter from the longest prompts, the rest from all."""
        g = traffic.generator(self.ctx.seed, 4, "cpu")
        B, k = self.mix["batch"], self.mix["check_requests"]
        longest = max(s[0] for s in self.served)
        pool = [(i, r) for i in range(len(self.served)) for r in range(B)]
        long_pool = [p for p in pool if self.served[p[0]][0] == longest]
        picks = [long_pool[j] for j in torch.randperm(len(long_pool), generator=g)[:k // 4]]
        rest = [p for p in pool if p not in picks]
        picks += [rest[j] for j in torch.randperm(len(rest), generator=g)[:k - len(picks)]]
        out = []
        for i, r in picks:
            length, index, fed = self.served[i]
            out.append((self.prompts[length][index, r], fed[r].to(self.ctx.device)))
        return out

    def gaps(self, samples, logits) -> list[float]:
        """For each sampled request, the widest gap by which a served token's logit lies
        below the best logit of the reference at its position."""
        out = []
        for (_, served), lg in zip(samples, logits):
            chosen = lg.gather(1, served.long()[:, None])[:, 0]
            out.append(float((lg.max(dim=1).values - chosen).max()))
        return out

    def reference_logits(self, samples, mm=ref.f32_mm) -> list[torch.Tensor]:
        params = self.make_params()
        return [ref.served_logits(self.conf["model"], params, p, s, mm=mm) for p, s in samples]

    def check(self) -> dict[str, float]:
        self.samples = self.sample()
        self.ref_logits = self.reference_logits(self.samples)
        return {"logit_gap": max(self.gaps(self.samples, self.ref_logits))}

    def control(self) -> dict[str, float]:
        """The gap of the token the reference in fp8 puts first, at each position of the
        same prompts and served tokens (after ``check``)."""
        low = self.reference_logits(self.samples, mm=quant.fp8_mm)
        firsts = [(p, lg.argmax(dim=1)) for (p, _), lg in zip(self.samples, low)]
        return {"logit_gap": max(self.gaps(firsts, self.ref_logits))}
