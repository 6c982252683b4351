"""Plain InternLM2 (arXiv:2403.17297): the decoder stack, its training loss, AdamW, and
the logits a served request's tokens are judged by.

Plain PyTorch in float32: every matrix product, the attention and the loss take f32
copies of the weights, with TF32 off (``no_tf32``).  Nothing here imports the program.
The weights are the nested dict the benchmark made (``portbench/lib/weights.py``):
``embed`` (V, D), ``layers[i]`` with ``norm1``/``norm2`` (D,), ``mixer`` ``wq`` (D, H, hd),
``wk``/``wv`` (D, KVH, hd), ``wo`` (H, hd, D), ``ffn`` ``wi``/``wg`` (D, F), ``wo`` (F, D),
then ``final_norm`` (D,) and ``lm_head`` (D, V).

The layer follows the published block: RMSNorm, grouped-query attention with rotary
positions on split halves (query head h reads key/value head h // (H / KVH)), causal
softmax at scale hd^-1/2, a SwiGLU MLP (``wo(wi x * silu(wg x))``), residuals around
both, a final RMSNorm and an untied head.  ``mm`` is the one place a product is taken,
so the precision control (``portbench/reference/quant.py``) can swap it.
"""

from __future__ import annotations

import contextlib
import math

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint


@contextlib.contextmanager
def no_tf32():
    """f32 products in f32: TF32 off for cuBLAS and cuDNN, restored on exit."""
    saved = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = saved


def f32_mm(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return a.float() @ b.float()


class Model:
    """The stack at the sizes of a configuration's ``model`` block; ``mm`` takes every
    matrix product of the layers and the head."""

    def __init__(self, sizes: dict, mm=f32_mm) -> None:
        self.D = sizes["d_model"]
        self.H = sizes["n_heads"]
        self.KVH = sizes["n_kv_heads"]
        self.hd = sizes["d_model"] // sizes["n_heads"]
        self.eps = sizes["norm_eps"]
        self.theta = sizes["rope_theta"]
        self.mm = mm

    def norm(self, x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
        x = x.float()
        return x * torch.rsqrt(x.square().mean(-1, keepdim=True) + self.eps) * w.float()

    def rope(self, x: torch.Tensor, pos: torch.Tensor) -> torch.Tensor:
        """x (B, heads, S, hd) at absolute positions ``pos`` (S,): split-half rotation."""
        half = self.hd // 2
        freqs = 1.0 / self.theta ** (
            torch.arange(0, self.hd, 2, dtype=torch.float32, device=x.device) / self.hd)
        ang = pos.float()[:, None] * freqs
        cos, sin = torch.cos(ang), torch.sin(ang)
        x1, x2 = x[..., :half], x[..., half:]
        return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)

    def attention(self, p: dict, h: torch.Tensor, pos: torch.Tensor) -> torch.Tensor:
        B, S, D = h.shape
        H, KVH, hd = self.H, self.KVH, self.hd

        def proj(w, heads):
            y = self.mm(h.reshape(B * S, D), w.reshape(D, heads * hd))
            return y.reshape(B, S, heads, hd).transpose(1, 2)

        q = self.rope(proj(p["wq"], H), pos)
        k = self.rope(proj(p["wk"], KVH), pos)
        v = proj(p["wv"], KVH)
        k = k.repeat_interleave(H // KVH, dim=1)
        v = v.repeat_interleave(H // KVH, dim=1)
        scores = (q @ k.transpose(-1, -2)) / math.sqrt(hd)
        causal = torch.ones(S, S, dtype=torch.bool, device=h.device).tril()
        scores = scores.masked_fill(~causal, float("-inf"))
        o = torch.softmax(scores, dim=-1) @ v
        o = o.transpose(1, 2).reshape(B * S, H * hd)
        return self.mm(o, p["wo"].reshape(H * hd, D)).reshape(B, S, D)

    def mlp(self, p: dict, h: torch.Tensor) -> torch.Tensor:
        B, S, D = h.shape
        x = h.reshape(B * S, D)
        y = self.mm(x, p["wi"]) * F.silu(self.mm(x, p["wg"]))
        return self.mm(y, p["wo"]).reshape(B, S, D)

    def layer(self, p: dict, x: torch.Tensor, pos: torch.Tensor) -> torch.Tensor:
        x = x + self.attention(p["mixer"], self.norm(x, p["norm1"]), pos)
        return x + self.mlp(p["ffn"], self.norm(x, p["norm2"]))

    def hidden(self, params: dict, tokens: torch.Tensor, *, remat: bool) -> torch.Tensor:
        """The final hidden states (B, S, D) f32; with ``remat`` each layer keeps only
        its input and runs again in the backward, so the stack fits beside its state."""
        pos = torch.arange(tokens.shape[1], device=tokens.device)
        x = params["embed"][tokens.long()].float()
        for lp in params["layers"]:
            if remat:
                x = checkpoint(self.layer, lp, x, pos, use_reentrant=False)
            else:
                x = self.layer(lp, x, pos)
        return self.norm(x, params["final_norm"])

    def logits(self, params: dict, h: torch.Tensor) -> torch.Tensor:
        B, S, D = h.shape
        return self.mm(h.reshape(B * S, D), params["lm_head"]).reshape(B, S, -1)

    def loss(self, params: dict, tokens: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
        """Mean next-token cross-entropy over every position, in f32."""
        logits = self.logits(params, self.hidden(params, tokens, remat=True))
        return F.cross_entropy(logits.reshape(-1, logits.shape[-1]), labels.long().reshape(-1))


def leaves(tree) -> list[torch.Tensor]:
    """The tensors of a nested dict / list: dict keys sorted, lists in order."""
    if isinstance(tree, dict):
        return [t for k in sorted(tree) for t in leaves(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [t for v in tree for t in leaves(v)]
    return [tree]


def paths(tree, prefix: str = "") -> list[str]:
    """The name of each tensor of :func:`leaves`, in the same order."""
    if isinstance(tree, dict):
        return [q for k in sorted(tree) for q in paths(tree[k], f"{prefix}{k}.")]
    if isinstance(tree, (list, tuple)):
        return [q for i, v in enumerate(tree) for q in paths(v, f"{prefix}{i}.")]
    return [prefix[:-1]]


def rebuild(tree, flat: list):
    """``tree`` with its tensors replaced, in order, by those of ``flat``."""
    it = iter(flat)

    def go(node):
        if isinstance(node, dict):
            return {k: go(node[k]) for k in sorted(node)}
        if isinstance(node, (list, tuple)):
            return [go(v) for v in node]
        return next(it)

    return go(tree)


class AdamW:
    """AdamW with a global-norm clip and a warmup-then-cosine rate, in f32; each
    parameter is stored back in its own dtype after the update and the moments in
    f32.  ``opt`` is the configuration's optimizer block."""

    def __init__(self, opt: dict) -> None:
        self.o = opt

    def lr(self, step: int) -> float:
        o = self.o
        warm = min(step / max(o["warmup_steps"], 1), 1.0)
        span = max(o["total_steps"] - o["warmup_steps"], 1)
        prog = min(max((step - o["warmup_steps"]) / span, 0.0), 1.0)
        return o["lr"] * warm * 0.5 * (1.0 + math.cos(math.pi * prog))

    def clip(self, grads: list[torch.Tensor]) -> list[torch.Tensor]:
        gn = torch.sqrt(sum(g.float().square().sum() for g in grads))
        scale = torch.clamp(self.o["clip_norm"] / (gn + 1e-9), max=1.0)
        return [g.float() * scale for g in grads]

    def update(self, params: list, grads: list, m: list, v: list, step: int):
        """One step: (new params, new m, new v) from the clipped gradients."""
        o = self.o
        b1, b2, eps, wd = o["b1"], o["b2"], o["eps"], o["weight_decay"]
        lr = self.lr(step)
        bc1, bc2 = 1.0 - b1 ** (step + 1), 1.0 - b2 ** (step + 1)
        out_p, out_m, out_v = [], [], []
        for p, g, mi, vi in zip(params, grads, m, v, strict=True):
            pf = p.float()
            mi = b1 * mi + (1 - b1) * g
            vi = b2 * vi + (1 - b2) * g.square()
            delta = (mi / bc1) / (torch.sqrt(vi / bc2) + eps) + wd * pf
            out_p.append((pf - lr * delta).to(p.dtype))
            out_m.append(mi)
            out_v.append(vi)
        return out_p, out_m, out_v


def train_readings(sizes: dict, opt: dict, params: dict, batches: list[dict],
                   sample: list[torch.Tensor], *, mm=f32_mm) -> dict:
    """The reference's first ``len(batches)`` steps from ``params``: each step's loss,
    the first step's clipped gradient (as AdamW takes it) as a norm per leaf and at the
    flat indices ``sample`` gives each leaf, and each leaf's change after the last
    step as a norm.  Leaves in the program's order.  Runs with TF32 off; the f32
    copies it differentiates are made a step at a time."""
    model = Model(sizes, mm)
    adam = AdamW(opt)
    with no_tf32():
        flat = leaves(params)
        start = [p.clone() for p in flat]
        m = [torch.zeros_like(p, dtype=torch.float32) for p in flat]
        v = [torch.zeros_like(p, dtype=torch.float32) for p in flat]
        losses, grad_norms, grad_sample = [], None, None
        for step, batch in enumerate(batches):
            live = [p.detach().float().requires_grad_(True) for p in flat]
            loss = model.loss(rebuild(params, live), batch["tokens"], batch["labels"])
            grads = adam.clip(list(torch.autograd.grad(loss, live)))
            del live
            losses.append(float(loss.detach()))
            if step == 0:
                grad_norms = [float(torch.linalg.vector_norm(g)) for g in grads]
                grad_sample = [g.reshape(-1)[i] for g, i in zip(grads, sample)]
            with torch.no_grad():
                flat, m, v = adam.update(flat, grads, m, v, step)
            del grads
        change = [float(torch.linalg.vector_norm(p.float() - s.float()))
                  for p, s in zip(flat, start)]
    return {"losses": losses, "grad_norms": grad_norms, "grad_sample": grad_sample,
            "change_norms": change}


@torch.no_grad()
def served_logits(sizes: dict, params: dict, prompt: torch.Tensor, served: torch.Tensor, *,
                  mm=f32_mm) -> torch.Tensor:
    """The logits (n, V) f32 at the n positions that produced ``served`` (n,): the
    prompt's last position, then each served token but the last, fed as the program
    fed them.  One request; TF32 off."""
    model = Model(sizes, mm)
    n = served.shape[0]
    seq = torch.cat([prompt.long(), served[:-1].long()])[None]
    with no_tf32():
        h = model.hidden(params, seq, remat=False)
        return model.logits(params, h[:, -n:])[0]
