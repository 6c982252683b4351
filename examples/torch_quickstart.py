"""Quickstart on PyTorch: the paper's toolchain in five minutes.

The counterpart of ``examples/quickstart.py`` in ``repro_torch``: recursion,
higher-order functions, closures, and closure-based ST AD through all of them,
reverse-over-reverse included.  Every call here has only Python scalars (or
tensors made on the default device) as arguments, so it runs on torch's default
device, which ``--device`` sets: the card unless the CPU is asked for.

    PYTHONPATH=src python examples/torch_quickstart.py               # on the card
    PYTHONPATH=src python examples/torch_quickstart.py --device cpu
"""

import argparse

import torch

from repro_torch.core import api as myia
import repro_torch.core.primitives as P
from repro_torch.device import resolve_device

tanh = P.tanh  # Myia primitives are plain callables inside @myia code


# -- 1. compile a function through the pipeline ------------------------------


@myia.myia
def f(x):
    return x ** 3 + 2.0 * x


# -- 2. gradients via closure-based source transformation --------------------

def g(x):
    return x ** 3 + 2.0 * x


# -- 3. recursion ------------------------------------------------------------

def power_rec(x, n):
    if n == 0:
        return 1.0
    return x * power_rec(x, n - 1)


@myia.myia
def use_recursion(x):
    return power_rec(x, 5)


# -- 4. higher-order functions + closures ------------------------------------

def compose_twice(fn, x):
    return fn(fn(x))


@myia.myia
def hof(x):
    def scaled_tanh(v):
        return tanh(v) * x  # closes over x — a real closure

    return compose_twice(scaled_tanh, x)


# -- 5. arrays: same pipeline, and the gradient matches torch.autograd --------

def loss(w, x):
    h = tanh(x @ w)
    return P.reduce_sum(h * h, (0, 1), False)


def _show(v):
    """A result as the reference prints a 0-d array: its value."""
    return v.item() if isinstance(v, torch.Tensor) else v


def run(results: dict | None = None) -> dict:
    """The five sections on torch's default device; each result by name, in
    ``results`` when given."""
    out = {} if results is None else results
    out["f"] = f(2.0)
    print("f(2.0) =", _show(out["f"]), "(expected 12.0)")

    df = myia.grad(g)
    out["df"] = df(2.0)
    print("g'(2.0) =", _show(out["df"]), "(expected 3·4+2 = 14.0)")
    # reverse-over-reverse: the transform applies to its own output (§3.2)
    ddf = myia.grad(myia.grad(g))
    out["ddf"] = ddf(2.0)
    print("g''(2.0) =", _show(out["ddf"]), "(expected 6·2 = 12.0)")

    out["rec"] = use_recursion(2.0)
    print("x^5 at 2:", _show(out["rec"]), "(expected 32)")
    out["drec"] = myia.grad(use_recursion)(2.0)
    print("d/dx x^5 at 2:", _show(out["drec"]), "(expected 80)")

    out["hof"] = hof(0.5)
    print("hof(0.5) =", _show(out["hof"]))
    out["dhof"] = myia.grad(hof)(0.5)
    print("hof'(0.5) =", _show(out["dhof"]),
          "(gradient flows through the closure's free variable)")

    # seeds 0 and 1 as the reference's PRNG keys; drawn on the CPU, then placed
    dev = torch.get_default_device()
    w = torch.randn(8, 8, generator=torch.Generator().manual_seed(0), device="cpu").to(dev)
    x = torch.randn(4, 8, generator=torch.Generator().manual_seed(1), device="cpu").to(dev)
    out["g_myia"] = myia.grad(loss)(w, x)
    w_ = w.detach().requires_grad_(True)
    (out["g_torch"],) = torch.autograd.grad(torch.sum(torch.tanh(x @ w_) ** 2), (w_,))
    out["match"] = bool(torch.allclose(out["g_myia"], out["g_torch"], atol=1e-5))
    print("myia grad == torch.autograd grad:", out["match"])
    return out


def main(argv=None, *, results: dict | None = None) -> int:
    """``results``: a dict that receives each section's result (for a caller that
    checks where they live)."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = ap.parse_args(argv)
    with torch.device(resolve_device(args.device)):
        out = run(results)
    assert out["match"]
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
