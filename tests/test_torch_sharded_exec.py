"""The model zoo under a mesh: the placed train step, prefill and decode
(``repro_torch.distributed.jit_*``) on gloo CPU ranks against the port's
single-device values.

The reference's sharded step fails on this tree (``tests/distributed/
test_collectives.py::TestShardedTrainStep``), so the oracle is the port's own
single-device run, held there against the reference by the other
``test_torch_*`` files.  Bounds are the reference's SPMD ones: losses rtol 2e-5,
parameters rtol 2e-4 and atol 1e-6 after three steps; logits rtol 2e-4, atol
2e-5 (f32, reduced configs).

Each rank is a subprocess (``file://`` rendezvous under ``tmp_path``) with its
own timeout, as in ``tests/test_torch_spmd_exec.py``; the ranks import
``repro_torch`` only.  Cases, by mesh:

* internlm2: three AdamW or Adafactor steps;
* gemma3 (windowed layers, tied vocab-sharded embedding): prefill and four
  greedy decode steps; mamba2 (K5 on local heads): prefill and decode;
* grok (MoE): ``loss_fn`` and every gradient, with the experts sharded
  (4 experts on model 2) and with the expert fallback (3 experts: the model axis
  moves to the expert FFN width);
* 1×4: internlm2's 2 kv heads do not divide the model axis, so they are
  replicated while the 4 q heads are sharded (K and V cut to each rank's
  groups);
* what reaches ``kernels.*``: plain local tensors, never a DTensor.

Then ``launch.train --compiler torch --data-mesh 2`` under
``torch.distributed.run``, with a restart from its per-rank checkpoints, and
``launch.serve --compiler torch --data-mesh 2`` serving on one device.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import textwrap

import numpy as np
import pytest

from test_torch_spmd_exec import SRC, TIMEOUT, _run_ranks

_RANK = textwrap.dedent(
    """
    import dataclasses, json, sys
    sys.path.insert(0, {src!r})
    import numpy as np
    import torch
    import torch.distributed as dist

    from repro_torch import kernels, tree as T
    from repro_torch.configs import get_config
    from repro_torch.distributed import (
        _global, _on, _placed, jit_decode_step, jit_prefill, jit_train_step,
        make_rules, make_serve_fns, make_train_state_fn, make_train_step, place)
    from repro_torch.distributed.sharding import batch_specs, param_shardings
    from repro_torch.launch.mesh import make_local_mesh
    from repro_torch.models import init_params, loss_fn
    from repro_torch.models.model import stacked_layer_groups
    from repro_torch.optim import OptConfig, make_optimizer
    from repro_torch.parallel import MeshContext

    rank, world, data, model = (int(a) for a in sys.argv[1:5])
    cases = sys.argv[5].split(",")
    dist.init_process_group("gloo", init_method="file://{store}", rank=rank, world_size=world)
    mesh = make_local_mesh(data, model, device="cpu")
    rng = np.random.default_rng(0)

    def ints(vocab, shape):
        return torch.from_numpy(rng.integers(0, vocab, shape).astype(np.int32))

    def train(arch, opt_name, steps=3):
        cfg = get_config(arch, reduced=True)
        opt = make_optimizer(OptConfig(name=opt_name, lr=1e-2, warmup_steps=1, total_steps=3),
                             layer_groups=stacked_layer_groups(cfg))
        batches = [{{"tokens": ints(cfg.vocab, (4, 16)), "labels": ints(cfg.vocab, (4, 16))}}
                   for _ in range(steps)]
        init = make_train_state_fn(cfg, opt, device="cpu")
        s0, l0 = init(), []
        step = make_train_step(cfg, opt)
        for b in batches:
            s0, m = step(s0, b)
            l0.append(float(m["loss"]))
        fn, sh = jit_train_step(cfg, opt, MeshContext(mesh, make_rules(cfg)), init(), batches[0])
        s1, l1 = init(), []
        for b in batches:
            s1, m = fn(s1, b)
            l1.append(float(m["loss"]))
        np.testing.assert_allclose(l1, l0, rtol=2e-5, err_msg=f"{{arch}} {{opt_name}} losses")
        for tree in ("params", "opt"):
            pls = T.leaves(sh[tree], is_leaf=lambda x: isinstance(x, tuple))
            for (path, a), b, pl in zip(T.leaves_with_paths(s0[tree]), T.leaves(s1[tree]), pls,
                                        strict=True):
                assert tuple(b.placements) == tuple(pl), (path, b.placements, pl)
                np.testing.assert_allclose(b.full_tensor().numpy(), a.numpy(), rtol=2e-4,
                                           atol=1e-6, err_msg=f"{{arch}} {{tree}} {{path}}")
        assert int(s1["step"].full_tensor()) == steps
        print("OK train", arch, opt_name, flush=True)

    def serve(arch, cfg=None, gen=4):
        cfg = cfg or get_config(arch, reduced=True)
        params = init_params(cfg, seed=0, device="cpu")
        B, S = 4, 12
        tokens = ints(cfg.vocab, (B, S))
        pre, dec = make_serve_fns(cfg, S + gen)
        with torch.no_grad():
            lg, c0 = pre(params, tokens)
            want = [lg]
            for i in range(gen):
                lg, c0 = dec(params, c0, want[-1].argmax(-1).to(torch.int32), S + i)
                want.append(lg)
        ctx = MeshContext(mesh, make_rules(cfg))
        fp, _ = jit_prefill(cfg, ctx, S + gen, params, {{"tokens": tokens}})
        lg, c1 = fp(params, tokens)
        fd, _, c_sh = jit_decode_step(cfg, ctx, S + gen, params, c1, B)
        got = [lg]
        for i in range(gen):
            lg, c1 = fd(params, c1, got[-1].argmax(-1).to(torch.int32), S + i)
            got.append(lg)
        for i, (a, b) in enumerate(zip(want, got, strict=True)):
            assert not hasattr(b, "placements")
            np.testing.assert_allclose(b.numpy(), a.numpy(), rtol=2e-4, atol=2e-5,
                                       err_msg=f"{{arch}} logits of step {{i}}")
        for a, b, pl in zip(T.leaves(c0), T.leaves(c1), T.leaves(
                c_sh, is_leaf=lambda x: isinstance(x, tuple)), strict=True):
            assert tuple(b.placements) == tuple(pl)
            np.testing.assert_allclose(b.full_tensor().numpy(), a.numpy(), rtol=2e-4,
                                       atol=2e-5, err_msg=f"{{arch}} caches")
        print("OK serve", arch, flush=True)

    def moe(experts):
        cfg = dataclasses.replace(get_config("grok-1-314b", reduced=True), num_experts=experts)
        params = init_params(cfg, seed=0, device="cpu")
        batch = {{"tokens": ints(cfg.vocab, (4, 12)), "labels": ints(cfg.vocab, (4, 12))}}
        live = T.map_leaves(lambda p: p.detach().requires_grad_(True), params)
        l0, m0 = loss_fn(cfg, live, batch)
        g0 = torch.autograd.grad(l0, T.leaves(live))
        ctx = MeshContext(mesh, make_rules(cfg))
        with _on(ctx):
            pp = place(params, param_shardings(cfg, params, ctx), mesh)
            live1 = T.map_leaves(lambda p: p.detach().requires_grad_(True), pp)
            l1, m1 = loss_fn(cfg, live1, place(batch, _placed(ctx, batch_specs(ctx, batch)), mesh))
            g1 = torch.autograd.grad(l1, T.leaves(live1))
        np.testing.assert_allclose(float(_global(l1)), float(l0), rtol=2e-5)
        np.testing.assert_allclose(float(_global(m1["aux"])), float(m0["aux"]), rtol=2e-5)
        for (path, _), a, b in zip(T.leaves_with_paths(params), g0, g1, strict=True):
            np.testing.assert_allclose(_global(b).numpy(), a.numpy(), rtol=2e-4, atol=1e-6,
                                       err_msg=f"grok E={{experts}} grad {{path}}")
        wi = pp["layers"][0]["ffn"]["wi"]
        print("OK moe", experts, [str(p) for p in wi.placements], flush=True)
        serve("grok-1-314b", cfg, gen=2)

    def gather():
        # the gather a mesh over gloo on the card takes (c10d's all_gather, chosen by the
        # mesh maker there), run here on CPU ranks through redistribute: the whole
        # tensor, one c10d gather per sharded mesh dim, and the gradient back in blocks
        from torch.distributed.tensor import Replicate, Shard
        import repro_torch.parallel as P

        full = torch.arange(4 * 6, dtype=torch.float32).reshape(4, 6)
        real, calls = P.all_gather, []

        def counted(x, dim, group):
            calls.append(dim)
            return real(x, dim, group)

        P.gather_through_c10d(mesh)
        P.all_gather = counted
        try:
            for pls in ((Shard(0), Shard(1)), (Shard(0), Shard(0)), (Replicate(), Shard(1)),
                        (Shard(1), Replicate())):
                calls.clear()
                x = place(full, pls, mesh).requires_grad_()
                y = P.redistribute(x, (Replicate(), Replicate()))
                assert all(isinstance(p, Replicate) for p in y.placements), y.placements
                assert torch.equal(y.to_local(), full), pls
                assert len(calls) == sum(isinstance(p, Shard) for p in pls), (pls, calls)
                g = torch.autograd.grad((y * y).sum(), x)[0]
                assert tuple(g.placements) == pls and torch.equal(g.full_tensor(), 2 * full), pls
        finally:
            P.all_gather = real
            P._C10D_GATHER.discard(mesh)
        print("OK gather", flush=True)

    def record_kernels():
        seen = []
        real = {{n: getattr(kernels, n) for n in ("rmsnorm", "flash_attention", "ssd_scan")}}

        def spy(name):
            def f(*a, **k):
                seen.append((name, [type(t).__name__ for t in a if isinstance(t, torch.Tensor)],
                             [tuple(t.shape) for t in a if isinstance(t, torch.Tensor)]))
                return real[name](*a, **k)
            return f

        cfg = get_config("internlm2-1.8b", reduced=True)
        opt = make_optimizer(OptConfig(), layer_groups=stacked_layer_groups(cfg))
        state = make_train_state_fn(cfg, opt, device="cpu")()
        batch = {{"tokens": ints(cfg.vocab, (4, 16)), "labels": ints(cfg.vocab, (4, 16))}}
        fn, _ = jit_train_step(cfg, opt, MeshContext(mesh, make_rules(cfg)), state, batch)
        mcfg = get_config("mamba2-370m", reduced=True)
        params = init_params(mcfg, seed=0, device="cpu")
        tokens = {{"tokens": ints(mcfg.vocab, (4, 12))}}
        fp, _ = jit_prefill(mcfg, MeshContext(mesh, make_rules(mcfg)), 16, params, tokens)
        for n in real:
            setattr(kernels, n, spy(n))
        try:
            fn(state, batch)  # the forward's K2 and K4, and K3 in the backward
            fp(params, tokens["tokens"])
        finally:
            for n, f in real.items():
                setattr(kernels, n, f)
        names = {{s[0] for s in seen}}
        assert names == {{"rmsnorm", "flash_attention", "ssd_scan"}}, names
        for name, types, shapes in seen:
            assert set(types) == {{"Tensor"}}, (name, types)
        print("KERNELS", json.dumps(seen), flush=True)

    for case in cases:
        if case == "train_adamw":
            train("internlm2-1.8b", "adamw")
        elif case == "train_adafactor":
            train("internlm2-1.8b", "adafactor")
        elif case == "serve":
            serve("gemma3-1b")
            serve("mamba2-370m")
        elif case == "serve_gemma":
            serve("gemma3-1b")
        elif case == "moe":
            moe(4)
            moe(3)
        elif case == "kernels":
            record_kernels()
        elif case == "gather":
            gather()
    dist.destroy_process_group()
    print("RANK PASSED", flush=True)
    """
)


def _mesh_run(tmp_path, data: int, model: int, cases: list[str]) -> list[str]:
    world = data * model
    script = _RANK.format(src=SRC, store=tmp_path / "store")
    outs = _run_ranks(script, world, lambda r: (str(r), str(world), str(data), str(model),
                                                ",".join(cases)), tmp_path)
    assert all("RANK PASSED" in out for out in outs)
    return outs


@pytest.mark.parametrize("data,model,cases", [
    (2, 1, ["train_adamw", "serve"]),
    (1, 2, ["train_adamw", "train_adafactor", "serve", "moe", "gather"]),
    (2, 2, ["train_adafactor", "serve", "moe", "gather"]),
], ids=["2x1", "1x2", "2x2"])
def test_placed_steps_match_the_single_device_port(data, model, cases, tmp_path):
    outs = _mesh_run(tmp_path, data, model, cases)
    for out in outs:
        for case in cases:
            tag = {"train_adamw": "OK train internlm2-1.8b adamw",
                   "train_adafactor": "OK train internlm2-1.8b adafactor",
                   "serve": "OK serve mamba2-370m", "moe": "OK moe 3",
                   "gather": "OK gather"}[case]
            assert tag in out, (case, out[-2000:])
    if model == 2:  # grok's experts: sharded at 4, the FFN width at 3 (the fallback)
        assert "OK moe 4 ['R', 'S(0)']" in outs[0]
        assert "OK moe 3 ['R', 'S(2)']" in outs[0]


def test_replicated_kv_heads_with_sharded_q_heads(tmp_path):
    """internlm2 reduced on 1×4: 4 q heads sharded one a rank, 2 kv heads (which do
    not divide 4) replicated; each rank's q head must meet kv head ``h // 2``."""
    outs = _mesh_run(tmp_path, 1, 4, ["train_adamw", "serve_gemma"])
    assert all("OK train internlm2-1.8b adamw" in out for out in outs)


def test_kernels_see_plain_local_tensors(tmp_path):
    outs = _mesh_run(tmp_path, 2, 1, ["kernels"])
    seen = json.loads(outs[0].split("KERNELS ")[1].splitlines()[0])
    for name, types, shapes in seen:
        assert types and set(types) == {"Tensor"}, (name, types)
        assert shapes[0][0] == 2, (name, shapes)  # batch 4 on the data axis of 2
    assert {s[0] for s in seen} == {"rmsnorm", "flash_attention", "ssd_scan"}


def _launch(args: list[str], timeout: int = TIMEOUT) -> subprocess.CompletedProcess:
    env = dict(os.environ, PYTHONPATH=SRC + os.pathsep + os.environ.get("PYTHONPATH", ""),
               OMP_NUM_THREADS="1")
    res = subprocess.run([sys.executable, *args], env=env, capture_output=True, text=True,
                         timeout=timeout)
    assert res.returncode == 0, res.stderr[-4000:]
    return res


def test_launch_train_torch_under_torch_distributed_run(tmp_path):
    base = ["-m", "torch.distributed.run", "--standalone", "--nproc-per-node", "2", "-m",
            "repro_torch.launch.train", "--reduced", "--device", "cpu", "--data-mesh", "2",
            "--batch", "4", "--seq", "16", "--ckpt-dir", str(tmp_path / "ck")]
    reports = []
    for steps in (3, 5):  # the second run resumes from each rank's own checkpoint
        res = _launch(base + ["--steps", str(steps)])
        reports.append([json.loads(line.split(" ", 1)[1]) for line in res.stdout.splitlines()
                        if line.startswith("SHARDED_RANK ")])
    first, second = reports
    assert sorted(r["rank"] for r in first) == [0, 1]
    for r in first:
        assert r["backend"] == "gloo" and r["steps"] == 3 and r["restarts"] == 0
        assert len(r["losses"]) == 3 and all(np.isfinite(r["losses"]))
        # one count of each kernel a step (none on the CPU, where the plain versions run)
        assert len(r["launches"]) == 3 and all(
            set(c) == {"rmsnorm_fwd", "rmsnorm_bwd", "flash_attention_fwd", "ssd_scan_fwd",
                       "fused_map", "fused_reduce", "fused"} for c in r["launches"])
    assert first[0]["losses"] == first[1]["losses"]
    for r in second:  # steps 3 and 4 only: steps 0-2 came back from the shards
        assert r["steps"] == 5 and len(r["losses"]) == 2
    assert sorted(os.listdir(tmp_path / "ck")) == ["rank0", "rank1"]


def test_launch_serve_torch_with_mesh_flags_serves_on_one_device():
    res = _launch(["-m", "repro_torch.launch.serve", "--reduced", "--device", "cpu",
                   "--batch", "2", "--prompt-len", "6", "--gen", "3", "--data-mesh", "2"])
    assert "serves on one device" in res.stdout
    assert "prefill: 2×6 tokens" in res.stdout and "decode:  3 steps" in res.stdout
