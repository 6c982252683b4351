"""The port's training substrate (``repro_torch.{checkpoint,data,optim,runtime}``).

The first part mirrors ``tests/substrate/*`` test for test (checkpoint 5, data 5,
optim 5, runtime 4) on the port's torch trees.  The second holds the port against
the reference on identical numpy inputs: ``SyntheticLM`` batches byte for byte, the
schedule and the clip, and AdamW and Adafactor updates, including Adafactor's update
clip over a segment the reference stacks into one leaf.

Tolerances: the schedule, the clip and the updates are the same f32 arithmetic in
both packages, with transcendentals (cos, pow, sqrt, rsqrt) that may differ by an ulp
and sums taken in another order, so 1e-6 relative plus 1e-6 absolute: a few ulps of
values of order 1 (an ulp is 1.2e-7 to 2.4e-7 there).
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from hypothesis import given, settings, strategies as st

from repro import data as jdata
from repro import optim as joptim
from repro_torch import tree as T
from repro_torch.checkpoint import CheckpointManager, latest_step, restore, save
from repro_torch.data import (
    DataConfig,
    Prefetcher,
    SyntheticLM,
    make_batch_iterator,
    to_device,
)
from repro_torch.optim import OptConfig, clip_by_global_norm, make_optimizer, warmup_cosine
from repro_torch.runtime import StragglerWatchdog, TrainLoopConfig, train_loop

UPDATE_TOL = dict(rtol=1e-6, atol=1e-6)


# ===========================================================================
# checkpoint (tests/substrate/test_checkpoint.py)
# ===========================================================================


def _tree(step):
    return {
        "params": {
            "w": torch.full((4, 3), float(step)),
            "b": torch.arange(5, dtype=torch.int32),
            "h": torch.full((2, 2), float(step) + 0.5, dtype=torch.bfloat16),
            "layers": [{"n": torch.full((3,), float(step))}, {"n": torch.zeros(3)}],
        },
        "step": torch.tensor(step, dtype=torch.int32),
    }


def test_save_restore_roundtrip(tmp_path):
    d = str(tmp_path / "ckpt")
    save(d, 3, _tree(3))
    step, got = restore(d, target=_tree(0))
    assert step == 3
    np.testing.assert_array_equal(got["params"]["w"].numpy(), np.full((4, 3), 3.0))
    assert got["params"]["h"].dtype == torch.bfloat16  # stored as its int16 bits
    assert torch.equal(got["params"]["h"], _tree(3)["params"]["h"])
    assert torch.equal(got["params"]["layers"][0]["n"], torch.full((3,), 3.0))
    assert int(got["step"]) == 3 and got["step"].dtype == torch.int32


def test_latest_valid_wins_and_torn_write_skipped(tmp_path):
    d = str(tmp_path / "ckpt")
    save(d, 1, _tree(1))
    save(d, 2, _tree(2))
    # simulate a torn write at step 5: dir exists, manifest corrupt
    torn = os.path.join(d, "step_0000000005")
    os.makedirs(torn)
    with open(os.path.join(torn, "manifest.json"), "w") as f:
        f.write("{ not json")
    assert latest_step(d) == 2
    step, got = restore(d, target=_tree(0))
    assert step == 2


def test_tmp_dir_never_visible(tmp_path):
    d = str(tmp_path / "ckpt")
    save(d, 7, _tree(7))
    assert not any(n.endswith(".tmp") for n in os.listdir(d))


def test_manager_keep_k_and_async(tmp_path):
    d = str(tmp_path / "ckpt")
    mgr = CheckpointManager(d, keep=2)
    for s in range(5):
        mgr.save(s, _tree(s))
    mgr.wait()
    steps = sorted(n for n in os.listdir(d) if n.startswith("step_"))
    assert len(steps) == 2
    assert steps[-1] == "step_0000000004"


def test_restore_onto_a_device_and_refuse_another_tree(tmp_path):
    """The port of the elastic restore: leaves go to the asked device (or the
    target leaf's); a checkpoint of another tree is refused."""
    d = str(tmp_path / "ckpt")
    save(d, 0, _tree(0))
    step, got = restore(d, target=_tree(0), device="cpu")
    assert all(t.device == torch.device("cpu") for t in T.leaves(got))
    other = _tree(0)
    other["params"]["extra"] = torch.zeros(1)
    with pytest.raises(ValueError, match="another tree"):
        restore(d, target=other)


# ===========================================================================
# data (tests/substrate/test_data.py)
# ===========================================================================


def test_batches_deterministic_per_step():
    cfg = DataConfig(vocab=100, seq_len=32, global_batch=4)
    ds1, ds2 = SyntheticLM(cfg), SyntheticLM(cfg)
    b1, b2 = ds1.batch(7), ds2.batch(7)
    np.testing.assert_array_equal(b1["tokens"], b2["tokens"])
    assert not np.array_equal(ds1.batch(8)["tokens"], b1["tokens"])


def test_labels_are_shifted_tokens():
    cfg = DataConfig(vocab=100, seq_len=32, global_batch=2)
    b = SyntheticLM(cfg).batch(0)
    np.testing.assert_array_equal(b["tokens"][:, 1:], b["labels"][:, :-1])


def test_host_shards_partition_global_batch():
    full = SyntheticLM(DataConfig(vocab=50, seq_len=16, global_batch=8)).batch(3)
    shard_batches = [
        SyntheticLM(
            DataConfig(vocab=50, seq_len=16, global_batch=8, host_shard=h, num_host_shards=4)
        ).batch(3)
        for h in range(4)
    ]
    for b in shard_batches:
        assert b["tokens"].shape == (2, 16)
    assert not np.array_equal(shard_batches[0]["tokens"], shard_batches[1]["tokens"])
    assert full["tokens"].shape == (8, 16)


def test_induction_copy_structure():
    cfg = DataConfig(vocab=1000, seq_len=256, global_batch=1, copy_frac=0.5)
    toks = SyntheticLM(cfg).batch(0)["tokens"][0]
    seen = {}
    found = False
    for i in range(len(toks) - 8):
        key = tuple(toks[i : i + 8])
        if key in seen and seen[key] != i:
            found = True
            break
        seen[key] = i
    assert found


def test_prefetcher_preserves_order():
    it = iter([{"x": np.array([i])} for i in range(10)])
    pf = Prefetcher(it, depth=3)
    got = [next(pf)["x"][0] for _ in range(10)]
    assert got == list(range(10))


# ===========================================================================
# optim (tests/substrate/test_optim.py)
# ===========================================================================


def quad_loss(p):
    return torch.sum((p["w"] - 3.0) ** 2) + torch.sum((p["b"] + 1.0) ** 2)


@pytest.mark.parametrize("name", ["adamw", "adafactor"])
def test_converges_on_quadratic(name):
    # total_steps == the run length so the cosine schedule anneals lr → 0
    cfg = OptConfig(name=name, lr=0.1, weight_decay=0.0, warmup_steps=0, total_steps=300)
    opt = make_optimizer(cfg)
    params = {"w": torch.zeros((4, 130)), "b": torch.zeros((7,))}
    state = opt.init(params)
    for i in range(300):
        live = T.map_leaves(lambda t: t.detach().requires_grad_(True), params)
        g = torch.autograd.grad(quad_loss(live), T.leaves(live))
        params, state, _ = opt.update(T.unflatten(params, list(g)), state, params, i)
    assert float(quad_loss(params)) < 1e-2


def test_adamw_bf16_state_dtype():
    opt = make_optimizer(OptConfig(state_dtype="bfloat16"))
    state = opt.init({"w": torch.zeros((8, 8))})
    assert state["m"]["w"].dtype == torch.bfloat16
    assert state["v"]["w"].dtype == torch.bfloat16


def test_adafactor_factored_state_is_small():
    opt = make_optimizer(OptConfig(name="adafactor", min_dim_size_to_factor=128))
    params = {
        "big": torch.zeros((512, 256)), "small": torch.zeros((16, 16)), "vec": torch.zeros((300,))
    }
    st_ = opt.init(params)
    assert set(st_["v"]["big"]) == {"vr", "vc"}
    assert st_["v"]["big"]["vr"].shape == (512,)
    assert st_["v"]["big"]["vc"].shape == (256,)
    assert set(st_["v"]["small"]) == {"v"}
    assert set(st_["v"]["vec"]) == {"v"}


@settings(max_examples=20, deadline=None)
@given(scale=st.floats(0.01, 100.0), max_norm=st.floats(0.1, 10.0))
def test_clip_property(scale, max_norm):
    g = {"a": torch.full((5,), scale), "b": torch.full((3, 2), -scale)}
    clipped, gn = clip_by_global_norm(g, max_norm)
    new_norm = float(torch.sqrt(sum(torch.sum(torch.square(x)) for x in T.leaves(clipped))))
    assert new_norm <= max_norm * 1.01 + 1e-6
    if float(gn) <= max_norm:
        np.testing.assert_allclose(clipped["a"].numpy(), g["a"].numpy(), rtol=1e-5)


def test_schedule_shape():
    cfg = OptConfig(lr=1.0, warmup_steps=10, total_steps=110)
    lrs = [float(warmup_cosine(cfg, s)) for s in range(0, 111, 10)]
    assert lrs[0] == 0.0
    assert abs(lrs[1] - 1.0) < 1e-6
    assert lrs[-1] < 1e-3
    assert all(a >= b - 1e-9 for a, b in zip(lrs[1:], lrs[2:]))


# ===========================================================================
# runtime (tests/substrate/test_runtime.py)
# ===========================================================================


def _quadratic_setup(tmp_path, total=30, ckpt_every=10):
    cfg = TrainLoopConfig(
        total_steps=total,
        checkpoint_every=ckpt_every,
        checkpoint_dir=str(tmp_path / "ckpt"),
        max_restarts=5,
    )

    def step_fn(state, batch):
        p, s = state
        g = 2 * (p - batch)
        p = p - 0.1 * g
        return (p, s + 1), {"loss": torch.sum((p - batch) ** 2)}

    def init_state():
        return (torch.zeros((4,)), torch.tensor(0, dtype=torch.int32))

    def batch_fn(step):
        return torch.full((4,), 3.0)

    return cfg, step_fn, init_state, batch_fn


def test_loop_runs_and_checkpoints(tmp_path):
    cfg, step_fn, init_state, batch_fn = _quadratic_setup(tmp_path)
    res = train_loop(cfg, step_fn, init_state, batch_fn)
    assert res.final_step == 30
    assert res.restarts == 0
    assert res.losses[-1] < res.losses[0]


def test_crash_restart_resumes_from_checkpoint(tmp_path):
    cfg, step_fn, init_state, batch_fn = _quadratic_setup(tmp_path)
    crashed = {"done": False}

    def injector(step):
        if step == 17 and not crashed["done"]:
            crashed["done"] = True
            raise RuntimeError("simulated node failure")

    res = train_loop(cfg, step_fn, init_state, batch_fn, fault_injector=injector)
    assert res.restarts == 1
    assert res.final_step == 30
    assert int(res.state[1]) == 30

    cfg2, *rest = _quadratic_setup(tmp_path / "b")
    res2 = train_loop(cfg2, *rest)
    np.testing.assert_allclose(res.state[0].numpy(), res2.state[0].numpy(), rtol=1e-6)


def test_nonfinite_loss_triggers_restart(tmp_path):
    cfg, step_fn, init_state, _ = _quadratic_setup(tmp_path, total=12, ckpt_every=5)
    poisoned = {"armed": True}

    def batch_fn(step):
        if step == 7 and poisoned["armed"]:
            poisoned["armed"] = False
            return torch.full((4,), float("nan"))
        return torch.full((4,), 3.0)

    res = train_loop(cfg, step_fn, init_state, batch_fn)
    assert res.final_step == 12
    assert res.restarts == 1
    assert np.isfinite(res.losses[-1])


def test_straggler_watchdog_flags_outliers():
    wd = StragglerWatchdog(factor=3.0, warmup=3)
    for i in range(10):
        wd.observe(i, 0.01)
    assert wd.observe(10, 1.0) is True
    assert wd.flagged and wd.flagged[0][0] == 10
    assert wd.observe(11, 0.011) is False


# ===========================================================================
# against the reference on identical inputs
# ===========================================================================


@pytest.mark.parametrize("cfg", [
    dict(vocab=512, seq_len=16, global_batch=2),
    dict(vocab=92544, seq_len=64, global_batch=4, seed=3, copy_frac=0.5),
    dict(vocab=100, seq_len=32, global_batch=8, host_shard=1, num_host_shards=4),
])
def test_synthetic_batches_are_byte_equal_to_the_reference(cfg):
    port, want = SyntheticLM(DataConfig(**cfg)), jdata.SyntheticLM(jdata.DataConfig(**cfg))
    for step in (0, 1, 17):
        got, exp = port.batch(step), want.batch(step)
        for k in ("tokens", "labels"):
            assert got[k].dtype == exp[k].dtype and got[k].tobytes() == exp[k].tobytes()
        t = to_device(got, "cpu")
        assert t["tokens"].dtype == torch.int32
        assert t["tokens"].numpy().tobytes() == exp["tokens"].tobytes()


def test_batch_iterator_puts_batches_on_the_device():
    cfg = DataConfig(vocab=64, seq_len=8, global_batch=2)
    it = make_batch_iterator(cfg, device="cpu", start_step=3)
    b = next(it)
    assert isinstance(b["tokens"], torch.Tensor)
    np.testing.assert_array_equal(b["tokens"].numpy(), SyntheticLM(cfg).batch(3)["tokens"])
    host = make_batch_iterator(cfg, prefetch=0)
    np.testing.assert_array_equal(next(host)["labels"], SyntheticLM(cfg).batch(0)["labels"])


def test_schedule_and_clip_match_reference():
    cfg = dict(lr=3e-4, warmup_steps=7, total_steps=50)
    for s in range(0, 60, 3):
        np.testing.assert_allclose(
            float(warmup_cosine(OptConfig(**cfg), torch.tensor(s, dtype=torch.int32))),
            float(joptim.warmup_cosine(joptim.OptConfig(**cfg), jnp.int32(s))), **UPDATE_TOL,
        )
    rs = np.random.RandomState(0)
    g = {"a": rs.randn(5, 7).astype(np.float32) * 3, "b": rs.randn(11).astype(np.float32)}
    got, gn = clip_by_global_norm({k: torch.from_numpy(v) for k, v in g.items()}, 1.0)
    want, wgn = joptim.clip_by_global_norm({k: jnp.asarray(v) for k, v in g.items()}, 1.0)
    np.testing.assert_allclose(float(gn), float(wgn), **UPDATE_TOL)
    for k in g:
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]), **UPDATE_TOL)


REPS = 3  # layers of the stacked segment in the update tests


def _trees(seed):
    """A reference tree with a stacked segment (leading axis REPS) and the port's tree
    of the same values, one leaf per layer; values from numpy."""
    rs = np.random.RandomState(seed)
    w = rs.randn(REPS, 130, 140).astype(np.float32)  # factored per layer
    n = rs.randn(REPS, 200).astype(np.float32)  # a stacked vector: not factored
    b = rs.randn(300).astype(np.float32)
    ref_tree = {"segments": [{"layers": [{"w": w, "n": n}]}], "b": b}
    port_tree = {"layers": [{"w": w[r], "n": n[r]} for r in range(REPS)], "b": b}
    return ref_tree, port_tree


def _to_jax(tree):
    return jax.tree.map(jnp.asarray, tree)


def _to_torch(tree):
    return T.map_leaves(lambda a: torch.from_numpy(np.array(a)), tree)


def _assert_same(port_tree, ref_tree, tol=UPDATE_TOL):
    ref_tree = jax.tree.map(np.asarray, ref_tree)
    stacked = ref_tree["segments"][0]["layers"][0]
    for r in range(REPS):
        for k in ("w", "n"):
            np.testing.assert_allclose(port_tree["layers"][r][k].numpy(), stacked[k][r], **tol)
    np.testing.assert_allclose(port_tree["b"].numpy(), ref_tree["b"], **tol)


@pytest.mark.parametrize("name", ["adamw", "adafactor"])
def test_updates_match_reference_on_identical_inputs(name):
    """Three updates from one state with the same numpy gradients in both packages.
    Layer 0's gradients are scaled up at the later steps, so Adafactor's update clip
    (RMS ≤ 1) acts, and acts differently on a lone layer than on the stacked group;
    the port takes it over the group (``layer_groups``)."""
    cfg = dict(name=name, lr=0.1, warmup_steps=1, total_steps=10, min_dim_size_to_factor=128)
    jopt = joptim.make_optimizer(joptim.OptConfig(**cfg))
    topt = make_optimizer(OptConfig(**cfg), layer_groups=[list(range(REPS))])
    ref_p, port_p = _trees(0)
    jp, tp = _to_jax(ref_p), _to_torch(port_p)
    js, ts = jopt.init(jp), topt.init(tp)
    lone = make_optimizer(OptConfig(**cfg), layer_groups=[])  # every layer its own leaf
    lp, ls = tp, lone.init(tp)
    for step in range(3):
        ref_g, port_g = _trees(10 + step)
        if step:
            ref_g["segments"][0]["layers"][0]["w"][0] *= 50.0
            port_g["layers"][0]["w"] *= 50.0
        jp, js, jm = jopt.update(_to_jax(ref_g), js, jp, jnp.int32(step))
        tp, ts, tm = topt.update(_to_torch(port_g), ts, tp, torch.tensor(step, dtype=torch.int32))
        lp, ls, _ = lone.update(_to_torch(port_g), ls, lp, step)
        np.testing.assert_allclose(float(tm["gnorm"]), float(jm["gnorm"]), **UPDATE_TOL)
        np.testing.assert_allclose(float(tm["lr"]), float(jm["lr"]), **UPDATE_TOL)
        _assert_same(tp, jp)
    if name == "adamw":
        _assert_same(ts["m"], js["m"])
        _assert_same(ts["v"], js["v"])
    else:
        jv = jax.tree.map(np.asarray, js["v"])["segments"][0]["layers"][0]
        for r in range(REPS):
            np.testing.assert_allclose(ts["v"]["layers"][r]["w"]["vr"].numpy(),
                                       jv["w"]["vr"][r], **UPDATE_TOL)
            np.testing.assert_allclose(ts["v"]["layers"][r]["w"]["vc"].numpy(),
                                       jv["w"]["vc"][r], **UPDATE_TOL)
            np.testing.assert_allclose(ts["v"]["layers"][r]["n"]["v"].numpy(),
                                       jv["n"]["v"][r], **UPDATE_TOL)
        # without the grouping the clip differs: the lone layers move otherwise
        with pytest.raises(AssertionError):
            _assert_same(lp, jp)


def test_adafactor_refuses_a_group_factored_only_when_stacked():
    """A 1-D leaf of >= 128 values stacked >= 128 deep is factored in the reference
    but not per layer; the port says so instead of updating otherwise."""
    params = {"layers": [{"n": torch.zeros(128)} for _ in range(128)]}
    opt = make_optimizer(OptConfig(name="adafactor"), layer_groups=[list(range(128))])
    with pytest.raises(ValueError, match="factored when stacked"):
        opt.init(params)


def test_adafactor_refuses_layers_without_their_groups():
    """Without ``layer_groups`` Adafactor would clip each layer alone, which is not
    the reference's update on a stacked model: it refuses a tree of layers, and takes
    a tree without layers as it is."""
    opt = make_optimizer(OptConfig(name="adafactor"))
    with pytest.raises(ValueError, match="stacked_layer_groups"):
        opt.init({"layers": [{"n": torch.zeros(8)} for _ in range(2)]})
    assert set(opt.init({"n": torch.zeros(8)})["v"]) == {"n"}


def test_tree_helpers_round_trip():
    tree = {"b": [torch.zeros(1), {"z": torch.ones(2), "a": torch.ones(3)}], "a": torch.ones(4)}
    paths = [p for p, _ in T.leaves_with_paths(tree)]
    assert paths == [("a",), ("b", 0), ("b", 1, "a"), ("b", 1, "z")]
    back = T.unflatten(tree, T.leaves(tree))
    assert [p for p, _ in T.leaves_with_paths(back)] == paths
    with pytest.raises(ValueError, match="fewer leaves"):
        T.unflatten(tree, T.leaves(tree)[:-1])
    with pytest.raises(ValueError, match="more leaves"):
        T.unflatten(tree, T.leaves(tree) + [torch.zeros(1)])
