"""Each FLOP and byte count on known shapes, and the metric readers on a made-up run."""

import types

import pytest

from portbench import run
from portbench.lib import common, flops, peaks, trace

INTERNLM2 = common.load_json(common.ROOT / "portbench/configs/internlm2-1.8b.json")["model"]
MYIA = common.load_json(common.ROOT / "portbench/configs/myia-lm-internlm2.json")["dims"]


def test_causal_pairs():
    assert flops.causal_pairs(4) == 10
    assert flops.causal_pairs(1, start=9) == 10
    assert flops.causal_pairs(3, start=2) == 3 * 2 + 6


def test_internlm2_counts():
    per_layer = 2048 * 2048 * 2 + 2048 * 1024 * 2 + 3 * 2048 * 8192
    assert flops.zoo_matmul_params(INTERNLM2) == 24 * per_layer + 2048 * 92544
    train = flops.zoo_train_flops(INTERNLM2, 8, 1024)
    assert train == 6 * (24 * per_layer + 2048 * 92544) * 8192 \
        + 12 * 24 * 8 * 16 * 128 * (1024 * 1025 // 2)
    assert 8.5e13 < train < 8.7e13
    decode = flops.zoo_serve_flops(INTERNLM2, 32, 1, 1024)
    assert decode == 2 * flops.zoo_matmul_params(INTERNLM2) * 32 + 4 * 24 * 32 * 16 * 128 * 1025


def test_attention_bound():
    b = flops.attn_fwd_bound_s(INTERNLM2, 8, 1024, 2, peaks.BF16_FLOPS)
    assert b == pytest.approx(4 * 8 * 16 * 128 * 524800 / 989e12)  # compute-bound
    tiny = flops.attn_fwd_bound_s(INTERNLM2, 1, 1, 2, peaks.BF16_FLOPS)
    assert tiny == pytest.approx(2 * 128 * (32 + 16) / 3.35e12)  # memory-bound


def test_myia_counts():
    assert flops.myia_matmul_params(MYIA) == 2 * 2048 * 8192 + 2048 * 92544
    assert flops.myia_train_flops(MYIA, 8, 256) == pytest.approx(2.74e12, rel=0.01)
    b = flops.myia_k1_bytes(MYIA, 8, 256)
    assert b["onehot"] == b["reduce"] == 8 * 2048 * 92544
    assert b["tanh_bwd_h"] == 4 * b["tanh_bwd_d"]


def made_up_run(workload, ops, counts, spans=(), window_s=None):
    found = common.find_cell(workload)
    t = trace.Trace(list(ops))
    s = common.Spans()
    s.items.extend(spans)
    return types.SimpleNamespace(found=found, trace=t, spans=s, counts=counts,
                                 window_s=window_s or (counts["end"] - counts["start"]) / 1e9)


def test_train_readers():
    step_s = 1.0
    k4 = [("void fa_fwd_tc_kernel<...>", int(i * 1e7), int(i * 1e7 + 1e6)) for i in range(96)]
    counts = {"start": 0, "end": int(2e9), "steps": 2, "batch": 8, "seq": 1024}
    r = made_up_run("internlm2-train-8x1024", k4, counts)
    got = run.read_metrics(r.found["metrics"]["per_layer"], r)
    bound = 96 * flops.attn_fwd_bound_s(INTERNLM2, 8, 1024, 2, peaks.BF16_FLOPS)
    assert got["attn_fwd_roofline.train"]["value"] == pytest.approx(100 * bound / 0.096)
    assert got["mfu.train"]["value"] == pytest.approx(
        100 * 2 * flops.zoo_train_flops(INTERNLM2, 8, 1024) / (2 * step_s * 989e12))
    assert got["device_idle_pct.train"]["value"] == pytest.approx(100 * (1 - 0.096 / 2))


def test_renamed_kernel_reads_missing():
    ops = [("renamed_attention", 0, 1000)] * 96
    counts = {"start": 0, "end": int(2e9), "steps": 2, "batch": 8, "seq": 1024}
    r = made_up_run("internlm2-train-8x1024", ops, counts)
    got = run.read_metrics(["attn_fwd_roofline.train"], r)
    assert got == {}


def test_serve_readers():
    counts = {"start": 0, "end": int(4e9), "batches": [1024, 4096], "batch": 32, "gen": 16}
    k4 = [("fa_fwd_tc_kernel", i * 1000, i * 1000 + 500) for i in range(48)]
    spans = [("decode_call", 0, int(0.8e9)), ("decode_call", int(2e9), int(2.8e9))]
    r = made_up_run("internlm2-serve-longprompt", k4, counts, spans)
    got = run.read_metrics(r.found["metrics"]["per_layer"], r)
    assert got["decode_ms_per_step.serve"]["value"] == pytest.approx(1.6e3 / 32)
    assert "attn_fwd_roofline.serve" in got and "mfu.serve" in got


def test_myia_readers():
    counts = {"start": 0, "end": int(1e9), "steps": 10, "batch": 8, "seq": 256}
    k1 = [(f"fused_{k}", i * 10_000, i * 10_000 + 900) for i in range(10)
          for k in ("map1", "map2", "map3", "reduce4", "reduce4")]
    r = made_up_run("myia-lm-train-8x256", k1, counts)
    got = run.read_metrics(r.found["metrics"]["per_layer"], r)
    assert got["mfu.myia"]["value"] == pytest.approx(
        100 * 10 * flops.myia_train_flops(MYIA, 8, 256) / 67e12)
    assert "k1_roofline.myia" in got


def test_leaf_gaps_and_median_difference():
    import torch

    from portbench.lib import compare

    assert compare.worst_leaf_gap([1.0, 2.0, 0.0], [1.0, 2.2, 0.001]) == pytest.approx(0.2 / 2.2)
    assert compare.worst_leaf_gap([1.0, 0.5], [1.0, 0.001], [True, False]) == 0.0
    assert compare.moving_leaves([1.0, 1.0, 1e-5]) == [True, True, False]
    assert compare.loss_gap([2.0, 1.0], [2.0, 1.1]) == pytest.approx(0.1 / 1.1)
    r = [torch.ones(4), torch.full((4,), 2.0), torch.zeros(4)]
    p = [torch.ones(4) * 1.1, torch.full((4,), 2.0), torch.ones(4)]
    assert compare.median_leaf_difference(p, r) == pytest.approx(0.05)
