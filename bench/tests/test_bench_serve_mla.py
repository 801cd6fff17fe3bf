"""The latent-attention serving cell (``deepseek-v2-lite.doc-qa``)
rehearsed on the CPU at the configuration's smoke size through
``run.run_cell``: the program passes and the control fails, faults
planted under the timed path read not correct, a traced window's readers
read, a program without the configuration fails at set-up, the
configuration file is the program's, the weights are the seed's, and the
yardstick and the readers count what they say."""
from __future__ import annotations

import dataclasses
import types

import pytest
import torch

from bench import run as R
from bench.harness import common
from bench.loops import serve_mla
from bench.reference import deepseek_v2 as ref
from bench.traffic.deepseek_v2_weights import Weights
from bench.yardstick.attention import visible_pairs
from bench.yardstick.mla_attention import mla_bytes, mla_flops, mla_seconds
from bench.yardstick.mla_flops import request_flops

CELL = "deepseek-v2-lite.doc-qa"
ARCH = "deepseek-v2-lite"
TINY_WL = {"batch": 2, "prompt_lengths": [16, 32], "new_tokens": 3}
# The smoke size computes in float32 (its config's dtype) on the same
# bfloat16 weights as the reference: the program reads about 1e-6 there
# and the float8 control about 0.28, as in the Mellum2 cell's rehearsal
# (bench/tests/test_bench_serve.py), whose float32 limit this is.  The
# cell's own limit is for bfloat16 at full size.
FLOAT32_LIMITS = {"logits_rel": 1e-3}


@pytest.fixture
def cpu():
    from repro_torch.device import set_device
    prev = set_device("cpu")
    try:
        yield
    finally:
        set_device(prev)


def tiny_config() -> dict:
    """The configuration file's numbers at the program's smoke size."""
    from repro_torch.configs import smoke_config
    return dict(serve_mla.as_published(smoke_config(ARCH)), smoke=True)


def tiny_run(seed: int = 2 ** 31 + 13, trace: bool = False, **wl):
    return R.run_cell(CELL, seed, 0.5, trace, require_cuda=False,
                      overrides={"config": tiny_config(),
                                 "workload": dict(TINY_WL, **wl)})


def test_program_passes_and_control_fails(cpu):
    run, metrics, *_ = tiny_run(limits=FLOAT32_LIMITS)
    assert run.correct, [(c.name, c.value) for c in run.checks]
    assert [m["name"] for m in metrics] == ["requests_per_s", "setup_s"]
    assert run.metrics["requests_per_s"] > 0 and run.attempted % 2 == 0
    wl = dict(common.load_json("workloads", CELL), **TINY_WL,
              limits=FLOAT32_LIMITS)
    from bench import serve_control
    ctl = serve_control.control_checks(wl, run)
    assert ctl == serve_mla.control_checks(wl, run)
    assert ctl["logits_rel"] > 100 * wl["limits"]["logits_rel"], ctl


def test_traced_run_reads_its_metrics(cpu):
    run, metrics, device, breakdown = tiny_run(trace=True)
    got = {m["name"]: run.metrics.get(m["name"]) for m in metrics}
    assert set(got) == {"device.idle_pct.serve", "model.prefill_ms",
                        "model.decode_step_ms", "mla.flash_roofline",
                        "mla.mfu_pct"}
    assert got["model.prefill_ms"] > 0 and got["model.decode_step_ms"] > 0
    # no card: the device readers and the MFU find nothing to read
    for name in ("device.idle_pct.serve", "mla.flash_roofline",
                 "mla.mfu_pct"):
        assert got[name] is None, name
    names = {s["name"] for sp in run.layer["spans"] for s in sp}
    assert {"batch", "model.prefill", "model.decode_step", "attn.mla",
            "moe.route", "moe.experts", "moe.shared"} <= names
    assert device["window_s"] > 0 and set(breakdown) == {"device_ops",
                                                          "idle_gaps"}


def _gates_renormalized(mp):
    """The routed experts' gates renormalized by their top-k sum."""
    from repro_torch.models import blocks
    orig = blocks.apply_moe_grouped

    def bad(p, x, cfg):
        moe = dataclasses.replace(cfg.moe, norm_topk_prob=True)
        return orig(p, x, dataclasses.replace(cfg, moe=moe))
    mp.setattr(blocks, "apply_moe_grouped", bad)


def _no_softmax_mscale(mp):
    """The softmax scale without YaRN's m²."""
    from repro_torch.models.config import RopeConfig
    mp.setattr(RopeConfig, "softmax_factor", property(lambda self: 1.0))


@pytest.mark.parametrize("fault", [_gates_renormalized, _no_softmax_mscale],
                         ids=lambda f: f.__name__.strip("_"))
def test_a_broken_timed_path_is_not_correct(fault, cpu, monkeypatch):
    fault(monkeypatch)
    run, *_ = tiny_run(limits=FLOAT32_LIMITS)
    assert not run.correct, [(c.name, c.value) for c in run.checks]


def test_a_program_without_the_configuration_fails_at_once(cpu):
    """What the parent commit does on this cell: no such configuration,
    a ``BenchError`` at set-up (``bench/run.py`` exits 2)."""
    cfg = dict(common.load_json("configs", ARCH), arch="no-such-model")
    with pytest.raises(common.BenchError, match="no configuration"):
        serve_mla.run(cfg, dict(common.load_json("workloads", CELL)), 5,
                      1.0, False, lambda: None, None)


def test_the_configuration_file_is_the_programs():
    """The file holds the published numbers; the program's full config
    gives each of them (``program_config`` raises on a difference)."""
    cfg = common.load_json("configs", ARCH)
    assert serve_mla.program_config(cfg).name == ARCH
    assert cfg["reduced"] == {}
    for key, value in (("kv_lora_rank", 256), ("norm_topk_prob", True),
                       ("rope_scaling", dict(cfg["rope_scaling"],
                                             mscale_all_dim=1.0))):
        with pytest.raises(common.BenchError, match=key):
            serve_mla.program_config(dict(cfg, **{key: value}))


def test_the_program_loads_the_published_weights(cpu):
    """The weights are the seed's alone; every name the reference reads
    has a shape; the program's loader carries the shared experts and the
    dense layer; every token's routed experts are decided by the router
    band with a margin rounding cannot cross."""
    from repro_torch.configs import smoke_config
    from repro_torch.models import params_from_published
    cfg = tiny_config()
    w, again, other = (Weights(cfg, s, "cpu") for s in (7, 7, 8))
    name = "model.layers.1.mlp.shared_experts.down_proj.weight"
    assert torch.equal(w[name], again[name])
    assert not torch.equal(w[name], other[name])
    for i in range(cfg["num_hidden_layers"]):
        assert set(ref.layer_names(cfg, i)) <= set(w.shapes)
    p = params_from_published(smoke_config(ARCH), w, torch.float32)
    assert torch.equal(p["layers"][1]["mlp"]["shared"]["w_down"],
                       w[name].float().T)
    assert torch.equal(p["layers"][0]["mlp"]["w_up"], w[
        "model.layers.0.mlp.up_proj.weight"].float().T)
    E, k = cfg["n_routed_experts"], cfg["num_experts_per_tok"]
    band = w["model.embed_tokens.weight"].float()[:, :E]
    assert bool(((band > 0).sum(-1) == k).all())
    for n in ("model.layers.0.mlp.down_proj.weight", name,
              "model.layers.2.self_attn.o_proj.weight"):
        assert not w[n][:E].any()


def test_yardstick_counts():
    # one prompt of 3 over 3 keys: 6 causal pairs
    assert mla_flops(2, 3, 3, 4, 24, 16) == 2 * 40 * 2 * 4 * 6
    assert mla_bytes(2, 3, 5, 4, 24, 16) == 2 * 2 * 4 * (3 * 40 + 5 * 40)
    assert mla_seconds(1, 8, 8, 1, 8, 8) > 0
    cfg = {"hidden_size": 8, "num_attention_heads": 2, "kv_lora_rank": 4,
           "qk_nope_head_dim": 3, "qk_rope_head_dim": 2, "v_head_dim": 3,
           "n_routed_experts": 4, "num_experts_per_tok": 2,
           "moe_intermediate_size": 3, "intermediate_size": 5,
           "n_shared_experts": 2, "first_k_dense_replace": 1,
           "num_hidden_layers": 2, "vocab_size": 10}
    attn = 2 * (8 * 2 * 5 + 8 * 6 + 4 * 2 * 6 + 2 * 3 * 8)
    dense, sparse = 6 * 8 * 5, 2 * 8 * 4 + 2 * 6 * 8 * 3 + 6 * 8 * 6
    # one token, no decode: one pair a layer at 2·H·(dqk + dv)
    assert request_flops(cfg, 1, 0) == \
        2 * attn + dense + sparse + 2 * 2 * 2 * 8 + 2 * 8 * 10
    # one decode step more: two tokens a layer, 1 + 2 pairs, two logits
    assert request_flops(cfg, 1, 1) == 2 * (2 * attn + 3 * 2 * 2 * 8) + \
        2 * dense + 2 * sparse + 2 * 2 * 8 * 10
    assert visible_pairs(1, 2) == 2


def test_flash_roofline_reads_the_decompressed_calls():
    """``mla.flash_roofline`` on a made-up window: one prefill with two
    decompressed calls and one absorbed (not counted) under it, two
    flash launches inside it and one outside."""
    reader = common.load_module("metrics", "mla.flash_roofline")
    cfg = common.load_json("configs", ARCH)
    tag = {"form": "decompressed", "batch": 4, "tokens": 4 * 1024,
           "keys": 1024}
    spans = [{"span_id": 1, "parent_id": 0, "name": "model.prefill",
              "start": 10.0, "dur_s": 1.0, "tags": {}},
             {"span_id": 2, "parent_id": 1, "name": "attn.mla",
              "start": 10.1, "dur_s": 0.1, "tags": tag},
             {"span_id": 3, "parent_id": 1, "name": "attn.mla",
              "start": 10.3, "dur_s": 0.1, "tags": tag},
             {"span_id": 4, "parent_id": 1, "name": "attn.mla",
              "start": 10.5, "dur_s": 0.1, "tags": dict(tag,
                                                         form="absorbed")}]
    prof = types.SimpleNamespace(
        events=[("flash_tc_kernel<256>", 10.2e6, 10.2e6 + 2000),
                ("flash_tc_kernel<256>", 10.4e6, 10.4e6 + 3000),
                ("flash_tc_kernel<256>", 12.0e6, 12.0e6 + 9000),
                ("other", 10.2e6, 10.3e6)],
        wall=lambda us: us / 1e6)
    run = types.SimpleNamespace(profile=prof, layer={"spans": [spans],
                                                     "cfg": cfg})
    need = 2 * mla_seconds(4, 1024, 1024, 16, 192, 128)
    assert reader.read(run) == pytest.approx(100 * need / 5e-3)
    run.layer["spans"] = [spans[:1]]            # no tagged call: nothing
    assert reader.read(run) is None
