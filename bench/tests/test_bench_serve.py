"""The serving cell (``mellum2-12b.repo-ctx``) rehearsed on the CPU at the
configuration's smoke size through ``run.run_cell``: the program passes
and the control fails, faults planted under the timed path read not
correct, the traced window's readers read, a run loads no JAX, a
program without the configuration fails at once, and the yardstick
counts what it says."""
from __future__ import annotations

import dataclasses
import json
import os
import subprocess
import sys

import pytest
import torch

from bench import run as R
from bench.harness import common
from bench.loops import serve
from bench.reference import mellum2 as ref
from bench.traffic.mellum2_weights import Weights
from bench.yardstick.attention import visible_pairs
from bench.yardstick.experts import expert_bytes, expert_flops
from bench.yardstick.model_flops import request_flops

CELL = "mellum2-12b.repo-ctx"
ARCH = "mellum2-12b-a2.5b"
TINY_WL = {"batch": 2, "prompt_lengths": [32, 48], "new_tokens": 3}
# The smoke size computes in float32 (its config's dtype) on the same
# bfloat16 weights as the reference: the program reads at most 2.7e-6
# there and the float8 control at least 0.35 (three seeds); the cell's
# rule (60% of the log distance up from the program's reading) gives
# 3.1e-3 at that precision, rounded down to 1e-3.  The cell's own limit
# is for bfloat16 at full size.
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
    return dict(serve.as_published(smoke_config(ARCH)), smoke=True)


def tiny_run(seed: int = 2 ** 31 + 11, trace: bool = False, **wl):
    return R.run_cell(CELL, seed, 1.0, trace, require_cuda=False,
                      overrides={"config": tiny_config(),
                                 "workload": dict(TINY_WL, **wl)})


def test_program_passes_and_control_fails(cpu):
    run, metrics, *_ = tiny_run(limits=FLOAT32_LIMITS)
    assert run.correct, [(c.name, c.value) for c in run.checks]
    assert [m["name"] for m in metrics] == ["requests_per_s", "setup_s"]
    assert run.metrics["requests_per_s"] > 0 and run.attempted % 2 == 0
    wl = dict(common.load_json("workloads", CELL), **TINY_WL,
              limits=FLOAT32_LIMITS)
    # the control through the harness's tool, the loop's own
    from bench import serve_control
    ctl = serve_control.control_checks(wl, run)
    assert ctl == serve.control_checks(wl, run)
    assert ctl["logits_rel"] > wl["limits"]["logits_rel"], ctl


def test_traced_run_reads_its_metrics(cpu):
    run, metrics, device, breakdown = tiny_run(trace=True)
    got = {m["name"]: run.metrics.get(m["name"]) for m in metrics}
    assert set(got) == {"device.idle_pct.serve", "model.prefill_ms",
                        "model.decode_step_ms", "model.mfu_pct",
                        "attn.flash_roofline", "moe.grouped_roofline"}
    assert got["model.prefill_ms"] > 0 and got["model.decode_step_ms"] > 0
    # no card: the device readers and the MFU find nothing to read
    for name in ("device.idle_pct.serve", "model.mfu_pct",
                 "attn.flash_roofline", "moe.grouped_roofline"):
        assert got[name] is None, name
    names = {s["name"] for sp in run.layer["spans"] for s in sp}
    assert {"batch", "model.prefill", "model.decode_step", "moe.route",
            "moe.experts"} <= names
    assert device["window_s"] > 0 and set(breakdown) == {"device_ops",
                                                          "idle_gaps"}


# -- faults planted under the timed path ------------------------------------

def _top_k_less_one(mp):
    """Each token routed to one expert fewer than the configuration's."""
    from repro_torch.models import blocks
    orig = blocks.apply_moe_grouped

    def bad(p, x, cfg):
        moe = dataclasses.replace(cfg.moe, top_k=cfg.moe.top_k - 1)
        return orig(p, x, dataclasses.replace(cfg, moe=moe))
    mp.setattr(blocks, "apply_moe_grouped", bad)


def _full_attention_on_sliding_layers(mp):
    """The sliding layers' prefill attends over every earlier position."""
    from repro_torch.models import layers
    orig = layers.attention
    mp.setattr(layers, "attention",
               lambda *a, window=0, **k: orig(*a, window=0, **k))


def _default_rope_on_full_layers(mp):
    """The full layers' YaRN rope replaced by the default one."""
    from repro_torch.models import layers
    from repro_torch.models.config import RopeConfig
    orig = layers.rope

    def bad(x, positions, theta=10_000.0):
        if isinstance(theta, RopeConfig):
            theta = RopeConfig(theta=theta.theta)
        return orig(x, positions, theta)
    mp.setattr(layers, "rope", bad)


def _one_pair_dropped(mp):
    """The first (token, expert) pair of every expert layer's call left
    out: its row of the down product zeroed."""
    orig = torch._grouped_mm
    calls = []

    def bad(a, b, *args, **kw):
        out = orig(a, b, *args, **kw)
        calls.append(1)
        if len(calls) % 3 == 0:             # gate, up, down
            out[0] = 0
        return out
    mp.setattr(torch, "_grouped_mm", bad)


@pytest.mark.parametrize("fault", [
    _top_k_less_one, _full_attention_on_sliding_layers,
    _default_rope_on_full_layers, _one_pair_dropped],
    ids=lambda f: f.__name__.strip("_"))
def test_a_broken_timed_path_is_not_correct(fault, cpu, monkeypatch):
    run, *_ = tiny_run(limits=FLOAT32_LIMITS)
    assert run.correct, [(c.name, c.value) for c in run.checks]
    fault(monkeypatch)
    run, *_ = tiny_run(limits=FLOAT32_LIMITS)
    assert not run.correct, [(c.name, c.value) for c in run.checks]


def test_a_run_loads_no_jax():
    """What makes ``bench/run.py`` exit with code 3: JAX or the JAX
    package in ``sys.modules`` at the close of a run."""
    code = (
        "import json, sys\n"
        f"sys.path.insert(0, {str(common.ROOT)!r})\n"
        "from bench.harness import common\n"
        "from bench.tests.test_bench_serve import tiny_run\n"
        "run, *_ = tiny_run()\n"
        "print(json.dumps([run.correct, common.forbidden_loaded()]))\n")
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True,
                          text=True, timeout=300,
                          env=dict(os.environ, PYTHONPATH=str(common.SRC),
                                   REPRO_TORCH_DEVICE="cpu"))
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert json.loads(proc.stdout.strip().splitlines()[-1]) == [True, []]


def test_a_program_without_the_configuration_fails_at_once(cpu):
    cfg = dict(common.load_json("configs", ARCH), arch="no-such-model")
    with pytest.raises(common.BenchError, match="no configuration"):
        serve.run(cfg, dict(common.load_json("workloads", CELL)), 5, 1.0,
                  False, lambda: None, None)


def test_the_configuration_file_is_the_programs():
    """The file holds the published numbers; the program's full config
    gives each of them (``program_config`` raises on a difference)."""
    cfg = common.load_json("configs", ARCH)
    assert serve.program_config(cfg).name == ARCH
    bad = dict(cfg, sliding_window=2048)
    with pytest.raises(common.BenchError, match="sliding_window"):
        serve.program_config(bad)


def test_the_program_loads_the_published_weights(cpu):
    """The weights are the seed's alone (drawn again, the same; another
    seed, others); the program's loader carries each published tensor
    into its own layout and conventions; every token's experts are
    decided by the router band with a margin rounding cannot cross."""
    from repro_torch.configs import smoke_config
    from repro_torch.models import params_from_published
    cfg = tiny_config()
    w, again, other = (Weights(cfg, s, "cpu") for s in (7, 7, 8))
    name = "model.layers.1.mlp.experts.2.down_proj.weight"
    assert torch.equal(w[name], again[name])
    assert not torch.equal(w[name], other[name])
    assert all(w[n].dtype == torch.bfloat16 for n in ref.layer_names(cfg, 0))
    mcfg = smoke_config(ARCH)
    p = params_from_published(mcfg, w, torch.float32)
    lay = p["layers"][1]
    pre = "model.layers.1."
    f32 = {n: w[n].float() for n in w}
    assert torch.equal(lay["attn"]["wq"],
                       f32[pre + "self_attn.q_proj.weight"].T)
    assert torch.equal(lay["attn"]["ln"] + 1,
                       f32[pre + "input_layernorm.weight"])
    assert torch.equal(lay["mlp"]["w_down"][2], f32[name].T)
    assert torch.equal(lay["mlp"]["router"], f32[pre + "mlp.gate.weight"].T)
    assert torch.equal(p["head"], f32["lm_head.weight"].T)
    torch.testing.assert_close(p["embed"] * mcfg.d_model ** 0.5,
                               f32["model.embed_tokens.weight"])
    E, k = cfg["num_experts"], cfg["num_experts_per_tok"]
    band = f32["model.embed_tokens.weight"][:, :E]
    assert bool(((band > 0).sum(-1) == k).all())
    assert float(band[band > 0].min()) >= 1.0
    for n in (pre + "self_attn.o_proj.weight", name):
        assert not f32[n][:E].any()


def test_yardstick_counts():
    def brute(sq, sk, w):
        return sum(min(i + 1, w) if w else i + 1 for i in range(sk - sq, sk))
    for sq, sk, w in [(1, 1, 0), (5, 5, 2), (1, 20, 4), (20, 20, 0),
                      (7, 30, 16), (30, 30, 64)]:
        assert visible_pairs(sq, sk, w) == brute(sq, sk, w)
    assert expert_flops(10, 4, 3) == 3 * 2 * 10 * 4 * 3
    assert expert_bytes(10, 2, 4, 3) == 2 * (3 * 2 * 4 * 3 + 3 * 10 * 4
                                             + 3 * 10 * 3)
    # one layer of each kind, one token, no decode: the projections, the
    # router, k experts and the logits, and attention over one key
    cfg = {"hidden_size": 8, "num_attention_heads": 2,
           "num_key_value_heads": 1, "head_dim": 4, "num_experts": 4,
           "num_experts_per_tok": 2, "moe_intermediate_size": 3,
           "vocab_size": 10, "sliding_window": 2,
           "layer_types": ["sliding_attention", "full_attention"]}
    per_layer = 2 * 8 * 4 * (2 * 2 + 2 * 1) + 2 * 8 * 4 + 2 * 3 * 2 * 8 * 3 \
        + 4 * 4 * 2
    assert request_flops(cfg, 1, 0) == 2 * per_layer + 2 * 8 * 10
