"""The port's attention layers, flash_attention and attention block
against the JAX package's, on identical numpy inputs.

On CPU tensors the port's ``flash_attention`` wrapper runs its plain
version (``flash_attention_ref``, the model's ``attention_naive``); it
is held against the JAX Pallas kernel in interpret mode.  The CUDA
kernel itself is held against the plain version on the card by
tests/test_torch_cuda.py and ``chip_smoke.py``.

Tolerances:
* float32 rtol=atol=2e-5 — the JAX package's own tolerance between its
  flash kernel and the naive form (tests/test_kernels.py), which also
  covers like forms here (float32 products summed in another order);
* bfloat16 rtol=atol=5e-2 — the JAX package's own bf16 flash tolerance;
  the two frameworks round bf16 intermediates (the softmax weights, the
  einsum outputs) at different places;
* rtol=atol=1e-4 for the attention block (projections, RoPE, ring
  caches), float32 through a few more matmuls;
* for the CUDA bf16 kernel's rounding, emulated here, chip_smoke's own
  tolerances: rtol=atol=2e-2 against the plain version on the same bf16
  inputs, rtol=atol=1e-2 against float32 arithmetic, and a relative
  Frobenius error within 5e-3 against float32 arithmetic in each quarter
  of the query positions.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro.kernels import ref as jref
from repro.kernels.flash_attention import flash_attention as jflash
from repro.models import blocks as JB
from repro.models import layers as JL
from repro_torch.configs import smoke_config
from repro_torch.device import set_device
from repro_torch.kernels import flash_attention, flash_attention_ref, ops
from repro_torch.launch.serve import generate
from repro_torch.models import blocks as PB
from repro_torch.models import init_params
from repro_torch.models import layers as PL

from _config_schema import port_config

F32_TOL = dict(rtol=2e-5, atol=2e-5)
BF16_TOL = dict(rtol=5e-2, atol=5e-2)
BLOCK_TOL = dict(rtol=1e-4, atol=1e-4)
# (S, H, KV, Dh, block_q, block_k) of the JAX package's own flash test
SHAPES = [(128, 4, 4, 32, 32, 32),      # MHA
          (128, 4, 2, 32, 64, 32),      # GQA
          (256, 8, 1, 64, 64, 64)]      # MQA
MASKS = [(True, 0), (True, 48), (False, 0), (False, 48)]
# chip_smoke's bf16 flash cases, cut to batch 1 and two heads:
# (S, H, KV, Dh, causal, window), and its tolerances (rtol = atol)
CHIP_BF16_CASES = [(512, 2, 1, 256, True, 2048), (4096, 2, 1, 256, True, 2048)]
FLASH_TOL_BF16 = 2e-2         # against the plain version, bf16 inputs
FLASH_F32_TOL = 1e-2          # against float32 arithmetic
FLASH_BANDS, FLASH_BAND_TOL = 4, 5e-3   # relative Frobenius, by row band
BLOCK_K = 64                  # keys a tile of the bf16 kernel
# the grouped decode attention against the reference: float32 to a few
# units of its last place (the products sum in another order), bfloat16
# to its last place
DECODE_TOL = {"float32": dict(rtol=2e-6, atol=2e-6),
              "bfloat16": dict(rtol=2 ** -7, atol=0)}
# (G, KV): multi-head (KV = H), two groups, Mellum2's 8 × 4, MQA
DECODE_GROUPS = [(1, 4), (4, 2), (8, 4), (16, 1)]
NEG_INF = -1e30


@pytest.fixture(autouse=True)
def _cpu():
    prev = set_device("cpu")
    yield
    set_device(prev)


def t(a):
    return torch.from_numpy(np.array(a))


def close(got, want, tol):
    np.testing.assert_allclose(np.asarray(got, np.float32),
                               np.asarray(want, np.float32), **tol)


def qkv(B, Sq, Sk, H, KV, Dh, seed):
    rng = np.random.default_rng(seed)
    q = rng.normal(0, 1, (B, Sq, H, Dh)).astype(np.float32)
    k, v = (rng.normal(0, 1, (B, Sk, KV, Dh)).astype(np.float32)
            for _ in range(2))
    return q, k, v


# ---------------------------------------------------------------------------
# flash_attention
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("causal,window", MASKS)
@pytest.mark.parametrize("S,H,KV,Dh,bq,bk", SHAPES)
def test_flash_matches_pallas_interpret(S, H, KV, Dh, bq, bk, causal,
                                        window):
    q, k, v = qkv(2, S, S, H, KV, Dh, seed=S + H + KV)
    out = flash_attention(t(q), t(k), t(v), causal=causal, window=window)
    want = jflash(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                  causal=causal, window=window, block_q=bq, block_k=bk,
                  interpret=True)
    assert out.shape == q.shape and out.dtype == torch.float32
    close(out, want, F32_TOL)


@pytest.mark.parametrize("causal,window", MASKS)
def test_flash_matches_reference_oracle(causal, window):
    q, k, v = qkv(2, 96, 96, 4, 2, 16, seed=1)
    close(flash_attention(t(q), t(k), t(v), causal=causal, window=window),
          jref.flash_attention_ref(*map(jnp.asarray, (q, k, v)), causal,
                                   window), F32_TOL)


@pytest.mark.parametrize("KV", [2, 1])
def test_flash_bf16_matches_pallas_interpret(KV):
    q, k, v = qkv(1, 64, 64, 2, KV, 32, seed=KV)
    out = flash_attention(*(t(a).to(torch.bfloat16) for a in (q, k, v)))
    want = jflash(*(jnp.asarray(a, jnp.bfloat16) for a in (q, k, v)),
                  block_q=32, block_k=32, interpret=True)
    assert out.dtype == torch.bfloat16
    close(out.float(), np.asarray(want, np.float32), BF16_TOL)


def test_flash_rows_that_see_nothing_match_pallas():
    """Sq > Sk under a window: the last rows see no key, and both average
    every value (the NEG_INF fill, not -inf)."""
    q, k, v = qkv(1, 64, 32, 2, 1, 16, seed=3)
    out = flash_attention(t(q), t(k), t(v), causal=True, window=8)
    want = jflash(*map(jnp.asarray, (q, k, v)), causal=True, window=8,
                  block_q=32, block_k=32, interpret=True)
    close(out, want, F32_TOL)
    close(out[0, -1], t(v)[0].mean(0).expand(2, 16), F32_TOL)


def test_flash_cpu_runs_plain_version_without_launch():
    before = ops.kernel_launches()["flash_attention"]
    q, k, v = map(t, qkv(1, 16, 16, 2, 1, 16, seed=4))
    out = flash_attention(q, k, v, window=4)
    assert ops.kernel_launches()["flash_attention"] == before
    close(out, flash_attention_ref(q, k, v, True, 4), dict(rtol=0, atol=0))


@pytest.mark.parametrize("case", ["dtype", "mixed_dtype", "head_dim",
                                  "groups", "kv_shapes", "last_stride"])
def test_flash_rejects_what_the_kernel_does_not_take(case):
    q, k, v = map(t, qkv(1, 16, 16, 4, 2, 16, seed=5))
    if case == "dtype":
        q, k, v = q.half(), k.half(), v.half()
    elif case == "mixed_dtype":
        k = k.to(torch.bfloat16)
    elif case == "head_dim":
        q, k, v = (a[..., :12].contiguous() for a in (q, k, v))
    elif case == "groups":
        q = q[:, :, :3].contiguous()
    elif case == "kv_shapes":
        v = v[:, :8]
    else:
        q = q.transpose(2, 3).contiguous().transpose(2, 3)
    with pytest.raises((TypeError, ValueError)):
        flash_attention(q, k, v)


def bf16_kernel_form(q, k, v, causal, window):
    """flash_attention as the CUDA kernel computes bf16 inputs: q.k in
    float32 from bf16 operands, scores in log2 units, key tiles of
    :data:`BLOCK_K` folded one at a time into float32 m, l and acc, the
    softmax weights rounded to bf16 before P.V (l sums them unrounded),
    masked scores NEG_INF and keys past Sk -inf, o = acc / max(l, 1e-30)
    rounded to bf16.  q: (B, Sq, H, Dh), k, v: (B, Sk, KV, Dh)."""
    b, sq, h, dh = q.shape
    sk, kv = k.shape[1], k.shape[2]
    qf = q.float().transpose(1, 2)                                # B,H,Sq,D
    kf, vf = (x.float().repeat_interleave(h // kv, dim=2).transpose(1, 2)
              for x in (k, v))
    scale = dh ** -0.5 * 1.4426950408889634
    rows = torch.arange(sq)[:, None]
    m = torch.full((b, h, sq, 1), NEG_INF)
    l = torch.zeros((b, h, sq, 1))
    acc = torch.zeros((b, h, sq, dh))
    for t0 in range(0, sk, BLOCK_K):
        keys = torch.arange(t0, t0 + BLOCK_K)[None, :]
        kt = kf[:, :, t0:t0 + BLOCK_K]
        s = torch.full((b, h, sq, BLOCK_K), -torch.inf)
        s[..., :kt.shape[2]] = qf @ kt.transpose(-1, -2) * scale
        d = rows - keys
        masked = (d < 0) if causal else torch.zeros_like(d, dtype=torch.bool)
        if window:
            masked |= d >= window
        s = torch.where(masked & (keys < sk), NEG_INF, s)
        m_new = torch.maximum(m, s.amax(-1, keepdim=True))
        alpha = torch.exp2(m - m_new)
        p = torch.exp2(s - m_new)
        l = l * alpha + p.sum(-1, keepdim=True)
        p16 = p[..., :kt.shape[2]].to(torch.bfloat16).float()
        acc = acc * alpha + p16 @ vf[:, :, t0:t0 + BLOCK_K]
        m = m_new
    o = acc / torch.clamp_min(l, 1e-30)
    return o.transpose(1, 2).to(torch.bfloat16)


@pytest.mark.parametrize("S,H,KV,Dh,causal,window", CHIP_BF16_CASES)
def test_bf16_kernel_rounding_holds_chip_tolerances(S, H, KV, Dh, causal,
                                                    window):
    """The bf16 kernel's rounding points stay inside chip_smoke's
    tolerances at its bf16 cases (batch 1, two heads)."""
    q, k, v = (t(a).to(torch.bfloat16)
               for a in qkv(1, S, S, H, KV, Dh, seed=S + Dh))
    got = bf16_kernel_form(q, k, v, causal, window).float()
    plain = flash_attention_ref(q, k, v, causal, window).float()
    close(got, plain, dict(rtol=FLASH_TOL_BF16, atol=FLASH_TOL_BF16))
    f32 = flash_attention_ref(q.float(), k.float(), v.float(), causal,
                              window)
    close(got, f32, dict(rtol=FLASH_F32_TOL, atol=FLASH_F32_TOL))
    for i in range(FLASH_BANDS):
        band = slice(i * S // FLASH_BANDS, (i + 1) * S // FLASH_BANDS)
        rel = (got[:, band] - f32[:, band]).norm() / f32[:, band].norm()
        assert rel <= FLASH_BAND_TOL, (i, float(rel))


@pytest.mark.parametrize("causal,window", [(True, 0), (False, 24),
                                           (True, 8)])
def test_bf16_kernel_form_rows_that_see_nothing(causal, window):
    """Sq > Sk under a window and a ragged last key tile: the emulated
    kernel averages every value for rows that see no key, as the plain
    version does, and agrees with it elsewhere."""
    q, k, v = (t(a).to(torch.bfloat16)
               for a in qkv(1, 90, 40, 2, 1, 24, seed=window))
    got = bf16_kernel_form(q, k, v, causal, window).float()
    f32 = flash_attention_ref(q.float(), k.float(), v.float(), causal,
                              window)
    close(got, f32, dict(rtol=FLASH_F32_TOL, atol=FLASH_F32_TOL))


def test_flash_mixed_devices_raise():
    q, k, v = map(t, qkv(1, 8, 8, 2, 1, 16, seed=6))
    with pytest.raises(ValueError):
        flash_attention(q, k, v.to("meta"))


# ---------------------------------------------------------------------------
# layers
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("theta", [10_000.0, 1_000_000.0])
def test_rope_matches(dtype, theta):
    rng = np.random.default_rng(7)
    x = rng.normal(0, 1, (2, 9, 3, 16)).astype(np.float32)
    pos = rng.integers(0, 5000, (2, 9)).astype(np.int32)
    got = PL.rope(t(x).to(getattr(torch, dtype)), t(pos), theta)
    want = JL.rope(jnp.asarray(x, dtype), jnp.asarray(pos), theta)
    assert got.dtype == getattr(torch, dtype)
    # float32: angles up to 5000 rad lose ~3e-4 in either framework's
    # sin/cos of a float32 argument
    tol = dict(rtol=1e-3, atol=1e-3) if dtype == "float32" else BF16_TOL
    close(got.float(), np.asarray(want, np.float32), tol)


def positions_with_holes(B, S, seed):
    """Increasing absolute positions with some slots marked -1 (empty
    ring slots)."""
    rng = np.random.default_rng(seed)
    pos = np.tile(np.arange(S, dtype=np.int32) + 5, (B, 1))
    pos[rng.random((B, S)) < 0.2] = -1
    return pos


@pytest.mark.parametrize("causal,window", MASKS)
def test_mask_bias_matches(causal, window):
    qp = positions_with_holes(2, 12, seed=8)
    kp = positions_with_holes(2, 20, seed=9)
    close(PL._mask_bias(t(qp), t(kp), causal, window),
          JL._mask_bias(jnp.asarray(qp), jnp.asarray(kp), causal, window),
          dict(rtol=0, atol=0))


@pytest.mark.parametrize("kv_map", [None, [0, 0, 1, 1, 0, 0]])
@pytest.mark.parametrize("causal,window", MASKS)
def test_attention_naive_matches(causal, window, kv_map):
    q, k, v = qkv(2, 12, 20, 6, 2, 16, seed=10)
    qp = np.tile(np.arange(12, dtype=np.int32) + 8, (2, 1))
    kp = positions_with_holes(2, 20, seed=11)
    km = None if kv_map is None else np.asarray(kv_map, np.int32)
    got = PL.attention_naive(t(q), t(k), t(v), t(qp), t(kp), causal, window,
                             kv_map=None if km is None else t(km))
    want = JL.attention_naive(*map(jnp.asarray, (q, k, v, qp, kp)), causal,
                              window,
                              kv_map=None if km is None else jnp.asarray(km))
    close(got, want, F32_TOL)


def test_expand_kv_groups_consecutive_heads():
    """jnp.repeat along the head axis is repeat_interleave, not repeat."""
    k = np.random.default_rng(12).normal(0, 1, (1, 3, 2, 4)).astype(
        np.float32)
    close(PL._expand_kv(t(k), 6), JL._expand_kv(jnp.asarray(k), 6),
          dict(rtol=0, atol=0))


def ring_positions(B, S, Sq, ring):
    """The step's positions and the slot positions of rings of S slots
    once a decode step of Sq tokens is written: ``unwritten`` has fewer
    positions than slots (-1 past them), ``wrapped`` has written past
    its end, each slot holding the latest position ≡ slot mod S; each
    row has written its own count."""
    qp = np.empty((B, Sq), np.int32)
    kp = np.full((B, S), -1, np.int32)
    for b in range(B):
        n = S - 5 + b if ring == "unwritten" else 2 * S + 3 + b
        for p in range(max(0, n - S), n):
            kp[b, p % S] = p
        qp[b] = np.arange(n - Sq, n)
    return qp, kp


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("Sq", [1, 3])
@pytest.mark.parametrize("ring", ["unwritten", "wrapped"])
@pytest.mark.parametrize("window", [0, 8])
@pytest.mark.parametrize("G,KV", DECODE_GROUPS)
def test_attention_decode_matches_naive_over_expanded_rings(G, KV, window,
                                                             ring, Sq, dtype):
    """The grouped decode attention returns what the reference returns
    over the rings repeated to the query heads."""
    B, S, Dh = 3, 37, 16
    dt = getattr(torch, dtype)
    q, k, v = (t(a).to(dt) for a in qkv(B, Sq, S, G * KV, KV, Dh,
                                         seed=G + KV))
    qp, kp = map(t, ring_positions(B, S, Sq, ring))
    got = PL.attention_decode(q, k, v, qp, kp, window)
    want = PL.attention_naive(q, k, v, qp, kp, True, window)
    assert got.dtype == want.dtype and got.shape == want.shape
    torch.testing.assert_close(got, want, **DECODE_TOL[dtype])


@pytest.mark.parametrize("triangular", [False, True])
@pytest.mark.parametrize("causal,window", MASKS)
@pytest.mark.parametrize("S,chunk", [(64, 16), (50, 16)])
def test_attention_chunked_matches(S, chunk, causal, window, triangular):
    q, k, v = qkv(2, S, S, 4, 2, 16, seed=S + chunk)
    pos = np.tile(np.arange(S, dtype=np.int32), (2, 1))
    got = PL.attention_chunked(t(q), t(k), t(v), t(pos), t(pos), causal,
                               window, chunk=chunk, triangular=triangular)
    want = JL.attention_chunked(*map(jnp.asarray, (q, k, v, pos, pos)),
                                causal, window, chunk=chunk,
                                triangular=triangular)
    close(got, want, F32_TOL)


@pytest.mark.parametrize("impl", ["naive", "chunked", "chunked_tri",
                                  "pallas"])
@pytest.mark.parametrize("S", [8, 64, 48])
def test_attention_dispatch_matches(impl, S):
    """Every impl through the dispatcher at a sequence below, at and past
    the chunk, against JAX's dispatcher (whose pallas runs its kernel in
    interpret mode where the preconditions hold)."""
    q, k, v = qkv(2, S, S, 4, 1, 16, seed=S)
    pos = np.tile(np.arange(S, dtype=np.int32), (2, 1))
    kw = dict(causal=True, window=24, impl=impl, chunk=16)
    got = PL.attention(t(q), t(k), t(v), t(pos), t(pos), **kw)
    want = JL.attention(*map(jnp.asarray, (q, k, v, pos, pos)), **kw)
    close(got, want, F32_TOL)


def test_attention_unknown_impl_raises():
    q, k, v = map(t, qkv(1, 40, 40, 2, 1, 16, seed=13))
    pos = torch.arange(40)[None]
    with pytest.raises(ValueError):
        PL.attention(q, k, v, pos, pos, impl="ring", chunk=16)


@pytest.mark.parametrize("Sq,Sk,H,KV,chunk,kv_map", [
    (32, 32, 4, 1, 16, None), (1, 32, 4, 1, 16, None),
    (40, 40, 4, 1, 16, None), (300, 300, 4, 2, 1024, None),
    (512, 512, 4, 4, 1024, None), (32, 32, 6, 4, 16, None),
    (32, 32, 4, 2, 16, [0, 0, 1, 1])])
def test_pallas_preconditions_match(Sq, Sk, H, KV, chunk, kv_map):
    q = torch.zeros((1, Sq, H, 8))
    k = torch.zeros((1, Sk, KV, 8))
    jq, jk = jnp.zeros((1, Sq, H, 8)), jnp.zeros((1, Sk, KV, 8))
    assert PL._pallas_attention_ok(q, k, chunk, kv_map) == \
        JL._pallas_attention_ok(jq, jk, chunk, kv_map)


def test_attention_pallas_reaches_the_kernel_where_jax_does(monkeypatch):
    calls = []
    real = PL.flash_attention
    monkeypatch.setattr(PL, "flash_attention",
                        lambda *a, **kw: calls.append(1) or real(*a, **kw))
    for S, want in [(32, 1), (40, 0), (1, 0), (16, 1)]:
        calls.clear()
        q, k, v = map(t, qkv(1, S, S, 4, 2, 16, seed=S))
        pos = torch.arange(S)[None]
        PL.attention(q, k, v, pos, pos, impl="pallas", chunk=16)
        assert len(calls) == want, S


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_swiglu_matches(dtype):
    rng = np.random.default_rng(14)
    x = rng.normal(0, 1, (2, 5, 16)).astype(np.float32)
    wg, wu = (rng.normal(0, 0.25, (16, 32)).astype(np.float32)
              for _ in range(2))
    wd = rng.normal(0, 0.2, (32, 16)).astype(np.float32)
    tdt, jdt = getattr(torch, dtype), jnp.dtype(dtype)
    got = PL.swiglu(*(t(a).to(tdt) for a in (x, wg, wu, wd)))
    want = JL.swiglu(*(jnp.asarray(a, jdt) for a in (x, wg, wu, wd)))
    close(got.float(), np.asarray(want, np.float32),
          F32_TOL if dtype == "float32" else BF16_TOL)


# ---------------------------------------------------------------------------
# the attention block
# ---------------------------------------------------------------------------

def attn_cfg(arch, impl):
    return dataclasses.replace(port_config(jconfigs.smoke_config(arch)),
                               attention_impl=impl)


def attn_params(cfg, seed):
    """An attention block's JAX init with its zero inits (norm scale,
    qkv biases) perturbed, as numpy."""
    p = jax.tree.map(np.asarray, JB.init_attn(cfg, jax.random.key(seed)))
    rng = np.random.default_rng(seed)
    for name in ("ln", "bq", "bk", "bv"):
        if name in p:
            p[name] = rng.normal(0, 0.1, p[name].shape).astype(np.float32)
    return p


def run_both(cfg, p, x, pos, mode, jcache, pcache, window):
    jy, jc = JB.apply_attn({n: jnp.asarray(a) for n, a in p.items()},
                           jnp.asarray(x),
                           JB.Ctx(jnp.asarray(pos), mode, jcache), cfg,
                           window=window)
    py, pc = PB.apply_attn({n: t(a) for n, a in p.items()}, t(x),
                           PB.Ctx(t(pos), mode, pcache), cfg, window=window)
    close(py, jy, BLOCK_TOL)
    return jc, pc


def close_attn_cache(pc, jc):
    close(pc.k, jc.k, BLOCK_TOL)
    close(pc.v, jc.v, BLOCK_TOL)
    np.testing.assert_array_equal(pc.pos.numpy(), np.asarray(jc.pos))
    assert pc.index == int(jc.index)


@pytest.mark.parametrize("impl", ["chunked", "pallas"])
@pytest.mark.parametrize("arch,local", [("recurrentgemma-9b", True),
                                        ("h2o-danube-1.8b", True),
                                        ("phi3-mini-3.8b", False),
                                        ("qwen2.5-14b", False)])
def test_apply_attn_prefill_then_decode_past_the_ring(arch, local, impl):
    """Prefill S = 32 (twice the smoke window of 16, so a local layer's
    ring wraps), then 20 decode steps past it, against the JAX block step
    by step: outputs, K/V rings, slot positions and write index."""
    cfg = attn_cfg(arch, impl)
    window = cfg.window if local else 0
    p = attn_params(cfg, seed=len(arch))
    B, S, s_max = 2, 32, 64
    rng = np.random.default_rng(15)
    x = rng.normal(0, 1, (B, S, cfg.d_model)).astype(np.float32)
    pos = np.tile(np.arange(S, dtype=np.int32), (B, 1))
    jc = JB.init_attn_cache(cfg, B, s_max, window=window)
    pc = PB.init_attn_cache(cfg, B, s_max, torch.device("cpu"),
                            window=window)
    assert pc.k.shape == jc.k.shape and pc.index == int(jc.index)
    jc, pc = run_both(cfg, p, x, pos, "prefill", jc, pc, window)
    close_attn_cache(pc, jc)
    for step in range(20):
        xs = rng.normal(0, 1, (B, 1, cfg.d_model)).astype(np.float32)
        ps = np.full((B, 1), S + step, np.int32)
        jc, pc = run_both(cfg, p, xs, ps, "decode", jc, pc, window)
        close_attn_cache(pc, jc)


def test_apply_attn_train_mode_has_no_cache():
    cfg = attn_cfg("internlm2-20b", "chunked")
    p = attn_params(cfg, seed=2)
    x = np.random.default_rng(16).normal(0, 1, (2, 20, cfg.d_model)).astype(
        np.float32)
    pos = np.tile(np.arange(20, dtype=np.int32), (2, 1))
    jc, pc = run_both(cfg, p, x, pos, "train", None, None, 0)
    assert jc is None and pc is None


def test_decode_leaves_the_cache_passed_in_unchanged():
    cfg = attn_cfg("phi3-mini-3.8b", "chunked")
    p = {n: t(a) for n, a in attn_params(cfg, seed=3).items()}
    cache = PB.init_attn_cache(cfg, 1, 8, torch.device("cpu"))
    x = torch.ones((1, 1, cfg.d_model))
    _, new = PB.apply_attn(p, x, PB.Ctx(torch.zeros((1, 1), dtype=torch.int32),
                                        "decode", cache), cfg)
    assert int((cache.pos >= 0).sum()) == 0 and new.index == 1
    assert int((new.pos >= 0).sum()) == 1


def mellum2_shaped(dtype):
    """Mellum2's smoke config (window 16, three sliding layers to a full
    one) at Mellum2's grouping of 8 query heads a KV head, over 2."""
    return dataclasses.replace(smoke_config("mellum2-12b-a2.5b"),
                               n_heads=16, n_kv_heads=2, dtype=dtype)


def generate_mellum2_shaped(dtype, prompt=32, new=24):
    """Prefill ``prompt`` tokens (twice the window), then ``new`` decode
    steps past it; the details (tokens, every step's logits)."""
    cfg = mellum2_shaped(dtype)
    params = init_params(cfg, torch.Generator().manual_seed(7))
    ids = torch.randint(0, cfg.vocab, (2, prompt),
                        generator=torch.Generator().manual_seed(8))
    return cfg, generate(cfg, params, ids, max_new=new, s_max=prompt + new,
                         details=True)


def expanded_route(q, k, v, q_pos, k_pos, window=0):
    """The decode attention as it was: over the rings repeated to the
    query heads."""
    return PL.attention(q, k, v, q_pos, k_pos, causal=True, window=window,
                        impl="naive")


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_grouped_decode_matches_expanded_route_past_the_window(monkeypatch,
                                                               dtype):
    """A Mellum2-shaped model, prefill then decode past the sliding
    window, on the grouped route and on the expanded one: the same
    tokens and logits (bfloat16 bit for bit)."""
    _, got = generate_mellum2_shaped(dtype)
    monkeypatch.setattr(PL, "attention_decode", expanded_route)
    _, want = generate_mellum2_shaped(dtype)
    assert torch.equal(got.tokens, want.tokens)
    tol = dict(rtol=0, atol=0) if dtype == "bfloat16" else BLOCK_TOL
    for g, w in zip(got.logits, want.logits):
        torch.testing.assert_close(g, w, **tol)


def test_decode_counts_one_grouped_call_a_layer_and_step(monkeypatch):
    """Every attention layer of every decode step takes the grouped
    route on plain tensors, which never repeats the rings (prefill
    does, in the flash kernel's plain version)."""
    modes, apply_attn, expand_kv = [], PB.apply_attn, PL._expand_kv

    def attn(p, x, ctx, cfg, window=0):
        modes.append(ctx.mode)
        try:
            return apply_attn(p, x, ctx, cfg, window)
        finally:
            modes.pop()

    def no_expand_in_decode(*a, **kw):
        assert modes[-1] != "decode", "the grouped route repeated a ring"
        return expand_kv(*a, **kw)
    monkeypatch.setattr(PB, "apply_attn", attn)
    monkeypatch.setattr(PL, "_expand_kv", no_expand_in_decode)
    before = PB.attn_decode_counts()
    cfg, _ = generate_mellum2_shaped("float32", new=5)
    after = PB.attn_decode_counts()
    assert after["grouped"] - before["grouped"] == cfg.n_layers * 5
    assert after["expanded"] == before["expanded"]


def test_head_padded_decode_counts_expanded():
    """A head-padded arch (its ``kv_map``) decodes on the expanded
    route."""
    cfg = dataclasses.replace(port_config(jconfigs.smoke_config(
                                  "internlm2-20b")),
                              n_kv_heads=2, head_pad=8, kv_pad=6)
    p = {n: t(a) for n, a in attn_params(cfg, seed=4).items()}
    cache = PB.init_attn_cache(cfg, 1, 8, torch.device("cpu"))
    before = PB.attn_decode_counts()
    PB.apply_attn(p, torch.ones((1, 1, cfg.d_model)),
                  PB.Ctx(torch.zeros((1, 1), dtype=torch.int32), "decode",
                         cache), cfg)
    after = PB.attn_decode_counts()
    assert after["expanded"] - before["expanded"] == 1
    assert after["grouped"] == before["grouped"]


@pytest.mark.parametrize("pad", [(8, 6), (8, 2)])
def test_head_padding_matches(pad):
    """Head-padded configs (physical heads past the logical ones): the
    kv map keeps the logical grouping and padded heads are masked."""
    head_pad, kv_pad = pad
    cfg = dataclasses.replace(port_config(jconfigs.smoke_config(
                                  "internlm2-20b")),
                              n_kv_heads=2, head_pad=head_pad, kv_pad=kv_pad)
    np.testing.assert_array_equal(PB.head_kv_map(cfg).numpy(),
                                  np.asarray(JB.head_kv_map(cfg)))
    close(PB.head_mask(cfg, torch.float32), JB.head_mask(cfg, jnp.float32),
          dict(rtol=0, atol=0))
    p = attn_params(cfg, seed=4)
    x = np.random.default_rng(17).normal(0, 1, (2, 12, cfg.d_model)).astype(
        np.float32)
    pos = np.tile(np.arange(12, dtype=np.int32), (2, 1))
    run_both(cfg, p, x, pos, "train", None, None, 0)
