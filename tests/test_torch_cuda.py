"""The port's CUDA kernels on the card, against their plain versions.

Needs a CUDA device and skips without one; imports nothing of JAX, so
it also runs where only the port's dependencies are installed:

    PYTHONPATH=src python3 -m pytest -q -m cuda tests/test_torch_cuda.py

Tolerances: rtol=1e-5, atol=1e-6 for the ELL kernels — fp32, another
summation order (the kernel may fuse multiply-add); rtol=atol=1e-4 for
wkv6, whose recurrence carries fp32 rounding across time steps, and for
a small model's prefill on the card against the CPU (fp32 matmuls, TF32
off, through a few layers); none for rglru_scan, which rounds each
product and sum as the plain version's two elementwise operations do;
for flash_attention in float32 rtol=atol=2e-5 (the JAX package's own
tolerance between its flash kernel and the naive form) and in bfloat16
rtol=atol=1e-2 against the plain version on the same values in float32
(the kernel computes in float32 and rounds only its output to bf16, half
an ulp: at most 0.0078 below 4), the same for the grouped decode
attention against the naive form on the same bf16 values; for segsum and segsum_windowed
rtol=1e-5, atol=1e-4·max(1, max|plain|) (another summation order; in
segsum, float atomics add in an order that changes from run to run) and
exact equality for integer counts (below 2^24, every order gives the same
float); for spgemm_sel exact
equality where each (row, j) has at most one stored hit, else rtol=atol=
1e-6 (another summation order).
"""
import dataclasses
import importlib

import numpy as np
import pytest
import torch

from repro_torch.configs import smoke_config
from repro_torch.core import Assoc, eval_batch, lazy
from repro_torch.core import expr as X
from repro_torch.db import DB, put
from repro_torch.device import set_device
from repro_torch.kernels import flash_attention, flash_attention_ref, ops, \
    rglru_scan, rglru_scan_ref, segsum, segsum_ref, segsum_windowed, \
    spgemm_sel, spgemm_sel_ref, spmm_ell, spmm_ell_ref, spmv_ell, \
    spmv_ell_ref, wkv6, wkv6_ref
from repro_torch.kernels import spmm as kspmm
from repro_torch.models import blocks, init_params, layers, model, prefill

# the module (the package namespace's ``segsum`` is the function)
ksegsum = importlib.import_module("repro_torch.kernels.segsum")

pytestmark = pytest.mark.cuda
RTOL, ATOL = 1e-5, 1e-6
WKV_TOL = dict(rtol=1e-4, atol=1e-4)
WKV_HEAD_DIMS = (8, 16, 32, 64, 128)
CLIP_FLOOR = float(np.exp(-np.exp(0.5)))   # the model's smallest decay
ATTN_F32_TOL = dict(rtol=2e-5, atol=2e-5)
ATTN_BF16_TOL = dict(rtol=1e-2, atol=1e-2)
HEAD_DIMS = (16, 64, 80, 96, 128, 256)
RINGS = ("plus_times", "max_times")


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    prev = set_device("cuda")
    tf32 = (torch.backends.cuda.matmul.allow_tf32,
            torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    yield torch.device("cuda")
    torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 \
        = tf32
    set_device(prev)


def to_device(tree, dev):
    """A parameter or cache tree (dicts, lists, tuples of tensors) on
    ``dev``."""
    if isinstance(tree, dict):
        return {k: to_device(v, dev) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)) and not hasattr(tree, "_fields"):
        return [to_device(v, dev) for v in tree]
    if hasattr(tree, "_fields"):
        return type(tree)(*(to_device(v, dev) for v in tree))
    return tree.to(dev) if isinstance(tree, torch.Tensor) else tree


def ell_case(R, C, K, seed, dev):
    rng = np.random.default_rng(seed)
    ecols = rng.integers(0, C, (R, K)).astype(np.int32)
    ecols[rng.random((R, K)) < 0.3] = -1
    ecols[rng.random(R) < 0.1] = -1
    evals = rng.normal(0, 1, (R, K)).astype(np.float32)
    evals[ecols < 0] = 0.0
    x = rng.normal(0, 1, C).astype(np.float32)
    Xm = rng.normal(0, 1, (C, 8)).astype(np.float32)
    return [torch.from_numpy(a).to(dev) for a in (ecols, evals, x, Xm)]


@pytest.mark.parametrize("ring", RINGS)
def test_kernels_match_plain(card, ring):
    ec, ev, x, Xm = ell_case(5000, 3000, 9, seed=11, dev=card)
    before = ops.kernel_launches()
    y = spmv_ell(ec, ev, x, ring=ring)
    Y = spmm_ell(ec, ev, Xm, ring=ring)
    torch.cuda.synchronize()
    after = ops.kernel_launches()
    assert after["spmv_ell"] == before["spmv_ell"] + 1
    assert after["spmm_ell"] == before["spmm_ell"] + 1
    torch.testing.assert_close(y, spmv_ell_ref(ec, ev, x, ring),
                               rtol=RTOL, atol=ATOL)
    torch.testing.assert_close(Y, spmm_ell_ref(ec, ev, Xm, ring),
                               rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("ring", RINGS)
def test_b1_equals_spmv(card, ring):
    ec, ev, x, _ = ell_case(777, 500, 5, seed=3, dev=card)
    y1 = spmv_ell(ec, ev, x, ring=ring)
    y2 = spmm_ell(ec, ev, x[:, None].contiguous(), ring=ring)[:, 0]
    torch.testing.assert_close(y1, y2, rtol=0, atol=0)


def test_mixed_devices_raise(card):
    ec, ev, x, _ = ell_case(10, 20, 2, seed=4, dev=card)
    with pytest.raises(ValueError):
        spmv_ell(ec, ev, x.cpu())


def test_eval_batch_on_card_matches_cpu(card, monkeypatch):
    monkeypatch.setattr(X, "DEVICE_NNZ_THRESHOLD", 1)
    rng = np.random.default_rng(1)
    rows = np.asarray([f"v{i:04d}" for i in rng.integers(0, 200, 2000)])
    cols = np.asarray([f"v{i:04d}" for i in rng.integers(0, 200, 2000)])
    T = DB("Tedge", "TedgeT")
    put(T, Assoc(rows, cols, rng.integers(1, 5, 2000).astype(float)))
    vecs = [Assoc(np.asarray([f"v{j:04d}"]), np.asarray([f"s{j}"]),
                  np.asarray([1.0])) for j in range(8)]
    k0 = ops.kernel_launches()
    on_card = eval_batch([T.lazy() * lazy(v) for v in vecs])
    assert ops.kernel_launches()["spmm_ell"] == k0["spmm_ell"] + 1
    set_device("cpu")
    on_cpu = eval_batch([T.lazy() * lazy(v) for v in vecs])
    assert all(a == b for a, b in zip(on_card, on_cpu))


def wkv_case(B, S, H, Dh, seed, dev):
    """r, k, v normal; w in (0.45, 0.95); u x 0.1."""
    rng = np.random.default_rng(seed)
    r, k, v = (rng.normal(0, 1, (B, S, H, Dh)) for _ in range(3))
    w = 0.5 / (1 + np.exp(-rng.normal(0, 1, (B, S, H, Dh)))) + 0.45
    u = rng.normal(0, 1, (H, Dh)) * 0.1
    return [torch.from_numpy(a.astype(np.float32)).to(dev)
            for a in (r, k, v, w, u)]


@pytest.mark.parametrize("Dh", [16, 64])
def test_wkv6_matches_plain(card, Dh):
    args = wkv_case(2, 96, 3, Dh, seed=Dh, dev=card)
    before = ops.kernel_launches()["wkv6"]
    out, state = wkv6(*args)
    torch.cuda.synchronize()
    assert ops.kernel_launches()["wkv6"] == before + 1
    want_out, want_state = wkv6_ref(*args)
    torch.testing.assert_close(out, want_out, **WKV_TOL)
    torch.testing.assert_close(state, want_state, **WKV_TOL)
    wkv6(*args)
    assert ops.kernel_launches()["wkv6"] == before + 2


@pytest.mark.parametrize("decay", ["normal", "clip_floor"])
@pytest.mark.parametrize("Dh", WKV_HEAD_DIMS)
def test_wkv6_chunks(card, Dh, decay):
    """Every head dim; S = 97, ragged against the kernel's 16-step chunks;
    the decays as the tests draw them, or all at the model's clip floor,
    where the chunked form's exp(±Σ log w) is largest."""
    r, k, v, w, u = wkv_case(2, 97, 3, Dh, seed=Dh + 1, dev=card)
    if decay == "clip_floor":
        w = torch.full_like(w, CLIP_FLOOR)
    before = ops.kernel_launches()["wkv6"]
    out, state = wkv6(r, k, v, w, u)
    torch.cuda.synchronize()
    assert ops.kernel_launches()["wkv6"] == before + 1
    want_out, want_state = wkv6_ref(r, k, v, w, u)
    torch.testing.assert_close(out, want_out, **WKV_TOL)
    torch.testing.assert_close(state, want_state, **WKV_TOL)


def test_wkv6_unaligned_views(card):
    """Views whose base is not 16-byte aligned take the kernel's 4-byte
    copies and give the contiguous inputs' result exactly."""
    r, k, v, w, u = wkv_case(2, 40, 2, 32, seed=3, dev=card)
    views = [torch.cat([torch.zeros_like(a[..., :1]), a], dim=-1)[..., 1:]
             for a in (r, k, v, w)]
    assert views[0].data_ptr() % 16
    got = wkv6(*views, u)
    want = wkv6(r, k, v, w, u)
    for g, x in zip(got, want):
        torch.testing.assert_close(g, x, rtol=0, atol=0)


def test_wkv6_strided_views(card):
    """The kernel reads views of wider tensors through their strides."""
    r, k, v, w, u = wkv_case(2, 40, 2, 32, seed=1, dev=card)
    views = [torch.cat([a, torch.zeros_like(a)], dim=-1)[..., :32]
             for a in (r, k, v, w)]
    assert not views[0].is_contiguous()
    got = wkv6(*views, u)
    want = wkv6(r, k, v, w, u)
    for g, x in zip(got, want):
        torch.testing.assert_close(g, x, rtol=0, atol=0)


def test_wkv6_rejects_mixed_devices_and_head_dims(card):
    r, k, v, w, u = wkv_case(1, 8, 2, 16, seed=2, dev=card)
    before = ops.kernel_launches()["wkv6"]
    with pytest.raises(ValueError):
        wkv6(r, k, v, w, u.cpu())
    r12, k12, v12, w12 = (a[..., :12].contiguous() for a in (r, k, v, w))
    with pytest.raises(ValueError):
        wkv6(r12, k12, v12, w12, u[:, :12].contiguous())
    with pytest.raises(TypeError):
        wkv6(r.double(), k, v, w, u)
    assert ops.kernel_launches()["wkv6"] == before


def test_prefill_on_card_matches_cpu(card):
    """A small rwkv6 prefill through the kernel (S a multiple of the
    chunk) against the same call on the CPU (plain recurrence)."""
    cfg = dataclasses.replace(smoke_config("rwkv6-1.6b"), rwkv_impl="pallas")
    params = init_params(cfg, torch.Generator().manual_seed(0))
    toks = torch.from_numpy(np.random.default_rng(3).integers(
        0, cfg.vocab, (2, 4 * cfg.rwkv_chunk)).astype(np.int32))
    cpu_logits, cpu_caches = prefill(params, {"tokens": toks}, cfg, 64)
    before = ops.kernel_launches()["wkv6"]
    logits, caches = prefill(to_device(params, card),
                             {"tokens": toks.to(card)}, cfg, 64)
    torch.cuda.synchronize()
    assert ops.kernel_launches()["wkv6"] == before + cfg.n_layers
    torch.testing.assert_close(logits.cpu(), cpu_logits, **WKV_TOL)
    for got, want in zip(caches, cpu_caches):
        for g, x in zip(got, want):
            torch.testing.assert_close(g.cpu(), x, **WKV_TOL)


def rglru_case(B, S, C, seed, dev):
    """a in (0, 1), b small normal — as the model makes them."""
    rng = np.random.default_rng(seed)
    a = 1 / (1 + np.exp(-rng.normal(0, 2, (B, S, C))))
    b = rng.normal(0, 0.1, (B, S, C))
    return [torch.from_numpy(x.astype(np.float32)).to(dev) for x in (a, b)]


@pytest.mark.parametrize("B,S,C", [(2, 37, 300), (1, 1, 64), (3, 160, 4096)])
def test_rglru_scan_matches_plain(card, B, S, C):
    a, b = rglru_case(B, S, C, seed=S, dev=card)
    before = ops.kernel_launches()["rglru_scan"]
    out = rglru_scan(a, b)
    torch.cuda.synchronize()
    assert ops.kernel_launches()["rglru_scan"] == before + 1
    assert out.shape == (B, S, C) and out.dtype == torch.float32
    torch.testing.assert_close(out, rglru_scan_ref(a, b), rtol=0, atol=0)


def test_rglru_scan_strided_and_rejects(card):
    a, b = rglru_case(2, 50, 128, seed=5, dev=card)
    wide = [torch.cat([x, torch.ones_like(x)], dim=-1)[..., :128]
            for x in (a, b)]
    assert not wide[0].is_contiguous()
    torch.testing.assert_close(rglru_scan(*wide), rglru_scan(a, b),
                               rtol=0, atol=0)
    before = ops.kernel_launches()["rglru_scan"]
    with pytest.raises(ValueError):
        rglru_scan(a, b.cpu())
    with pytest.raises(TypeError):
        rglru_scan(a.double(), b.double())
    with pytest.raises(ValueError):
        rglru_scan(a, b[:, :10])
    assert ops.kernel_launches()["rglru_scan"] == before


def attn_case(B, Sq, Sk, H, KV, Dh, dtype, seed, dev):
    rng = np.random.default_rng(seed)
    q = rng.normal(0, 1, (B, Sq, H, Dh))
    k, v = (rng.normal(0, 1, (B, Sk, KV, Dh)) for _ in range(2))
    return [torch.from_numpy(x.astype(np.float32)).to(dev).to(dtype)
            for x in (q, k, v)]


def check_attention(q, k, v, causal, window):
    """Kernel against the plain version on the same values in float32;
    one launch, q's dtype out."""
    before = ops.kernel_launches()["flash_attention"]
    out = flash_attention(q, k, v, causal=causal, window=window)
    torch.cuda.synchronize()
    assert ops.kernel_launches()["flash_attention"] == before + 1
    assert out.shape == q.shape and out.dtype == q.dtype
    want = flash_attention_ref(q.float(), k.float(), v.float(), causal,
                               window)
    tol = ATTN_F32_TOL if q.dtype == torch.float32 else ATTN_BF16_TOL
    torch.testing.assert_close(out.float(), want, **tol)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("Dh", HEAD_DIMS)
def test_flash_attention_head_dims(card, Dh, dtype):
    """Every head dim of the smoke and model configs, GQA, a ragged
    sequence (100 is no multiple of the 32-row or 64-key tiles)."""
    q, k, v = attn_case(2, 100, 100, 4, 2, Dh, dtype, seed=Dh, dev=card)
    check_attention(q, k, v, causal=True, window=0)


@pytest.mark.parametrize("causal,window", [(True, 0), (True, 40),
                                           (False, 0), (False, 40)])
@pytest.mark.parametrize("H,KV", [(4, 4), (4, 2), (8, 1)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_attention_masks(card, causal, window, H, KV, dtype):
    q, k, v = attn_case(2, 200, 200, H, KV, 64, dtype, seed=H + KV,
                        dev=card)
    check_attention(q, k, v, causal, window)


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_attention_rows_that_see_nothing(card, causal, dtype):
    """Sq > Sk with a window: rows i >= Sk + window - 1 see no key and
    average every value, as the Pallas kernel and the plain version do."""
    q, k, v = attn_case(1, 130, 40, 2, 1, 64, dtype, seed=7, dev=card)
    check_attention(q, k, v, causal, window=16)


@pytest.mark.parametrize("Dh", [8, 24])
def test_flash_attention_bf16_padded_head_dims(card, Dh):
    """Head dims that are multiples of 8 but not of 16: the tensor-core
    kernel pads the mma's k-dimension with zeros in shared memory."""
    q, k, v = attn_case(2, 100, 100, 4, 2, Dh, torch.bfloat16, seed=Dh,
                        dev=card)
    check_attention(q, k, v, causal=True, window=0)
    check_attention(q, k, v, causal=False, window=24)


def test_flash_attention_bf16_mha_head_dim_96(card):
    """phi-3-vision's prefill shape in small: one query head a kv head
    (each block one head of 128 positions) at Dh = 96, which the
    tensor-core kernel pads to 128 in shared memory."""
    q, k, v = attn_case(2, 256, 256, 8, 8, 96, torch.bfloat16, seed=96,
                        dev=card)
    check_attention(q, k, v, causal=True, window=0)
    before = ops.kernel_launches()["flash_attention"]
    got = flash_attention(q, k, v, causal=True)
    assert ops.kernel_launches()["flash_attention"] == before + 1
    torch.testing.assert_close(got.float(), flash_attention_ref(
        q, k, v, True, 0).float(), rtol=2e-2, atol=2e-2)


def test_flash_attention_unaligned_q(card):
    """A bf16 q view that is not 16-byte aligned takes the kernel's
    element-wise Q copy and gives the contiguous q's result exactly."""
    q, k, v = attn_case(2, 96, 96, 4, 2, 64, torch.bfloat16, seed=10,
                        dev=card)
    view = torch.cat([torch.zeros_like(q[..., :1]), q], dim=-1)[..., 1:]
    assert view.data_ptr() % 16
    torch.testing.assert_close(flash_attention(view, k, v, window=40),
                               flash_attention(q, k, v, window=40),
                               rtol=0, atol=0)


@pytest.mark.parametrize("dtype,Dh", [(torch.bfloat16, 256),
                                      (torch.float32, 128),
                                      (torch.float32, 256)])
def test_flash_attention_tiles_past_48kb(card, dtype, Dh):
    """K and V tiles of 64 keys above the 48 KB static shared-memory
    limit (64, 64 and 128 KB) launch and compute: the kernel raises its
    dynamic limit before the launch."""
    assert 2 * 64 * Dh * torch.finfo(dtype).bits // 8 > 48 * 1024
    q, k, v = attn_case(1, 512, 512, 16, 1, Dh, dtype, seed=3, dev=card)
    check_attention(q, k, v, causal=True, window=2048)


def test_flash_attention_strided_views(card):
    """q, k and v read through their strides (views of wider tensors)
    give the contiguous inputs' result exactly."""
    q, k, v = attn_case(2, 96, 96, 4, 2, 64, torch.bfloat16, seed=9,
                        dev=card)
    views = [torch.cat([x, torch.zeros_like(x)], dim=2)[:, :, :x.shape[2]]
             for x in (q, k, v)]
    assert not views[0].is_contiguous()
    torch.testing.assert_close(flash_attention(*views, window=40),
                               flash_attention(q, k, v, window=40),
                               rtol=0, atol=0)


def test_flash_attention_rejects(card):
    q, k, v = attn_case(1, 32, 32, 4, 2, 64, torch.float32, seed=1,
                        dev=card)
    before = ops.kernel_launches()["flash_attention"]
    with pytest.raises(ValueError):
        flash_attention(q, k.cpu(), v)
    with pytest.raises(TypeError):
        flash_attention(q.half(), k.half(), v.half())
    with pytest.raises(ValueError):
        flash_attention(q[..., :12].contiguous(), k[..., :12].contiguous(),
                        v[..., :12].contiguous())
    with pytest.raises(ValueError):
        flash_attention(q[:, :, :3].contiguous(), k, v)
    wide = torch.cat([k, k], dim=-1)
    with pytest.raises(ValueError):       # k not 16-byte aligned
        flash_attention(q, wide[..., 2:66], v)
    assert ops.kernel_launches()["flash_attention"] == before


@pytest.mark.parametrize("S,window", [(4160, 0), (1024, 512)])
def test_attention_decode_on_card_matches_naive(card, S, window):
    """The grouped decode attention's card route (bfloat16 products with
    a float32 result) against the reference over the repeated rings, on
    the same bfloat16 values; it allocates no float32 or repeated copy
    of a ring (under half a ring's bytes in all)."""
    B, H, KV, Dh = 8, 32, 4, 128
    q, k, v = attn_case(B, 1, S, H, KV, Dh, torch.bfloat16, seed=S,
                        dev=card)
    k_pos = torch.arange(S, device=card, dtype=torch.int32).repeat(B, 1)
    k_pos[1::2, S - 7:] = -1                  # odd rows: unwritten slots
    q_pos = k_pos.amax(1, keepdim=True)
    want = layers.attention_naive(q, k, v, q_pos, k_pos, True, window)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    got = layers.attention_decode(q, k, v, q_pos, k_pos, window)
    torch.cuda.synchronize()
    assert torch.cuda.max_memory_allocated() - base < k.nbytes // 2
    assert got.dtype == torch.bfloat16 and got.shape == want.shape
    torch.testing.assert_close(got, want, **ATTN_BF16_TOL)


def test_kernel_attributes(card):
    """Every library reports each of its kernels' registers and shared
    memory (cudaFuncGetAttributes), as chip_smoke logs them."""
    rows = ops.kernel_attributes()
    assert {r["lib"] for r in rows} == set(ops.SIGNATURES)
    assert all(0 < r["registers"] <= 255 for r in rows)
    names = {r["kernel"] for r in rows}
    assert "flash_attention bf16 Dh<=256" in names
    assert "wkv6 Dh=64" in names


def test_recurrentgemma_prefill_on_card_matches_cpu(card):
    """A small recurrentgemma prefill through both kernels against the
    same call on the CPU (plain versions): 5 RG-LRU and 2 local-attention
    layers in the smoke config's RRL RRL R."""
    cfg = dataclasses.replace(smoke_config("recurrentgemma-9b"),
                              rglru_impl="pallas", attention_impl="pallas")
    params = init_params(cfg, torch.Generator().manual_seed(0))
    toks = torch.from_numpy(np.random.default_rng(4).integers(
        0, cfg.vocab, (2, 32)).astype(np.int32))
    cpu_logits, cpu_caches = prefill(params, {"tokens": toks}, cfg, 64)
    before = ops.kernel_launches()
    logits, caches = prefill(to_device(params, card),
                             {"tokens": toks.to(card)}, cfg, 64)
    torch.cuda.synchronize()
    after = ops.kernel_launches()
    assert after["rglru_scan"] - before["rglru_scan"] == 5
    assert after["flash_attention"] - before["flash_attention"] == 2
    torch.testing.assert_close(logits.cpu(), cpu_logits, **WKV_TOL)
    for got, want in zip(caches, cpu_caches):
        for g, x in zip(got, want):
            if isinstance(x, torch.Tensor):
                torch.testing.assert_close(g.cpu(), x, **WKV_TOL)
            else:
                assert g == x


@pytest.mark.parametrize("arch", ["granite-moe-3b-a800m",
                                  "qwen3-moe-235b-a22b"])
def test_moe_prefill_on_card_matches_cpu(card, arch):
    """A MoE smoke prefill (attention_impl="pallas") on the card against
    the same call on the CPU: logits and caches within WKV_TOL, layer 0's
    routing (the experts of every (token, choice) pair) equal.  qwen3's
    GQA reaches flash_attention once a layer; granite's one kv head of 4
    too."""
    cfg = dataclasses.replace(smoke_config(arch), attention_impl="pallas")
    params = init_params(cfg, torch.Generator().manual_seed(0))
    toks = torch.from_numpy(np.random.default_rng(5).integers(
        0, cfg.vocab, (2, 32)).astype(np.int32))
    cpu_logits, cpu_caches = prefill(params, {"tokens": toks}, cfg, 64)
    dev_params = to_device(params, card)
    before = ops.kernel_launches()["flash_attention"]
    logits, caches = prefill(dev_params, {"tokens": toks.to(card)}, cfg, 64)
    torch.cuda.synchronize()
    assert ops.kernel_launches()["flash_attention"] - before == cfg.n_layers
    torch.testing.assert_close(logits.cpu(), cpu_logits, **WKV_TOL)
    for got, want in zip(caches, cpu_caches):
        for g, x in zip(got, want):
            if isinstance(x, torch.Tensor):
                torch.testing.assert_close(g.cpu(), x, **WKV_TOL)
            else:
                assert g == x

    def experts(p, t):
        x, *_ = model._embed_inputs(p, {"tokens": t}, cfg, "prefill")
        mlp = p["layers"][0]["mlp"]
        h = layers.rms_norm(x, mlp["ln"], cfg.norm_eps)
        probs = torch.softmax(h @ mlp["router"], dim=-1)
        C = blocks.moe_capacity(cfg.moe, t.shape[1])
        slot, keep, _ = blocks._token_choice_dispatch(probs, cfg.moe.top_k,
                                                      C)
        return (slot // C).cpu(), keep.cpu()

    (e_card, k_card), (e_cpu, k_cpu) = experts(dev_params, toks.to(card)), \
        experts(params, toks)
    assert torch.equal(e_card, e_cpu) and torch.equal(k_card, k_cpu)
    assert bool(k_cpu.all())


# ---------------------------------------------------------------------------
# segsum, segsum_windowed, spgemm_sel
# ---------------------------------------------------------------------------

SEG_RTOL, SEG_ATOL = 1e-5, 1e-4          # atol x max(1, max|plain|)
SEL_TOL = dict(rtol=1e-6, atol=1e-6)
SEGSUMS = {"segsum": segsum, "segsum_windowed": segsum_windowed}


def seg_close(got, want):
    atol = SEG_ATOL * max(1.0, float(want.abs().max()) if want.numel() else 0)
    torch.testing.assert_close(got, want, rtol=SEG_RTOL, atol=atol)


def seg_case(nnz, nseg, seed, dev, sort=False, pad=0.0,
             dtype=torch.float32):
    """Random ids in [0, nseg) (a ``pad`` share set to -1), normal vals."""
    rng = np.random.default_rng(seed)
    ids = rng.integers(0, max(nseg, 1), nnz).astype(np.int32)
    ids[rng.random(nnz) < pad] = -1
    if sort:
        ids.sort()
    vals = rng.normal(0, 1, nnz).astype(np.float32)
    return (torch.from_numpy(ids).to(dev),
            torch.from_numpy(vals).to(dev).to(dtype))


@pytest.mark.parametrize("name", sorted(SEGSUMS))
@pytest.mark.parametrize("nnz,nseg", [(100, 17), (1000, 300), (5000, 64),
                                      (7, 3), (777, 100), (20000, 5000),
                                      (100003, 1000), (513, 1)])
def test_segsums_match_plain(card, name, nnz, nseg):
    ids, vals = seg_case(nnz, nseg, seed=nnz + nseg, dev=card,
                         sort=name == "segsum_windowed")
    before = ops.kernel_launches()[name]
    got = SEGSUMS[name](ids, vals, nseg)
    torch.cuda.synchronize()
    assert ops.kernel_launches()[name] == before + 1
    seg_close(got, segsum_ref(ids, vals, nseg))


@pytest.mark.parametrize("name", sorted(SEGSUMS))
def test_segsums_integer_counts_exact(card, name):
    """Unit values sum to exact counts whatever the order: ragged runs,
    runs across every range boundary, and one run over all of nnz."""
    rng = np.random.default_rng(5)
    for ids_np in (np.sort(rng.integers(0, 3000, 200_001)),
                   np.repeat(np.arange(50), rng.integers(1, 9000, 50)),
                   np.full(100_000, 7)):
        ids = torch.from_numpy(ids_np.astype(np.int32)).to(card)
        if name == "segsum":
            ids = ids[torch.randperm(ids.numel(), device=card)]
        ones = torch.ones(ids.numel(), device=card)
        got = SEGSUMS[name](ids, ones, 3000)
        assert torch.equal(got, segsum_ref(ids, ones, 3000))


@pytest.mark.parametrize("name", sorted(SEGSUMS))
def test_segsums_sparse_million_segments(card, name):
    ids, vals = seg_case(2048, 1_000_000, seed=9, dev=card, sort=True)
    if name == "segsum":
        ids = ids.flip(0)
    seg_close(SEGSUMS[name](ids, vals, 1_000_000),
              segsum_ref(ids, vals, 1_000_000))


@pytest.mark.parametrize("name", sorted(SEGSUMS))
def test_segsums_bf16_values(card, name):
    ids, vals = seg_case(4099, 31, seed=4, dev=card,
                         sort=name == "segsum_windowed",
                         dtype=torch.bfloat16)
    seg_close(SEGSUMS[name](ids, vals, 31), segsum_ref(ids, vals, 31))


def test_segsum_drops_padding_and_out_of_range(card):
    ids, vals = seg_case(30_000, 500, seed=6, dev=card, pad=0.3)
    ids[::97] = 500                              # one past the last segment
    ids[::101] = 10**6
    seg_close(segsum(ids, vals, 500), segsum_ref(ids, vals, 500))
    seg_close(segsum(ids.long(), vals, 500), segsum_ref(ids, vals, 500))


@pytest.mark.parametrize("name", sorted(SEGSUMS))
def test_segsums_empty(card, name):
    before = ops.kernel_launches()[name]
    empty_i = torch.zeros(0, dtype=torch.int32, device=card)
    empty_v = torch.zeros(0, device=card)
    got = SEGSUMS[name](empty_i, empty_v, 9)
    assert got.shape == (9,) and not got.any()
    ids, vals = seg_case(50, 5, seed=1, dev=card, sort=True)
    assert SEGSUMS[name](ids, vals, 0).shape == (0,)
    assert ops.kernel_launches()[name] == before


@pytest.mark.parametrize("name", sorted(SEGSUMS))
def test_segsums_never_run_plain_on_card(card, name, monkeypatch):
    def boom(*a, **k):
        raise AssertionError("plain version called for CUDA tensors")
    monkeypatch.setattr(ksegsum, "segsum_ref", boom)
    ids, vals = seg_case(1000, 40, seed=2, dev=card, sort=True)
    SEGSUMS[name](ids, vals, 40)
    torch.cuda.synchronize()


@pytest.mark.parametrize("name", sorted(SEGSUMS))
def test_segsums_reject_bad_inputs(card, name):
    fn = SEGSUMS[name]
    ids, vals = seg_case(64, 8, seed=3, dev=card, sort=True)
    before = ops.kernel_launches()[name]
    with pytest.raises(TypeError):
        fn(ids.float(), vals, 8)
    with pytest.raises(TypeError):
        fn(ids, vals.double(), 8)
    with pytest.raises(ValueError):
        fn(ids[:-1], vals, 8)
    with pytest.raises(ValueError):
        fn(ids.view(8, 8), vals.view(8, 8), 8)
    with pytest.raises(ValueError):
        fn(ids, vals.cpu(), 8)
    assert ops.kernel_launches()[name] == before


def test_segsum_windowed_bit_identical(card):
    """No atomics, so a fixed order: two calls give the same bits, with
    one run of 1 M ids across hundreds of ranges; one launch a call."""
    rng = np.random.default_rng(8)
    ids = np.sort(np.concatenate([rng.integers(0, 50_000, 1_000_000),
                                  np.full(1_000_000, 20_000)]))
    ids = torch.from_numpy(ids.astype(np.int32)).to(card)
    vals = torch.from_numpy(rng.normal(0, 1, ids.numel()).astype(
        np.float32)).to(card)
    before = ops.kernel_launches()["segsum_windowed"]
    a = segsum_windowed(ids, vals, 50_000)
    b = segsum_windowed(ids, vals, 50_000)
    torch.cuda.synchronize()
    assert ops.kernel_launches()["segsum_windowed"] == before + 2
    assert torch.equal(a, b)
    seg_close(a, segsum_ref(ids, vals, 50_000))


def test_segsum_windowed_writes_every_element(card):
    """The output comes from torch.empty: memory the caching allocator
    hands back full of NaN must leave no NaN, with empty segments below,
    between (also across range edges) and above the ids."""
    n_seg = 3_000_000
    rng = np.random.default_rng(9)
    ids = np.sort(np.concatenate([rng.integers(1000, 2_900_000, 400_000),
                                  rng.integers(5000, 5100, 100_000)]))
    ids = torch.from_numpy(ids.astype(np.int32)).to(card)
    ones = torch.ones(ids.numel(), device=card)
    junk = torch.full((n_seg,), float("nan"), device=card)
    del junk
    got = segsum_windowed(ids, ones, n_seg)
    assert not got.isnan().any()
    assert torch.equal(got, segsum_ref(ids, ones, n_seg))
    assert not got[:1000].any() and not got[2_900_000:].any()


def test_segsum_windowed_drops_out_of_range(card):
    """Sorted ids with the ELL's -1 padding first and ids at or past
    num_segments last: dropped, and the segments around them zeroed."""
    rng = np.random.default_rng(10)
    ids = np.sort(np.concatenate([np.full(9000, -1),
                                  rng.integers(3, 700, 20_000),
                                  np.full(7000, 800), [10**6] * 5]))
    ids = torch.from_numpy(ids.astype(np.int32)).to(card)
    vals = torch.from_numpy(rng.normal(0, 1, ids.numel()).astype(
        np.float32)).to(card)
    seg_close(segsum_windowed(ids, vals, 800), segsum_ref(ids, vals, 800))
    ones = torch.ones(ids.numel(), device=card)
    assert torch.equal(segsum_windowed(ids, ones, 800),
                       segsum_ref(ids, ones, 800))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("name", sorted(SEGSUMS))
def test_segsums_unaligned_views(card, name, dtype):
    """Views that start off a 16-byte boundary: ids and values shifted
    alike (the kernels realign their 16-byte loads) and shifted apart (no
    common alignment: element-wise loads)."""
    ids, vals = seg_case(50_003, 900, seed=12, dev=card,
                         sort=name == "segsum_windowed", dtype=dtype)
    for a, b in ((1, 1), (3, 3), (1, 2), (2, 5)):
        n = ids.numel() - 5
        i, v = ids[a:a + n], vals[b:b + n]
        seg_close(SEGSUMS[name](i, v, 900), segsum_ref(i, v, 900))
        ones = torch.ones(n + 8, device=card, dtype=dtype)[b:b + n]
        assert torch.equal(SEGSUMS[name](i, ones, 900),
                           segsum_ref(i, ones, 900))


def test_segsum_hot_id_counts_exact(card):
    """One id holds 90% of 4 M shuffled ids: unit values still count
    exactly (every partial an integer below 2^24), one launch."""
    rng = np.random.default_rng(11)
    ids = np.where(rng.random(4_000_000) < 0.9, 7,
                   rng.integers(0, 100_000, 4_000_000)).astype(np.int32)
    ids = torch.from_numpy(ids).to(card)
    ones = torch.ones(ids.numel(), device=card)
    before = ops.kernel_launches()["segsum"]
    got = segsum(ids, ones, 100_000)
    torch.cuda.synchronize()
    assert ops.kernel_launches()["segsum"] == before + 1
    assert torch.equal(got, torch.bincount(ids.long(),
                                           minlength=100_000).float())


def sel_case(R, C, K, B, seed, dev, distinct=False):
    """A random ELL pack with -1 padding and blank rows; ``distinct``
    keeps each row's columns distinct (at most one hit per (row, j))."""
    rng = np.random.default_rng(seed)
    if distinct:
        ecols = np.argsort(rng.random((R, C)), axis=1)[:, :K].astype(np.int32)
    else:
        ecols = rng.integers(0, C, (R, K)).astype(np.int32)
    ecols[rng.random((R, K)) < 0.2] = -1
    ecols[rng.random(R) < 0.05] = -1
    evals = rng.normal(0, 1, (R, K)).astype(np.float32)
    evals[ecols < 0] = 0.0
    sel = rng.choice(C, B, replace=B > C).astype(np.int32)
    return [torch.from_numpy(a).to(dev) for a in (ecols, evals, sel)]


@pytest.mark.parametrize("B", [1, 8, 40, 300])
@pytest.mark.parametrize("ring", RINGS)
def test_spgemm_sel_matches_plain(card, B, ring):
    ec, ev, sel = sel_case(5003, 3000, 9, B, seed=B, dev=card)
    sel[0] = -1                                 # never a stored column
    before = ops.kernel_launches()["spgemm_sel"]
    got = spgemm_sel(ec, ev, sel, ring=ring)
    torch.cuda.synchronize()
    assert ops.kernel_launches()["spgemm_sel"] == before + 1
    torch.testing.assert_close(got, spgemm_sel_ref(ec, ev, sel, ring),
                               **SEL_TOL)


@pytest.mark.parametrize("ring", RINGS)
def test_spgemm_sel_one_hit_exact(card, ring):
    """At most one stored hit per (row, j): equal to the plain version,
    and under plus_times to spmm_ell against the one-hot X."""
    ec, ev, sel = sel_case(2000, 64, 9, 8, seed=12, dev=card, distinct=True)
    sel = torch.arange(0, 64, 8, dtype=torch.int32, device=card)
    got = spgemm_sel(ec, ev, sel, ring=ring)
    assert torch.equal(got, spgemm_sel_ref(ec, ev, sel, ring))
    onehot = torch.zeros((64, 8), device=card)
    onehot[sel.long(), torch.arange(8, device=card)] = 1.0
    if ring == "plus_times":
        assert torch.equal(got, spmm_ell(ec, ev, onehot))


def test_spgemm_sel_negative_hits_survive(card):
    ec = torch.tensor([[0, 1, -1]], dtype=torch.int32, device=card)
    ev = torch.tensor([[-2.0, -3.0, 0.0]], device=card)
    sel = torch.tensor([0, 1, 5], dtype=torch.int32, device=card)
    got = spgemm_sel(ec, ev, sel, ring="max_times")
    assert got.cpu().tolist() == [[-2.0, -3.0, 0.0]]
    onehot = torch.zeros((6, 3), device=card)
    onehot[sel.long(), torch.arange(3, device=card)] = 1.0
    assert spmm_ell(ec, ev, onehot, ring="max_times").cpu().tolist() == \
        [[0.0, 0.0, 0.0]]


def test_spgemm_sel_empty_shapes(card):
    ec, ev, sel = sel_case(10, 20, 3, 4, seed=1, dev=card)
    before = ops.kernel_launches()["spgemm_sel"]
    assert spgemm_sel(ec[:0], ev[:0], sel).shape == (0, 4)
    assert spgemm_sel(ec, ev, sel[:0]).shape == (10, 0)
    assert ops.kernel_launches()["spgemm_sel"] == before
    k0 = spgemm_sel(ec[:, :0].contiguous(), ev[:, :0].contiguous(), sel,
                    ring="max_times")
    assert k0.shape == (10, 4) and not k0.any()


def test_spgemm_sel_never_runs_plain_on_card(card, monkeypatch):
    def boom(*a, **k):
        raise AssertionError("plain version called for CUDA tensors")
    monkeypatch.setattr(kspmm, "spgemm_sel_ref", boom)
    ec, ev, sel = sel_case(300, 50, 4, 8, seed=2, dev=card)
    spgemm_sel(ec, ev, sel)
    torch.cuda.synchronize()


def test_spgemm_sel_rejects_bad_inputs(card):
    ec, ev, sel = sel_case(30, 50, 4, 8, seed=3, dev=card)
    before = ops.kernel_launches()["spgemm_sel"]
    with pytest.raises(TypeError):
        spgemm_sel(ec.long(), ev, sel)
    with pytest.raises(ValueError):
        spgemm_sel(ec, ev, sel.float())
    with pytest.raises(ValueError):
        spgemm_sel(ec, ev, sel[None])
    with pytest.raises(ValueError):
        spgemm_sel(ec, ev, sel, ring="min_plus")
    with pytest.raises(ValueError):
        spgemm_sel(ec, ev, sel.cpu())
    assert ops.kernel_launches()["spgemm_sel"] == before


def test_gateway_c2_on_card(card):
    """The gateway over the net backend on the card: ``/v1/c2`` holds the
    injected C2 in its top 3, and the scoring ran on ``cuda``."""
    import json
    import urllib.request

    from repro_torch.core import parse_tsv, val2col
    from repro_torch.device import get_device
    from repro_torch.pipeline import TrafficConfig, botnet_truth, \
        records_to_tsv, synth_packets
    from repro_torch.serve import Gateway, Tenant, TokenAuth

    cfg = TrafficConfig(n_hosts=64, pkt_rate=300.0, n_bots=8,
                        beacon_period_s=4.0, seed=1)
    E = val2col(parse_tsv(records_to_tsv(synth_packets(cfg, 30.0))))
    T = DB("Tedge", "TedgeT", "TedgeDeg", backend="net", n_instances=2,
           io_timeout=30.0)
    gw = Gateway(T, TokenAuth({"tok": Tenant("t", rate=100.0,
                                             burst=100.0)}))
    try:
        put(T, E.putval("1,"))
        addr = gw.start()
        assert get_device().type == "cuda"
        r = urllib.request.Request(f"http://{addr}/v1/c2?top_k=3",
                                   headers={"Authorization": "Bearer tok"})
        with urllib.request.urlopen(r, timeout=60) as resp:
            report = json.loads(resp.read())["report"]
        assert botnet_truth(cfg)["c2"] in report["hosts"]
        assert all(np.isfinite(report["scores"]))
    finally:
        gw.stop()
        T.close()
        T.backend.close()


# ---------------------------------------------------------------------------
# Training and the mesh on the card.
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("kernel", ["flash_attention", "wkv6", "rglru_scan"])
def test_kernels_raise_under_autograd_on_card(card, kernel):
    """A kernel input that requires grad, in grad mode: the wrapper
    raises before launching (the kernels have no backward), instead of
    returning an output with no autograd history."""
    x = (torch.rand(1, 16, 2, 16, device=card) * 0.5 + 0.25)
    if kernel == "flash_attention":
        args = [x.clone().requires_grad_(True), x.clone(), x.clone()]
        fn = flash_attention
    elif kernel == "wkv6":
        args = [x.clone().requires_grad_(True), x.clone(), x.clone(),
                x.clone(), torch.zeros(2, 16, device=card)]
        fn = wkv6
    else:
        args = [x[..., 0].clone().requires_grad_(True), x[..., 0].clone()]
        fn = rglru_scan
    before = ops.kernel_launches()[kernel]
    with pytest.raises(RuntimeError, match=f"{kernel} has no backward"):
        fn(*args)
    assert ops.kernel_launches()[kernel] == before
    with torch.no_grad():
        fn(*args)
    assert ops.kernel_launches()[kernel] == before + 1


def test_train_steps_card_match_cpu(card):
    """Two smoke train steps of rwkv6 in float32 (TF32 off) on the card
    against the CPU from the same seeded weights and batches: losses and
    gradient norms within rtol=1e-4, and no hand-written kernel runs."""
    from repro_torch.train import OptConfig, init_train_state
    from repro_torch.train.trainer import make_train_step
    cfg = smoke_config("rwkv6-1.6b")
    opt = OptConfig(lr=1e-3, warmup_steps=1)
    rng = np.random.default_rng(0)
    toks = rng.integers(0, cfg.vocab, (2, 4, 33)).astype(np.int64)
    out = {}
    before = ops.kernel_launches()
    for dev in ("cpu", "cuda"):
        params, state = init_train_state(cfg, torch.Generator()
                                         .manual_seed(0))
        params, state = to_device((params, state), dev)
        step = make_train_step(cfg, opt)
        out[dev] = []
        for t in toks:
            t = torch.from_numpy(t).to(dev)
            params, state, m = step(params, state, {"tokens": t[:, :-1],
                                                    "labels": t[:, 1:]})
            out[dev].append((float(m["loss"]), float(m["grad_norm"])))
    np.testing.assert_allclose(out["cuda"], out["cpu"], rtol=1e-4)
    assert ops.kernel_launches() == before


def test_launch_train_smoke_on_card(card, tmp_path):
    from repro_torch.launch import train
    losses = train.main(["--smoke", "--steps", "3", "--workdir",
                         str(tmp_path), "--ckpt-every", "2"])
    assert len(losses) == 3 and np.isfinite(losses).all()


def test_checkpoint_card_to_cpu_bit_exact(card, tmp_path):
    from repro_torch import checkpoint as C
    tree = {"w": torch.randn(64, 8, device=card),
            "h": torch.randn(5, device=card).to(torch.bfloat16),
            "step": torch.tensor(3, dtype=torch.int32, device=card)}
    C.save(str(tmp_path), 0, tree)
    for like_dev in ("cuda", "cpu"):
        like = {k: v.to(like_dev) for k, v in tree.items()}
        back, _ = C.restore(str(tmp_path), like)
        for k, v in tree.items():
            assert back[k].device.type == like_dev
            assert back[k].dtype == v.dtype
            assert torch.equal(back[k].cpu().reshape(-1).view(torch.uint8),
                               v.cpu().reshape(-1).view(torch.uint8))


def test_one_rank_nccl_world(card, tmp_path):
    """A one-rank NCCL world: the sharded degree and PageRank reduce with
    all_reduce on the card and equal the world of one; the int8 pod
    mean stays within scale/2 of its input."""
    import datetime

    import torch.distributed as dist

    from repro_torch.analytics import distributed as D
    from repro_torch.core.interop import coo_from_numpy
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.train import compressed_pod_mean
    store = dist.FileStore(str(tmp_path / "store"), 1)
    dist.init_process_group("nccl", store=store, rank=0, world_size=1,
                            timeout=datetime.timedelta(seconds=120))
    try:
        mesh = make_mesh((1,), ("data",))
        assert mesh.group("data") is not None
        rng = np.random.default_rng(0)
        r, c = rng.integers(0, 50, (2, 301))
        m = coo_from_numpy(r, c, np.ones(301, np.float32), (50, 50))
        assert torch.equal(D.degree_sharded(m, mesh), D.degree_sharded(m))
        np.testing.assert_allclose(D.pagerank_sharded(m, mesh, 10).cpu(),
                                   D.pagerank_sharded(m, None, 10).cpu(),
                                   rtol=1e-5, atol=1e-7)
        g = {"w": torch.randn(64, 32, device=card)}
        out = compressed_pod_mean(g, make_mesh((1,), ("pod",)))
        scale = float(g["w"].abs().max()) / 127
        assert float((out["w"] - g["w"]).abs().max()) <= scale / 2 + 1e-7
    finally:
        dist.destroy_process_group()


def _nccl_world(tmp_path):
    import datetime

    import torch.distributed as dist
    store = dist.FileStore(str(tmp_path / "store"), 1)
    dist.init_process_group("nccl", store=store, rank=0, world_size=1,
                            timeout=datetime.timedelta(seconds=120))


def test_sharded_step_one_rank_nccl(card, tmp_path):
    """The sharded train step (state placed by ``shard_params`` over a
    (1, 1) mesh, every leaf a DTensor) in a one-rank NCCL world against
    the plain step on the same seeded float32 smoke parameters and
    batches: losses and gradient norms rtol=1e-4 (float32 on the card,
    another reduction order), every parameter within 2·lr·steps."""
    import torch.distributed as dist
    from torch.distributed.tensor import DTensor

    from repro_torch.launch.mesh import make_mesh
    from repro_torch.train import OptConfig, adamw_init
    from repro_torch.train import sharding as S
    from repro_torch.train.trainer import make_train_step
    from repro_torch.tree import tree_leaves
    cfg = dataclasses.replace(smoke_config("rwkv6-1.6b"), dtype="float32")
    opt = OptConfig(lr=1e-3, warmup_steps=1)
    rng = np.random.default_rng(0)
    batches = []
    for _ in range(2):
        t = torch.from_numpy(rng.integers(0, cfg.vocab, (4, 65)).astype(
            np.int32)).to(card)
        batches.append({"tokens": t[:, :-1], "labels": t[:, 1:]})

    def run(mesh, shard):
        params = init_params(cfg, torch.Generator(device=card).manual_seed(0))
        if shard:
            params = S.shard_params(params, mesh)
        state = adamw_init(params)
        step = make_train_step(cfg, opt, mesh)
        metrics = []
        for b in batches:
            params, state, m = step(params, state, b)
            metrics.append((float(m["loss"]), float(m["grad_norm"])))
        return params, np.asarray(metrics)

    want_p, want = run(None, False)
    _nccl_world(tmp_path)
    try:
        mesh = make_mesh((1, 1), ("data", "model"))
        got_p, got = run(mesh, True)
        assert all(isinstance(p, DTensor) for p in tree_leaves(got_p))
        got_p = S.full_tree(got_p)
    finally:
        dist.destroy_process_group()
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=0)
    for a, b in zip(tree_leaves(got_p), tree_leaves(want_p)):
        assert float((a - b).abs().max()) <= 2 * 1e-3 * 2


def test_census_under_nccl(card, tmp_path):
    """``launch.census`` counts NCCL collectives by kind and operand
    bytes (a (64, 32) float32 operand, 8192 bytes), a functional
    all-reduce and an explicit ``dist.all_reduce`` each once."""
    import torch.distributed as dist
    import torch.distributed._functional_collectives as fc

    from repro_torch.launch.census import Census
    _nccl_world(tmp_path)
    try:
        x = torch.ones(64, 32, device=card)
        c = Census()
        with c:
            fc.all_reduce(x, "sum", dist.group.WORLD).wait()
            dist.all_reduce(x)
            torch.cuda.synchronize()
        assert c.collective_bytes() == {"all-reduce": 2 * 8192,
                                        "total": 2 * 8192}
        assert dict(c.coll_calls) == {"all-reduce": 2}
    finally:
        dist.destroy_process_group()


def test_launch_train_over_the_world_on_card(card, tmp_path):
    """``launch.train`` in a one-rank NCCL world places its state over the
    world (DTensors by ``param_specs``) and trains: finite losses, and a
    checkpoint written from the sharded state."""
    import torch.distributed as dist

    from repro_torch import checkpoint as C
    from repro_torch.launch import train
    _nccl_world(tmp_path)
    try:
        losses = train.main(["--smoke", "--steps", "2", "--workdir",
                             str(tmp_path / "w"), "--ckpt-every", "2"])
    finally:
        dist.destroy_process_group()
    assert len(losses) == 2 and np.isfinite(losses).all()
    assert C.latest_step(str(tmp_path / "w" / "ckpt_rwkv6_1_6b")) == 1


def _same_results(got, want, path="$"):
    """Host values equal; floats within rtol=1e-5, atol=1e-7 (the
    examples' device floats, another summation order)."""
    if isinstance(want, dict):
        assert set(got) == set(want), path
        for k in want:
            _same_results(got[k], want[k], f"{path}.{k}")
    elif isinstance(want, (list, tuple)):
        assert len(got) == len(want), path
        for i, (g, w) in enumerate(zip(got, want)):
            _same_results(g, w, f"{path}[{i}]")
    elif isinstance(want, float):
        assert np.isclose(got, want, rtol=1e-5, atol=1e-7), (path, got, want)
    else:
        assert got == want, (path, got, want)


@pytest.mark.parametrize("name", ["quickstart", "pcap_analytics",
                                  "pcap_pipeline", "train_packet_lm"])
def test_example_on_card_equals_cpu(card, tmp_path, name):
    """``repro_torch.examples.<name>.run`` on the card gives the CPU's
    results (train_packet_lm: its first two losses within rtol=1e-5, as
    chip_smoke's float32 smoke steps, then a falling loss and text) and
    launches no hand-written kernel at the example's size."""
    ex = importlib.import_module(f"repro_torch.examples.{name}")
    params = None
    if name == "train_packet_lm":   # one init for both devices
        params = init_params(smoke_config("rwkv6-1.6b"),
                             torch.Generator().manual_seed(0))

    def run(dev):
        if name in ("quickstart", "pcap_analytics"):
            return ex.run()
        kw = {"workdir": str(tmp_path / dev.type)}
        if params is not None:
            kw["params"] = to_device(params, dev)
        return ex.run(**kw)

    ops.reset_launches()
    got = run(card)
    assert not any(ops.kernel_launches().values())
    set_device("cpu")
    want = run(torch.device("cpu"))
    set_device("cuda")
    if name == "train_packet_lm":
        np.testing.assert_allclose(got["losses"][:2], want["losses"][:2],
                                   rtol=1e-5)
        assert np.isfinite(got["losses"]).all()
        assert np.mean(got["losses"][-5:]) < np.mean(got["losses"][:5])
        assert isinstance(got["outs"][0], str)
        return
    got.pop("workdir", None)
    want.pop("workdir", None)
    _same_results(got, want)
