"""The port's WKV-6 against the JAX package's, on identical numpy inputs.

On CPU tensors the port's ``wkv6`` wrapper runs its plain version
(``wkv6_ref``, the model's ``wkv_scan``); it is held against the JAX
Pallas kernel in interpret mode, the JAX oracle and JAX's chunked form.
The CUDA kernel itself is held against the plain version on the card by
tests/test_torch_cuda.py and ``chip_smoke.py``.

Tolerances:
* rtol=atol=1e-3 wherever a chunked form (the Pallas kernel or
  ``wkv_chunked``) meets a sequential one — the JAX package's own
  tolerance between the two (tests/test_kernels.py): the chunked form
  scales by exp(±Σ log w) and rounds differently in float32;
* rtol=atol=1e-5 between like forms (float32, summed in another order);
* rtol=atol=1e-4 for the CUDA kernel's chunked form (chunks of 16 steps,
  ragged last chunk) against the port's ``wkv_chunked(chunk=16)``, the
  plain version and the Pallas kernel at ``chunk=16``: the kernel's own
  tolerance against the plain version on the card.
"""
import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ref as jref
from repro.kernels.wkv6 import wkv6 as jwkv6
from repro.models import blocks as JB
from repro_torch.device import set_device
from repro_torch.kernels import ops, wkv6, wkv6_ref
from repro_torch.models import blocks as PB

FORMS_TOL = dict(rtol=1e-3, atol=1e-3)
LIKE_TOL = dict(rtol=1e-5, atol=1e-5)
KERNEL_TOL = dict(rtol=1e-4, atol=1e-4)
CLIP_FLOOR = math.exp(-math.exp(0.5))    # the model's smallest decay
KERNEL_CHUNK = 16
# (S, H, Dh, chunk) of the JAX package's own WKV-6 kernel test
SHAPES = [(64, 2, 16, 16), (128, 4, 32, 32), (96, 1, 8, 32)]


@pytest.fixture(autouse=True)
def _cpu():
    prev = set_device("cpu")
    yield
    set_device(prev)


def wkv_inputs(B, S, H, Dh, seed):
    """r, k, v normal; w in (0.45, 0.95); u × 0.1 — as the JAX test."""
    rng = np.random.default_rng(seed)
    r, k, v = (rng.normal(0, 1, (B, S, H, Dh)).astype(np.float32)
               for _ in range(3))
    w = (0.5 / (1 + np.exp(-rng.normal(0, 1, (B, S, H, Dh)))) + 0.45
         ).astype(np.float32)
    u = (rng.normal(0, 1, (H, Dh)) * 0.1).astype(np.float32)
    return r, k, v, w, u


def t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def close(got, want, tol):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), **tol)


@pytest.mark.parametrize("S,H,Dh,chunk", SHAPES)
def test_matches_pallas_interpret(S, H, Dh, chunk):
    arrs = wkv_inputs(2, S, H, Dh, seed=S + Dh)
    out, _ = wkv6(*map(t, arrs))
    want = jwkv6(*map(jnp.asarray, arrs), chunk=chunk, interpret=True)
    assert out.shape == (2, S, H, Dh) and out.dtype == torch.float32
    close(out, want, FORMS_TOL)


@pytest.mark.parametrize("S,H,Dh,chunk", SHAPES)
def test_matches_reference_oracle(S, H, Dh, chunk):
    arrs = wkv_inputs(2, S, H, Dh, seed=S + Dh + 1)
    out, _ = wkv6(*map(t, arrs))
    close(out, jref.wkv6_ref(*map(jnp.asarray, arrs)), LIKE_TOL)


@pytest.mark.parametrize("S,H,Dh,chunk", SHAPES)
def test_final_state_matches_wkv_chunked(S, H, Dh, chunk):
    """The state the kernel hands to decode equals the one the JAX
    model recomputes with ``wkv_chunked`` after its Pallas call."""
    arrs = wkv_inputs(2, S, H, Dh, seed=S + Dh + 2)
    _, state = wkv6(*map(t, arrs))
    zero = jnp.zeros((2, H, Dh, Dh), jnp.float32)
    _, want = JB.wkv_chunked(*map(jnp.asarray, arrs), zero, chunk=chunk)
    assert state.shape == (2, H, Dh, Dh)
    close(state, want, FORMS_TOL)


@pytest.mark.parametrize("form", ["scan", "chunked"])
def test_model_forms_match_jax_from_a_state(form):
    """``wkv_scan``/``wkv_chunked`` from a non-zero state (decode hands
    one over) against the JAX model's same function."""
    B, S, H, Dh, chunk = 2, 48, 3, 16, 16
    arrs = wkv_inputs(B, S, H, Dh, seed=5)
    s0 = np.random.default_rng(6).normal(0, 1, (B, H, Dh, Dh)).astype(
        np.float32)
    kw = {} if form == "scan" else {"chunk": chunk}
    got = getattr(PB, f"wkv_{form}")(*map(t, arrs), t(s0), **kw)
    want = getattr(JB, f"wkv_{form}")(*map(jnp.asarray, arrs),
                                      jnp.asarray(s0), **kw)
    for g, w in zip(got, want):
        close(g, w, LIKE_TOL)


def test_port_forms_agree():
    arrs = list(map(t, wkv_inputs(2, 64, 2, 32, seed=7)))
    o_ref, s_ref = wkv6_ref(*arrs)
    o_ch, s_ch = PB.wkv_chunked(*arrs, torch.zeros_like(s_ref), chunk=32)
    close(o_ch, o_ref, FORMS_TOL)
    close(s_ch, s_ref, FORMS_TOL)


def test_strided_inputs():
    """Views of a wider tensor (unit-stride last axis, shared strides)
    are taken as they are and give the contiguous answer."""
    r, k, v, w, u = wkv_inputs(2, 16, 2, 8, seed=8)
    wide = [np.concatenate([a, np.zeros_like(a)], axis=-1)
            for a in (r, k, v, w)]
    views = [t(a)[..., :8] for a in wide]
    assert not views[0].is_contiguous()
    got, gs = wkv6(*views, t(u))
    want, ws = wkv6(*map(t, (r, k, v, w, u)))
    close(got, want, dict(rtol=0, atol=0))
    close(gs, ws, dict(rtol=0, atol=0))


def test_cpu_runs_plain_version_without_launch():
    before = ops.kernel_launches()["wkv6"]
    wkv6(*map(t, wkv_inputs(1, 8, 1, 16, seed=9)))
    assert ops.kernel_launches()["wkv6"] == before


@pytest.mark.parametrize("case", ["dtype", "head_dim", "u_shape", "strides",
                                  "shapes"])
def test_rejects_what_the_kernel_does_not_take(case):
    r, k, v, w, u = map(t, wkv_inputs(1, 8, 2, 16, seed=10))
    if case == "dtype":
        r = r.double()
    elif case == "head_dim":
        r, k, v, w = (a[..., :12].contiguous() for a in (r, k, v, w))
        u = u[:, :12].contiguous()
    elif case == "u_shape":
        u = u[:1].contiguous()
    elif case == "strides":
        k = k.transpose(1, 2).contiguous().transpose(1, 2)
    else:
        v = v[:, :4]
    with pytest.raises((TypeError, ValueError)):
        wkv6(r, k, v, w, u)


def test_mixed_devices_raise():
    r, k, v, w, u = map(t, wkv_inputs(1, 8, 2, 16, seed=11))
    with pytest.raises(ValueError):
        wkv6(r, k, v, w, u.to("meta"))


# ---------------------------------------------------------------------------
# The CUDA kernel's chunked form, emulated on the CPU.
# ---------------------------------------------------------------------------

def kernel_form(r, k, v, w, u, chunk=KERNEL_CHUNK):
    """WKV-6 as ``csrc/wkv6.cu`` computes it, in float32: chunks of
    ``chunk`` steps, steps past S padded with w = 1 and r = k = v = 0;
    within a chunk cum = Σ log2 w (inclusive), ce the exclusive sum, cl
    its last value; q_eff = r 2^ce, k_in = k 2^-cum, k_out = k 2^(cl -
    cum); A = q_eff k_inᵀ below the diagonal and Σ r k u on it; o =
    q_eff S + A v; S ← 2^cl ⊙ S + k_outᵀ v."""
    B, S, H, D = r.shape
    n = -(-S // chunk)
    pad = n * chunk - S

    def padded(t, fill):
        tail = torch.full((B, pad, H, D), fill, dtype=torch.float32)
        return torch.cat([t, tail], dim=1)

    def chunks(t):        # (B, n*chunk, H, D) -> (n, B, H, chunk, D)
        return t.reshape(B, n, chunk, H, D).permute(1, 0, 3, 2, 4)

    lw = torch.log2(torch.clamp_min(w, 1e-38))
    rc, kc, vc, lc = (chunks(padded(t, 0.0)) for t in (r, k, v, lw))
    below = torch.tril(torch.ones(chunk, chunk), -1)
    state = torch.zeros(B, H, D, D)
    outs = []
    for i in range(n):
        cum = torch.cumsum(lc[i], dim=2)
        ce = cum - lc[i]
        cl = cum[..., -1:, :]
        q_eff = rc[i] * torch.exp2(ce)
        k_in = kc[i] * torch.exp2(-cum)
        k_out = kc[i] * torch.exp2(cl - cum)
        A = torch.einsum("bhck,bhsk->bhcs", q_eff, k_in) * below
        A = A + torch.diag_embed(torch.einsum("bhck,hk->bhc",
                                              rc[i] * kc[i], u))
        outs.append(torch.einsum("bhck,bhkv->bhcv", q_eff, state)
                    + torch.einsum("bhcs,bhsv->bhcv", A, vc[i]))
        state = state * torch.exp2(cl).transpose(-1, -2) + \
            torch.einsum("bhsk,bhsv->bhkv", k_out, vc[i])
    out = torch.stack(outs).permute(1, 0, 3, 2, 4).reshape(B, n * chunk, H, D)
    return out[:, :S], state


def kernel_inputs(S, Dh, decay, seed):
    r, k, v, w, u = wkv_inputs(2, S, 3, Dh, seed)
    if decay == "clip_floor":
        w = np.full_like(w, CLIP_FLOOR)
    return r, k, v, w, u


@pytest.mark.parametrize("decay", ["normal", "clip_floor"])
@pytest.mark.parametrize("S,Dh", [(512, 64), (97, 64), (128, 16),
                                  (33, 128)])
def test_kernel_form_matches_plain(S, Dh, decay):
    """At the serve head dim and long chunks, ragged S included."""
    arrs = kernel_inputs(S, Dh, decay, seed=S + Dh)
    got = kernel_form(*map(t, arrs))
    want = wkv6_ref(*map(t, arrs))
    for g, x in zip(got, want):
        close(g, x, KERNEL_TOL)


@pytest.mark.parametrize("decay", ["normal", "clip_floor"])
@pytest.mark.parametrize("S,Dh", [(512, 64), (64, 32)])
def test_kernel_form_matches_wkv_chunked(S, Dh, decay):
    arrs = list(map(t, kernel_inputs(S, Dh, decay, seed=S + 2 * Dh)))
    got = kernel_form(*arrs)
    zero = torch.zeros(2, 3, Dh, Dh)
    want = PB.wkv_chunked(*arrs, zero, chunk=KERNEL_CHUNK)
    for g, x in zip(got, want):
        close(g, x, KERNEL_TOL)


@pytest.mark.parametrize("decay", ["normal", "clip_floor"])
@pytest.mark.parametrize("S,Dh", [(256, 64), (48, 8)])
def test_kernel_form_matches_pallas_interpret(S, Dh, decay):
    """The Pallas kernel at ``chunk=16`` (it asserts S % chunk == 0)."""
    arrs = kernel_inputs(S, Dh, decay, seed=S + 3 * Dh)
    got, _ = kernel_form(*map(t, arrs))
    want = jwkv6(*map(jnp.asarray, arrs), chunk=KERNEL_CHUNK, interpret=True)
    close(got, want, KERNEL_TOL)

