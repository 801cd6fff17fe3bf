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
* rtol=atol=1e-5 between like forms (float32, summed in another order).
"""
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
