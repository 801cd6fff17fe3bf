"""The sharded train step's work a device, counted on ``meta`` tensors in
fake worlds (``launch.dryrun.measure_cell``), against the same step
counted in one process (``launch.census.Census`` around the plain step).
The counting runs in child processes: a process group initialized in a
pytest worker would change every later test there.

* Tensor parallelism does each product's share.  Over (1, 4), the
  per-device FLOPs equal one process's / 4 within 1% at every
  ``tp_out`` site: h2o-danube (attention ``wo``, MLP ``w_down``) at
  L = 1 and 2, whisper (cross-attention and the encoder), granite-moe
  (the MoE output), recurrentgemma (RG-LRU ``wo`` and local attention)
  and rwkv6 (``wo`` and ``cv``), ``remat="none"``, S = 64, B = 16, kv
  heads made divisible by 4.  The JAX package's rules replicate two
  products over model, and each rank does them whole: RWKV's decay LoRA
  (``dw_a``, ``dw_b``: ``("data", None)``, ``(None, "data")``) and the
  MoE router (``("data", None)``).  Their FLOPs are allowed exactly.
* Every smoke config counts on (1, 1), (4, 1) and (1, 4), GQA with one
  kv head on a model axis of 1 included; (1, 1) counts what one process
  counts, and (4, 1) and (1, 4) their shares as above.
"""
import dataclasses
import json
import os
import subprocess
import sys
import textwrap
from pathlib import Path

import pytest

from repro_torch.configs import ARCHS, smoke_config

ROOT = Path(__file__).resolve().parents[1]

SHARE_RTOL = 0.01
S, B = 64, 16

COUNT = """
    import dataclasses, json, torch
    from repro_torch.configs import smoke_config
    from repro_torch.launch import dryrun as D
    from repro_torch.launch.census import Census
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.models import inputs as I, model as M
    from repro_torch.models.config import ShapeConfig
    from repro_torch.train import OptConfig, adamw_init
    from repro_torch.train.trainer import make_train_step
    shape, opt = ShapeConfig("t", {S}, {B}, "train"), OptConfig(grad_accum=1)

    def plain(cfg):
        params = D._meta(M.abstract_params(cfg))
        state, batch = adamw_init(params), D._meta(I.input_specs(cfg, shape))
        census = Census()
        census.pin((params, state, batch))
        with census:
            make_train_step(cfg, opt)(params, state, batch)
        return census.flops

    cases = {cases}
    out = {{name: {{"plain": plain(cfg)}} for name, cfg in cases.items()}}
    for mesh in {meshes}:
        D.fake_world(mesh[0] * mesh[1])
        for name, cfg in cases.items():
            out[name][str(mesh)] = D.measure_cell(
                cfg, shape, make_mesh(mesh, ("data", "model")), opt)["flops"]
    print(json.dumps(out))
"""


def _replicated_flops(cfg) -> float:
    """FLOPs of the products the JAX package's rules replicate over
    model, on one process: RWKV's decay LoRA (two products a layer) and
    the MoE router (one), each forward product with its two backward
    ones, plus the recompute's forward under ``remat="block"``."""
    t = B * S
    fwd = 0
    for kind in cfg.layer_types():
        if kind == "W":
            fwd += 2 * (2 * t * cfg.d_model * cfg.decay_lora)
        if cfg.moe is not None and kind in ("A", "L"):
            fwd += 2 * t * cfg.d_model * cfg.moe.n_experts
    return fwd * (3 if cfg.remat == "none" else 4)


def _share(cfg, plain: float, tp: int) -> float:
    rep = _replicated_flops(cfg)
    return (plain - rep) / 4 + rep / (4 // tp)


def _count(cases: dict, meshes) -> dict:
    """{case: {"plain": FLOPs, str(mesh): per-device FLOPs}} from a child
    process; ``cases`` maps a name to (arch, smoke-config changes)."""
    cfgs = ", ".join(
        f"{name!r}: dataclasses.replace(smoke_config({arch!r}), **{kw!r})"
        for name, (arch, kw) in cases.items())
    script = COUNT.format(S=S, B=B, meshes=list(meshes),
                          cases="{" + cfgs + "}")
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"),
               REPRO_TORCH_DEVICE="cpu")
    out = subprocess.run([sys.executable, "-c", textwrap.dedent(script)],
                         env=env, capture_output=True, text=True,
                         timeout=420)
    assert out.returncode == 0, out.stderr[-4000:]
    return json.loads(out.stdout.strip().splitlines()[-1])


# one cell of each tp_out family, kv heads divisible by 4
TP_CASES = {
    "h2o_L1": ("h2o-danube-1.8b", {"n_layers": 1}),
    "h2o_L2": ("h2o-danube-1.8b", {"n_layers": 2}),
    "whisper": ("whisper-large-v3", {"n_layers": 1, "encoder_layers": 1}),
    "granite_moe": ("granite-moe-3b-a800m", {"n_layers": 1,
                                             "n_kv_heads": 4}),
    "recurrentgemma": ("recurrentgemma-9b", {"n_layers": 3,
                                             "n_kv_heads": 4}),
    "rwkv6": ("rwkv6-1.6b", {"n_layers": 1}),
}
TP_COMMON = {"remat": "none", "scan_layers": False}


@pytest.fixture(scope="module")
def tp_counts():
    return _count({name: (arch, dict(kw, **TP_COMMON))
                   for name, (arch, kw) in TP_CASES.items()}, [(1, 4)])


@pytest.mark.parametrize("case", sorted(TP_CASES))
def test_tensor_parallel_step_does_its_share(tp_counts, case):
    """Over (1, 4) each rank counts one process's FLOPs / 4 (the
    replicated LoRA and router whole) within 1%: both backward products
    of every ``tp_out`` site run on the rank's shards."""
    arch, kw = TP_CASES[case]
    cfg = dataclasses.replace(smoke_config(arch), **dict(kw, **TP_COMMON))
    got = tp_counts[case]
    assert got["plain"] > 0
    want = _share(cfg, got["plain"], 4)
    assert abs(got["(1, 4)"] - want) <= SHARE_RTOL * want, (got, want)


@pytest.fixture(scope="module")
def mesh_counts():
    return _count({arch: (arch, {"n_layers": 2}) for arch in ARCHS},
                  [(1, 1), (4, 1), (1, 4)])


@pytest.mark.parametrize("arch", ARCHS)
def test_smoke_config_counts_on_every_mesh(mesh_counts, arch):
    """(1, 1) counts exactly what one process counts; (4, 1) a quarter
    of it; (1, 4) a quarter but for the products the rules replicate
    (default remat, L = 2)."""
    cfg = dataclasses.replace(smoke_config(arch), n_layers=2)
    got = mesh_counts[arch]
    assert got["(1, 1)"] == got["plain"] > 0
    for mesh, tp in (("(4, 1)", 1), ("(1, 4)", 4)):
        want = _share(cfg, got["plain"], tp)
        assert abs(got[mesh] - want) <= SHARE_RTOL * want, (mesh, got, want)
