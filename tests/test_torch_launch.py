"""The port's launch tooling against the JAX package's: the analytic perf
model, the roofline and hill-climb terms on the H100 constants, the
calibration's unit configs, the activation-sharding rules, the
collective census on hand-built programs, and the dry run of a smoke
config in a fake world (a child process: a process group initialized in
a pytest worker would change every later test there).

Tolerances, with their reasons:
* ``perfmodel`` exact: the same float arithmetic in the same order;
* roofline and hill-climb terms within rtol=1e-12 of the JAX package's
  times the ratio of the two packages' constants (one more rounding of
  a product or quotient);
* the census exact (integer byte counts).
"""
import dataclasses
import json
import os
import subprocess
import sys
import textwrap
from pathlib import Path

import numpy as np
import pytest

from repro_torch.configs import ARCHS, get_config
from repro_torch.launch import calibrate as C
from repro_torch.launch import hillclimb as H
from repro_torch.launch import perfmodel as PM
from repro_torch.launch import roofline as R
from repro_torch.models import shard_ctx as SC
from repro_torch.models.config import ALL_SHAPES

ROOT = Path(__file__).resolve().parents[1]
TERMS_RTOL = 1e-12


def _import_without_xla_flags(name: str):
    """Import a JAX-package module that sets ``XLA_FLAGS`` (to 512 host
    devices) at import, restoring the variable after it, so no later
    child process starts JAX with 512 devices."""
    import importlib
    prev = os.environ.get("XLA_FLAGS")
    try:
        return importlib.import_module(name)
    finally:
        if prev is None:
            os.environ.pop("XLA_FLAGS", None)
        else:
            os.environ["XLA_FLAGS"] = prev


@pytest.fixture(scope="module")
def jax_launch():
    """The JAX package's perfmodel, roofline, calibrate and hillclimb
    (the dryrun they import sets ``XLA_FLAGS``; restored)."""
    _import_without_xla_flags("repro.launch.dryrun")
    mods = {n: _import_without_xla_flags(f"repro.launch.{n}")
            for n in ("perfmodel", "roofline", "calibrate", "hillclimb")}
    return mods


def _jax_cell_perf(jpm, *args, **kwargs):
    prev = os.environ.get("XLA_FLAGS")
    try:
        return jpm.cell_perf(*args, **kwargs)
    finally:
        if prev is None:
            os.environ.pop("XLA_FLAGS", None)
        else:
            os.environ["XLA_FLAGS"] = prev


def same_perf(got, want) -> None:
    assert got.flops == want.flops
    assert got.hbm_bytes == want.hbm_bytes
    assert got.coll_bytes == want.coll_bytes
    assert got.coll_by_kind == want.coll_by_kind


# ---------------------------------------------------------------------------
# the analytic perf model
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("mesh", ["single", "multi"])
@pytest.mark.parametrize("shape", [s.name for s in ALL_SHAPES])
@pytest.mark.parametrize("arch", ARCHS)
def test_cell_perf_equals_jax(jax_launch, arch, shape, mesh):
    """Default knobs: every (arch, shape, mesh) cell's FLOPs, HBM and
    collective bytes by kind equal the JAX package's exactly."""
    same_perf(PM.cell_perf(arch, shape, mesh),
              _jax_cell_perf(jax_launch["perfmodel"], arch, shape, mesh))


def _patched(cfg, patch: dict):
    """``hillclimb.run_iteration``'s config patch (moe_capacity folded
    into the MoE config)."""
    patch = dict(patch)
    cap = patch.pop("moe_capacity", None)
    if cap is not None:
        patch["moe"] = dataclasses.replace(cfg.moe, capacity_factor=cap)
    return dataclasses.replace(cfg, **patch)


def _opt_fields(opt) -> dict:
    return None if opt is None else dataclasses.asdict(opt)


@pytest.mark.parametrize("cell", sorted(H.CELLS))
def test_hillclimb_knob_sets_equal_jax(jax_launch, cell):
    """Every iteration ``hillclimb.CELLS`` builds: the same tag, knobs,
    config patch, optimizer and profile as the JAX package's, and
    ``cell_perf`` under them equal to the JAX package's exactly."""
    from repro import configs as jconfigs
    jh, jpm = jax_launch["hillclimb"], jax_launch["perfmodel"]
    arch, shape, mesh, iters = H.CELLS[cell]()
    jarch, jshape, jmesh, jiters = jh.CELLS[cell]()
    assert (arch, shape, mesh) == (jarch, jshape, jmesh)
    assert [it.tag for it in iters] == [it.tag for it in jiters]
    for it, jit in zip(iters, jiters):
        assert dataclasses.asdict(it.knobs) == dataclasses.asdict(jit.knobs)
        assert it.cfg_patch == jit.cfg_patch
        assert _opt_fields(it.opt) == _opt_fields(jit.opt)
        assert (it.profile, it.measure) == (jit.profile, jit.measure)
        cfg = _patched(get_config(arch), it.cfg_patch)
        jcfg = _patched(jconfigs.get_config(arch), jit.cfg_patch)
        same_perf(PM.cell_perf(arch, shape, mesh, it.knobs, cfg=cfg),
                  _jax_cell_perf(jpm, arch, shape, mesh, jit.knobs,
                                 cfg=jcfg))


def test_h100_constants():
    """The roofline's constants are the H100 SXM figures the kernel
    bounds use (989 TFLOP/s dense bf16, 3.35 TB/s), one 400 Gb/s NDR
    link a card across nodes; no TPU figure is left."""
    assert (R.PEAK_FLOPS, R.HBM_BW, R.LINK_BW, R.NVLINK_BW) == \
        (989e12, 3.35e12, 50e9, 450e9)
    text = (ROOT / "src/repro_torch/launch/roofline.py").read_text()
    for tpu in ("197e12", "819e9", "v5e", "TPU"):
        assert tpu not in text


@pytest.mark.parametrize("cell", sorted(H.CELLS))
def test_terms_scale_with_the_constants(jax_launch, cell):
    """``hillclimb.terms`` and ``roofline.analyze``: each time term is
    the JAX package's times the ratio of the constants it divides by;
    the dominant term and the roofline fraction follow from them."""
    jh, jr = jax_launch["hillclimb"], jax_launch["roofline"]
    arch, shape, mesh, iters = H.CELLS[cell]()
    scale = {"t_compute": jr.PEAK_FLOPS / R.PEAK_FLOPS,
             "t_memory": jr.HBM_BW / R.HBM_BW,
             "t_collective": jr.LINK_BW / R.LINK_BW}
    for it in iters:
        cfg = _patched(get_config(arch), it.cfg_patch)
        got = H.terms(arch, shape, mesh, it.knobs, cfg=cfg)
        prev = os.environ.get("XLA_FLAGS")
        want = jh.terms(arch, shape, mesh, it.knobs, cfg=cfg)
        if prev is not None:
            os.environ["XLA_FLAGS"] = prev
        for k, f in scale.items():
            np.testing.assert_allclose(got[k], want[k] * f, rtol=TERMS_RTOL)
        for kind, t in want["coll_by_kind"].items():
            np.testing.assert_allclose(got["coll_by_kind"][kind],
                                       t * scale["t_collective"],
                                       rtol=TERMS_RTOL)
        scaled = {k: want[k] * f for k, f in scale.items()}
        dom = max(scaled, key=scaled.get)
        assert got["dominant"] == dom[2:]
        mf = R.model_flops_per_device(arch, shape, 256 if mesh == "single"
                                      else 512)
        np.testing.assert_allclose(got["roofline_fraction"],
                                   (mf / R.PEAK_FLOPS) / scaled[dom],
                                   rtol=TERMS_RTOL)


def test_roofline_analyze(jax_launch):
    """``analyze`` of a dry-run record: the terms on the H100 constants,
    the record's memory in GiB, and the JAX package's keys."""
    jr = jax_launch["roofline"]
    rec = {"arch": "h2o_danube_1_8b", "shape": "train_4k", "mesh": "single",
           "ok": True, "n_devices": 256, "grad_accum": 2,
           "memory": {"temp_bytes": 3 * 2**30, "argument_bytes": 2**30},
           "collective_bytes": {"all-gather": 5, "total": 5}}
    got, want = R.analyze(rec), jr.analyze(rec)
    assert set(got) == (set(want) - {"hlo_census"}) | {"census"}
    np.testing.assert_allclose(got["t_compute_s"], want["t_compute_s"]
                               * jr.PEAK_FLOPS / R.PEAK_FLOPS,
                               rtol=TERMS_RTOL)
    np.testing.assert_allclose(got["t_memory_s"], want["t_memory_s"]
                               * jr.HBM_BW / R.HBM_BW, rtol=TERMS_RTOL)
    assert got["t_collective_s"] == want["t_collective_s"]
    assert (got["temp_gib"], got["args_gib"]) == (3.0, 1.0)
    assert got["census"] == rec["collective_bytes"]
    assert R.analyze(dict(rec, skipped="x")) is None
    assert "| **" in R.fmt_markdown([got])


@pytest.mark.parametrize("arch", ARCHS)
def test_unit_config_equals_jax(jax_launch, arch):
    """The calibration's unit variant, field by field."""
    got = dataclasses.asdict(C.unit_config(arch))
    want = dataclasses.asdict(jax_launch["calibrate"].unit_config(arch))
    assert got == want


# ---------------------------------------------------------------------------
# activation sharding
# ---------------------------------------------------------------------------

class FakeMesh:
    """A mesh stand-in: axis sizes by name and their order."""

    def __init__(self, shape, axes):
        self.shape = dict(zip(axes, shape))
        self.axis_names = tuple(axes)


MESHES = [((1, 1), ("data", "model")), ((2, 4), ("data", "model")),
          ((16, 16), ("data", "model")),
          ((2, 16, 16), ("pod", "data", "model"))]
# the call sites' logical specs, on dims that divide and that do not
SITES = [((256, 4096, 2048), ("batch", None, None)),
         ((3, 4096, 2048), ("batch", None, None)),
         ((32, 512, 40, 128), ("batch", None, "model", None)),
         ((32, 512, 8, 128), ("batch", None, "model", None)),
         ((32, 512, 5632), ("batch", None, "model")),
         ((32, 40, 128, 1536), ("batch", "model", None, None)),
         ((32, 64, 128, 1536), ("batch", "model", None, None)),
         ((1, 1, 2048), ("batch", None, None))]
HEADS = [(32, 512, 32, 128), (32, 512, 8, 128), (32, 512, 1, 256),
         (32, 512, 20, 64)]


@pytest.mark.parametrize("profile", ["2d", "zero3"])
@pytest.mark.parametrize("shape,axes", MESHES)
def test_constrain_spec_equals_jax(monkeypatch, shape, axes, profile):
    """``constrain``'s spec (and ``constrain_heads``') equals the one
    the JAX package's ``constrain`` pins, on stand-in meshes, for every
    call site's logical axes."""
    import jax
    import jax.numpy as jnp
    from repro.models import shard_ctx as jsc
    monkeypatch.setattr(jax.lax, "with_sharding_constraint",
                        lambda x, spec: spec)
    monkeypatch.setattr(jsc, "NamedSharding", lambda mesh, spec: spec)
    mesh = FakeMesh(shape, axes)
    with jsc.activation_sharding(mesh, profile):
        want = [tuple(jsc.constrain(jnp.zeros(s, jnp.int8), *lg))
                for s, lg in SITES]
        want_heads = [tuple(jsc.constrain_heads(jnp.zeros(s, jnp.int8)))
                      for s in HEADS]
    got = [SC.logical_spec(s, *lg, mesh=mesh, profile=profile)
           for s, lg in SITES]
    assert got == want
    monkeypatch.setattr(SC, "constrain", lambda x, *lg: SC.logical_spec(
        x.shape, *lg))

    class Shape:
        def __init__(self, shape):
            self.shape = shape
    with SC.activation_sharding(mesh, profile):
        assert [SC.constrain_heads(Shape(s)) for s in HEADS] == want_heads
    assert SC.current_mesh() is None and SC.current_profile() == "2d"


def test_constrain_is_a_no_op_on_plain_tensors():
    import torch
    x = torch.ones(4, 8, 16)
    with SC.activation_sharding(FakeMesh((2, 2), ("data", "model"))):
        assert SC.constrain(x, "batch", None, None) is x
        assert SC.tp_out(x) is x
        assert SC.local_rows(x) is x
        assert SC.pinned(x, "batch", None, None) is x
    assert SC.gathered({"w": x})["w"] is x


def _attention_census(device: str, s: int, chunk: int, h: int = 4,
                      dh: int = 2, triangular: bool = False):
    """Census of a no-grad causal ``attention_chunked`` at (1, s, h, dh)."""
    import torch
    from repro_torch.launch.census import Census
    from repro_torch.models.layers import attention_chunked
    rng = np.random.default_rng(0)
    q, k, v = (torch.from_numpy(rng.standard_normal((1, s, h, dh),
                                                    np.float32)).to(device)
               for _ in range(3))
    pos = torch.arange(s)[None].to(device)
    census = Census()
    census.pin((q, k, v, pos))
    with torch.no_grad(), census:
        attention_chunked(q, k, v, pos, pos, True, 0, chunk=chunk,
                          triangular=triangular)
    return census


def test_prefill_attention_peak_is_o_chunk_squared():
    """A no-grad prefill at S = 4·chunk walks (chunk, chunk) score tiles,
    as the JAX package's does: its live peak stays under four float32
    (B, H, chunk, chunk) tiles, and doubling S adds less than one tile
    (a schedule with all queries in one block holds (B, H, S, chunk))."""
    chunk, h = 128, 4
    tile = h * chunk * chunk * 4
    peak4 = _attention_census("cpu", 4 * chunk, chunk, h).peak
    peak8 = _attention_census("cpu", 8 * chunk, chunk, h).peak
    assert peak4 < 4 * tile, (peak4, tile)
    assert peak8 - peak4 < tile, (peak4, peak8, tile)


@pytest.mark.parametrize("triangular", [False, True])
def test_census_of_alike_steps_on_meta_equals_the_whole_loop(triangular):
    """On ``meta`` tensors the census runs one KV step a Q block and
    counts it for every step: FLOPs, bytes, ops and peak equal those of
    the whole loop run on the CPU."""
    cpu = _attention_census("cpu", 1024, 128, dh=8, triangular=triangular)
    meta = _attention_census("meta", 1024, 128, dh=8, triangular=triangular)
    assert cpu.flops > 0
    assert (meta.flops, meta.bytes_accessed, dict(meta.ops), meta.peak) \
        == (cpu.flops, cpu.bytes_accessed, dict(cpu.ops), cpu.peak)


# ---------------------------------------------------------------------------
# the census and the dry run (child processes in fake worlds)
# ---------------------------------------------------------------------------

def run_child(script: str, timeout: float = 240) -> dict:
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"),
               REPRO_TORCH_DEVICE="cpu")
    out = subprocess.run([sys.executable, "-c", textwrap.dedent(script)],
                         env=env, capture_output=True, text=True,
                         timeout=timeout)
    assert out.returncode == 0, out.stderr[-4000:]
    return json.loads(out.stdout.strip().splitlines()[-1])


CENSUS_CHILD = """
    import json, torch, torch.distributed as dist
    import torch.distributed._functional_collectives as fc
    from torch.testing._internal.distributed.fake_pg import FakeStore
    from repro_torch.launch.census import Census
    dist.init_process_group("fake", store=FakeStore(), rank=0, world_size=4)
    g = dist.group.WORLD
    out = {}
    def one(name, fn):
        c = Census()
        with c:
            fn()
        out[name] = [c.collective_bytes(), dict(c.coll_calls)]
    x = torch.ones(8, 16)                       # 512 bytes
    one("fc_all_reduce", lambda: fc.all_reduce(x, "sum", g).wait())
    one("fc_all_gather", lambda: fc.all_gather_tensor(x, 0, g).wait())
    one("fc_reduce_scatter",
        lambda: fc.reduce_scatter_tensor(x, "sum", 0, g).wait())
    one("fc_all_to_all",
        lambda: fc.all_to_all_single(x, None, None, g).wait())
    one("c10d_all_reduce", lambda: dist.all_reduce(x))
    one("c10d_all_gather",
        lambda: dist.all_gather_into_tensor(torch.empty(32, 16), x))
    one("c10d_reduce_scatter",
        lambda: dist.reduce_scatter_tensor(torch.empty(2, 16), x))
    one("c10d_all_to_all",
        lambda: dist.all_to_all_single(torch.empty(8, 16), x))
    one("c10d_send", lambda: dist.send(x, 1))
    c = Census()
    a, b = torch.ones(4, 8), torch.ones(8, 3)
    with c:
        y = (a @ b).t().reshape(-1).clone()
        torch.zeros(5).scatter_(0, torch.zeros(2, dtype=torch.long),
                                torch.ones(2))
    out["ops"] = [c.op_census(), c.flops]
    dist.destroy_process_group()
    print(json.dumps(out))
"""


def test_census_collective_bytes_by_kind():
    """Hand-built programs with known operand bytes (an (8, 16) float32
    operand, 512 bytes), one per kind, through functional collectives
    and explicit ``dist.*`` calls: each counted once under its JAX name
    (the wait is not a second collective); plus the op census and FLOPs
    of a small program."""
    got = run_child(CENSUS_CHILD)
    kinds = {"fc_all_reduce": "all-reduce", "fc_all_gather": "all-gather",
             "fc_reduce_scatter": "reduce-scatter",
             "fc_all_to_all": "all-to-all", "c10d_all_reduce": "all-reduce",
             "c10d_all_gather": "all-gather",
             "c10d_reduce_scatter": "reduce-scatter",
             "c10d_all_to_all": "all-to-all",
             "c10d_send": "collective-permute"}
    for name, kind in kinds.items():
        coll, calls = got[name]
        assert coll == {kind: 512, "total": 512}, name
        assert calls == {kind: 1}, name
    census, flops = got["ops"]
    assert census["dot"] == 1 and census["transpose"] == 1
    assert census["reshape"] >= 1 and census["copy"] >= 1
    assert census["scatter"] == 1
    assert census["fusion"] is None and census["while"] is None
    assert flops == 2 * 4 * 8 * 3


DRYRUN_CHILD = """
    import dataclasses, json, torch
    from repro_torch.configs import smoke_config
    from repro_torch.launch import dryrun as D
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.models.config import ShapeConfig
    from repro_torch.train import OptConfig
    D.fake_world(16)
    mesh = make_mesh((4, 4), ("data", "model"))
    out = {}
    for remat in ("block", "block_save_coll"):
        cfg = dataclasses.replace(smoke_config("h2o-danube-1.8b"),
                                  remat=remat)
        out[remat] = D.measure_cell(cfg, ShapeConfig("t", 64, 16, "train"),
                                    mesh, OptConfig(grad_accum=2))
    out["skip"] = D.run_cell("whisper-large-v3", "long_500k", "single",
                             force=True)
    print(json.dumps(out))
"""


@pytest.fixture(scope="module")
def dryrun_child(tmp_path_factory):
    return run_child(DRYRUN_CHILD)


def test_dryrun_record_has_the_jax_keys(dryrun_child):
    """A dry run of h2o's smoke config (S = 64, B = 16, grad_accum 2) in
    a fake 16-rank world over (4, 4): the JAX package's record keys, a
    positive per-device FLOP count, collectives of the FSDP×TP step, and
    ``argument_bytes`` equal to the local shard bytes the specs imply."""
    import torch
    from repro_torch.models import abstract_params
    from repro_torch.configs import smoke_config
    from repro_torch.train import sharding as S
    from repro_torch.tree import leaves_at, tree_leaves
    rec = dryrun_child["block"]
    keys = {"ok", "lower_s", "compile_s", "flops", "bytes_accessed",
            "collective_bytes", "op_census", "memory", "n_devices"}
    assert keys <= set(rec) and rec["ok"] and rec["n_devices"] == 16
    assert set(rec["memory"]) == {"argument_bytes", "output_bytes",
                                  "temp_bytes", "alias_bytes", "code_bytes"}
    assert rec["flops"] > 0 and rec["bytes_accessed"] > 0
    assert {"all-gather", "reduce-scatter", "all-reduce"} <= \
        set(rec["collective_bytes"])
    assert rec["collective_bytes"]["total"] == sum(
        v for k, v in rec["collective_bytes"].items() if k != "total")
    assert set(rec["op_census"]) == {"fusion", "dot", "scatter", "gather",
                                     "transpose", "reshape", "copy", "while"}
    mesh = FakeMesh((4, 4), ("data", "model"))
    params = abstract_params(smoke_config("h2o-danube-1.8b"))
    specs = leaves_at(S.param_specs(params, mesh), params)
    shard = 0
    for p, spec in zip(tree_leaves(params), specs):
        n = p.numel()
        for ax in spec:
            for a in (ax if isinstance(ax, tuple) else (ax,)):
                n //= mesh.shape[a] if a else 1
        shard += n * p.element_size()
    batch = 2 * (16 // 4) * 64 * 4               # tokens, labels int32
    assert rec["memory"]["argument_bytes"] == 3 * shard + 4 + batch
    assert rec["memory"]["alias_bytes"] == 3 * shard
    assert rec["memory"]["temp_bytes"] > 0
    assert rec["memory"]["code_bytes"] == 0
    assert torch.float32.itemsize == 4


def test_dryrun_save_coll_keeps_collectives(dryrun_child):
    """``block_save_coll`` replays fewer all-reduces in the recompute
    than ``block`` and counts the same FLOPs and other collectives."""
    block, save = dryrun_child["block"], dryrun_child["block_save_coll"]
    assert save["collective_calls"]["all-reduce"] < \
        block["collective_calls"]["all-reduce"]
    assert save["flops"] == block["flops"]
    for k in ("all-gather", "reduce-scatter"):
        assert save["collective_calls"][k] == block["collective_calls"][k]


def test_dryrun_skip_reason_equals_jax(dryrun_child):
    from repro import configs as jconfigs
    from repro.models import inputs as JI
    from repro.models.config import shape_by_name
    rec = dryrun_child["skip"]
    assert rec["ok"] and rec["skipped"] == JI.check_applicable(
        jconfigs.get_config("whisper-large-v3"), shape_by_name("long_500k"))
