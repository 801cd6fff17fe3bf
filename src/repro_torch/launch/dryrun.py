"""Multi-pod dry run: count every (arch × shape × mesh) cell's step
without running it on a card (the JAX package's ``launch/dryrun.py``).

For each cell this runs the real step function (``make_train_step`` for
train shapes, prefill/decode for serving shapes) on full-size inputs
with the production placements, in a ``"fake"`` process group of 256
(``single``: (16, 16) over (data, model)) or 512 (``multi``: (2, 16, 16)
over (pod, data, model)) ranks, on the ``meta`` device: tensors carry
shapes and dtypes and no storage, collectives move nothing, and this
process plays rank 0.  Parameters and optimizer state are full-size
``meta`` tensors placed by ``train.sharding.shard_params``; the inputs
come from ``models.inputs.input_specs``/``cache_specs``.  A
:class:`~repro_torch.launch.census.Census` around the step records, per
device (rank 0's shards):

* ``flops`` — counted on the local shards (matmul-class ops);
* ``bytes_accessed`` — each dispatched op's inputs and outputs, nothing
  fused (``bytes_accessed_note`` says so);
* ``collective_bytes`` and ``op_census`` — see ``launch/census.py``;
* ``memory`` — ``argument_bytes``: the local shards of parameters,
  optimizer state and batch (and caches); ``temp_bytes``: the peak of
  live storage the step allocated on top of them; ``output_bytes``: the
  step's outputs that are new storage; ``alias_bytes``: the state the
  sharded train step updates in place (donated); ``code_bytes``: 0, an
  eager program has no compiled executable (``code_bytes_note``);
* ``n_devices``; ``lower_s`` (placing the state) and ``compile_s`` (the
  counted step), the trace's seconds.

The configs' default ``chunked`` attention and WKV run, as in the JAX
package's dryrun; no hand-written kernel is involved.  Records are
cached in results/torch/dryrun/<cell>.json so a sweep restarts where it
stopped (failures re-run).  Each world size needs its own process
group, so ``main`` re-initializes the fake group between meshes; run
this module in a process of its own (``init_process_group`` flips
``dist.is_initialized()`` for everything after it).

Usage:
  python -m repro_torch.launch.dryrun --arch qwen2.5-14b --shape train_4k
  python -m repro_torch.launch.dryrun --all [--mesh single|multi|both]
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import math
import os
import time
import traceback
from typing import Callable, Optional

import torch
import torch.distributed as dist

from ..configs import ARCHS, canonical, get_config
from ..models import inputs as I
from ..models import model as M
from ..models.config import ALL_SHAPES, ModelConfig, shape_by_name
from ..train import OptConfig, adamw_init
from ..train import sharding as S
from ..train.trainer import (make_decode_step, make_prefill_step,
                             make_train_step)
from ..tree import tree_leaves, tree_map
from .census import Census
from .mesh import make_production_mesh

RESULTS_DIR = os.path.join(os.path.dirname(__file__), "..", "..", "..",
                           "results", "torch", "dryrun")

# Production micro-batching (per arch), the JAX package's table.
TRAIN_GRAD_ACCUM = {
    "h2o_danube_1_8b": 2, "granite_moe_3b_a800m": 4, "rwkv6_1_6b": 2,
    "phi3_mini_3_8b": 2, "phi_3_vision_4_2b": 2, "whisper_large_v3": 2,
    "qwen2_5_14b": 4, "internlm2_20b": 4, "recurrentgemma_9b": 4,
    "qwen3_moe_235b_a22b": 8,
}
BYTES_NOTE = ("sum of every dispatched op's input and output bytes on the "
              "local shards, nothing fused: an upper bound on HBM traffic")
CODE_NOTE = "an eager program has no compiled executable"
WORLDS = {"single": 256, "multi": 512}


def default_opt(arch: str) -> OptConfig:
    return OptConfig(grad_accum=TRAIN_GRAD_ACCUM.get(canonical(arch), 2))


def fake_world(n: int) -> None:
    """This process as rank 0 of a ``"fake"`` group of ``n`` ranks
    (re-initialized when the size differs)."""
    from torch.testing._internal.distributed.fake_pg import FakeStore
    if dist.is_initialized():
        if dist.get_world_size() == n:
            return
        dist.destroy_process_group()
    dist.init_process_group("fake", store=FakeStore(), rank=0, world_size=n)


def _per_device_batch(shape, mesh) -> None:
    # train shapes must tile the data axes exactly; small serving batches
    # (long_500k B=1) replicate across data instead (batch_spec).
    if shape.kind == "train":
        data_par = math.prod(mesh.shape[n] for n in mesh.axis_names
                             if n in ("pod", "data"))
        assert shape.global_batch % data_par == 0, \
            (shape.name, shape.global_batch, data_par)


def _meta(meta_tree, dtype_map: Optional[Callable] = None):
    """A tree of ``meta`` tensors (shapes and dtypes, no storage),
    ``dtype_map`` applied to their dtypes."""
    def one(t):
        if not isinstance(t, torch.Tensor):
            return t
        dt = dtype_map(t.dtype) if dtype_map else t.dtype
        return torch.empty(t.shape, dtype=dt, device="meta")
    return tree_map(one, meta_tree)


def _local_bytes(tree) -> int:
    from torch.distributed.tensor import DTensor
    total = 0
    for x in tree_leaves(tree):
        if isinstance(x, DTensor):
            x = x.to_local()
        if isinstance(x, torch.Tensor):
            total += x.numel() * x.element_size()
    return total


def _batch_local_bytes(batch: dict, mesh, profile: str) -> int:
    total = 0
    for v in batch.values():
        spec = S.batch_spec(v, mesh, profile)
        n = math.prod(v.shape) * v.element_size()
        if spec[0] is not None:
            n //= math.prod(mesh.shape[a]
                            for a in S.batch_axis_tuple(mesh, profile))
        total += n
    return total


@dataclasses.dataclass
class Lowered:
    """A cell's step and its placed ``meta`` inputs, ready to count."""
    fn: Callable
    args: tuple
    argument_bytes: int


def lower_cell(cfg: ModelConfig, shape, mesh, opt: OptConfig = None,
               profile: str = "2d") -> Lowered:
    """Build the step and its placed ``meta`` inputs for one cell (in a
    fake world).  Raises ``SkipCell``."""
    opt = opt or OptConfig()
    specs = I.input_specs(cfg, shape)           # raises SkipCell
    _per_device_batch(shape, mesh)
    batch = _meta(specs)
    batch_bytes = _batch_local_bytes(batch, mesh, profile)

    if shape.kind == "train":
        params = S.shard_params(_meta(M.abstract_params(cfg)), mesh, profile)
        opt_state = adamw_init(params)
        step = make_train_step(cfg, opt, mesh, profile)
        return Lowered(step, (params, opt_state, batch),
                       _local_bytes((params, opt_state)) + batch_bytes)

    f32_to_bf16 = None
    if getattr(cfg, "serve_param_dtype", None) == "bfloat16":
        # serving loads bf16 weights, as in the JAX package
        def f32_to_bf16(dt):
            return torch.bfloat16 if dt == torch.float32 else dt
    params = S.shard_params(_meta(M.abstract_params(cfg), f32_to_bf16),
                            mesh)
    sbatch = S.shard_batch(batch, mesh)
    if shape.kind == "prefill":
        step = make_prefill_step(cfg, s_max=shape.seq_len, mesh=mesh)
        return Lowered(step, (params, sbatch),
                       _local_bytes((params, sbatch)))
    caches = S.shard_caches(_meta(I.cache_specs(cfg, shape)), mesh)
    step = make_decode_step(cfg, mesh=mesh)
    return Lowered(step, (params, caches, sbatch),
                   _local_bytes((params, caches, sbatch)))


def count(lowered: Lowered) -> dict:
    """Run the lowered step under a :class:`Census` (and
    ``CommDebugMode`` as a cross-check); the record's measured keys."""
    from torch.distributed.tensor.debug import CommDebugMode
    census = Census()
    census.pin(lowered.args)
    t0 = time.time()
    with CommDebugMode() as comm, census:
        out = lowered.fn(*lowered.args)
    t_count = time.time() - t0
    from torch.distributed.tensor import DTensor
    outs = [x.to_local() if isinstance(x, DTensor) else x
            for x in tree_leaves(out) if isinstance(x, torch.Tensor)]
    # outputs in an argument's storage: the state updated in place
    alias = sum(x.numel() * x.element_size() for x in outs
                if census.is_pinned(x))
    output = sum(x.numel() * x.element_size() for x in outs
                 if not census.is_pinned(x))
    return {
        "compile_s": round(t_count, 2),
        "flops": float(census.flops),
        "bytes_accessed": float(census.bytes_accessed),
        "bytes_accessed_note": BYTES_NOTE,
        "collective_bytes": census.collective_bytes(),
        "collective_calls": dict(census.coll_calls),
        "comm_debug_counts": {str(k): int(v) for k, v in
                              comm.get_comm_counts().items()},
        "shape_inference_excluded": census.excludes_propagation,
        "op_census": census.op_census(),
        "memory": {"argument_bytes": int(lowered.argument_bytes),
                   "output_bytes": int(output),
                   "temp_bytes": int(census.peak),
                   "alias_bytes": int(alias),
                   "code_bytes": 0},
        "code_bytes_note": CODE_NOTE,
    }


def measure_cell(cfg: ModelConfig, shape, mesh, opt: OptConfig,
                 profile: str = "2d") -> dict:
    """Place and count one cell on ``mesh`` (of the fake world this
    process is rank 0 of): the record's measured keys and ``ok``."""
    t0 = time.time()
    lowered = lower_cell(cfg, shape, mesh, opt=opt, profile=profile)
    t_lower = time.time() - t0
    out = count(lowered)
    out.update({"ok": True, "lower_s": round(t_lower, 2),
                "n_devices": int(mesh.size)})
    return out


def run_cell(arch: str, shape_name: str, mesh_kind: str,
             cfg_override=None, tag: str = "", force: bool = False,
             opt_override: OptConfig = None, profile: str = "2d") -> dict:
    os.makedirs(RESULTS_DIR, exist_ok=True)
    cell = f"{canonical(arch)}__{shape_name}__{mesh_kind}" + \
        (f"__{tag}" if tag else "")
    path = os.path.join(RESULTS_DIR, cell + ".json")
    if os.path.exists(path) and not force:
        with open(path) as f:
            cached = json.load(f)
        if cached.get("ok"):        # cached failures re-run (bugs get fixed)
            return cached

    cfg = cfg_override or get_config(arch)
    shape = shape_by_name(shape_name)
    opt = opt_override or default_opt(arch)
    record = {"arch": canonical(arch), "shape": shape_name,
              "mesh": mesh_kind, "tag": tag, "config": cfg.name,
              "grad_accum": opt.grad_accum if shape_name.startswith("train")
              else None}
    try:
        fake_world(WORLDS[mesh_kind])
        mesh = make_production_mesh(multi_pod=(mesh_kind == "multi"))
        record.update(measure_cell(cfg, shape, mesh, opt, profile))
    except I.SkipCell as e:
        record.update({"ok": True, "skipped": str(e)})
    except Exception as e:  # record failures — they are bugs to fix
        record.update({"ok": False, "error": repr(e),
                       "traceback": traceback.format_exc()[-4000:]})
    with open(path + ".tmp", "w") as f:
        json.dump(record, f, indent=1)
    os.replace(path + ".tmp", path)
    return record


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None)
    ap.add_argument("--mesh", default="both",
                    choices=["single", "multi", "both"])
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--force", action="store_true")
    args = ap.parse_args(argv)

    archs = ARCHS if (args.all or not args.arch) else [args.arch]
    shapes = [s.name for s in ALL_SHAPES] if (args.all or not args.shape) \
        else [args.shape]
    meshes = ["single", "multi"] if args.mesh == "both" else [args.mesh]

    torch.set_num_threads(1)
    for mesh_kind in meshes:
        for arch in archs:
            for shape in shapes:
                rec = run_cell(arch, shape, mesh_kind, force=args.force)
                status = ("SKIP: " + rec["skipped"]) if rec.get("skipped") \
                    else ("OK" if rec.get("ok") else
                          "FAIL: " + rec.get("error", "?"))
                mem = rec.get("memory", {})
                print(f"{rec['arch']:26s} {shape:12s} {mesh_kind:6s} "
                      f"{status}"
                      + (f"  temp={mem.get('temp_bytes', 0)/2**30:.2f}GiB"
                         f" args={mem.get('argument_bytes', 0)/2**30:.2f}GiB"
                         f" lower={rec.get('lower_s')}s"
                         f" compile={rec.get('compile_s')}s"
                         if rec.get("ok") and not rec.get("skipped") else ""),
                      flush=True)
    if dist.is_initialized():
        dist.destroy_process_group()


if __name__ == "__main__":
    main()
