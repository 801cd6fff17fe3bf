"""Hill-climb loop over the selected cells (the JAX package's
``launch/hillclimb.py``, on the port's dryrun and the H100 roofline).

For each (cell, iteration) this computes the analytic roofline terms
(``perfmodel`` on ``roofline``'s H100 constants) AND re-runs the real
step in the fake world of ``launch/dryrun.py`` to record its per-device
memory and collective census — each iteration a (hypothesis → change →
measure) record written to results/torch/perf/<cell>__<tag>.json.

Cells, as in the JAX package: qwen3-moe-235b-a22b, granite-moe-3b-a800m,
h2o-danube-1.8b and recurrentgemma-9b at train_4k, and qwen2.5-14b at
prefill_32k, all on the single-pod mesh.

Usage:
  python -m repro_torch.launch.hillclimb [--cell h2o|qwen3|granite|...]
"""
from __future__ import annotations

import dataclasses
import json
import os

from ..configs import get_config
from ..train import OptConfig
from . import perfmodel as PM
from .dryrun import RESULTS_DIR, run_cell
from .roofline import HBM_BW, LINK_BW, PEAK_FLOPS, model_flops_per_device

PERF_DIR = os.path.join(os.path.dirname(RESULTS_DIR), "perf")


@dataclasses.dataclass
class Iter:
    tag: str
    hypothesis: str
    knobs: PM.PerfKnobs
    cfg_patch: dict = dataclasses.field(default_factory=dict)
    opt: OptConfig = None
    profile: str = "2d"
    measure: bool = True       # re-lower the real module for evidence


def terms(arch, shape, mesh, knobs, cfg=None):
    perf = PM.cell_perf(arch, shape, mesh, knobs, cfg=cfg)
    t = {"t_compute": perf.flops / PEAK_FLOPS,
         "t_memory": perf.hbm_bytes / HBM_BW,
         "t_collective": perf.coll_bytes / LINK_BW,
         "coll_by_kind": {k: v / LINK_BW
                          for k, v in perf.coll_by_kind.items()}}
    bound = max(t["t_compute"], t["t_memory"], t["t_collective"])
    mf = model_flops_per_device(arch, shape, 256 if mesh == "single"
                                else 512)
    t["dominant"] = max((t["t_compute"], "compute"),
                        (t["t_memory"], "memory"),
                        (t["t_collective"], "collective"))[1]
    t["roofline_fraction"] = (mf / PEAK_FLOPS) / bound
    return t


def run_iteration(arch: str, shape: str, mesh: str, it: Iter,
                  force: bool = False) -> dict:
    os.makedirs(PERF_DIR, exist_ok=True)
    from ..configs import canonical
    cell = f"{canonical(arch)}__{shape}__{mesh}__{it.tag}"
    path = os.path.join(PERF_DIR, cell + ".json")
    if os.path.exists(path) and not force:
        with open(path) as f:
            return json.load(f)
    cfg = get_config(arch)
    if it.cfg_patch:
        patch = dict(it.cfg_patch)
        cap = patch.pop("moe_capacity", None)
        if cap is not None:
            patch["moe"] = dataclasses.replace(cfg.moe,
                                               capacity_factor=cap)
        cfg = dataclasses.replace(cfg, **patch)
    rec = {"arch": canonical(arch), "shape": shape, "mesh": mesh,
           "tag": it.tag, "hypothesis": it.hypothesis,
           "model_terms": terms(arch, shape, mesh, it.knobs, cfg=cfg)}
    if it.measure:
        dr = run_cell(arch, shape, mesh, cfg_override=cfg,
                      tag="perf_" + it.tag, force=force,
                      opt_override=it.opt, profile=it.profile)
        rec["measured"] = {
            "ok": dr.get("ok"), "error": dr.get("error"),
            "temp_gib": dr.get("memory", {}).get("temp_bytes", 0) / 2**30,
            "args_gib": dr.get("memory", {}).get("argument_bytes", 0)
            / 2**30,
            "collectives": dr.get("collective_bytes"),
            "compile_s": dr.get("compile_s"),
        }
    with open(path, "w") as f:
        json.dump(rec, f, indent=1)
    return rec


def h2o_iterations():
    ga = 2
    base = PM.PerfKnobs(grad_accum=ga)
    return "h2o-danube-1.8b", "train_4k", "single", [
        Iter("baseline", "production 2-D (FSDP×TP) defaults",
             base, opt=OptConfig(grad_accum=ga)),
        Iter("save_coll",
             "TP all-reduce replay in remat is 1/3 of collective time; "
             "saving collective outputs cuts passes 3→2",
             dataclasses.replace(base, save_coll=True),
             cfg_patch={"remat": "block_save_coll"},
             opt=OptConfig(grad_accum=ga)),
        Iter("bf16_wire",
             "f32 param gathers + grad reduces are 2× the needed bytes; "
             "bf16 on the wire halves both",
             dataclasses.replace(base, gather_bytes=2, grad_bytes=2),
             opt=OptConfig(grad_accum=ga, gather_dtype="bfloat16",
                           grad_dtype="bfloat16")),
        Iter("zero3",
             "1.8B params need no TP on 256 chips: pure ZeRO-3 removes "
             "all per-layer TP all-reduces; param gathers (bf16) are the "
             "only collective left",
             dataclasses.replace(base, gather_bytes=2, grad_bytes=2,
                                 grad_accum=1, profile="zero3"),
             opt=OptConfig(grad_accum=1, gather_dtype="bfloat16",
                           grad_dtype="bfloat16"),
             profile="zero3"),
        Iter("zero3_tri",
             "now compute-bound: masked-full attention does 2× the "
             "causal work; triangular schedule removes the waste",
             dataclasses.replace(base, gather_bytes=2, grad_bytes=2,
                                 grad_accum=1, profile="zero3",
                                 attention_tri=True),
             cfg_patch={"attention_impl": "chunked_tri"},
             opt=OptConfig(grad_accum=1, gather_dtype="bfloat16",
                           grad_dtype="bfloat16"),
             profile="zero3"),
        Iter("zero3_tri_noremat",
             "zero3 leaves memory headroom: dropping remat removes the "
             "recompute pass (4/3× compute) entirely",
             dataclasses.replace(base, gather_bytes=2, grad_bytes=2,
                                 grad_accum=1, profile="zero3",
                                 attention_tri=True, remat=False),
             cfg_patch={"attention_impl": "chunked_tri", "remat": "none"},
             opt=OptConfig(grad_accum=1, gather_dtype="bfloat16",
                           grad_dtype="bfloat16"),
             profile="zero3"),
    ]


def moe_iterations(arch, ga):
    base = PM.PerfKnobs(grad_accum=ga)
    return arch, "train_4k", "single", [
        Iter("baseline", "production 2-D (FSDP×TP/EP) defaults",
             base, opt=OptConfig(grad_accum=ga)),
        Iter("bf16_wire",
             "halve gather/reduce wire bytes via bf16",
             dataclasses.replace(base, gather_bytes=2, grad_bytes=2),
             opt=OptConfig(grad_accum=ga, gather_dtype="bfloat16",
                           grad_dtype="bfloat16")),
        Iter("save_coll",
             "skip collective replay in remat (passes 3→2)",
             dataclasses.replace(base, gather_bytes=2, grad_bytes=2,
                                 save_coll=True),
             cfg_patch={"remat": "block_save_coll"},
             opt=OptConfig(grad_accum=ga, gather_dtype="bfloat16",
                           grad_dtype="bfloat16")),
        Iter("cap_1_0",
             "capacity factor 1.25→1.0 cuts a2a + expert flops 20%",
             dataclasses.replace(base, gather_bytes=2, grad_bytes=2,
                                 save_coll=True),
             cfg_patch={"remat": "block_save_coll", "moe_capacity": 1.0},
             opt=OptConfig(grad_accum=ga, gather_dtype="bfloat16",
                           grad_dtype="bfloat16")),
    ]


def qwen3_extra():
    """Feasibility push: ga=16 halves the activation working set at the
    cost of 2× param gathers (the model shows the collective-term price
    explicitly)."""
    arch, shape, mesh, iters = moe_iterations("qwen3-moe-235b-a22b", 8)
    base16 = PM.PerfKnobs(grad_accum=16, gather_bytes=2, grad_bytes=2)
    iters += [
        Iter("ga16",
             "halve activation memory via 2× micro-batching; param "
             "gathers double (collective-term price, modeled)",
             base16,
             opt=OptConfig(grad_accum=16, gather_dtype="bfloat16",
                           grad_dtype="bfloat16")),
        Iter("ga16_cap10",
             "recover a2a bytes with capacity 1.0 on top of ga16",
             dataclasses.replace(base16),
             cfg_patch={"moe_capacity": 1.0},
             opt=OptConfig(grad_accum=16, gather_dtype="bfloat16",
                           grad_dtype="bfloat16")),
        Iter("ga16_save_coll",
             "combine: ga16 memory headroom may absorb save_coll's "
             "saved tp_out tensors, buying the 3→2 collective passes",
             dataclasses.replace(base16, save_coll=True),
             cfg_patch={"remat": "block_save_coll", "moe_capacity": 1.0},
             opt=OptConfig(grad_accum=16, gather_dtype="bfloat16",
                           grad_dtype="bfloat16")),
    ]
    return arch, shape, mesh, iters


CELLS = {
    "h2o": h2o_iterations,
    "qwen3": qwen3_extra,
    "granite": lambda: moe_iterations("granite-moe-3b-a800m", 4),
}


def main():
    import argparse
    ap = argparse.ArgumentParser()
    ap.add_argument("--cell", choices=list(CELLS) + ["all"], default="all")
    ap.add_argument("--force", action="store_true")
    args = ap.parse_args()
    names = list(CELLS) if args.cell == "all" else [args.cell]
    for name in names:
        arch, shape, mesh, iters = CELLS[name]()
        print(f"=== {arch} {shape} {mesh} ===")
        for it in iters:
            rec = run_iteration(arch, shape, mesh, it, force=args.force)
            t = rec["model_terms"]
            meas = rec.get("measured", {})
            print(f"{it.tag:12s} comp={t['t_compute']:.3f}s "
                  f"mem={t['t_memory']:.3f}s coll={t['t_collective']:.3f}s "
                  f"dom={t['dominant'][:4]} "
                  f"frac={t['roofline_fraction']:.2%} "
                  f"| measured temp={meas.get('temp_gib', 0):.2f}GiB "
                  f"ok={meas.get('ok')}", flush=True)


def prefill_iterations():
    """Serving-side prefill (qwen2.5 prefill_32k): the triangular
    schedule halves causal attention work, and prefill has no
    remat/optimizer confounders."""
    base = PM.PerfKnobs()
    return "qwen2.5-14b", "prefill_32k", "single", [
        Iter("baseline", "production serving defaults (masked-full attn)",
             base),
        Iter("tri",
             "causal prefill at 32k does 2x the visible-pair work under "
             "the masked-full schedule; triangular removes it",
             dataclasses.replace(base, attention_tri=True),
             cfg_patch={"attention_impl": "chunked_tri"}),
    ]


CELLS["qwen25_prefill"] = prefill_iterations


def rg_iterations():
    """recurrentgemma train (6 matmul streams per RG-LRU block +
    256k-vocab embeddings)."""
    ga = 4
    base = PM.PerfKnobs(grad_accum=ga)
    return "recurrentgemma-9b", "train_4k", "single", [
        Iter("baseline", "production 2-D defaults", base,
             opt=OptConfig(grad_accum=ga)),
        Iter("bf16_wire",
             "memory term is dominated by ga·3 re-reads of gathered f32 "
             "params; bf16 gathers halve both HBM and wire bytes",
             dataclasses.replace(base, gather_bytes=2, grad_bytes=2),
             opt=OptConfig(grad_accum=ga, gather_dtype="bfloat16",
                           grad_dtype="bfloat16")),
        Iter("bf16_save_coll",
             "then collectives dominate: skip replay (passes 3→2)",
             dataclasses.replace(base, gather_bytes=2, grad_bytes=2,
                                 save_coll=True),
             cfg_patch={"remat": "block_save_coll"},
             opt=OptConfig(grad_accum=ga, gather_dtype="bfloat16",
                           grad_dtype="bfloat16")),
        Iter("bf16_sc_tri",
             "local-attention blocks still do masked-full work; "
             "triangular/banded schedule trims the window waste",
             dataclasses.replace(base, gather_bytes=2, grad_bytes=2,
                                 save_coll=True, attention_tri=True),
             cfg_patch={"remat": "block_save_coll",
                        "attention_impl": "chunked_tri"},
             opt=OptConfig(grad_accum=ga, gather_dtype="bfloat16",
                           grad_dtype="bfloat16")),
        Iter("ga8_sc_tri",
             "save_coll at ga=4 adds the saved tp_out tensors: double "
             "the micro-batching to absorb them",
             dataclasses.replace(base, gather_bytes=2, grad_bytes=2,
                                 save_coll=True, attention_tri=True,
                                 grad_accum=8),
             cfg_patch={"remat": "block_save_coll",
                        "attention_impl": "chunked_tri"},
             opt=OptConfig(grad_accum=8, gather_dtype="bfloat16",
                           grad_dtype="bfloat16")),
    ]


CELLS["recurrentgemma"] = rg_iterations


if __name__ == "__main__":
    main()
