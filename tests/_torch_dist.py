"""Run a function on every rank of a gloo world of CPU processes.

Each rank is a process started with the ``spawn`` method; the world is
initialized through a file store under the test's ``tmp_path`` (no TCP
port, so parallel test workers cannot collide) with a timeout, the port
is pinned to the CPU, and the function's result (a dict of numpy arrays)
comes back through ``rank<r>.npz``.  Imports nothing of JAX, so the
ranks start quickly.
"""
import datetime
import json
import time
from pathlib import Path

import numpy as np
import torch
import torch.distributed as dist
import torch.multiprocessing as mp

WORLD_TIMEOUT_S = 180


def _entry(rank, fn, world, store, out, args):
    torch.set_num_threads(1)
    from repro_torch.device import set_device
    set_device("cpu")
    dist.init_process_group(
        "gloo", init_method=f"file://{store}", rank=rank, world_size=world,
        timeout=datetime.timedelta(seconds=WORLD_TIMEOUT_S))
    try:
        result = fn(rank, world, *args)
        np.savez(Path(out) / f"rank{rank}.npz", **result)
    finally:
        dist.destroy_process_group()


def run_world(fn, world: int, tmp_path, *args,
              timeout: float = WORLD_TIMEOUT_S) -> list:
    """``fn(rank, world, *args)`` on each of ``world`` ranks; returns
    their results in rank order.  A rank that raises fails the call; a
    world that has not finished within ``timeout`` seconds is killed."""
    out = Path(tmp_path) / f"world{time.monotonic_ns()}"
    out.mkdir()
    ctx = mp.start_processes(_entry, args=(fn, world, str(out / "store"),
                                           str(out), args),
                             nprocs=world, join=False, start_method="spawn")
    deadline = time.monotonic() + timeout
    try:
        while not ctx.join(timeout=max(0.1, deadline - time.monotonic())):
            if time.monotonic() >= deadline:
                raise TimeoutError(f"world of {world} ranks ran past "
                                   f"{timeout} s")
    finally:
        for p in ctx.processes:
            if p.is_alive():
                p.kill()
                p.join(timeout=10)
    return [dict(np.load(out / f"rank{r}.npz")) for r in range(world)]


# ---------------------------------------------------------------------------
# The ranks' bodies of the distributed tests, and the inputs they share
# with the one-process side of each comparison.
# ---------------------------------------------------------------------------

GRAPH_N, GRAPH_NNZ = 200, 3001          # nnz not divisible by 2 or 4
WINDOW = dict(n_hosts=64, pkt_rate=300.0, n_bots=8, beacon_period_s=4.0,
              seed=1)
# PageRank iterations (few: the JAX package traces its shard_map anew in
# every iteration, a second each on the CPU)
PR_ITERS, TABLE_ITERS = 5, 6
TRAIN_ARCH, TRAIN_B, TRAIN_S, TRAIN_LR = "rwkv6-1.6b", 4, 16, 1e-3


def graph_arrays():
    """(rows, cols, vals, x) of a random (200, 200) graph with 3001
    entries, duplicates included."""
    rng = np.random.default_rng(0)
    rows = rng.integers(0, GRAPH_N, GRAPH_NNZ).astype(np.int32)
    cols = rng.integers(0, GRAPH_N, GRAPH_NNZ).astype(np.int32)
    vals = rng.integers(1, 4, GRAPH_NNZ).astype(np.float32)
    x = rng.normal(0, 1, GRAPH_N).astype(np.float32)
    return rows, cols, vals, x


def window_tsv() -> str:
    """A 10 s packet window as the pipeline's TSV text."""
    from repro_torch.pipeline import TrafficConfig, records_to_tsv, \
        synth_packets
    return records_to_tsv(synth_packets(TrafficConfig(**WINDOW), 10.0))


def sharded_analytics(mesh, axis: str = "data") -> dict:
    """degree, SpMV, row sums, PageRank and ``pagerank_table`` through
    the JAX package's positional signatures on ``mesh``."""
    from repro_torch.analytics import distributed as D
    from repro_torch.core import parse_tsv, val2col
    from repro_torch.core.interop import coo_from_numpy
    rows, cols, vals, x = graph_arrays()
    m = coo_from_numpy(rows, cols, vals, (GRAPH_N, GRAPH_N))
    keys, table_pr = D.pagerank_table(val2col(parse_tsv(window_tsv())),
                                      mesh, TABLE_ITERS)
    return {"deg": D.degree_sharded(m, mesh, axis).numpy(),
            "spmv": D.spmv_t_sharded(m, torch.from_numpy(x), mesh,
                                     axis).numpy(),
            "rowsum": D.spmv_weighted_rowsum(m, mesh, axis).numpy(),
            "pr": D.pagerank_sharded(m, mesh, PR_ITERS).numpy(),
            "keys": keys, "table_pr": table_pr.numpy()}


def analytics_ranks(rank, world):
    from repro_torch.launch.mesh import make_mesh
    return sharded_analytics(make_mesh((world,), ("data",)))


def train_batches(vocab: int) -> list:
    """Two global batches of ``TRAIN_B`` sequences from a seed."""
    out = []
    for seed in (10, 11):
        toks = np.random.default_rng(seed).integers(
            0, vocab, (TRAIN_B, TRAIN_S + 1)).astype(np.int32)
        out.append({"tokens": torch.from_numpy(toks[:, :-1]),
                    "labels": torch.from_numpy(toks[:, 1:])})
    return out


def train_run(mesh, grad_dtype=None) -> dict:
    """The first batch's (loss, gradients), then two train steps from
    the seeded smoke parameters: losses, gradient norms, parameters (on
    a mesh of a world the step places the plain state by
    ``shard_params``; gradients and parameters are gathered whole)."""
    from repro_torch.configs import smoke_config
    from repro_torch.train import OptConfig, init_train_state
    from repro_torch.train import sharding as S
    from repro_torch.train.trainer import make_grad_fn, make_train_step
    from repro_torch.tree import tree_leaves
    cfg = smoke_config(TRAIN_ARCH)
    opt = OptConfig(lr=TRAIN_LR, warmup_steps=1, grad_dtype=grad_dtype)
    params, state = init_train_state(cfg, torch.Generator().manual_seed(0))
    batches = train_batches(cfg.vocab)
    loss, grads = make_grad_fn(cfg, opt, mesh)(params, batches[0])
    grads = S.full_tree(grads)
    out = {"loss0": loss.numpy()}
    for i, g in enumerate(tree_leaves(grads)):
        out[f"g{i}"] = g.float().numpy()
        out[f"gdtype{i}"] = np.asarray(str(g.dtype))
    step = make_train_step(cfg, opt, mesh)
    losses, norms = [], []
    for b in batches:
        params, state, m = step(params, state, b)
        losses.append(float(m["loss"]))
        norms.append(float(m["grad_norm"]))
    out.update(losses=np.asarray(losses), norms=np.asarray(norms))
    for i, p in enumerate(tree_leaves(S.full_tree(params))):
        out[f"p{i}"] = p.numpy()
    return out


def train_ranks(rank, world, grad_dtype):
    from repro_torch.launch.mesh import make_mesh
    return train_run(make_mesh((world,), ("data",)), grad_dtype)


def pod_grads(seed: int) -> dict:
    rng = np.random.default_rng(seed)
    return {"w": rng.normal(0, 0.1, (64, 32)).astype(np.float32),
            "b": rng.normal(0, 3.0, (16,)).astype(np.float32)}


def compress_ranks(rank, world, same: bool):
    """compressed_pod_mean over a ``pod`` axis of ``world`` ranks, each
    rank holding ``pod_grads(0)`` (``same``) or ``pod_grads(rank)``."""
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.train import compressed_pod_mean
    g = pod_grads(0 if same else rank)
    mesh = make_mesh((world, 1), ("pod", "data"))
    out = compressed_pod_mean({k: torch.from_numpy(v) for k, v in g.items()},
                              mesh)
    # a mesh without the axis passes the grads through untouched
    same_tree = compressed_pod_mean(g, make_mesh((world,), ("data",)))
    assert same_tree is g
    return {k: v.numpy() for k, v in out.items()}


def placement_ranks(rank, world):
    """On a (2, 2) (data, model) world: every rwkv6 smoke parameter
    distributed with its 2d placements and gathered back; the
    analytics over the ``data`` axis of the same mesh."""
    from repro_torch.configs import smoke_config
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.models import init_params
    from repro_torch.train import sharding as S
    from repro_torch.tree import leaves_at, tree_leaves
    mesh = make_mesh((2, 2), ("data", "model"))
    params = init_params(smoke_config(TRAIN_ARCH),
                         torch.Generator().manual_seed(0))
    specs = leaves_at(S.param_specs(params, mesh), params)
    out = {}
    for i, (p, spec) in enumerate(zip(tree_leaves(params), specs)):
        d = S.shard_tensor(p, spec, mesh)
        out[f"local{i}"] = np.asarray(d.to_local().shape)
        out[f"same{i}"] = np.asarray(torch.equal(d.full_tensor(), p))
    out.update({f"a_{k}": v for k, v in sharded_analytics(mesh).items()})
    return out


def remesh_ranks(rank, world, root):
    """Elastic restart: a tree placed on a (2, 2) mesh, saved whole by
    rank 0, restores as DTensors onto a (4, 1) mesh of the same world
    with other placements."""
    from repro_torch import checkpoint as C
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.train import sharding as S
    w = torch.arange(64, dtype=torch.float32).reshape(8, 8)
    mesh1 = make_mesh((2, 2), ("data", "model"))
    placed = S.shard_tensor(w, ("data", "model"), mesh1)
    if rank == 0:
        C.save(root, 0, {"w": placed.full_tensor()})
    else:
        placed.full_tensor()                    # the gather is collective
    dist.barrier()
    mesh2 = make_mesh((4, 1), ("data", "model"))
    back, _ = C.restore(root, {"w": w}, mesh=mesh2,
                        shardings={"w": ("model", "data")})
    return {"local": back["w"].to_local().numpy(),
            "full": back["w"].full_tensor().numpy(),
            "placements": np.asarray(str(back["w"].placements))}


# ---------------------------------------------------------------------------
# The sharded (FSDP x TP) train step.
# ---------------------------------------------------------------------------

SHARDED_ARCHS = ("rwkv6-1.6b", "recurrentgemma-9b", "h2o-danube-1.8b",
                 "granite-moe-3b-a800m")
# S = 32: the chunked WKV (chunk 32) and, with attention_chunk=16, the
# chunked attention run
SHARDED_B, SHARDED_S, SHARDED_LR, SHARDED_CHUNK = 8, 32, 1e-3, 16


def sharded_batches(vocab: int) -> list:
    """Two global batches of ``SHARDED_B`` sequences from a seed."""
    out = []
    for seed in (20, 21):
        toks = np.random.default_rng(seed).integers(
            0, vocab, (SHARDED_B, SHARDED_S + 1)).astype(np.int32)
        out.append({"tokens": torch.from_numpy(toks[:, :-1]),
                    "labels": torch.from_numpy(toks[:, 1:])})
    return out


def sharded_run(arch: str, mesh=None, remat: str = "block",
                grad_accum: int = 1, wire: str = None) -> dict:
    """Two train steps of ``arch``'s smoke config from seeded parameters:
    losses, gradient norms and the parameters after them (gathered
    whole); on a mesh of a world the state is placed by ``shard_params``
    and each leaf's local gradient and parameter shapes, and the local
    bytes of parameters and moments, are returned too."""
    import dataclasses
    from repro_torch.configs import smoke_config
    from repro_torch.train import OptConfig, init_train_state
    from repro_torch.train import sharding as S
    from repro_torch.train.trainer import make_grad_fn, make_train_step
    from repro_torch.tree import tree_leaves
    cfg = dataclasses.replace(smoke_config(arch), remat=remat,
                              attention_chunk=SHARDED_CHUNK)
    opt = OptConfig(lr=SHARDED_LR, warmup_steps=1, grad_accum=grad_accum,
                    gather_dtype=wire, grad_dtype=wire)
    params, state = init_train_state(cfg, torch.Generator().manual_seed(0))
    out = {}
    if mesh is not None:
        whole = S.shard_params(params, mesh)
        # placed layer by layer as made: the same shards and placements
        params, state = init_train_state(
            cfg, torch.Generator().manual_seed(0), mesh)
        out["init_equal"] = np.asarray(all(
            tuple(a.placements) == tuple(b.placements)
            and torch.equal(a.to_local(), b.to_local())
            for a, b in zip(tree_leaves(params), tree_leaves(whole))))
        del whole
        _, grads = make_grad_fn(cfg, opt, mesh)(params,
                                                sharded_batches(cfg.vocab)[0])
        for i, (g, p) in enumerate(zip(tree_leaves(grads),
                                       tree_leaves(params))):
            out[f"glocal{i}"] = np.asarray(g.to_local().shape)
            out[f"plocal{i}"] = np.asarray(p.to_local().shape)
        out["state_bytes"] = np.asarray(sum(
            x.to_local().numel() * x.element_size()
            for x in tree_leaves((params, state["m"], state["v"]))))
    step = make_train_step(cfg, opt, mesh)
    losses, norms = [], []
    for b in sharded_batches(cfg.vocab):
        params, state, m = step(params, state, b)
        losses.append(float(m["loss"]))
        norms.append(float(m["grad_norm"]))
    out.update(losses=np.asarray(losses), norms=np.asarray(norms))
    whole = S.full_tree(params) if mesh is not None else params
    for i, p in enumerate(tree_leaves(whole)):
        out[f"p{i}"] = p.detach().numpy()
    return out


def ckpt_tree():
    """The tree the checkpoint round trips carry: rwkv6's seeded smoke
    parameters."""
    from repro_torch.configs import smoke_config
    from repro_torch.models import init_params
    return init_params(smoke_config(SHARDED_ARCHS[0]),
                       torch.Generator().manual_seed(3))


def sharded_world_ranks(rank, world, shape, axes, extras, ckpt_in,
                        ckpt_out):
    """On a ``shape`` world: :func:`sharded_run` of every arch of
    ``SHARDED_ARCHS`` (keys prefixed ``<arch>/``); with ``extras`` also
    h2o under ``block_save_coll`` (``save_coll/``), rwkv6 with two
    micro-batches (``ga2/``) and with bfloat16 gathers and gradients
    (``bf16/``), the global norm of a sharded tree
    (``gnorm``), a checkpoint of the trained rwkv6 parameters saved by
    every rank to ``ckpt_out`` and the one-process checkpoint at
    ``ckpt_in`` restored onto this mesh (``restored_*``)."""
    from repro_torch import checkpoint as C
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.train import sharding as S
    from repro_torch.train.optimizer import global_norm
    from repro_torch.tree import leaves_at, tree_leaves
    mesh = make_mesh(shape, axes)
    out = {}
    for arch in SHARDED_ARCHS:
        out.update({f"{arch}/{k}": v
                    for k, v in sharded_run(arch, mesh).items()})
    if not extras:
        return out
    out.update({f"save_coll/{k}": v for k, v in sharded_run(
        "h2o-danube-1.8b", mesh, remat="block_save_coll").items()})
    out.update({f"ga2/{k}": v for k, v in sharded_run(
        SHARDED_ARCHS[0], mesh, grad_accum=2).items()})
    out.update({f"bf16/{k}": v for k, v in sharded_run(
        SHARDED_ARCHS[0], mesh, wire="bfloat16").items()})
    tree = ckpt_tree()
    placed = S.shard_params(tree, mesh)
    out["gnorm"] = np.asarray(float(global_norm(placed)))
    C.save(ckpt_out, 7, placed, {"world": world})
    dist.barrier()
    specs = S.param_specs(tree, mesh)
    back, meta = C.restore(ckpt_in, tree, mesh=mesh, shardings=specs)
    out["restored_meta"] = np.asarray(json.dumps(meta))
    out["restored_equal"] = np.asarray(all(
        torch.equal(b.full_tensor(), t) for b, t in
        zip(tree_leaves(back), tree_leaves(tree))))
    out["restored_placed"] = np.asarray(all(
        tuple(b.placements) == S.placements(sp, mesh) for b, sp in
        zip(tree_leaves(back), leaves_at(specs, tree))))
    return out
