"""The port's mesh, sharded analytics, data-parallel train step, int8 pod
mean and sharding rules, on gloo worlds of CPU processes (spawned, a
file store under ``tmp_path``, a timeout on every world), against the
port in one process and the JAX package on its one-device mesh.

Tolerances, with their reasons:
* degrees exact (integer counts below 2^24 add exactly in any order);
* row sums and PageRank rtol=1e-5, atol=1e-7 (``RTOL``/``ATOL``):
  float32 sums of the shards' partial results, another order; SpMV
  rtol=1e-5 with atol=1e-5·max|y|, its signed terms cancelling (the
  rounding scales with the terms, not with their sum);
* the data-parallel step (the sharded step over a (2,) data mesh: each
  rank's half of the batch, the gradients reduce-scattered): loss and
  gradients rtol=1e-5, atol=1e-6·max|g| of the leaf (the sum of two
  half-batch sums against the whole batch's); parameters as ``test_torch_train.py`` holds them (every entry
  within 2·lr·steps, 99.9% within 2e-6: Adam maps each gradient to about
  ±lr);
* ``grad_dtype="bfloat16"``: gloo reduces bfloat16, so the ranks' bf16
  gradients are summed and halved in bf16; they agree with the
  one-process bf16 gradients within 2^-7 relative to the leaf's largest
  entry (two bf16 roundings against one);
* the int8 pod mean within scale/2 of the true mean, scale = the axis's
  absmax / 127 (each pod's rounding error is at most scale/2), and
  within rtol=1e-6 of the JAX package when every rank holds the same
  gradients (the same float32 operations);
* the sharded (FSDP×TP) step on gloo worlds of (2, 2), (4,) and (1, 2)
  ranks against the one-process step: losses rtol=1e-5 and gradient
  norms rtol=1e-4 (the shards' float32 partial sums reduced in another
  order; the norm sums squares over shards); parameters after two steps
  as the data-parallel step's (every entry within 2·lr·steps, 99.9%
  within 2e-6); ``block_save_coll`` against ``block`` on the same world
  within rtol=1e-6 (the saved collective outputs are the values the
  recompute would make); the global norm of a sharded tree rtol=1e-6; a
  checkpoint across world sizes bit for bit.
"""
import functools
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh as JMesh

import _torch_dist as W
from repro import configs as jconfigs
from repro.analytics import distributed as jD
from repro.core import parse_tsv as jparse_tsv
from repro.core import sparse as jS
from repro.core import val2col as jval2col
from repro.models import model as JM
from repro.train import compression as jC
from repro.train import sharding as jSH
from repro_torch.analytics import distributed as D
from repro_torch.configs import ARCHS, smoke_config
from repro_torch.core import parse_tsv, val2col
from repro_torch.core.interop import coo_from_numpy
from repro_torch.device import set_device
from repro_torch.launch import mesh as M
from repro_torch.models import abstract_params, init_cache
from repro_torch.models import model as PM
from repro_torch.train import compressed_pod_mean
from repro_torch.train import sharding as S
from repro_torch.tree import tree_leaves

RTOL, ATOL = 1e-5, 1e-7
DP_RTOL, DP_ATOL = 1e-5, 1e-6                # atol x max|g| of the leaf
STEP_PARAM_ATOL, STEP_PARAM_SHARE = 2e-6, 0.999
BF16_REL = 2 ** -7


@pytest.fixture(autouse=True)
def _cpu():
    prev = set_device("cpu")
    yield
    set_device(prev)


def close(got, want, rtol=RTOL, atol=ATOL):
    np.testing.assert_allclose(np.asarray(got, np.float32),
                               np.asarray(want, np.float32), rtol=rtol,
                               atol=atol)


@functools.cache
def jax_analytics() -> dict:
    """The JAX package's sharded analytics on its one-device mesh."""
    rows, cols, vals, x = W.graph_arrays()
    m = jS.COO(jnp.asarray(rows), jnp.asarray(cols), jnp.asarray(vals),
               (W.GRAPH_N, W.GRAPH_N))
    mesh = JMesh(np.asarray(jax.devices()[:1]), ("data",))
    keys, pr = jD.pagerank_table(jval2col(jparse_tsv(W.window_tsv())),
                                 mesh, W.TABLE_ITERS)
    return {"deg": jD.degree_sharded(m, mesh),
            "spmv": jD.spmv_t_sharded(m, jnp.asarray(x), mesh),
            "rowsum": jD.spmv_weighted_rowsum(m, mesh),
            "pr": jD.pagerank_sharded(m, mesh, W.PR_ITERS),
            "keys": keys, "table_pr": pr}


def same_analytics(got: dict, want: dict) -> None:
    np.testing.assert_array_equal(np.asarray(got["deg"]),
                                  np.asarray(want["deg"]))
    np.testing.assert_array_equal(np.asarray(got["keys"]),
                                  np.asarray(want["keys"]))
    for k in ("rowsum", "pr", "table_pr"):
        close(got[k], want[k])
    close(got["spmv"], want["spmv"],
          atol=RTOL * float(np.abs(np.asarray(want["spmv"])).max()))


# ---------------------------------------------------------------------------
# the mesh
# ---------------------------------------------------------------------------

def test_mesh_outside_a_world():
    m = M.make_mesh((1,), ("data",))
    assert m.shape == {"data": 1} and m.axis_names == ("data",)
    assert m.group("data") is None and m.index("data") == 0
    assert M.make_smoke_mesh().shape == {"data": 1, "model": 1}
    with pytest.raises(ValueError, match="needs a world of 256"):
        M.make_production_mesh()
    with pytest.raises(ValueError, match="needs a world of 512"):
        M.make_production_mesh(multi_pod=True)
    with pytest.raises(ValueError, match="needs a world of 2"):
        M.make_mesh((2,), ("data",))
    with pytest.raises(ValueError):
        M.make_mesh((1, 1), ("data",))


# ---------------------------------------------------------------------------
# sharded analytics
# ---------------------------------------------------------------------------

def test_positional_signatures_one_process():
    """The JAX package's positional forms: ``pagerank_sharded(adj, mesh,
    5)`` binds 5 to ``num_iters``, ``pagerank_table(T, None, 6)`` runs 6
    iterations; ``mesh=None`` is the world of one."""
    one = W.sharded_analytics(None)
    same_analytics(one, jax_analytics())
    rows, cols, vals, _ = W.graph_arrays()
    m = coo_from_numpy(rows, cols, vals, (W.GRAPH_N, W.GRAPH_N))
    mesh = M.make_mesh((1,), ("data",))
    close(D.pagerank_sharded(m, mesh, W.PR_ITERS), D.pagerank_sharded(
        m, num_iters=W.PR_ITERS), rtol=0, atol=0)
    assert not np.allclose(D.pagerank_sharded(m, None, 2).numpy(),
                           one["pr"], rtol=1e-3)
    E = val2col(parse_tsv(W.window_tsv()))
    close(D.pagerank_table(E, None, W.TABLE_ITERS)[1], D.pagerank_table(
        E, num_iters=W.TABLE_ITERS)[1], rtol=0, atol=0)


def test_analytics_on_four_ranks(tmp_path):
    """Each of 4 ranks reduces its shard (3001 entries: the last shard
    padded with dead entries) and all_reduce sums them: every rank's
    answer equals the one-process port's and the JAX package's."""
    ranks = W.run_world(W.analytics_ranks, 4, tmp_path)
    one = W.sharded_analytics(None)
    want = jax_analytics()
    for r in ranks:
        same_analytics(r, one)
        same_analytics(r, want)
    assert D.shard_coo(coo_from_numpy(*W.graph_arrays()[:3],
                                      (W.GRAPH_N, W.GRAPH_N)), 4).rows.shape \
        == (4, 751)


# ---------------------------------------------------------------------------
# the data-parallel train step
# ---------------------------------------------------------------------------

def n_leaves(run: dict, prefix: str) -> int:
    return sum(1 for k in run if k[len(prefix):].isdigit()
               and k.startswith(prefix))


def test_data_parallel_step_equals_whole_batch(tmp_path):
    """Two ranks, each taking half of the batch, against one process on
    the whole batch: the first step's loss and gradients, then two train
    steps' losses, gradient norms and parameters."""
    ranks = W.run_world(W.train_ranks, 2, tmp_path, None)
    one = W.train_run(None)
    for r in ranks:
        close(r["loss0"], one["loss0"], rtol=DP_RTOL, atol=0)
        for i in range(n_leaves(one, "g")):
            g, w = r[f"g{i}"], one[f"g{i}"]
            close(g, w, rtol=DP_RTOL,
                  atol=DP_ATOL * max(float(np.abs(w).max()), 1e-30))
        close(r["losses"], one["losses"], rtol=DP_RTOL, atol=0)
        close(r["norms"], one["norms"], rtol=1e-4, atol=0)
        diff = np.concatenate([np.abs(r[f"p{i}"] - one[f"p{i}"]).ravel()
                               for i in range(n_leaves(one, "p"))])
        assert diff.max() <= 2 * W.TRAIN_LR * 2
        assert (diff <= STEP_PARAM_ATOL).mean() >= STEP_PARAM_SHARE
    # the ranks end with the same parameters, bit for bit
    for i in range(n_leaves(one, "p")):
        np.testing.assert_array_equal(ranks[0][f"p{i}"], ranks[1][f"p{i}"])


def test_data_parallel_bf16_gradients(tmp_path):
    """``grad_dtype="bfloat16"``: the cast comes before the reduction,
    which gloo runs in bfloat16 (no float32 detour)."""
    ranks = W.run_world(W.train_ranks, 2, tmp_path, "bfloat16")
    one = W.train_run(None, "bfloat16")
    for r in ranks:
        for i in range(n_leaves(one, "g")):
            assert str(r[f"gdtype{i}"]) == "torch.bfloat16"
            w = one[f"g{i}"]
            close(r[f"g{i}"], w, rtol=BF16_REL,
                  atol=BF16_REL * max(float(np.abs(w).max()), 1e-30))


# ---------------------------------------------------------------------------
# the int8 pod mean
# ---------------------------------------------------------------------------

def test_compressed_pod_mean_error_bounded(tmp_path):
    ranks = W.run_world(W.compress_ranks, 2, tmp_path, False)
    g = [W.pod_grads(0), W.pod_grads(1)]
    for r in ranks:
        for k in g[0]:
            true = (g[0][k] + g[1][k]) / 2
            scale = max(np.abs(g[0][k]).max(), np.abs(g[1][k]).max()) / 127
            assert np.abs(r[k] - true).max() <= scale / 2 + 1e-7, k
            assert r[k].dtype == np.float32
        for k in g[0]:
            np.testing.assert_array_equal(r[k], ranks[0][k])


def test_compressed_pod_mean_matches_jax(tmp_path):
    """Every rank holds the same gradients: the mean of equal quantized
    values is each rank's own, as in the JAX package on a one-device pod
    axis; and in one process (no world) the port quantizes the same."""
    ranks = W.run_world(W.compress_ranks, 2, tmp_path, True)
    g = W.pod_grads(0)
    jmesh = JMesh(np.asarray(jax.devices()[:1]).reshape(1, 1),
                  ("pod", "data"))
    want = jC.compressed_pod_mean({k: jnp.asarray(v) for k, v in g.items()},
                                  jmesh)
    local = compressed_pod_mean({k: torch.from_numpy(v)
                                 for k, v in g.items()},
                                M.make_mesh((1, 1), ("pod", "data")))
    for k in g:
        for got in (ranks[0][k], ranks[1][k], local[k].numpy()):
            close(got, want[k], rtol=1e-6, atol=0)
        scale = np.abs(g[k]).max() / 127
        assert np.abs(local[k].numpy() - g[k]).max() <= scale / 2 + 1e-7


# ---------------------------------------------------------------------------
# sharding rules
# ---------------------------------------------------------------------------

class FakeMesh:
    """A mesh stand-in: axis sizes by name and their order, nothing
    else (what the rules read)."""

    def __init__(self, shape, axes):
        self.shape = dict(zip(axes, shape))
        self.axis_names = tuple(axes)


MESHES = [((1, 1), ("data", "model")), ((2, 4), ("data", "model")),
          ((16, 16), ("data", "model")),
          ((2, 16, 16), ("pod", "data", "model"))]
PROFILES = ("2d", "zero3", "2d_podfsdp")


def spec_tuples(tree):
    """The JAX spec tree with each PartitionSpec as a tuple."""
    if isinstance(tree, dict):
        return {k: spec_tuples(v) for k, v in tree.items()}
    return tuple(tree)


@pytest.mark.parametrize("profile", PROFILES)
@pytest.mark.parametrize("shape,axes", MESHES)
@pytest.mark.parametrize("arch", ARCHS)
def test_param_specs_match_jax(arch, shape, axes, profile):
    """Every config's smoke parameter shapes (the JAX package's tree,
    which the rules read by name and shape) give the JAX package's
    specs; where the port builds the config, its own per-layer tree
    gives the JAX specs of the stacked groups without their leading
    dim."""
    mesh = FakeMesh(shape, axes)
    jparams = JM.abstract_params(jconfigs.smoke_config(arch))
    want = spec_tuples(jSH.param_specs(jparams, mesh, profile))
    assert S.param_specs(jparams, mesh, profile) == want
    assert S.batch_axes(mesh, profile) == jSH.batch_axes(mesh, profile)
    cfg = smoke_config(arch)
    PM.check_supported(cfg)
    mine = S.param_specs(abstract_params(cfg), mesh, profile)
    period = len(cfg.pattern)
    n_grouped = cfg.n_layers // period * period

    def unstacked(group):
        """A stacked JAX layer group's specs without the leading dim (MoE
        expert tensors keep theirs: the rules read E at shape[-3])."""
        return {b: {n: s[1:] for n, s in sub.items()}
                for b, sub in group.items()}

    for li, layer in enumerate(mine["layers"]):
        if li < n_grouped:
            jl = unstacked(want["groups"][f"slot{li % period}"])
        else:
            jl = want["tail"][f"layer{li - n_grouped}"]
        assert layer == jl, li
    if cfg.is_encdec:
        enc = want["encoder"]
        assert len(mine["encoder"]["layers"]) == cfg.encoder_layers
        for li, layer in enumerate(mine["encoder"]["layers"]):
            assert layer == unstacked(enc["layers"]), ("encoder", li)
        assert mine["encoder"]["final_norm"] == enc["final_norm"]
    if cfg.moe is not None:
        assert len(mine["layers"][0]["mlp"]["w_gate"]) == 3
    for k in mine:
        if k not in ("layers", "encoder"):
            assert mine[k] == want[k], k


@pytest.mark.parametrize("arch", ["rwkv6-1.6b", "recurrentgemma-9b"])
def test_cache_specs_match_jax(arch):
    from repro.train import sharding as jsh
    jmesh = JMesh(np.asarray(jax.devices()[:1]).reshape(1, 1),
                  ("data", "model"))
    jcfg = jconfigs.smoke_config(arch)
    jspecs = jsh.cache_shardings(JM.init_cache(jcfg, 2, 32), jmesh)
    cfg = smoke_config(arch)
    mine = S.cache_specs(init_cache(cfg, 2, 32, torch.device("cpu")),
                         FakeMesh((1, 1), ("data", "model")))
    period = len(cfg.pattern)
    n_grouped = cfg.n_layers // period * period
    for li, c in enumerate(mine):
        if li < n_grouped:
            w = jspecs["groups"][f"slot{li % period}"]
            w = [tuple(s.spec)[1:] for s in w]
        else:
            w = [tuple(s.spec) for s in jspecs["tail"][f"layer{li - n_grouped}"]]
        assert list(c) == w, li


def test_placements():
    from torch.distributed.tensor import Replicate, Shard
    mesh = FakeMesh((2, 2, 4), ("pod", "data", "model"))
    assert S.placements(("data", "model"), mesh) == \
        (Replicate(), Shard(0), Shard(1))
    assert S.placements((("pod", "data"), None, "model"), mesh) == \
        (Shard(0), Shard(0), Shard(2))
    assert S.placements((None,), mesh) == (Replicate(),) * 3


def test_parameters_distributed_and_gathered(tmp_path):
    """A (2, 2) (data, model) world: every rwkv6 smoke parameter placed
    with its 2d spec holds 1/4, 1/2 or all of its shape a rank and
    gathers back equal; the analytics over the mesh's ``data`` lines
    equal the one-process answers."""
    ranks = W.run_world(W.placement_ranks, 4, tmp_path)
    params = abstract_params(smoke_config(W.TRAIN_ARCH))
    mesh = FakeMesh((2, 2), ("data", "model"))
    from repro_torch.tree import leaves_at, tree_leaves
    specs = leaves_at(S.param_specs(params, mesh), params)
    one = W.sharded_analytics(None)
    for r in ranks:
        for i, (p, spec) in enumerate(zip(tree_leaves(params), specs)):
            want = [d // (2 if ax is not None else 1)
                    for d, ax in zip(p.shape, spec)]
            assert list(r[f"local{i}"]) == want, (i, spec)
            assert bool(r[f"same{i}"]), i
        same_analytics({k[2:]: v for k, v in r.items()
                        if k.startswith("a_")}, one)
    assert any(s != (None,) * len(s) for s in specs)


# ---------------------------------------------------------------------------
# the sharded (FSDP x TP) train step
# ---------------------------------------------------------------------------

SHARDED_WORLDS = {"2x2": ((2, 2), ("data", "model"), True),
                  "4": ((4,), ("data",), False),
                  "1x2": ((1, 2), ("data", "model"), False)}


@pytest.fixture(scope="module")
def sharded(tmp_path_factory):
    """Every ``SHARDED_WORLDS`` world's run (rank 0's, and every rank's
    gradient shapes), the one-process runs, and the checkpoints."""
    from repro_torch import checkpoint as CK
    root = tmp_path_factory.mktemp("sharded")
    one = {a: W.sharded_run(a) for a in W.SHARDED_ARCHS}
    one["ga2"] = W.sharded_run(W.SHARDED_ARCHS[0], grad_accum=2)
    one["bf16"] = W.sharded_run(W.SHARDED_ARCHS[0], wire="bfloat16")
    CK.save(str(root / "one"), 5, W.ckpt_tree(), {"world": 1})
    worlds = {}
    for name, (shape, axes, extras) in SHARDED_WORLDS.items():
        worlds[name] = W.run_world(
            W.sharded_world_ranks, int(np.prod(shape)), root, shape, axes,
            extras, str(root / "one"), str(root / f"ranks_{name}"))
    return {"one": one, "worlds": worlds, "root": root}


def runs_of(ranks: list, prefix: str) -> list:
    return [{k[len(prefix):]: v for k, v in r.items()
             if k.startswith(prefix)} for r in ranks]


def same_steps(got: dict, want: dict) -> None:
    close(got["losses"], want["losses"], rtol=DP_RTOL, atol=0)
    close(got["norms"], want["norms"], rtol=1e-4, atol=0)
    diff = np.concatenate([np.abs(got[f"p{i}"] - want[f"p{i}"]).ravel()
                           for i in range(n_leaves(want, "p"))])
    assert diff.max() <= 2 * W.SHARDED_LR * 2
    assert (diff <= STEP_PARAM_ATOL).mean() >= STEP_PARAM_SHARE


@pytest.mark.parametrize("arch", W.SHARDED_ARCHS)
@pytest.mark.parametrize("world", sorted(SHARDED_WORLDS))
def test_sharded_step_equals_one_process(sharded, world, arch):
    """Two sharded train steps of the arch's smoke config (state placed
    by ``shard_params``, the batch over the batch axes, S = 32: the
    chunked WKV and chunked attention run) on every rank against the
    one-process step; the ranks end with the same whole parameters."""
    ranks = runs_of(sharded["worlds"][world], f"{arch}/")
    for r in ranks:
        same_steps(r, sharded["one"][arch])
    for i in range(n_leaves(ranks[0], "p")):
        for r in ranks[1:]:
            np.testing.assert_array_equal(r[f"p{i}"], ranks[0][f"p{i}"])


@pytest.mark.parametrize("world", sorted(SHARDED_WORLDS))
def test_sharded_gradients_and_state_are_local(sharded, world):
    """Every rank's gradient of every leaf has its parameter's local
    shape (reduce-scattered in the backward, never whole where the leaf
    is sharded), and parameters plus AdamW moments on a rank take the
    whole state's bytes divided by the shard count, give or take the
    leaves the rules replicate (norm scales, biases, mixes: under 10%
    of the state)."""
    from repro_torch.configs import smoke_config
    from repro_torch.models import abstract_params
    shape = SHARDED_WORLDS[world][0]
    n = int(np.prod(shape))
    for arch in W.SHARDED_ARCHS:
        whole = 3 * 4 * sum(p.numel() for p in tree_leaves(
            abstract_params(smoke_config(arch))))
        for r in runs_of(sharded["worlds"][world], f"{arch}/"):
            for i in range(n_leaves(r, "glocal")):
                assert list(r[f"glocal{i}"]) == list(r[f"plocal{i}"]), \
                    (arch, i)
            got = int(r["state_bytes"])
            assert whole / n <= got <= 1.1 * whole / n + 0.1 * whole, \
                (arch, got, whole / n)


@pytest.mark.parametrize("world", sorted(SHARDED_WORLDS))
def test_sharded_init_places_layers_as_made(sharded, world):
    """``init_train_state`` over a mesh of a world, each layer sliced as
    it is made, gives every rank the shards and placements that
    ``shard_params`` of the whole seeded tree gives, bit for bit."""
    for arch in W.SHARDED_ARCHS:
        for r in runs_of(sharded["worlds"][world], f"{arch}/"):
            assert bool(r["init_equal"]), arch


def test_sharded_grad_accum(sharded):
    """Two micro-batches a step on the (2, 2) world against the
    one-process step with two micro-batches."""
    for r in runs_of(sharded["worlds"]["2x2"], "ga2/"):
        same_steps(r, sharded["one"]["ga2"])


def test_sharded_bf16_gathers_and_gradients(sharded):
    """``gather_dtype`` and ``grad_dtype`` bfloat16 on the (2, 2) world:
    parameters gathered and gradients reduce-scattered in bfloat16 (the
    one-process step casts once, after the whole gradient), so the
    losses agree within 2^-7 relative and the gradient norms within
    2·2^-7 (two bf16 roundings of each gradient against one)."""
    want = sharded["one"]["bf16"]
    for r in runs_of(sharded["worlds"]["2x2"], "bf16/"):
        close(r["losses"], want["losses"], rtol=BF16_REL, atol=0)
        close(r["norms"], want["norms"], rtol=2 * BF16_REL, atol=0)
        assert np.isfinite(r["p0"]).all()


def test_block_save_coll_equals_block(sharded):
    """``block_save_coll`` keeps the tensor-parallel collectives' outputs
    instead of recomputing them: the same losses, norms and parameters
    as ``block`` on the same (2, 2) world."""
    for r in sharded["worlds"]["2x2"]:
        got = {k[len("save_coll/"):]: v for k, v in r.items()
               if k.startswith("save_coll/")}
        want = {k[len("h2o-danube-1.8b/"):]: v for k, v in r.items()
                if k.startswith("h2o-danube-1.8b/")}
        close(got["losses"], want["losses"], rtol=1e-6, atol=0)
        close(got["norms"], want["norms"], rtol=1e-6, atol=0)
        for i in range(n_leaves(want, "p")):
            close(got[f"p{i}"], want[f"p{i}"], rtol=1e-6, atol=1e-7)


def test_global_norm_of_a_sharded_tree(sharded):
    """``global_norm`` over DTensors of mixed placements (sharded over
    one axis, two, or replicated) counts every entry once: the whole
    tree's norm."""
    from repro_torch.train.optimizer import global_norm
    want = float(global_norm(W.ckpt_tree()))
    for r in sharded["worlds"]["2x2"]:
        close(r["gnorm"], want, rtol=1e-6, atol=0)


def test_sharded_checkpoint_across_world_sizes(sharded):
    """A sharded tree saved by 4 ranks (gathered, rank 0 writing) restores
    whole on one process bit for bit, and one process's checkpoint
    restores onto the 4-rank mesh placed by the specs, bit for bit."""
    from repro_torch import checkpoint as CK
    tree = W.ckpt_tree()
    back, meta = CK.restore(str(sharded["root"] / "ranks_2x2"), tree)
    assert meta == {"world": 4}
    for b, t in zip(tree_leaves(back), tree_leaves(tree)):
        assert b.dtype == t.dtype and torch.equal(b, t)
    for r in sharded["worlds"]["2x2"]:
        assert bool(r["restored_equal"]) and bool(r["restored_placed"])
        assert json.loads(str(r["restored_meta"])) == {"world": 1}
