"""The port's checkpoint manager: each test of ``tests/test_checkpoint.py``
on the port (atomicity, restart, async, elastic restore onto another
mesh), the JAX package's on-disk contract in both directions, bfloat16
bit for bit, and a training run resumed from its checkpoint equal, bit
for bit on the CPU, to the run that never stopped."""
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import _torch_dist as W
from repro import checkpoint as JC
from repro_torch import checkpoint as C
from repro_torch.device import set_device
from repro_torch.tree import tree_leaves


@pytest.fixture(autouse=True)
def _cpu():
    prev = set_device("cpu")
    yield
    set_device(prev)


def tree(seed=0):
    rng = np.random.default_rng(seed)
    return {"a": torch.from_numpy(rng.normal(0, 1, (8, 4)).astype(np.float32)),
            "b": {"c": torch.arange(10, dtype=torch.int32),
                  "d": torch.tensor(2.5)}}


def equal_trees(a, b):
    la, lb = tree_leaves(a), tree_leaves(b)
    assert len(la) == len(lb)
    for x, y in zip(la, lb):
        assert x.dtype == y.dtype and torch.equal(x, y)


class TestSaveRestore:
    def test_roundtrip(self, tmp_path):
        t = tree()
        C.save(str(tmp_path), 3, t, {"step": 3, "note": "x"})
        back, meta = C.restore(str(tmp_path), t)
        assert meta["note"] == "x"
        equal_trees(t, back)

    def test_latest_step(self, tmp_path):
        assert C.latest_step(str(tmp_path)) is None
        C.save(str(tmp_path), 1, tree())
        C.save(str(tmp_path), 5, tree())
        assert C.latest_step(str(tmp_path)) == 5

    def test_uncommitted_ignored(self, tmp_path):
        C.save(str(tmp_path), 1, tree())
        d = os.path.join(str(tmp_path), "step_00000009")
        os.makedirs(d)                       # no COMMITTED marker
        with open(os.path.join(d, "manifest.json"), "w") as f:
            f.write("{}")
        assert C.latest_step(str(tmp_path)) == 1

    def test_crash_mid_save_keeps_previous(self, tmp_path):
        C.save(str(tmp_path), 1, tree(1))
        # simulate crash: a .tmp dir left behind
        os.makedirs(os.path.join(str(tmp_path), "step_00000002.tmp"))
        back, _ = C.restore(str(tmp_path), tree())
        assert C.latest_step(str(tmp_path)) == 1
        equal_trees(back, tree(1))

    def test_multi_shard(self, tmp_path):
        big = {"x": torch.ones((1000, 100)), "y": torch.ones((1000, 100))}
        C.save(str(tmp_path), 0, big, shard_size=200_000)
        files = os.listdir(os.path.join(str(tmp_path), "step_00000000"))
        assert sum(f.startswith("shard_") for f in files) > 1
        back, _ = C.restore(str(tmp_path), big)
        np.testing.assert_array_equal(back["x"].numpy(),
                                      np.ones((1000, 100)))

    def test_missing_raises(self, tmp_path):
        with pytest.raises(FileNotFoundError):
            C.restore(str(tmp_path), tree())
        C.save(str(tmp_path), 0, tree())
        with pytest.raises(ValueError):
            C.restore(str(tmp_path), {"a": torch.zeros(1)})

    def test_bfloat16_and_devices(self, tmp_path):
        """bf16 leaves restore bit for bit (saved as their 16-bit
        pattern); each tensor lands on its like's device, a ``meta``
        like's on the CPU; non-tensor likes come back as numpy."""
        t = {"w": torch.randn(5, 3).to(torch.bfloat16),
             "n": 7, "s": torch.tensor(3, dtype=torch.int32)}
        d = C.save(str(tmp_path), 0, t)
        with open(os.path.join(d, "manifest.json")) as f:
            dtypes = [x["dtype"] for x in json.load(f)["leaves"]]
        assert dtypes == ["int64", "int32", "bfloat16"]   # n, s, w
        like = {"w": torch.empty(5, 3, dtype=torch.bfloat16,
                                 device="meta"), "n": 0,
                "s": torch.zeros((), dtype=torch.int32)}
        back, _ = C.restore(str(tmp_path), like)
        assert back["w"].device.type == "cpu"
        assert torch.equal(back["w"].view(torch.int16),
                           t["w"].view(torch.int16))
        assert int(back["n"]) == 7 and isinstance(back["n"], np.ndarray)
        assert back["s"].dtype == torch.int32 and int(back["s"]) == 3


class TestJaxContract:
    def test_port_reads_jax_checkpoint(self, tmp_path):
        jt = {"a": jnp.arange(12, dtype=jnp.float32).reshape(3, 4),
              "b": {"c": jnp.arange(5, dtype=jnp.int32),
                    "d": jnp.asarray(2.5)}}
        JC.save(str(tmp_path), 4, jt, {"step": 4})
        back, meta = C.restore(str(tmp_path), tree())
        assert meta == {"step": 4}
        for x, y in zip(tree_leaves(back), jax.tree.leaves(jt)):
            np.testing.assert_array_equal(x.numpy(), np.asarray(y))

    def test_jax_reads_port_checkpoint(self, tmp_path):
        t = tree(2)
        C.save(str(tmp_path), 6, t, {"step": 6})
        like = jax.tree.map(lambda x: jnp.zeros(x.shape), {
            "a": t["a"].numpy(), "b": {"c": t["b"]["c"].numpy(),
                                       "d": t["b"]["d"].numpy()}})
        back, meta = JC.restore(str(tmp_path), like)
        assert meta == {"step": 6}
        for x, y in zip(jax.tree.leaves(back), tree_leaves(t)):
            np.testing.assert_array_equal(np.asarray(x), y.numpy())


class TestAsync:
    def test_async_save_and_gc(self, tmp_path):
        saver = C.AsyncCheckpointer(str(tmp_path), keep=2)
        for step in range(5):
            saver.save_async(step, tree(step), {"step": step})
        saver.wait()
        steps = sorted(int(n.split("_")[1])
                       for n in os.listdir(str(tmp_path))
                       if n.startswith("step_"))
        assert steps == [3, 4]
        back, _ = C.restore(str(tmp_path), tree())
        equal_trees(back, tree(4))

    def test_async_snapshot_is_taken_at_call(self, tmp_path):
        """The writer saves the values as they were at ``save_async``,
        even when the caller changes its tensors in place afterwards."""
        saver = C.AsyncCheckpointer(str(tmp_path))
        t = tree()
        want = {"a": t["a"].clone(), "b": {k: v.clone()
                                           for k, v in t["b"].items()}}
        saver.save_async(0, t)
        t["a"].add_(1.0)
        saver.wait()
        equal_trees(C.restore(str(tmp_path), tree())[0], want)

    def test_async_error_surfaces(self, tmp_path):
        blocker = tmp_path / "file"
        blocker.write_text("x")               # a FILE where a dir must go
        saver = C.AsyncCheckpointer(str(blocker / "sub"))
        saver.save_async(0, tree())
        with pytest.raises(BaseException):
            saver.wait()


class TestTrainingResume:
    def test_sampler_and_optstate_roundtrip(self, tmp_path):
        from repro_torch.data import SamplerState
        from repro_torch.train import OptConfig, adamw_init, adamw_update
        params = tree()
        params["b"]["c"] = params["b"]["c"].float()
        opt = adamw_init(params)
        grads = {"a": torch.ones(8, 4), "b": {"c": torch.ones(10),
                                              "d": torch.tensor(1.0)}}
        params2, opt2, _ = adamw_update(params, grads, opt, OptConfig())
        sampler = SamplerState(file_index=3, offset=17, epoch=1)
        C.save(str(tmp_path), 7, (params2, opt2, sampler.to_dict()),
               {"step": 7})
        (p, o, s), meta = C.restore(str(tmp_path),
                                    (params2, opt2, sampler.to_dict()))
        assert int(o["step"]) == 1 and o["step"].dtype == torch.int32
        assert int(s["file_index"]) == 3
        assert meta["step"] == 7
        equal_trees((p, o), (params2, opt2))

    def test_resumed_run_equals_uninterrupted(self, tmp_path):
        """``launch.train`` on the CPU: 4 steps straight, against 2 steps
        saved (``--ckpt-every 2``) then ``--resume`` to 4: the step-3
        checkpoints (parameters, AdamW state, sampler) equal bit for
        bit."""
        from repro_torch.launch import train
        data = train.synth_corpus(str(tmp_path / "data"))
        common = ["--smoke", "--seq", "32", "--batch", "2", "--data", data,
                  "--ckpt-every", "2"]
        straight = train.main(common + ["--steps", "4", "--workdir",
                                        str(tmp_path / "a")])
        first = train.main(common + ["--steps", "2", "--workdir",
                                     str(tmp_path / "b")])
        rest = train.main(common + ["--steps", "4", "--resume",
                                    "--workdir", str(tmp_path / "b")])
        assert first + rest == straight
        a_dir = tmp_path / "a" / "ckpt_rwkv6_1_6b" / "step_00000003"
        b_dir = tmp_path / "b" / "ckpt_rwkv6_1_6b" / "step_00000003"
        with open(a_dir / "manifest.json") as f:
            n = json.load(f)["n_leaves"]
        za = dict(np.load(a_dir / "shard_00000.npz"))
        zb = dict(np.load(b_dir / "shard_00000.npz"))
        assert len(za) == len(zb) == n
        for k in za:
            np.testing.assert_array_equal(za[k], zb[k])


class TestElasticRemesh:
    def test_restore_onto_different_mesh(self, tmp_path):
        """A checkpoint written under a (2, 2) mesh restores as DTensors
        onto a (4, 1) mesh of the same 4-rank gloo world, with other
        placements: each rank holds its (8, 2) column block, and the
        gathered tensor equals the saved one."""
        ranks = W.run_world(W.remesh_ranks, 4, tmp_path,
                            str(tmp_path / "ckpt"))
        w = np.arange(64, dtype=np.float32).reshape(8, 8)
        for r, out in enumerate(ranks):
            np.testing.assert_array_equal(out["full"], w)
            np.testing.assert_array_equal(out["local"],
                                          w[:, 2 * r:2 * r + 2])
            assert "Shard(dim=1)" in str(out["placements"])
