"""Sharded, journaled, atomic checkpointing (restart-capable) — the JAX
package's ``checkpoint/manager.py`` on PyTorch, with its on-disk layout.

Layout (one directory per step)::

    <root>/step_00000123/
        manifest.json          # leaf paths, shapes, dtypes, metadata
        shard_00000.npz        # flat leaves, chunked ≤ shard_size bytes
        ...
        COMMITTED              # written last — absence ⇒ incomplete

Fault-tolerance contract:
* writes go to ``step_XXXXXXXX.tmp/`` and are renamed only after
  COMMITTED is fsync'd — a crash mid-save leaves the previous checkpoint
  intact;
* ``latest_step()`` ignores uncommitted directories;
* leaves are saved as whole host arrays (bfloat16 as its 16-bit pattern,
  the manifest naming the dtype) and restore bit for bit onto any
  device: each tensor leaf onto its like's device, or with ``shardings``
  as a DTensor over ``mesh`` (each rank reading the files and keeping
  its slice);
* a tree of DTensors (the sharded train step's state) is gathered whole
  leaf by leaf, a collective every rank of the world takes part in, and
  written by rank 0 alone: the same files, so a save on several ranks
  restores on one and the reverse;
* optimizer and sampler state ride along in the same tree.

``AsyncCheckpointer`` overlaps serialization with training (one step of
double buffering).
"""
from __future__ import annotations

import json
import os
import shutil
import threading
import time
from typing import Any, Optional

import numpy as np
import torch
import torch.distributed as dist
from torch.distributed.tensor import DTensor

from ..tree import leaves_at, tree_leaves, tree_paths, tree_unflatten

BF16 = "bfloat16"


def _is_sharded(tree) -> bool:
    return any(isinstance(x, DTensor) for x in tree_leaves(tree))


def _writes(sharded: bool) -> bool:
    """Whether this process writes: all callers of a plain tree, rank 0
    alone of a sharded one."""
    return not sharded or not dist.is_initialized() or dist.get_rank() == 0


def _whole(leaf):
    """A DTensor gathered whole (collective); anything else as it is."""
    return leaf.full_tensor() if isinstance(leaf, DTensor) else leaf


def _host_tree(tree, write: bool):
    """``tree`` with every leaf copied to the host (DTensors gathered
    whole); on a rank that does not write, the gathers alone (no host
    copy) and None."""
    if write:
        return tree_unflatten(tree, [_to_host(x) for x in tree_leaves(tree)])
    for x in tree_leaves(tree):
        if isinstance(x, DTensor):
            _whole(x.detach())
    return None


def _to_host(leaf):
    """A host copy of a leaf: tensors (DTensors gathered whole) as CPU
    tensors, others as numpy."""
    if isinstance(leaf, torch.Tensor):
        return _whole(leaf.detach()).to("cpu", copy=True)
    return np.array(leaf)


def _to_numpy(leaf) -> np.ndarray:
    if isinstance(leaf, torch.Tensor):
        t = leaf.detach().cpu()
        if t.dtype == torch.bfloat16:
            t = t.view(torch.int16)
        return t.numpy()
    return np.asarray(leaf)


def _dtype_name(leaf) -> str:
    if isinstance(leaf, torch.Tensor) and leaf.dtype == torch.bfloat16:
        return BF16
    return str(_to_numpy(leaf).dtype)


def save(root: str, step: int, tree: Any, metadata: Optional[dict] = None,
         shard_size: int = 512 * 2**20) -> str:
    """Atomic checkpoint save. Returns the committed directory.  A tree
    with DTensor leaves is gathered on every rank (each must call) and
    written by rank 0."""
    final = os.path.join(root, f"step_{step:08d}")
    if _is_sharded(tree):
        tree = _host_tree(tree, _writes(True))
        if tree is None:
            return final
    tmp = final + ".tmp"
    if os.path.exists(tmp):
        shutil.rmtree(tmp)
    os.makedirs(tmp, exist_ok=True)

    leaves = tree_leaves(tree)
    manifest = {
        "step": step,
        "treedef": tree_paths(tree),
        "n_leaves": len(leaves),
        "metadata": metadata or {},
        "time": time.time(),
        "leaves": [],
        "shards": [],
    }
    shard_idx, shard_bytes, shard_payload = 0, 0, {}
    for i, leaf in enumerate(leaves):
        arr = _to_numpy(leaf)
        manifest["leaves"].append({
            "index": i, "shape": list(arr.shape), "dtype": _dtype_name(leaf),
            "shard": shard_idx,
        })
        shard_payload[f"leaf_{i}"] = arr
        shard_bytes += arr.nbytes
        if shard_bytes >= shard_size:
            _write_shard(tmp, shard_idx, shard_payload)
            manifest["shards"].append(shard_idx)
            shard_idx += 1
            shard_bytes, shard_payload = 0, {}
    if shard_payload:
        _write_shard(tmp, shard_idx, shard_payload)
        manifest["shards"].append(shard_idx)

    with open(os.path.join(tmp, "manifest.json"), "w") as f:
        json.dump(manifest, f)
        f.flush()
        os.fsync(f.fileno())
    with open(os.path.join(tmp, "COMMITTED"), "w") as f:
        f.write(str(step))
        f.flush()
        os.fsync(f.fileno())
    if os.path.exists(final):
        shutil.rmtree(final)
    os.replace(tmp, final)
    return final


def _write_shard(d: str, idx: int, payload: dict):
    path = os.path.join(d, f"shard_{idx:05d}.npz")
    np.savez(path, **payload)


def latest_step(root: str) -> Optional[int]:
    if not os.path.isdir(root):
        return None
    steps = []
    for name in os.listdir(root):
        if name.startswith("step_") and not name.endswith(".tmp") and \
                os.path.exists(os.path.join(root, name, "COMMITTED")):
            steps.append(int(name.split("_")[1]))
    return max(steps) if steps else None


def _restore_leaf(arr: np.ndarray, dtype: str, like, spec, mesh):
    if not isinstance(like, torch.Tensor) and spec is None:
        return arr
    t = torch.from_numpy(arr)
    if dtype == BF16:
        t = t.view(torch.bfloat16)
    if spec is not None:
        from ..train.sharding import shard_tensor
        return shard_tensor(t.to(mesh.device_mesh.device_type), spec, mesh)
    dev = like.device if like.device.type != "meta" else torch.device("cpu")
    return t.to(dev)


def restore(root: str, tree_like: Any, step: Optional[int] = None,
            mesh=None, shardings=None) -> tuple[Any, dict]:
    """Restore into the structure of ``tree_like``.  Each tensor leaf
    lands on its like's device (a ``meta`` like: the CPU) with the saved
    dtype; a leaf whose like is no tensor comes back as a numpy array.
    ``shardings`` (a tree of specs, see ``train.sharding``) places every
    leaf as a DTensor over ``mesh`` instead (elastic restart onto
    another mesh)."""
    if step is None:
        step = latest_step(root)
        if step is None:
            raise FileNotFoundError(f"no committed checkpoint under {root}")
    d = os.path.join(root, f"step_{step:08d}")
    with open(os.path.join(d, "manifest.json")) as f:
        manifest = json.load(f)
    likes = tree_leaves(tree_like)
    if len(likes) != manifest["n_leaves"]:
        raise ValueError(f"checkpoint {d} holds {manifest['n_leaves']} "
                         f"leaves, the tree {len(likes)}")
    specs = [None] * len(likes) if shardings is None else \
        leaves_at(shardings, tree_like)
    shard_data = {}
    for s in manifest["shards"]:
        with np.load(os.path.join(d, f"shard_{s:05d}.npz")) as z:
            for k in z.files:
                shard_data[k] = z[k]
    leaves = [_restore_leaf(shard_data[f"leaf_{i}"], info["dtype"], like,
                            spec, mesh)
              for i, (info, like, spec) in enumerate(
                  zip(manifest["leaves"], likes, specs))]
    return tree_unflatten(tree_like, leaves), manifest["metadata"]


class AsyncCheckpointer:
    """Overlap checkpoint serialization with the next training steps."""

    def __init__(self, root: str, keep: int = 3):
        self.root = root
        self.keep = keep
        self._thread: Optional[threading.Thread] = None
        self.last_error: Optional[BaseException] = None

    def save_async(self, step: int, tree: Any, metadata=None):
        """Every rank of a sharded tree calls this (the gathers are
        collective); rank 0 alone writes."""
        self.wait()
        # materialize on host before handing to the writer thread
        host_tree = _host_tree(tree, _writes(_is_sharded(tree)))
        if host_tree is None:
            return

        def work():
            try:
                save(self.root, step, host_tree, metadata)
                self._gc()
            except BaseException as e:  # surfaced on next wait()
                self.last_error = e
        self._thread = threading.Thread(target=work, daemon=True)
        self._thread.start()

    def wait(self):
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        if self.last_error is not None:
            err, self.last_error = self.last_error, None
            raise err

    def _gc(self):
        steps = sorted(
            int(n.split("_")[1]) for n in os.listdir(self.root)
            if n.startswith("step_") and not n.endswith(".tmp")
            and os.path.exists(os.path.join(self.root, n, "COMMITTED")))
        for s in steps[:-self.keep]:
            shutil.rmtree(os.path.join(self.root, f"step_{s:08d}"),
                          ignore_errors=True)
