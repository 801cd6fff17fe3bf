"""Pipeline → token-stream bridge with resumable, sharded sampling (the
JAX package's ``data/stream.py``, copied: numpy only).

This is the paper-integration point: the D4M pipeline's parsed TSV
packet logs (stage 3 outputs) become the LM training corpus — "train the
anomaly language model on the traffic" is the modern version of the
paper's analytics, and the same six-stage infrastructure feeds it.

Fault-tolerance contract: the sampler state (file cursor, intra-file
offset, RNG key, epoch) is a small dict checkpointed alongside the model
— restore gives exactly-once continuation of the stream.  Sharding:
worker ``i of n`` reads every n-th file of the sorted glob from the
i-th, so the workers' files are disjoint.
"""
from __future__ import annotations

import dataclasses
import glob
from typing import Iterator, Optional

import numpy as np

from . import tokenizer as T


@dataclasses.dataclass
class SamplerState:
    file_index: int = 0
    offset: int = 0          # token offset within current file buffer
    epoch: int = 0
    seed: int = 0

    def to_dict(self) -> dict:
        return dataclasses.asdict(self)

    @classmethod
    def from_dict(cls, d: dict) -> "SamplerState":
        return cls(**d)


class TokenStream:
    """Deterministic, resumable token batches from pipeline TSV files."""

    def __init__(self, pattern: str, seq_len: int, batch: int,
                 shard: int = 0, n_shards: int = 1,
                 state: Optional[SamplerState] = None):
        files = sorted(glob.glob(pattern))
        self.files = [f for i, f in enumerate(files)
                      if i % n_shards == shard]
        if not self.files:
            raise FileNotFoundError(f"no files match {pattern} "
                                    f"(shard {shard}/{n_shards})")
        self.seq_len = seq_len
        self.batch = batch
        self.state = state or SamplerState()
        self._buf: Optional[np.ndarray] = None
        self._buf_index = -1

    def _load(self, idx: int) -> np.ndarray:
        with open(self.files[idx % len(self.files)], "rb") as f:
            text = f.read().decode(errors="replace")
        return T.encode(text, add_bos=True, add_eos=True)

    def _ensure(self):
        if self._buf_index != self.state.file_index:
            self._buf = self._load(self.state.file_index)
            self._buf_index = self.state.file_index

    def next_batch(self) -> dict:
        """Returns {'tokens': (B, S) int32, 'labels': (B, S) int32}."""
        need = self.batch * (self.seq_len + 1)
        chunks = []
        while need > 0:
            self._ensure()
            avail = self._buf.shape[0] - self.state.offset
            take = min(avail, need)
            chunks.append(
                self._buf[self.state.offset:self.state.offset + take])
            self.state.offset += take
            need -= take
            if self.state.offset >= self._buf.shape[0]:
                self.state.offset = 0
                self.state.file_index += 1
                if self.state.file_index >= len(self.files):
                    self.state.file_index = 0
                    self.state.epoch += 1
        flat = np.concatenate(chunks)
        flat = flat.reshape(self.batch, self.seq_len + 1)
        return {"tokens": flat[:, :-1].astype(np.int32),
                "labels": flat[:, 1:].astype(np.int32)}

    def __iter__(self) -> Iterator[dict]:
        while True:
            yield self.next_batch()
