"""Byte-level tokenizer (vocab-embedding friendly, no external deps).

Tokens 0..255 are raw bytes; ids ≥ 256 are reserved specials.  Any
assigned architecture's vocab (32k–256k) embeds the byte range, so one
tokenizer serves every config — production would swap in SentencePiece
behind the same interface.
"""
from __future__ import annotations

import numpy as np

PAD = 256
BOS = 257
EOS = 258
N_SPECIALS = 3


def encode(text: str, add_bos: bool = True, add_eos: bool = False
           ) -> np.ndarray:
    b = np.frombuffer(text.encode("utf-8"), dtype=np.uint8).astype(np.int32)
    parts = []
    if add_bos:
        parts.append(np.asarray([BOS], np.int32))
    parts.append(b)
    if add_eos:
        parts.append(np.asarray([EOS], np.int32))
    return np.concatenate(parts)


def decode(ids: np.ndarray) -> str:
    ids = np.asarray(ids)
    ids = ids[(ids >= 0) & (ids < 256)]
    return ids.astype(np.uint8).tobytes().decode("utf-8", errors="replace")
