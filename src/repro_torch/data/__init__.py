"""repro_torch.data — the byte tokenizer (the token stream is not ported
yet)."""
from . import tokenizer

__all__ = ["tokenizer"]
