"""repro_torch.data — the byte tokenizer and the resumable token stream
over the pipeline's packet logs."""
from . import tokenizer
from .stream import SamplerState, TokenStream

__all__ = ["tokenizer", "TokenStream", "SamplerState"]
