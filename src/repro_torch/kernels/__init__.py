"""Hand-written CUDA kernels of the port and their plain versions.

Sources live in ``csrc/`` and build with ``nvcc`` on first use (see
:mod:`repro_torch.kernels.ops`); a wrapper given CPU tensors runs the
plain PyTorch version instead (:mod:`repro_torch.kernels.ref`).
"""
from .flash_attention import flash_attention
from .ops import build_all, kernel_launches, on_cuda, reset_launches
from .ref import (flash_attention_ref, rglru_scan_ref, segsum_ref,
                  spgemm_sel_ref, spmm_ell_ref, spmv_ell_ref, wkv6_ref)
from .rglru import rglru_scan
from .segsum import segsum, segsum_windowed
from .spmm import spgemm_sel, spmm_ell
from .spmv import EllOverflowError, csr_to_ell, spmv_ell
from .wkv6 import wkv6

__all__ = [
    "spmv_ell", "spmm_ell", "spgemm_sel", "segsum", "segsum_windowed",
    "wkv6", "rglru_scan", "flash_attention", "csr_to_ell",
    "EllOverflowError", "spmv_ell_ref", "spmm_ell_ref", "spgemm_sel_ref",
    "segsum_ref", "wkv6_ref", "rglru_scan_ref", "flash_attention_ref",
    "on_cuda",
    "build_all", "kernel_launches", "reset_launches",
]
