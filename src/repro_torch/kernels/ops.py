"""Build, load and dispatch the hand-written CUDA kernels.

Each ``csrc/*.cu`` compiles with ``nvcc`` for ``sm_90a`` into its own
shared library with a plain C interface, loaded with ctypes.  Libraries
go to ``build/repro_torch/`` at the checkout root, named by a hash of
their source, at first use; :func:`build_all` starts one ``nvcc`` per
source at once.  A build failure raises.  Nothing is built or loaded at
import, so the package imports on a CPU-only torch.

The wrappers pick by the tensors' device (:func:`on_cuda`): CPU tensors
run the plain versions in :mod:`repro_torch.kernels.ref`, CUDA tensors
launch the kernel or raise.  Every launch adds one to its kernel's count
(:func:`kernel_launches`, :func:`reset_launches`).
"""
from __future__ import annotations

import ctypes
import hashlib
import itertools
import os
import shutil
import subprocess
import threading
from pathlib import Path

import torch

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "repro_torch"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC")

_VOIDP = ctypes.c_void_p
_I64 = ctypes.c_int64
_INT = ctypes.c_int
_F32 = ctypes.c_float
# <lib>_attrs(i, int out[4], const char** name) of every library
_ATTRS = (_INT, ctypes.POINTER(ctypes.c_int), ctypes.POINTER(ctypes.c_char_p))
# C signatures of every exported function, by library.
SIGNATURES = {
    "ell": {
        "ell_spmv": (_VOIDP, _VOIDP, _VOIDP, _VOIDP, _I64, _INT, _I64, _INT,
                     _VOIDP),
        "ell_spmm": (_VOIDP, _VOIDP, _VOIDP, _VOIDP, _I64, _INT, _I64, _INT,
                     _INT, _VOIDP),
        "ell_spgemm_sel": (_VOIDP, _VOIDP, _VOIDP, _VOIDP, _I64, _INT, _INT,
                           _INT, _VOIDP),
        "ell_attrs": _ATTRS,
    },
    "segsum": {
        "segsum_forward": (_VOIDP, _VOIDP, _VOIDP, _I64, _I64, _INT, _VOIDP),
        "segsum_windowed_forward": (_VOIDP, _VOIDP, _VOIDP, _I64, _I64, _INT,
                                    _VOIDP),
        "segsum_attrs": _ATTRS,
    },
    "wkv6": {
        "wkv6_forward": (_VOIDP,) * 7 + (_I64, _I64, _INT, _INT, _I64, _I64,
                                          _I64, _VOIDP),
        "wkv6_attrs": _ATTRS,
    },
    "rglru": {
        "rglru_forward": (_VOIDP,) * 3 + (_I64,) * 5 + (_VOIDP,),
        "rglru_attrs": _ATTRS,
    },
    "flash_attention": {
        "flash_attention_forward": (_VOIDP,) * 4 + (_I64,) * 3 + (_INT,) * 3
        + (_I64,) * 9 + (_INT, _INT, _F32, _INT, _VOIDP),
        "flash_attention_attrs": _ATTRS,
    },
}

_LOCK = threading.Lock()
_LIBS: dict = {}
_LAUNCHES = {"spmv_ell": 0, "spmm_ell": 0, "spgemm_sel": 0, "segsum": 0,
             "segsum_windowed": 0, "wkv6": 0, "rglru_scan": 0,
             "flash_attention": 0}


def on_cuda(*tensors: torch.Tensor) -> bool:
    """True when every tensor lies on a CUDA device, False when every
    one lies on the CPU; mixed or other devices raise."""
    kinds = {t.device.type for t in tensors}
    if kinds == {"cuda"}:
        if len({t.device for t in tensors}) != 1:
            raise ValueError("tensors lie on different CUDA devices")
        return True
    if kinds == {"cpu"}:
        return False
    raise ValueError(f"tensors must all lie on the CPU or all on one CUDA "
                     f"device, got {sorted(kinds)}")


def _nvcc() -> str:
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    path = shutil.which("nvcc") or os.path.join(home, "bin", "nvcc")
    if not os.path.exists(path):
        raise RuntimeError(f"nvcc not found on PATH or under {home}/bin")
    return path


def _lib_path(name: str) -> Path:
    src = (CSRC / f"{name}.cu").read_bytes() + b"".join(
        h.read_bytes() for h in sorted(CSRC.glob("*.cuh")))
    digest = hashlib.sha256(src + " ".join(NVCC_FLAGS).encode()).hexdigest()
    return BUILD_DIR / f"lib{name}-{digest[:16]}.so"


def _start_build(name: str):
    """Start nvcc for ``csrc/<name>.cu``; returns (process, tmp, out) or
    None when the library is already built."""
    out = _lib_path(name)
    if out.exists():
        return None
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
    proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True)
    return proc, tmp, out


def _finish_build(name: str, job) -> None:
    proc, tmp, out = job
    log, _ = proc.communicate()
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"nvcc failed for csrc/{name}.cu "
                           f"(exit {proc.returncode}):\n{log}")
    os.replace(tmp, out)


def build_all() -> None:
    """Compile every library not yet built, one nvcc per source, all
    started together; raises on the first failure."""
    with _LOCK:
        jobs = {n: _start_build(n) for n in SIGNATURES}
        errors = []
        for n, job in jobs.items():
            if job is None:
                continue
            try:
                _finish_build(n, job)
            except RuntimeError as e:
                errors.append(str(e))
        if errors:
            raise RuntimeError("\n".join(errors))


def load(name: str) -> ctypes.CDLL:
    """The loaded library ``name`` (built first if needed)."""
    lib = _LIBS.get(name)
    if lib is not None:
        return lib
    with _LOCK:
        if name not in _LIBS:
            job = _start_build(name)
            if job is not None:
                _finish_build(name, job)
            lib = ctypes.CDLL(str(_lib_path(name)))
            for fn, argtypes in SIGNATURES[name].items():
                getattr(lib, fn).argtypes = list(argtypes)
                getattr(lib, fn).restype = ctypes.c_int
            _LIBS[name] = lib
    return _LIBS[name]


def launch(lib: str, fn: str, kernel: str, device: torch.device,
           *args) -> None:
    """Call ``fn`` of library ``lib`` on ``device``'s current stream,
    raise on a non-zero CUDA error, and count one launch of ``kernel``."""
    c_fn = getattr(load(lib), fn)
    with torch.cuda.device(device):
        err = c_fn(*args, torch.cuda.current_stream(device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"{fn} launch failed: CUDA error {err}")
    with _LOCK:
        _LAUNCHES[kernel] += 1


def kernel_attributes() -> list:
    """Every kernel instance of every library, as cudaFuncGetAttributes
    reports it: registers a thread, static shared bytes, the largest
    dynamic shared bytes a launch has allowed so far, and local (spill)
    bytes a thread."""
    rows = []
    for lib in SIGNATURES:
        fn = getattr(load(lib), f"{lib}_attrs")
        for i in itertools.count():
            out = (ctypes.c_int * 4)()
            name = ctypes.c_char_p()
            err = fn(i, out, ctypes.byref(name))
            if err == -1:
                break
            if err:
                raise RuntimeError(f"{lib}_attrs({i}): CUDA error {err}")
            rows.append({"lib": lib, "kernel": name.value.decode(),
                         "registers": out[0], "static_smem": out[1],
                         "dynamic_smem": out[2], "local_bytes": out[3]})
    return rows


def kernel_launches() -> dict:
    """Snapshot of the per-kernel launch counts."""
    with _LOCK:
        return dict(_LAUNCHES)


def reset_launches() -> None:
    with _LOCK:
        for k in _LAUNCHES:
            _LAUNCHES[k] = 0
