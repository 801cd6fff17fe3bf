#!/usr/bin/env python3
"""Time variants of the segmented sums at chip_smoke's kernel window.

Run from the repository root on a machine with one CUDA card:

    python3 scripts/segsum_variants.py

Builds ``scripts/segsum_variants.cu`` with nvcc (the flags of
``repro_torch.kernels.ops``) into ``build/segsum_variants/``, makes
chip_smoke's kernel window (about 6 M packets x 9 fields, the row-major
pack flattened: 54 M ids over 11.5 M columns) and times, with CUDA events:

* every variant of the unsorted ``segsum`` that the .cu lists (the
  output's zeroing included, except in the read floor), in order and then
  in reverse, beside the port's ``segsum``; each one's largest error
  against the float64 sum and the share of chip_smoke's tolerance
  (``SEG_ATOL * max(1, max|f64|) + SEG_RTOL * |f64|``) that uses, and
  whether unit values count exactly when one id holds 90% of 4 M shuffled
  ids;
* the first ``segsum_windowed`` (after a zeroing memset) against the
  port's, in turns, on the same ids sorted, with the port's device time
  split by kernel from ``torch.profiler``, and the range-kernel variants
  of ``scripts/windowed_variants.cu`` (parts of the shipped kernel taken
  out, other widths, read floors).

Prints one line a measurement and the card's name and power limit.
Exits with code 2 without a CUDA device.
"""
from __future__ import annotations

import ctypes
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

import numpy as np  # noqa: E402
import torch  # noqa: E402

import chip_smoke as cs  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.kernels.segsum import segsum, segsum_windowed  # noqa: E402

SOURCE = ROOT / "scripts" / "segsum_variants.cu"
W_SOURCE = ROOT / "scripts" / "windowed_variants.cu"
LIB = ROOT / "build" / "segsum_variants" / "libsegsum_variants.so"
W_LIB = ROOT / "build" / "segsum_variants" / "libwindowed_variants.so"
VARIANTS = {0: "z memset", 1: "a table", 2: "b read floor",
            3: "c global atomics", 4: "d table, no global", 5: "e match+table",
            6: "f match+warp table", 7: "g f, 16-byte loads",
            8: "h e, 16-byte loads", 10: "k register cache+table",
            11: "l k, 16-byte loads", 12: "m l, 1024 threads, 16K slots",
            13: "n m, claim on second sighting", 14: "o m, no register cache"}
WINDOWED_FIRST = 9
W_VARIANTS = {0: "register-blocked loads", 1: "no gap zeros",
              2: "no run stores",
              3: "8 a thread", 4: "32 a thread", 5: "read floor, blocked",
              6: "read floor, coalesced"}


def build() -> tuple[ctypes.CDLL, ctypes.CDLL]:
    LIB.parent.mkdir(parents=True, exist_ok=True)
    jobs = [subprocess.Popen([ops._nvcc(), *ops.NVCC_FLAGS, "-o", str(out),
                              str(src)])
            for src, out in ((SOURCE, LIB), (W_SOURCE, W_LIB))]
    if any(j.wait() for j in jobs):
        raise RuntimeError("nvcc failed")
    lib, wlib = ctypes.CDLL(str(LIB)), ctypes.CDLL(str(W_LIB))
    lib.variant_run.argtypes = [ctypes.c_int] + [ctypes.c_void_p] * 3 + \
        [ctypes.c_int64, ctypes.c_int64, ctypes.c_void_p]
    wlib.windowed_variant_run.argtypes = [ctypes.c_int] + \
        [ctypes.c_void_p] * 4 + [ctypes.c_int64, ctypes.c_int64,
                                 ctypes.c_void_p]
    for fn in (lib.variant_run, wlib.windowed_variant_run):
        fn.restype = ctypes.c_int
    return lib, wlib


def runner(lib, which: int, ids, vals, n_seg: int):
    out = torch.empty(n_seg, device=vals.device)

    def run():
        err = lib.variant_run(which, ids.data_ptr(), vals.data_ptr(),
                              out.data_ptr(), ids.numel(), n_seg,
                              torch.cuda.current_stream().cuda_stream)
        if err:
            raise RuntimeError(f"variant {which}: error {err}")
        return out
    return run


def f64_sum(ids, vals, n_seg: int) -> torch.Tensor:
    keep = (ids >= 0) & (ids < n_seg)
    return torch.zeros(n_seg, dtype=torch.float64, device=vals.device) \
        .index_add_(0, ids[keep].long(), vals[keep].double())


def against_f64(got, exact) -> tuple[float, float]:
    """Largest error against the float64 sum, and the share of
    chip_smoke's limit it uses."""
    atol = cs.SEG_ATOL * max(1.0, float(exact.abs().max()))
    err = (got.double() - exact).abs()
    return float(err.max()), float((err / (atol + cs.SEG_RTOL
                                            * exact.abs())).max())


def hot_unit_case(dev):
    rng = np.random.default_rng(4)
    n = 4_000_000
    ids = np.where(rng.random(n) < 0.9, 7,
                   rng.integers(0, 100_000, n)).astype(np.int32)
    ids = torch.from_numpy(rng.permutation(ids)).to(dev)
    return ids, torch.ones(n, device=dev), 100_000


def main() -> int:
    if not torch.cuda.is_available():
        print("segsum_variants: no CUDA device", file=sys.stderr)
        return 2
    dev = torch.device("cuda")
    lib, wlib = build()
    ecols, evals, n_cols = cs.window_ell()
    ids = torch.from_numpy(ecols).to(dev).reshape(-1)
    vals = torch.from_numpy(evals).to(dev).reshape(-1)
    print(f"[variants] window: {ids.numel()} ids, {n_cols} segments")
    exact = f64_sum(ids, vals, n_cols)
    h_ids, h_ones, h_seg = hot_unit_case(dev)
    h_want = torch.bincount(h_ids.long(), minlength=h_seg).float()
    runs = {k: runner(lib, k, ids, vals, n_cols) for k in VARIANTS}
    runs["port"] = lambda: segsum(ids, vals, n_cols)
    for k, run in runs.items():
        got = run()
        err, used = against_f64(got, exact)
        hot = runner(lib, k, h_ids, h_ones, h_seg)() if k != "port" \
            else segsum(h_ids, h_ones, h_seg)
        name = VARIANTS.get(k, "port segsum")
        print(f"[variants] {name}: err vs f64 {err:.4g}, tolerance used "
              f"{used:.4f}, hot unit counts exact "
              f"{bool(torch.equal(hot, h_want))}")
    times: dict = {k: [] for k in runs}
    for order in (list(runs), list(runs)[::-1]):
        for k in order:
            times[k].append(cs.timed_ms(runs[k]))
    bound, _ = cs.segsum_bound(ids, vals, n_cols)
    for k, ts in times.items():
        print(f"[variants] {VARIANTS.get(k, 'port segsum')}: "
              f"{ts[0]:.4f} / {ts[1]:.4f} ms (in order / reversed), bound "
              f"{bound:.4f} ms")
    print("[variants] port segsum profile: "
          f"{cs.profiled_kernels(runs['port'])[0]}")

    # a window of 1 s (about the pipeline's nnz): the first design against
    # the port, event time of back-to-back calls and device time
    e1, v1, n1 = cs.window_ell(duration_s=1.0)
    i1 = torch.from_numpy(e1).to(dev).reshape(-1)
    x1 = torch.from_numpy(v1).to(dev).reshape(-1)
    small = {"a table": runner(lib, 1, i1, x1, n1),
             "port segsum": lambda: segsum(i1, x1, n1)}
    for name, run in list(small.items()) + list(small.items())[::-1]:
        print(f"[variants] 1 s window ({i1.numel()} ids, {n1} segments), "
              f"{name}: {cs.timed_ms(run):.4f} ms, device "
              f"{cs.profiled_kernels(run)[0]}")
    del i1, x1

    s_ids, order = torch.sort(ids)
    n_pad = int((s_ids < 0).sum())
    s_ids = s_ids[n_pad:].contiguous()
    s_vals = vals[order][n_pad:].contiguous()
    del order, exact, runs
    exact = f64_sum(s_ids, s_vals, n_cols)
    first = runner(lib, WINDOWED_FIRST, s_ids, s_vals, n_cols)

    def port():
        return segsum_windowed(s_ids, s_vals, n_cols)
    a, b = port(), port()
    print(f"[variants] windowed: port bit-identical across calls "
          f"{bool(torch.equal(a, b))}, err vs f64 port "
          f"{against_f64(a, exact)}, first {against_f64(first(), exact)}")
    ts = [cs.timed_ms(f) for f in (first, port, port, first)]
    wb, _ = cs.segsum_bound(s_ids, s_vals, n_cols)
    print(f"[variants] windowed first / port / port / first: "
          f"{' / '.join(f'{t:.4f}' for t in ts)} ms, bound {wb:.4f} ms")
    print(f"[variants] windowed port profile: {cs.profiled_kernels(port)[0]}")
    out = torch.empty(n_cols, device=dev)
    scratch = torch.empty(4 * (s_ids.numel() // 2048 + 2), dtype=torch.int32,
                          device=dev)

    def wrun(k):
        def run():
            err = wlib.windowed_variant_run(
                k, s_ids.data_ptr(), s_vals.data_ptr(), out.data_ptr(),
                scratch.data_ptr(), s_ids.numel(), n_cols,
                torch.cuda.current_stream().cuda_stream)
            if err:
                raise RuntimeError(f"windowed variant {k}: error {err}")
        return run
    wts: dict = {k: [] for k in W_VARIANTS}
    for order in (list(W_VARIANTS), list(W_VARIANTS)[::-1]):
        for k in order:
            wts[k].append(cs.timed_ms(wrun(k)))
    for k, ts in wts.items():
        print(f"[variants] windowed range kernel, {W_VARIANTS[k]}: "
              f"{ts[0]:.4f} / {ts[1]:.4f} ms (in order / reversed)")
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip())
    return 0


if __name__ == "__main__":
    sys.exit(main())
