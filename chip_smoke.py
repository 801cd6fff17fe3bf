#!/usr/bin/env python3
"""On-card smoke test of the PyTorch/CUDA port (``src/repro_torch``).

Run from the repository root on a machine with one CUDA card:

    python3 chip_smoke.py

Phases, each of which must pass (any failure raises, exit code != 0):

1. Build: compile every ``src/repro_torch/kernels/csrc/*.cu`` with nvcc
   for sm_90a (one nvcc per source, started together).
2. Kernels at a real window: the ELL incidence pack of
   ``synth_packets(TrafficConfig(), 60 s)`` (about 6 M packets x 9
   fields), 1% of rows blanked.  ``spmv_ell`` and ``spmm_ell`` (B = 8),
   in both rings, against their plain versions on the card; times of
   kernel, plain version and, for plus_times, ``torch.sparse.mm`` on a
   CSR tensor, with CUDA events after a warm-up; the bytes bound at
   3.35 TB/s.
3. The main path on the card: ingest -> ``put`` -> ``flush`` ->
   ``fit_degree_table`` -> ``detect_c2`` (the injected C2 must rank in
   the top 3) -> ``eval_batch`` of 8 chains (one ``spmm_ell`` launch) ->
   one solo chain (one ``spmv_ell`` launch) -> ``pagerank_table``.  The
   kernel launch counts are zeroed just before and read just after; the
   kernel inputs the path produced are compared and timed again.
4. The same main path with ``set_device("cpu")`` (plain versions): same
   C2 hosts, equal batch columns (integer counts), and fit and PageRank
   within rtol=1e-5, atol=1e-7.

Prints the card's name and power limit, a ``{"kernels": [...]}`` line and,
last, ``{"ok": true, "device": {...}}``.  Without a CUDA device it exits
with code 2 and prints no result.
"""
from __future__ import annotations

import json
import subprocess
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent / "src"))

import numpy as np  # noqa: E402
import torch  # noqa: E402

from repro_torch import analytics  # noqa: E402
from repro_torch.core import Assoc, eval_batch, lazy, parse_tsv, val2col  # noqa: E402
from repro_torch.core import expr as X  # noqa: E402
from repro_torch.db import DB, put  # noqa: E402
from repro_torch.device import set_device  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.kernels import spmm as kspmm  # noqa: E402
from repro_torch.kernels import spmv as kspmv  # noqa: E402
from repro_torch.kernels.ref import spmm_ell_ref, spmv_ell_ref  # noqa: E402
from repro_torch.pipeline import (TrafficConfig, botnet_truth,  # noqa: E402
                                  records_to_tsv, synth_packets)

HBM_BYTES_PER_S = 3.35e12     # H100 SXM device memory
FP32_FLOPS = 67e12            # H100 SXM fp32 outside the tensor cores
KERNEL_RTOL, KERNEL_ATOL = 1e-5, 1e-6     # fp32, another summation order
PATH_RTOL, PATH_ATOL = 1e-5, 1e-7
MAIN_CFG = dict(n_hosts=512, pkt_rate=2000.0, n_bots=16, beacon_period_s=4.0,
                seed=7)
KERNELS = {
    "spmv_ell": dict(fn=kspmv.spmv_ell, ref=spmv_ell_ref,
                     replaces="src/repro/kernels/spmv.py:128"),
    "spmm_ell": dict(fn=kspmm.spmm_ell, ref=spmm_ell_ref,
                     replaces="src/repro/kernels/spmm.py:81"),
}
SOURCE = "src/repro_torch/kernels/csrc/ell.cu"


class SmokeFailure(RuntimeError):
    pass


def check(cond: bool, what: str) -> None:
    if not cond:
        raise SmokeFailure(what)


def log(*parts) -> None:
    print(*parts, flush=True)


# ---------------------------------------------------------------------------
# Timing and bounds.
# ---------------------------------------------------------------------------

def timed_ms(fn, iters: int = 20, warmup: int = 3) -> float:
    """Mean time of ``fn()`` on the card in ms, from CUDA events."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def ell_bound(ecols: torch.Tensor, b: int) -> tuple[float, str]:
    """Least time for one ELL product on an H100, from this pack: the
    pack read once (R*K*8 bytes), each touched x / X row read once, the
    output written once; 2 flops per stored slot and query."""
    valid = ecols >= 0
    touched = int(torch.unique(ecols[valid]).numel())
    r, k = ecols.shape
    n_bytes = r * k * 8 + touched * 4 * b + r * 4 * b
    flops = 2 * int(valid.sum()) * b
    t_bytes = n_bytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / FP32_FLOPS * 1e3
    return max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops else "operations"


def csr_of(ecols: torch.Tensor, evals: torch.Tensor, n_cols: int):
    """The same matrix as a torch CSR tensor (the library yardstick)."""
    valid = ecols >= 0
    crow = torch.zeros(ecols.shape[0] + 1, dtype=torch.int64,
                       device=ecols.device)
    crow[1:] = valid.sum(1).cumsum(0)
    return torch.sparse_csr_tensor(crow, ecols[valid].long(), evals[valid],
                                   size=(ecols.shape[0], n_cols),
                                   check_invariants=False)


def compare(name: str, ecols, evals, x, ring: str) -> float:
    """Kernel against its plain version on the same inputs; returns the
    max abs error, raises beyond tolerance."""
    spec = KERNELS[name]
    got = spec["fn"](ecols, evals, x, ring=ring)
    want = spec["ref"](ecols, evals, x, ring)
    torch.cuda.synchronize()
    check(got.shape == want.shape, f"{name}/{ring}: shape {tuple(got.shape)}")
    check(bool(torch.isfinite(got).all()), f"{name}/{ring}: non-finite")
    err = float((got - want).abs().max()) if got.numel() else 0.0
    check(torch.allclose(got, want, rtol=KERNEL_RTOL, atol=KERNEL_ATOL),
          f"{name}/{ring}: max abs err {err} beyond rtol={KERNEL_RTOL}, "
          f"atol={KERNEL_ATOL}")
    return err


def measure(name: str, ecols, evals, x, ring: str, library: bool) -> dict:
    spec = KERNELS[name]
    b = 1 if x.dim() == 1 else x.shape[1]
    out = {"max_abs_err": compare(name, ecols, evals, x, ring),
           "ms": timed_ms(lambda: spec["fn"](ecols, evals, x, ring=ring)),
           "plain_ms": timed_ms(lambda: spec["ref"](ecols, evals, x, ring),
                                iters=5)}
    out["bound_ms"], out["bound_by"] = ell_bound(ecols, b)
    out["library_ms"] = None
    if library:
        A = csr_of(ecols, evals, x.shape[0])
        X2 = x if x.dim() == 2 else x[:, None].contiguous()
        out["library_ms"] = timed_ms(lambda: torch.sparse.mm(A, X2))
        del A
    return out


# ---------------------------------------------------------------------------
# Phase 2: the kernels at a real window.
# ---------------------------------------------------------------------------

def window_ell(duration_s: float = 60.0, seed: int = 0, blank: float = 0.01):
    """ELL incidence pack (packets x field|value ids) of a synthetic
    window at the generator's defaults, built from the records' integer
    fields (one ``np.unique`` per field; no string keys) with random
    positive weights; a ``blank`` share of rows is emptied to padding."""
    rec = synth_packets(TrafficConfig(seed=seed), duration_s)
    ts = rec["ts_sec"].astype(np.int64) * 1_000_000 + rec["ts_usec"]
    fields = [ts - ts[0], ts, rec["dst"], rec["orig_len"], rec["proto"],
              rec["src"], rec["dport"], rec["off_flags"], rec["sport"]]
    n = rec.shape[0]
    ecols = np.empty((n, len(fields)), np.int32)
    n_cols = 0
    for j, f in enumerate(fields):
        uniq, inv = np.unique(f, return_inverse=True)
        ecols[:, j] = inv + n_cols
        n_cols += uniq.shape[0]
    rng = np.random.default_rng(seed)
    evals = rng.uniform(0.5, 1.5, ecols.shape).astype(np.float32)
    dead = rng.random(n) < blank
    ecols[dead] = -1
    evals[dead] = 0.0
    return ecols, evals, n_cols


def kernels_at_window(dev: torch.device, duration_s: float = 60.0) -> dict:
    t0 = time.perf_counter()
    ecols_h, evals_h, n_cols = window_ell(duration_s)
    ecols = torch.from_numpy(ecols_h).to(dev)
    evals = torch.from_numpy(evals_h).to(dev)
    r, k = ecols.shape
    log(f"[window] {r} packets x {k} fields, {n_cols} field|value columns, "
        f"ELL {r * k * 8 / 1e9:.3f} GB, {int((ecols < 0).all(1).sum())} "
        f"empty rows, built in {time.perf_counter() - t0:.1f} s")
    rng = np.random.default_rng(1)
    x_pos = torch.from_numpy(rng.uniform(0, 1, n_cols).astype(np.float32))
    x_sgn = torch.from_numpy(rng.normal(0, 1, n_cols).astype(np.float32))
    X_pos = torch.from_numpy(rng.uniform(0, 1, (n_cols, 8)).astype(np.float32))
    X_sgn = torch.from_numpy(rng.normal(0, 1, (n_cols, 8)).astype(np.float32))
    cases = [("spmv_ell", "plus_times", x_pos), ("spmv_ell", "max_times", x_sgn),
             ("spmm_ell", "plus_times", X_pos), ("spmm_ell", "max_times", X_sgn)]
    results: dict = {}
    for name, ring, x in cases:
        m = measure(name, ecols, evals, x.to(dev), ring,
                    library=ring == "plus_times")
        m["shape"] = [r, k] + ([] if x.dim() == 1 else [x.shape[1]])
        results.setdefault(name, {})[ring] = m
        log(f"[window] {name} {ring}: kernel {m['ms']:.4f} ms, plain "
            f"{m['plain_ms']:.4f} ms, library {m['library_ms']} ms, bound "
            f"{m['bound_ms']:.4f} ms ({m['bound_by']}), max abs err "
            f"{m['max_abs_err']:.3g}")
    return results


# ---------------------------------------------------------------------------
# Phases 3 and 4: the main path.
# ---------------------------------------------------------------------------

class CaptureKernelInputs:
    """Keep a copy of the inputs of every ELL wrapper call made inside
    the block (the wrappers themselves still run and count)."""

    def __init__(self):
        self.calls: dict = {"spmv_ell": [], "spmm_ell": []}

    def _wrap(self, name, fn):
        def recorder(ecols, evals, x, ring="plus_times"):
            self.calls[name].append((ecols.clone(), evals.clone(), x.clone(),
                                     ring))
            return fn(ecols, evals, x, ring=ring)
        return recorder

    def __enter__(self):
        self._orig = (kspmv.spmv_ell, kspmm.spmm_ell)
        kspmv.spmv_ell = self._wrap("spmv_ell", self._orig[0])
        kspmm.spmm_ell = self._wrap("spmm_ell", self._orig[1])
        return self

    def __exit__(self, *exc):
        kspmv.spmv_ell, kspmm.spmm_ell = self._orig
        return False


def host_indicator(h: str) -> Assoc:
    """x_h: 1 at ``ip.src|h`` and ``ip.dst|h``, in a column named h."""
    return Assoc(np.asarray([f"ip.dst|{h}", f"ip.src|{h}"]),
                 np.asarray([h, h]), np.ones(2))


def main_path(device: str) -> dict:
    """Ingest a window and run the analytics through the port's public
    entry points on ``device``; checks launch routing on the way."""
    set_device(device)
    on_card = device == "cuda"
    cfg = TrafficConfig(**MAIN_CFG)
    times = {}

    def step(name, fn):
        t0 = time.perf_counter()
        out = fn()
        if on_card:
            torch.cuda.synchronize()
        times[name] = time.perf_counter() - t0
        return out

    rec = step("synth", lambda: synth_packets(cfg, 60.0))
    E = step("parse_val2col", lambda: val2col(parse_tsv(records_to_tsv(rec))))
    T = DB("Tedge", "TedgeT", "TedgeDeg", n_instances=2,
           tablets_per_instance=4)
    step("put_flush", lambda: (put(T, E.putval("1,")), T.flush()))
    fit = step("fit_degree_table", lambda: analytics.fit_degree_table(
        T, "ip.dst|"))
    rep = step("detect_c2", lambda: analytics.detect_c2(T, top_k=8))
    c2 = botnet_truth(cfg)["c2"]
    check(c2 in list(rep.hosts[:3]),
          f"[{device}] injected C2 {c2} not in top 3: {list(rep.hosts[:3])}")

    c0, k0 = X.launch_counts(), ops.kernel_launches()
    batch = step("eval_batch", lambda: eval_batch(
        [T.lazy() * lazy(host_indicator(h)) for h in rep.hosts]))
    c1, k1 = X.launch_counts(), ops.kernel_launches()
    check(c1["spmm"] - c0["spmm"] == 1 and c1["spmv"] == c0["spmv"],
          f"[{device}] eval_batch launches {c0} -> {c1}, want one spmm")
    check(k1["spmm_ell"] - k0["spmm_ell"] == (1 if on_card else 0),
          f"[{device}] spmm_ell wrapper launches {k0} -> {k1}")

    deg = T.degree_assoc("ip.dst|")
    solo = step("solo_chain", lambda: (T.lazy() * lazy(deg)).eval())
    c2_, k2 = X.launch_counts(), ops.kernel_launches()
    check(c2_["spmv"] - c1["spmv"] == 1,
          f"[{device}] solo chain launches {c1} -> {c2_}, want one spmv")
    check(k2["spmv_ell"] - k1["spmv_ell"] == (1 if on_card else 0),
          f"[{device}] spmv_ell wrapper launches {k1} -> {k2}")

    hosts, pr = step("pagerank_table", lambda: analytics.distributed
                     .pagerank_table(T, num_iters=30))
    pr = pr.cpu().numpy()
    check(pr.shape == hosts.shape and bool(np.isfinite(pr).all()),
          f"[{device}] pagerank shape {pr.shape} / non-finite")
    check(abs(float(pr.sum()) - 1.0) < 1e-3,
          f"[{device}] pagerank mass {pr.sum()}")
    log(f"[main {device}] {rec.shape[0]} packets, nnz {E.nnz}, fit alpha "
        f"{float(fit.alpha):.4f} r2 {float(fit.r2):.4f}, C2 {c2} rank "
        f"{list(rep.hosts).index(c2) + 1}, batch nnz "
        f"{[b.nnz for b in batch]}, solo nnz {solo.nnz}")
    log(f"[main {device}] seconds: " +
        json.dumps({k: round(v, 4) for k, v in times.items()}))
    return dict(fit=(float(fit.alpha), float(fit.r2)), c2=list(rep.hosts),
                batch=batch, solo=solo, hosts=hosts, pr=pr, times=times)


def compare_paths(card: dict, cpu: dict) -> None:
    check(card["c2"] == cpu["c2"],
          f"C2 hosts differ: card {card['c2']} cpu {cpu['c2']}")
    check(all(a == b for a, b in zip(card["batch"], cpu["batch"])),
          "eval_batch columns differ between card and CPU")
    check(card["solo"] == cpu["solo"],
          "solo chain differs between card and CPU")
    check(np.allclose(card["fit"], cpu["fit"], rtol=PATH_RTOL,
                      atol=PATH_ATOL),
          f"fit differs: card {card['fit']} cpu {cpu['fit']}")
    check(np.array_equal(card["hosts"], cpu["hosts"]) and
          np.allclose(card["pr"], cpu["pr"], rtol=PATH_RTOL, atol=PATH_ATOL),
          f"pagerank differs: max abs "
          f"{np.abs(card['pr'] - cpu['pr']).max()}")


# ---------------------------------------------------------------------------

def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is "
              "false)", file=sys.stderr)
        return 2
    dev = torch.device("cuda")
    t_start = time.perf_counter()
    log(f"torch {torch.__version__} cuda {torch.version.cuda} "
        f"python {sys.version.split()[0]}")

    t0 = time.perf_counter()
    ops.build_all()
    log(f"[build] nvcc sm_90a for {sorted(ops.SIGNATURES)} in "
        f"{time.perf_counter() - t0:.1f} s -> {ops.BUILD_DIR}")

    window = kernels_at_window(dev)

    ops.reset_launches()
    with CaptureKernelInputs() as cap:
        card = main_path("cuda")
    launches = ops.kernel_launches()
    log(f"[main cuda] kernel launches {launches}")
    for name, n in launches.items():
        check(n > 0, f"{name} was not launched on the main path")

    main_shapes = {}
    for name, calls in cap.calls.items():
        ecols, evals, x, ring = max(calls, key=lambda c: c[0].numel())
        m = measure(name, ecols, evals, x, ring, library=ring == "plus_times")
        m["shape"] = list(ecols.shape) + ([] if x.dim() == 1 else
                                          [x.shape[1]])
        main_shapes[name] = m
        log(f"[main cuda] {name} at {m['shape']}: kernel {m['ms']:.4f} ms, "
            f"plain {m['plain_ms']:.4f} ms, library {m['library_ms']} ms, "
            f"bound {m['bound_ms']:.5f} ms, max abs err "
            f"{m['max_abs_err']:.3g}")

    cpu = main_path("cpu")
    set_device("cuda")
    compare_paths(card, cpu)
    log("[compare] card and CPU main paths agree")

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]
    rows = []
    for name, spec in KERNELS.items():
        w = window[name]
        head = w["plus_times"]
        rows.append({
            "name": name, "route": "cuda", "source": SOURCE,
            "replaces": spec["replaces"], "launches": launches[name],
            "max_abs_err": max([m["max_abs_err"] for m in w.values()]
                               + [main_shapes[name]["max_abs_err"]]),
            "ms": head["ms"], "kernel_ms": head["ms"],
            "plain_ms": head["plain_ms"], "bound_ms": head["bound_ms"],
            "bound_by": head["bound_by"], "library_ms": head["library_ms"],
            "shape": head["shape"],
            "max_times": {k: w["max_times"][k] for k in
                          ("ms", "plain_ms", "bound_ms", "max_abs_err")},
            "main_path": {k: main_shapes[name][k] for k in
                          ("shape", "ms", "plain_ms", "library_ms",
                           "bound_ms", "max_abs_err")},
        })
    log(f"[done] {time.perf_counter() - t_start:.1f} s")
    print(smi)
    print(json.dumps({"kernels": rows}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
