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
5. ``wkv6`` against its plain version on the card at the serve shape
   (8, 512, 32, 64) and at (1, 4096, 32, 64): r, k, v normal, w in
   (0.45, 0.95), u x 0.1; and at the serve shape with every w at the
   model's clip floor exp(-e^0.5), where the kernel's chunked form scales
   by the largest exp(+-sum log w); output and final state within
   rtol=1e-4 and
   atol=1e-4 x max(1, max|plain|) (fp32, another summation order: the
   rounding of a recurrence grows with the state it accumulates, which
   the model's near-1 decays make large); times of kernel and plain
   version and the bytes bound.  No single PyTorch call computes WKV-6,
   so the library time is null.
6. The serving path of rwkv6-1.6b at full width and depth on the card:
   the port's seeded init, ``rwkv_impl="pallas"``, 8 prompts of 511
   bytes of packet-log text (S = 512 with BOS), ``generate(max_new=32)``
   through ``repro_torch.launch.serve``.  Launch counts are zeroed just
   before and read just after: exactly 24 ``wkv6`` launches, all in
   prefill.  One prefill and one decode step again under
   ``torch.profiler``: their device kernel time and its share of the
   unprofiled time.  Then the plain path (``rwkv_impl="chunked"``) on
   the same weights, teacher-forced over the kernel path's tokens: layer 0's WKV
   state (identical inputs) within rtol=atol=1e-3, the tolerance between
   the chunked and sequential forms; every layer's state, the prefill
   logits and all 32 decode steps' logits within a relative norm error
   of 0.1 (bf16 activations: the two forms round their WKV outputs to
   bf16 differently and the differences compound over 24 layers).
7. ``rglru_scan`` against its plain version on the card at the serve
   shape (8, 512, 4096) and at (1, 8192, 4096): a = exp(-8 softplus(Λ) r)
   in (0, 1) as the model makes it (Λ the model's init, r a sigmoid), b
   x 0.1 normal.  Equal bit for bit (the kernel rounds each product and
   sum as the plain version's two elementwise operations do); times of
   kernel and plain version and the bytes bound.  No single PyTorch call
   computes the recurrence, so the library time is null.
8. ``flash_attention`` against its plain version (the model's
   ``attention_naive``) on the card: the serve shape (8, 512, 16, 256)
   with one kv head, bf16, causal, window 2048; (1, 4096, 16, 256), the
   same, where the window cuts; (2, 512, 16, 128) with 4 kv heads in
   float32, causal; phi-3-vision's prefill shape (8, 1024, 32, 96), one
   kv head a query head (each block one head), bf16, causal, its head
   dim padded to 128 in shared memory; deepseek-v2-lite's prefill
   (decompressed latent attention) at (4, 2048, 16, 192) and at the
   cell's length (1, 16384, 16, 192), 16 kv heads, bf16, causal: q/k
   heads of 192, v of 128 zero-padded to 192 (the kernel pads both to
   256 in shared memory), DeepSeek's softmax scale 192^-0.5 m^2, and
   the output's padded columns exactly zero (batch 1 at 16,384: the
   plain version's float32 scores, B H S^2 of them, fit the card).
   bf16 within rtol=atol=2e-2 of the plain version on
   the same inputs (which rounds its softmax weights to bf16 before the
   product: up to 2^-9 of |v| per weight, plus half an output ulp each)
   and within rtol=atol=1e-2 of the plain version on the same values in
   float32 (the kernel's float32 accumulation, its softmax weights rounded
   to bf16 before P.V and its output once); and, for bf16, the relative
   Frobenius error against float32 arithmetic within 5e-3 in each quarter
   of the query positions (bf16 rounding of P and o gives about 2.2e-3
   there; a key tile a warp skips wrongly moves its rows' outputs by
   several percent, which the element-wise limits can miss); float32
   within rtol=atol=2e-5.  Times of kernel, plain version and, where it
   computes the same function (no window cut), the library yardstick
   ``scaled_dot_product_attention(is_causal=True)`` with k and v expanded
   to 16 heads; the bound from the visible (row, key) pairs.
9. The serving path of recurrentgemma-9b at full width and depth on the
   card (after freeing the rwkv6 weights): the port's seeded init,
   ``rglru_impl="pallas"``, ``attention_impl="pallas"``, the same 8
   prompts, ``generate(max_new=32, s_max=1024)``.  Launch counts are
   zeroed just before and read just after: exactly 26 ``rglru_scan`` and
   12 ``flash_attention`` launches, all in prefill, none in decode.
   Profiled prefill and decode step as in phase 6; peak device memory.
   Then the plain path (``rglru_impl="scan"``, ``attention_impl=
   "chunked"``, which is naive attention at S = 512) on the same weights,
   teacher-forced over the kernel path's tokens: layer 0's RG-LRU state
   (identical inputs; sequential kernel against the plain log-depth scan)
   within rtol=atol=1e-4 in float32; every layer's cache tensors, the
   prefill logits and all 32 decode steps' logits within a relative norm
   error of 0.1 (bf16, 38 layers), and the ring positions equal.

10. ``segsum``, ``segsum_windowed`` and ``spgemm_sel`` at the same
    window as phase 2 (run right after it): ``segsum`` over the flattened
    pack (about 54 M ids, the -1 padding dropped by the kernel),
    ``segsum_windowed`` over the same ids sorted (``torch.sort``, padding
    cut off, outside the timed call), ``spgemm_sel`` with 8 random
    columns in both rings; each against its plain version on the card
    (segsums within rtol=1e-5, atol=1e-4 x max(1, max|plain|): another
    summation order, and segsum's float atomics add in a run-dependent
    order; spgemm_sel within rtol=atol=1e-6); the segsums also within the
    same limit of the float64 sum (atol x max(1, max|f64|)), and
    ``segsum_windowed`` bit for bit across two calls; times of kernel,
    plain version and library yardstick (``index_add_`` on ids with the
    padding masked out beforehand; ``torch.sparse.mm`` of the CSR matrix
    and the dense one-hot selection) and the bytes bound; for the segsums
    also their device time from ``torch.profiler`` (by kernel; the
    largest of up to 8 profiled runs, as the profiler drops records at
    random late in a process, see phase 13) and the wrapper's host time
    a call, beside the event time of back-to-back calls.
11. The paper's pipeline on the card (after phase 4): ``run_pipeline``
    of ``repro_torch.pipeline`` over 4 capture files of 15 s of the
    main-path traffic (about 120,000 packets, 1 MiB splits, 4 workers)
    into ``MultiInstanceDB(2, 4)``: generate -> uncompress -> split ->
    parse -> sort -> sparse -> ingest -> flush, per-stage bytes and
    seconds logged.  The driver seeds file i with seed + i, so each file
    injects its own C2: ``detect_c2`` over the union of the ``*.E.npz``
    must rank exactly those four C2s first, and ``connections`` of each
    must be non-empty.
12. The new kernels over the pipeline's own tables: column degrees
    (``segsum`` on the row-major COO columns, ``segsum_windowed`` on them
    sorted) equal to TedgeDeg for every column key, exactly; packet
    field counts (``segsum_windowed`` on the rows) equal to the counts
    from E's triples; the ELL pack of E with ones against the 8
    ``detect_c2`` hosts' ``ip.dst|`` columns: ``spgemm_sel`` column sums
    equal to ``db.degree`` and the whole result equal to ``spmm_ell``
    against the one-hot X (plus_times); with signed values (one selected
    column all negative) ``spgemm_sel`` max_times equal to its plain
    version, keeping the negative hits that ``spmm_ell`` clamps to 0.
    Launch counts are zeroed just before phase 11 and read just after
    this phase: exactly 1 ``segsum``, 2 ``segsum_windowed``, 2
    ``spgemm_sel`` and 2 ``spmm_ell``, none in phase 11.  The same calls
    on CPU tensors (plain versions) give the same arrays.  The segsums
    and ``spgemm_sel`` are then measured at these shapes as in phase 10.
13. The gateway over the net store (after phase 12): phase 3's window
    (its incidence matrix: 120,239 packets, 1,082,151 nnz) through
    ``put`` and ``flush`` into ``DB(..., backend="net", n_instances=2)``
    with in-process shard servers on loopback, the stream
    (``StreamAnalytics().attach``) attached before any ingest; then
    ``repro_torch.serve.Gateway`` on 127.0.0.1:0, asked over HTTP with
    ``urllib``: 8 concurrent ``/v1/topk`` (equal answers, a coalesced
    batch of 2 or more), ``/v1/degree`` (n and the fit equal phase 3's
    ``fit_degree_table``), ``/v1/c2?top_k=3`` (the injected C2, phase 3's
    top 3), ``/v1/scanners`` and one column ``/v1/scan`` (equal to the
    same calls on phase 3's memory table), a ``pagerank`` job (top 5 keys
    and ranks equal to phase 3's ``pagerank_table``), ``/v1/windows``
    (packets summed over the closed windows equal the window's),
    ``/v1/stats`` (one ingest tap; ``kernel_launches`` equal to
    ``launch_counts()``), 401 without a token and 429 with Retry-After
    past a tenant's burst.  On the card, one ``/v1/c2`` request and one
    PageRank job each allocate device tensors and show device time
    under ``torch.profiler`` (which there drops a call's device records
    at random, so up to 8 calls are profiled and the largest time kept).  Then the
    attack scenario of ``tests/test_stream.py`` (c2, scan and ddos) block
    by block into a second net-backed table with the tap: each attack
    alerted in its truth window, naming its C2 server, scanner or
    victim.  The same again with ``set_device("cpu")``: every answer
    equal (keys and integers exactly, floats within rtol=1e-5,
    atol=1e-7).  Launch counts are zeroed just before the card's run and
    read just after: this path launches no hand-written kernel, and
    none may run.  Logs each endpoint's median latency over 5 requests
    after one warm-up, the ingest seconds and the phase's seconds.

14. Training and the mesh on the card (after phase 9): (a) rwkv6-1.6b at
    full width and depth (1.584 B parameters, bf16 compute, float32
    master weights, remat per layer) trained through the calls of
    ``repro_torch.launch.train.main`` in its order: ``synth_corpus`` (the
    port's pipeline, on the card), ``TokenStream`` B = 8, S = 512,
    seeded ``init_train_state``, ``make_train_step`` with
    ``OptConfig(warmup_steps=2)``, 12 steps, the last one's gradient and
    AdamW update apart (as the step composes them).  Every loss and
    gradient norm finite, the mean of the last 3 losses below the first,
    no hand-written kernel launched (counts zeroed just before, read
    just after).  Logs each step's seconds (CUDA events), the median
    after the first, tokens/s, the AdamW update's share of its step,
    peak device memory and one more step's device time under
    ``torch.profiler``, the device alone traced (a lower bound, see
    phase 13).  (b) Two smoke
    train steps of rwkv6 on the card and on the CPU from the same seeded
    parameters and batches: float32 losses and gradient norms within
    rtol=1e-5, bfloat16 within rtol=1e-2; every parameter within 2 lr a
    step of the CPU's (Adam moves each entry by about lr, and a tiny
    gradient of another sign by 2 lr apart), and 99.9% (float32) within
    2e-6 or 99% (bfloat16) within 1e-4.  (c) The bfloat16 run's state
    with a sampler state through ``repro_torch.checkpoint``: restored
    onto the card and onto the CPU bit for bit.  (d) A one-rank NCCL
    world (``FileStore`` under a temporary directory, destroyed at the
    end): ``pagerank_table`` of phase 3's table over a (1,) ``data``
    mesh equal to phase 3's (keys exact, ranks rtol=1e-5, atol=1e-7),
    ``degree_sharded`` exact, and ``compressed_pod_mean`` over a (1,)
    ``pod`` axis of (a)'s last gradients within scale/2 of them on every
    leaf (plus the float32 rounding of the dequantized value, under
    1e-5 scale).

15. The MoE, encoder-decoder and vision families on the card (after
    phase 9, each model freed before the next; peak memory, profiled
    prefill and decode as in phase 9, and launch counts zeroed just
    before and read just after each ``generate``).  (a)
    granite-moe-3b-a800m at full width and depth (3,349,513,728
    parameter entries; 40 experts top-8, 24 heads padded to 32),
    ``attention_impl="pallas"``, the same 8 prompts, ``generate(max_new=
    32)``: no kernel launched (the padded heads' head->kv map fails the
    kernel's precondition, as in the JAX package); logs the share of
    layer 0's prefill (token, choice) pairs dropped by capacity (C = 128
    at S = 512) and the share routed alike in bf16 and float32; the bf16
    prefill logits against a float32 prefill on the same weights (over
    the real vocabulary), held over the first layer (the same embedding,
    layer and head) within a relative norm error of 0.05 and logged over
    2 and all 32.  Teacher forcing is no check for a MoE under capacity
    pressure: the capacity, and so which pairs drop, depends on S.
    Deeper, bf16 and float32 are not comparable: a (token, choice) pair
    whose two best experts nearly tie routes differently in the two
    (2.5% of layer 0's pairs), reorders its expert's capacity queue,
    which moves which later pairs drop, and the next layers amplify it.
    ``scripts/moe_precision.py`` measures it on the CPU at full width for
    these 8 prompts: 0.0077 over 1 layer and 0.073 over 2 in the port,
    0.0074 and 0.115 in the JAX package on the same weights (float32 of
    the two within 1.4e-6, ``--layers 1 2 --with-jax``); and with no
    pair dropped, 0.066 over 2 layers and 0.26 over 8 (``--layers 2 8
    --no-drops``, the port's init).  0.05 is six times the 1-layer
    figure: bf16 rounding and layer 0's own flips.  (b) whisper-large-v3
    (2,398,169,600; 32 encoder and 32 decoder layers, 20 heads padded to
    32): ``generate`` with zero frames, no kernel (cross-attention's
    1500 keys exceed the attention chunk and ask for the kernel; the
    head map refuses it); the encoder's device time apart; then seeded
    normal frames: prefill and 32 decode steps over the generated tokens
    with the encoder output of those frames, each within 0.1 of one
    teacher-forced forward.  (c) phi-3-vision-4.2b (3,831,696,384; 576
    image tokens): 447-byte prompts, so S = 448 + 576 = 1024 where the
    kernel's precondition holds (511 bytes would give 1088, which it
    refuses; logged): exactly 32 ``flash_attention`` launches, all in
    prefill; then seeded normal image embeddings through the kernel path
    and the plain path (chunked, naive at S = 1024) over the generated
    tokens: prefill and all 32 decode steps' logits within 0.1; the
    kernel measured on layer 0's inputs.  (d) deepseek-v2-lite
    (15,706,484,224, bfloat16): the 8 prompts with 64 new tokens, one
    ``flash_attention`` launch a layer, all in prefill; decode replayed
    from one CUDA graph a call (1 eager / 1 captured / 62 replayed), its
    text equal to the eager loop's and its launches the same; a second
    served call counting 2 latent decode attention calls a layer.  (e)
    qwen3-moe-235b-a22b's full parameter tree counted on ``meta``
    (235,094,659,072).  (f) Every
    family's smoke config (float32, ``attention_impl="pallas"``) on the
    card and on the CPU from the same seeded parameters and batch
    (normal frames and image embeddings, 32 prefill positions): prefill
    and 4 decode steps' logits within rtol=atol=1e-4 (float32 matmuls
    in another order, TF32 off), layer 0's expert of every (token,
    choice) pair equal (capacity factor 4: nothing dropped), one
    ``flash_attention`` launch a layer on the card.

16. The sharded train step and the launch tooling (after phase 14, its
    state freed).  (a) A one-rank NCCL world over a (1, 1) (data, model)
    mesh: rwkv6-1.6b at full width and depth, phase 14's seed and
    batches (B = 8, S = 512), the state placed by ``init_train_state``
    over the mesh (every leaf a DTensor), 3 steps of ``make_train_step``
    through the placements path (the gathers, ``constrain``, the
    gradients reduced in the backward, the in-place AdamW on the
    shards): losses and
    gradient norms within phase 14 (b)'s bf16 rtol=1e-2 of phase 14's
    first 3, no kernel launched, every leaf still a DTensor; step
    seconds beside phase 14's median (DTensor's host dispatch), peak
    memory, one more step under ``FlopCounterMode`` and one profiled on
    the device alone.  (b) ``python -m repro_torch.launch.dryrun`` in a
    process of its own on the host (after the last timed phase, so that
    nothing shares the host while the card is timed) for rwkv6-1.6b
    train_4k and qwen2.5-14b prefill_32k on the single-pod (16, 16) mesh
    of a fake 256-rank world: each record ``ok``, its ``argument_bytes``
    equal to
    the local shard bytes ``param_specs`` implies (parameters, AdamW
    moments and step, batch); logs FLOPs, collective bytes by kind,
    ``temp_bytes``, the roofline terms on the H100 constants and each
    cell's seconds.  (c) The roofline of phase 14's step: the perf
    model's ``train_cell`` for rwkv6-1.6b at (B = 8, S = 512) on
    ``MeshDims(1, 1, 1)``, (a)'s counted FLOPs, phase 14's median step
    against 6·N·T / 989 TFLOP/s, and the card's own bf16 ``torch.matmul``
    TFLOP/s at 8192³ and device copy GB/s beside 989 TFLOP/s and
    3.35 TB/s.

17. The four examples on the card (after phase 16 (a) and (c), before
    (b)'s dry runs): ``python -m repro_torch.examples.<name>`` for
    ``quickstart``, ``pcap_analytics``, ``pcap_pipeline`` and
    ``train_packet_lm``, one child process each on the default device,
    which prints its kernel launch counts after the example: exit code
    0, the example's closing line (PageRank, the top PageRank hosts,
    "injected C2 recovered", "loss improved"), and exactly the
    hand-written kernels the example reaches launched (none, at the
    examples' own sizes); each example's seconds and launches logged.

Prints each kernel's registers and shared memory (``cudaFuncGetAttributes``
through each library's ``<lib>_attrs``), the card's name and power limit,
a ``{"kernels": [...]}`` line and, last, ``{"ok": true, "device": {...}}``.
Without a CUDA device it exits with code 2 and prints no result.
"""
from __future__ import annotations

import dataclasses
import gc
import glob
import json
import os
import shutil
import subprocess
import sys
import tempfile
import threading
import time
import urllib.error
import urllib.request
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent / "src"))

import numpy as np  # noqa: E402
import torch  # noqa: E402

from repro_torch import analytics, stream  # noqa: E402
from repro_torch.core import (Assoc, StartsWith, eval_batch,  # noqa: E402
                              lazy, parse_tsv, val2col)
from repro_torch.core import expr as X  # noqa: E402
from repro_torch.db import DB, MultiInstanceDB, put  # noqa: E402
from repro_torch.device import get_device, set_device  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.kernels import spmm as kspmm  # noqa: E402
from repro_torch.kernels import spmv as kspmv  # noqa: E402
from repro_torch.kernels.flash_attention import flash_attention  # noqa: E402
from repro_torch.kernels.ref import (flash_attention_ref,  # noqa: E402
                                     rglru_scan_ref, segsum_ref,
                                     spgemm_sel_ref, spmm_ell_ref,
                                     spmv_ell_ref, wkv6_ref)
from repro_torch.kernels.rglru import rglru_scan  # noqa: E402
from repro_torch.kernels.segsum import segsum, segsum_windowed  # noqa: E402
from repro_torch.kernels.wkv6 import wkv6  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.launch import serve  # noqa: E402
from repro_torch.models import (ShapeConfig, blocks,  # noqa: E402
                                init_params, inputs, layers, model)
from repro_torch.pipeline import (PipelineConfig,  # noqa: E402
                                  TrafficConfig, botnet_truth,
                                  records_to_tsv, run_pipeline,
                                  synth_packets)
from repro_torch.serve import Gateway, Tenant, TokenAuth  # noqa: E402
from repro_torch import checkpoint  # noqa: E402
from repro_torch.configs import smoke_config  # noqa: E402
from repro_torch.core import graph  # noqa: E402
from repro_torch.data import SamplerState, TokenStream  # noqa: E402
from repro_torch.launch.mesh import make_mesh  # noqa: E402
from repro_torch.launch.train import synth_corpus  # noqa: E402
from repro_torch.train import (OptConfig, adamw_update,  # noqa: E402
                               compressed_pod_mean, init_train_state)
from repro_torch.train import sharding  # noqa: E402
from repro_torch.configs import canonical  # noqa: E402
from repro_torch.launch import dryrun, perfmodel, roofline  # noqa: E402
from repro_torch.models.config import shape_by_name  # noqa: E402
from repro_torch.train.trainer import make_grad_fn, make_train_step  # noqa: E402,E501
from repro_torch.tree import leaves_at, tree_leaves, tree_map  # noqa: E402

HBM_BYTES_PER_S = 3.35e12     # H100 SXM device memory
FP32_FLOPS = 67e12            # H100 SXM fp32 outside the tensor cores
BF16_FLOPS = 989e12           # H100 SXM bf16 tensor cores, dense
KERNEL_RTOL, KERNEL_ATOL = 1e-5, 1e-6     # fp32, another summation order
RINGS = ("plus_times", "max_times")
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
WKV_SOURCE = "src/repro_torch/kernels/csrc/wkv6.cu"
WKV_REPLACES = "src/repro/kernels/wkv6.py:55"
WKV_RTOL, WKV_ATOL = 1e-4, 1e-4            # atol x max(1, max|plain|)
WKV_SHAPES = [(8, 512, 32, 64), (1, 4096, 32, 64)]
WKV_CLIP_FLOOR = float(np.exp(-np.exp(0.5)))   # the model's smallest decay
SERVE_ARCH, SERVE_BATCH, SERVE_PROMPT_BYTES, SERVE_NEW = \
    "rwkv6-1.6b", 8, 511, 32
SERVE_S_MAX = 1024
FORMS_RTOL, FORMS_ATOL = 1e-3, 1e-3        # chunked vs sequential WKV
SERVE_REL = 0.1                            # bf16 path, relative norm
RGLRU_SOURCE = "src/repro_torch/kernels/csrc/rglru.cu"
RGLRU_REPLACES = "src/repro/kernels/rglru.py:51"
RGLRU_SHAPES = [(8, 512, 4096), (1, 8192, 4096)]
FLASH_SOURCE = "src/repro_torch/kernels/csrc/flash_attention.cu"
FLASH_REPLACES = "src/repro/kernels/flash_attention.py:72"
MLA_ARCH = "deepseek-v2-lite"
_MLA = get_config(MLA_ARCH)
# DeepSeek's YaRN softmax scale: (qk_nope + qk_rope)^-0.5 m(mscale_all_dim)^2
MLA_SCALE = _MLA.qk_head_dim ** -0.5 * _MLA.rope_global.softmax_factor
# (B, S, H, KV, Dh, Dv, dtype, causal, window, scale): v is Dv wide,
# zero-padded to Dh past Dv (MLA's decompressed form); scale None is
# Dh^-0.5
FLASH_CASES = [(8, 512, 16, 1, 256, 256, torch.bfloat16, True, 2048, None),
               (1, 4096, 16, 1, 256, 256, torch.bfloat16, True, 2048, None),
               (2, 512, 16, 4, 128, 128, torch.float32, True, 0, None),
               (8, 1024, 32, 32, 96, 96, torch.bfloat16, True, 0, None),
               (4, 2048, 16, 16, _MLA.qk_head_dim, _MLA.v_head_dim,
                torch.bfloat16, True, 0, MLA_SCALE),
               (1, 16384, 16, 16, _MLA.qk_head_dim, _MLA.v_head_dim,
                torch.bfloat16, True, 0, MLA_SCALE)]
FLASH_TOL = {torch.bfloat16: 2e-2, torch.float32: 2e-5}   # rtol = atol
FLASH_F32_TOL = 1e-2          # bf16 output against float32 arithmetic
# bf16: relative Frobenius error against float32 arithmetic in each of
# FLASH_BANDS bands of query positions
FLASH_BANDS, FLASH_BAND_TOL = 4, 5e-3
RG_ARCH = "recurrentgemma-9b"
MOE_ARCH, ENCDEC_ARCH, VISION_ARCH, QWEN_MOE_ARCH = \
    "granite-moe-3b-a800m", "whisper-large-v3", "phi-3-vision-4.2b", \
    "qwen3-moe-235b-a22b"
# parameter entries of each full config (the JAX package's tree)
FAMILY_PARAMS = {MOE_ARCH: 3_349_513_728, ENCDEC_ARCH: 2_398_169_600,
                 VISION_ARCH: 3_831_696_384, QWEN_MOE_ARCH: 235_094_659_072,
                 MLA_ARCH: 15_706_484_224}
MLA_NEW = 64            # deepseek-v2-lite's new tokens a served call
# S = 447 + BOS + 576 image tokens = 1024, where the kernel's
# precondition holds; s_max leaves room for the 32 decode steps
VISION_PROMPT_BYTES, VISION_S_MAX = 447, 1056
# bf16 against float32 prefill logits over the first MOE_F32_LAYERS
# layers of the full-width weights (phase 15 (a) says why not all 32);
# logged over these depths
MOE_F32_LAYERS, MOE_F32_REL, MOE_F32_LOGGED = 1, 0.05, (1, 2)
FAMILY_SMOKE_TOL = 1e-4       # card against CPU, float32 smoke configs
RG_STATE_TOL = 1e-4           # layer 0 RG-LRU state, rtol = atol
SEGSUM_SOURCE = "src/repro_torch/kernels/csrc/segsum.cu"
SEGSUMS = {"segsum": dict(fn=segsum,
                          replaces="src/repro/kernels/segsum.py:48"),
           "segsum_windowed": dict(fn=segsum_windowed,
                                   replaces="src/repro/kernels/segsum.py:107")}
SEL_REPLACES = "src/repro/kernels/spmm.py:149"
SEG_RTOL, SEG_ATOL = 1e-5, 1e-4    # atol x max(1, max|plain|); sum order
SEL_RTOL, SEL_ATOL = 1e-6, 1e-6    # another summation order
SEL_B = 8
PIPE_CFG = dict(n_files=4, duration_per_file_s=15.0, split_size=1 << 20,
                n_workers=4)
PIPE_STAGES = ("generate", "uncompress", "split", "parse", "sort", "sparse",
               "ingest", "flush")
# launches of phase 12: column and row degrees, then the select and its
# one-hot cross-check in both rings
PIPE_LAUNCHES = {"segsum": 1, "segsum_windowed": 2, "spgemm_sel": 2,
                 "spmm_ell": 2}
GW_PACKETS, GW_NNZ = 120_239, 1_082_151    # phase 3's window
GW_SHARDS = 2
GW_TOKEN, GW_TIGHT = "analyst-token", "tight-token"
GW_COALESCE_S = 0.05          # window for the 8 concurrent top-k requests
GW_CONCURRENT, GW_REPEATS = 8, 5
GW_PROFILE_CALLS, GW_PROFILE_HITS = 8, 2
GW_HTTP_TIMEOUT = 120.0       # s: each HTTP request and each shard reply
GW_ENDPOINTS = (("topk", "/v1/topk?prefix=ip.dst|&k=10"),
                ("degree", "/v1/degree?prefix=ip.dst|"),
                ("c2", "/v1/c2?top_k=3"),
                ("scanners", "/v1/scanners"),
                ("windows", "/v1/windows?level=second&limit=10000"),
                ("stats", "/v1/stats"))


TRAIN_ARCH, TRAIN_B, TRAIN_S, TRAIN_STEPS = "rwkv6-1.6b", 8, 512, 12
TRAIN_WARMUP = 2
# card against CPU at the smoke size: losses and gradient norms
TRAIN_F32_RTOL, TRAIN_BF16_RTOL = 1e-5, 1e-2
TRAIN_SMOKE_B, TRAIN_SMOKE_S, TRAIN_SMOKE_LR = 4, 128, 1e-3
# parameters after the 2 steps: every entry within 2 lr a step (Adam maps
# each gradient to about +-lr, so a tiny gradient of another sign on
# the two devices moves its entry 2 lr apart), and this share of all
# entries within the near limit (float32: gradients equal to ~1e-6, so
# updates equal to ~1e-6 lr; bfloat16: to ~1e-2, so ~1e-2 lr)
TRAIN_PARAM_NEAR = {"float32": (2e-6, 0.999), "bfloat16": (1e-4, 0.99)}
# phase 16: the sharded steps against phase 14's first ones; the dry runs
SHARDED_STEPS = 3
# phase 17: each example's closing line, and the hand-written kernels its
# path reaches (none at the examples' own sizes: the planner keeps chains
# under DEVICE_NNZ_THRESHOLD on the host, PageRank reduces with
# index_add_, and the reduced rwkv6 runs the chunked WKV)
EXAMPLES = {
    "quickstart": ("pagerank: [", ()),
    "pcap_analytics": ("top PageRank hosts:", ()),
    "pcap_pipeline": ("injected C2 recovered from the traffic. pipeline "
                      "complete.", ()),
    "train_packet_lm": ("trained on pipeline output; loss improved. done.",
                        ()),
}
EXAMPLE_TIMEOUT_S = 300
DRYRUN_CELLS = (("rwkv6-1.6b", "train_4k"), ("qwen2.5-14b", "prefill_32k"))
DRYRUN_TIMEOUT_S = 600
MATMUL_N, COPY_BYTES = 8192, 1 << 30


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


def bound_of(n_bytes: float, ops_: float,
             peak: float = FP32_FLOPS) -> tuple[float, str]:
    """Least time in ms on an H100 for ``n_bytes`` moved at 3.35 TB/s and
    ``ops_`` operations at ``peak``, and which of the two bounds it."""
    t_bytes = n_bytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops_ / peak * 1e3
    return max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops else "operations"


def ell_bound(ecols: torch.Tensor, b: int) -> tuple[float, str]:
    """Least time for one ELL product on an H100, from this pack: the
    pack read once (R*K*8 bytes), each touched x / X row read once, the
    output written once; 2 flops per stored slot and query."""
    valid = ecols >= 0
    touched = int(torch.unique(ecols[valid]).numel())
    r, k = ecols.shape
    n_bytes = r * k * 8 + touched * 4 * b + r * 4 * b
    return bound_of(n_bytes, 2 * int(valid.sum()) * b)


def csr_of(ecols: torch.Tensor, evals: torch.Tensor, n_cols: int):
    """The same matrix as a torch CSR tensor (the library yardstick)."""
    valid = ecols >= 0
    crow = torch.zeros(ecols.shape[0] + 1, dtype=torch.int64,
                       device=ecols.device)
    crow[1:] = valid.sum(1).cumsum(0)
    return torch.sparse_csr_tensor(crow, ecols[valid].long(), evals[valid],
                                   size=(ecols.shape[0], n_cols),
                                   check_invariants=False)


def check_close(tag: str, got, want, rtol: float, atol: float) -> float:
    """Shape, finiteness and allclose of ``got`` against ``want``; returns
    the max abs error, raises beyond tolerance."""
    check(got.shape == want.shape and bool(torch.isfinite(got).all()),
          f"{tag}: shape {tuple(got.shape)} / non-finite")
    err = float((got - want).abs().max()) if got.numel() else 0.0
    check(torch.allclose(got, want, rtol=rtol, atol=atol),
          f"{tag}: max abs err {err} beyond rtol={rtol}, atol={atol}")
    return err


def compare(name: str, ecols, evals, x, ring: str) -> float:
    """Kernel against its plain version on the same inputs; returns the
    max abs error, raises beyond tolerance."""
    spec = KERNELS[name]
    got = spec["fn"](ecols, evals, x, ring=ring)
    want = spec["ref"](ecols, evals, x, ring)
    torch.cuda.synchronize()
    return check_close(f"{name}/{ring}", got, want, KERNEL_RTOL, KERNEL_ATOL)


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


def kernels_at_window(dev: torch.device, duration_s: float = 60.0):
    """Phases 2 and 10 on one window; returns the ELL kernels' results
    and the new kernels'."""
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
    del x_pos, x_sgn, X_pos, X_sgn
    return results, new_kernels_at_window(ecols, evals, n_cols)


# ---------------------------------------------------------------------------
# Phase 10: segsum, segsum_windowed and spgemm_sel at the window.
# ---------------------------------------------------------------------------

def segsum_bound(ids: torch.Tensor, vals: torch.Tensor, n_seg: int):
    """Each id and value read once, the output written once; one add per
    element."""
    n = ids.numel()
    return bound_of(n * (ids.element_size() + vals.element_size())
                    + n_seg * 4, n)


def sel_bound(ecols: torch.Tensor, b: int):
    """The pack read once (R*K*8 bytes), sel read once, the (R, b) output
    written once; a compare and a reduction per stored slot and column."""
    r, k = ecols.shape
    return bound_of(r * k * 8 + b * 4 + r * b * 4,
                    2 * int((ecols >= 0).sum()) * b)


def wrapper_host_ms(fn, iters: int = 50) -> float:
    """Host time of one call of ``fn`` (the Python wrapper and the
    launch), back to back without a synchronise after a warm-up."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(iters):
        fn()
    t = (time.perf_counter() - t0) * 1e3 / iters
    torch.cuda.synchronize()
    return t


def measure_segsum(name: str, ids, vals, n_seg: int) -> dict:
    """Kernel against its plain version and against the float64 sum on
    the same inputs (the windowed kernel also against itself: two calls,
    the same bits), then kernel, plain version and ``index_add_`` (ids
    outside [0, n_seg) masked out beforehand, untimed) timed; the kernel
    also by its device time (``torch.profiler``) and the wrapper's host
    time."""
    fn = SEGSUMS[name]["fn"]
    got = fn(ids, vals, n_seg)
    want = segsum_ref(ids, vals, n_seg)
    torch.cuda.synchronize()
    max_plain = float(want.abs().max()) if n_seg else 0.0
    atol = SEG_ATOL * max(1.0, max_plain)
    out = {"shape": [ids.numel(), n_seg], "max_plain": max_plain,
           "max_abs_err": check_close(name, got, want, SEG_RTOL, atol),
           "tol_used": float(((got - want).abs()
                              / (atol + SEG_RTOL * want.abs())).max())
           if n_seg else 0.0}
    keep = (ids >= 0) & (ids < n_seg)
    ids_k, vals_k = ids[keep].long(), vals[keep]
    exact = torch.zeros(n_seg, dtype=torch.float64, device=vals.device) \
        .index_add_(0, ids_k, vals_k.double())
    # float32 rounding of each sum, kernel's and plain version's (atomics)
    out["err_vs_f64"] = {k: float((x.double() - exact).abs().max())
                         if n_seg else 0.0
                         for k, x in (("kernel", got), ("plain", want))}
    # the same limit, against the exact sum
    atol64 = SEG_ATOL * max(1.0, float(exact.abs().max()))
    used = (got.double() - exact).abs() / (atol64 + SEG_RTOL * exact.abs())
    out["tol_used_f64"] = float(used.max()) if n_seg else 0.0
    check(out["tol_used_f64"] <= 1.0,
          f"{name}: {out['err_vs_f64']['kernel']} from the float64 sum, "
          f"{out['tol_used_f64']:.3f} of rtol={SEG_RTOL}, atol={SEG_ATOL} "
          f"x max(1, max|f64|)")
    if name == "segsum_windowed":
        check(torch.equal(got, fn(ids, vals, n_seg)),
              f"{name}: two calls differ")
        out["bit_identical"] = True
    del got, want, exact, used
    out["ms"] = timed_ms(lambda: fn(ids, vals, n_seg))
    # the profiler drops a run's device records at random once the
    # process has run a while: as in phase 13, up to GW_PROFILE_CALLS
    # profiled runs, the largest total kept, stopping after
    # GW_PROFILE_HITS runs that showed any
    split, hits = {}, 0
    for _ in range(GW_PROFILE_CALLS):
        run, _ = profiled_kernels(lambda: fn(ids, vals, n_seg), iters=5)
        hits += bool(run)
        if sum(run.values()) > sum(split.values()):
            split = run
        if hits >= GW_PROFILE_HITS:
            break
    check(bool(split), f"{name}: the profiler saw no device work")
    out["device_ms"] = sum(split.values())
    out["device_split_ms"] = {k[:48]: v for k, v in split.items()}
    out["host_ms"] = wrapper_host_ms(lambda: fn(ids, vals, n_seg))
    out["plain_ms"] = timed_ms(lambda: segsum_ref(ids, vals, n_seg), iters=5)
    out["library_ms"] = timed_ms(lambda: torch.zeros(
        n_seg, device=vals.device).index_add_(0, ids_k, vals_k))
    out["bound_ms"], out["bound_by"] = segsum_bound(ids, vals, n_seg)
    return out


def onehot_of(sel: torch.Tensor, n_cols: int) -> torch.Tensor:
    x = torch.zeros((n_cols, sel.numel()), device=sel.device)
    x[sel.long(), torch.arange(sel.numel(), device=sel.device)] = 1.0
    return x


def measure_sel(ecols, evals, sel, ring: str, n_cols: int,
                library: bool) -> dict:
    """Kernel against its plain version on the same inputs, then kernel,
    plain version and (plus_times) ``torch.sparse.mm`` of the CSR matrix
    against the dense one-hot selection timed."""
    got = kspmm.spgemm_sel(ecols, evals, sel, ring=ring)
    want = spgemm_sel_ref(ecols, evals, sel, ring)
    torch.cuda.synchronize()
    out = {"shape": list(ecols.shape) + [sel.numel()], "ring": ring,
           "max_abs_err": check_close(f"spgemm_sel/{ring}", got, want,
                                      SEL_RTOL, SEL_ATOL)}
    del got, want
    out["ms"] = timed_ms(lambda: kspmm.spgemm_sel(ecols, evals, sel,
                                                  ring=ring))
    out["plain_ms"] = timed_ms(lambda: spgemm_sel_ref(ecols, evals, sel,
                                                      ring), iters=5)
    out["library_ms"] = None
    if library:
        A, X1 = csr_of(ecols, evals, n_cols), onehot_of(sel, n_cols)
        out["library_ms"] = timed_ms(lambda: torch.sparse.mm(A, X1))
        del A, X1
    out["bound_ms"], out["bound_by"] = sel_bound(ecols, sel.numel())
    return out


def new_kernels_at_window(ecols, evals, n_cols: int) -> dict:
    ids, vals = ecols.reshape(-1), evals.reshape(-1)
    res = {"segsum": measure_segsum("segsum", ids, vals, n_cols)}
    s_ids, order = torch.sort(ids)
    n_pad = int((s_ids < 0).sum())
    s_ids = s_ids[n_pad:].contiguous()
    s_vals = vals[order][n_pad:].contiguous()
    del order
    res["segsum_windowed"] = measure_segsum("segsum_windowed", s_ids, s_vals,
                                            n_cols)
    del s_ids, s_vals
    rng = np.random.default_rng(2)
    sel = torch.from_numpy(rng.choice(n_cols, SEL_B, replace=False)
                           .astype(np.int32)).to(ecols.device)
    res["spgemm_sel"] = {ring: measure_sel(ecols, evals, sel, ring, n_cols,
                                           library=ring == "plus_times")
                         for ring in RINGS}
    for name, m in [("segsum", res["segsum"]),
                    ("segsum_windowed", res["segsum_windowed"])] + \
            [(f"spgemm_sel {r}", m) for r, m in res["spgemm_sel"].items()]:
        log(f"[window] {name} {m['shape']}: kernel {m['ms']:.4f} ms, plain "
            f"{m['plain_ms']:.4f} ms, library {m['library_ms']} ms, bound "
            f"{m['bound_ms']:.4f} ms ({m['bound_by']}), max abs err "
            f"{m['max_abs_err']:.3g}"
            + (f", against float64 {m['err_vs_f64']}, share of tolerance "
               f"used {m['tol_used']:.4f} against the plain version and "
               f"{m['tol_used_f64']:.4f} against float64 (max |plain| "
               f"{m['max_plain']}); device {m['device_ms']:.4f} ms "
               f"{m['device_split_ms']}, wrapper host {m['host_ms']:.4f} ms"
               + (", two calls bit-identical" if m.get("bit_identical")
                  else "") if "err_vs_f64" in m else ""))
    return res


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
                batch=batch, solo=solo, hosts=hosts, pr=pr, times=times,
                table=T, E=E, n_packets=rec.shape[0])


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
# Phases 11 and 12: the pipeline, and the new kernels over its tables.
# ---------------------------------------------------------------------------

def pipeline_path(dev: torch.device) -> dict:
    """``run_pipeline`` into a two-instance store on the card, C2
    recovery from its incidence files, then phase 12 over its tables.
    Launch counts are zeroed just before and read just after."""
    set_device("cuda")
    traffic = TrafficConfig(**MAIN_CFG)
    work = tempfile.mkdtemp(prefix="chip_smoke_pipeline_")
    times = {}
    try:
        ops.reset_launches()
        db = MultiInstanceDB(n_instances=2, tablets_per_instance=4)
        t0 = time.perf_counter()
        stats = run_pipeline(PipelineConfig(workdir=work, traffic=traffic,
                                            **PIPE_CFG), db)
        times["run_pipeline"] = time.perf_counter() - t0
        check(tuple(stats["stages"]) == PIPE_STAGES and
              stats["db_entries"] > 0, f"pipeline stages "
              f"{list(stats['stages'])}, entries {stats['db_entries']}")
        for stage, st in stats["stages"].items():
            grow = st["bytes_out"] / st["bytes_in"] if st["bytes_in"] else None
            log(f"[pipeline] {stage:10s} {st['n_tasks']} tasks, "
                f"{st['bytes_in']} B -> {st['bytes_out']} B (x{grow}), "
                f"{st['total_s']:.3f} s over its tasks")
        t0 = time.perf_counter()
        E = Assoc()
        for path in sorted(glob.glob(os.path.join(work, "*.E.npz"))):
            E = E + Assoc.load(path)
        times["load_E"] = time.perf_counter() - t0
        rep = step_timed(times, "detect_c2",
                         lambda: analytics.detect_c2(E, top_k=8))
        n_files = PIPE_CFG["n_files"]
        c2s = [botnet_truth(dataclasses.replace(
            traffic, seed=traffic.seed + i))["c2"] for i in range(n_files)]
        hosts = [str(h) for h in rep.hosts]
        check(sorted(hosts[:n_files]) == sorted(c2s),
              f"the {n_files} files' injected C2s {c2s} are not the top "
              f"{n_files} of detect_c2: {hosts}")
        conns = {}
        for c2 in c2s:
            conns[c2] = (len(db.connections(c2)), db.degree(f"ip.dst|{c2}"))
            check(conns[c2][0] > 0, f"no connections of C2 {c2}")
        log(f"[pipeline] {E.shape[0]} packets x {E.shape[1]} field|values, "
            f"nnz {E.nnz}, {stats['db_entries']} entries; C2 ranks "
            f"{[hosts.index(c) + 1 for c in c2s]} (file 0's {c2s[0]}); "
            f"connections, ip.dst degree: {conns}")
        k_pipe = ops.kernel_launches()
        check(not any(k_pipe.values()),
              f"the pipeline launched kernels: {k_pipe}")
        tables = pipeline_kernels(E, db, hosts, dev, times)
    finally:
        shutil.rmtree(work, ignore_errors=True)
    log(f"[pipeline] seconds: " +
        json.dumps({k: round(v, 4) for k, v in times.items()}) +
        " stage seconds: " + json.dumps(
            {k: round(v["total_s"], 4) for k, v in stats["stages"].items()}))
    return dict(stats=stats, times=times, ranks=[hosts.index(c) + 1
                                                 for c in c2s], **tables)


def step_timed(times: dict, name: str, fn):
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    times[name] = time.perf_counter() - t0
    return out


def pipeline_kernels(E: Assoc, db, hosts: list, dev, times: dict) -> dict:
    """Phase 12: segsum, segsum_windowed and spgemm_sel over the
    pipeline's incidence matrix, each held exactly against the store's
    own combiner sums, spmm_ell and the plain versions on the CPU."""
    coo = E.device_coo()
    rows, cols = coo.rows, coo.cols
    n_rows, n_cols = coo.shape
    ones = torch.ones(coo.nnz, device=dev)
    r, c, v = db.degree_assoc().triples()
    deg = dict(zip(r.tolist(), np.asarray(v, np.float64).tolist()))
    want_col = torch.tensor([deg[k] for k in E.col.tolist()],
                            dtype=torch.float32)
    tr, _, _ = E.triples()
    want_row = torch.from_numpy(np.bincount(
        np.searchsorted(E.row, tr), minlength=n_rows).astype(np.float32))
    sorted_cols = torch.sort(cols).values
    row_ptr = np.zeros(n_rows + 1, np.int64)
    row_ptr[1:] = np.cumsum(torch.bincount(rows.long(),
                                           minlength=n_rows).cpu().numpy())
    k_max = int(np.diff(row_ptr).max())
    cols_h = cols.cpu().numpy()
    ec_h, ev_h = kspmv.csr_to_ell(row_ptr, cols_h, np.ones(cols_h.shape,
                                                            np.float32),
                                  n_rows, k_max)
    keys = np.asarray([f"ip.dst|{h}" for h in hosts])
    sel_h = np.searchsorted(E.col, keys)
    check(bool((E.col[np.minimum(sel_h, n_cols - 1)] == keys).all()),
          f"a detect_c2 host has no ip.dst column: {hosts}")
    rng = np.random.default_rng(3)
    evs_h = rng.uniform(-1.5, 1.5, ec_h.shape).astype(np.float32)
    neg = ec_h == sel_h[0]                 # the first column: all negative
    evs_h[neg] = -np.abs(evs_h[neg]) - 0.25
    evs_h[ec_h < 0] = 0.0
    ec, ev, evs, sel = (torch.from_numpy(a).to(dev) for a in
                        (ec_h, ev_h, evs_h, sel_h.astype(np.int32)))
    onehot = onehot_of(sel, n_cols)

    def calls(t):
        """The phase's kernel calls on the tensors ``t`` (card or CPU)."""
        return {
            "col_segsum": segsum(t["cols"], t["ones"], n_cols),
            "col_windowed": segsum_windowed(t["sorted_cols"], t["ones"],
                                            n_cols),
            "row_windowed": segsum_windowed(t["rows"], t["ones"], n_rows),
            "sel_plus": kspmm.spgemm_sel(t["ec"], t["ev"], t["sel"]),
            "spmm_plus": kspmm.spmm_ell(t["ec"], t["ev"], t["onehot"]),
            "sel_max": kspmm.spgemm_sel(t["ec"], t["evs"], t["sel"],
                                        ring="max_times"),
            "spmm_max": kspmm.spmm_ell(t["ec"], t["evs"], t["onehot"],
                                       ring="max_times"),
        }

    inputs = dict(cols=cols, ones=ones, sorted_cols=sorted_cols, rows=rows,
                  ec=ec, ev=ev, evs=evs, sel=sel, onehot=onehot)
    card = step_timed(times, "kernels", lambda: calls(inputs))
    launches = ops.kernel_launches()
    want = dict(PIPE_LAUNCHES)
    want.update({k: 0 for k in launches if k not in PIPE_LAUNCHES})
    check(launches == want, f"pipeline phase launches {launches}, want "
          f"{want}")
    got = {k: x.cpu() for k, x in card.items()}
    for name in ("col_segsum", "col_windowed"):
        check(torch.equal(got[name], want_col),
              f"{name}: differs from TedgeDeg by "
              f"{float((got[name] - want_col).abs().max())}")
    check(torch.equal(got["row_windowed"], want_row),
          "row_windowed: differs from E's per-packet field counts")
    degs = torch.tensor([db.degree(k) for k in keys.tolist()],
                        dtype=torch.float32)
    check(torch.equal(got["sel_plus"].sum(0), degs),
          f"spgemm_sel column sums {got['sel_plus'].sum(0).tolist()} != "
          f"db.degree {degs.tolist()}")
    check(torch.equal(got["sel_plus"], got["spmm_plus"]),
          "spgemm_sel differs from spmm_ell against the one-hot X")
    check(torch.equal(card["sel_max"], spgemm_sel_ref(ec, evs, sel,
                                                      "max_times")),
          "spgemm_sel max_times differs from its plain version")
    hit = torch.from_numpy(neg.any(1))
    check(bool(hit.any()) and bool((got["sel_max"][hit, 0] < 0).all()) and
          bool((got["spmm_max"][hit, 0] == 0).all()),
          "negative-only column: spgemm_sel must keep it, spmm_ell clamp it")
    host = {k: x.cpu() for k, x in inputs.items()}
    cpu = calls(host)
    for name, x in cpu.items():
        check(torch.equal(x, got[name]), f"{name}: card and CPU differ")
    log(f"[pipeline] kernel launches {launches}; column degrees of "
        f"{n_cols} keys and field counts of {n_rows} packets equal "
        f"TedgeDeg and E; spgemm_sel over ELL {tuple(ec.shape)} x {SEL_B}: "
        f"column sums {degs.tolist()} equal db.degree and spmm_ell; "
        f"{int(hit.sum())} packets keep the negative column; CPU agrees")

    main = {
        "segsum": measure_segsum("segsum", cols, ones, n_cols),
        "segsum_windowed": measure_segsum("segsum_windowed", sorted_cols,
                                          ones, n_cols),
        "spgemm_sel": measure_sel(ec, ev, sel, "plus_times", n_cols,
                                  library=True),
    }
    for name, m in main.items():
        log(f"[pipeline] {name} at {m['shape']}: kernel {m['ms']:.4f} ms, "
            f"plain {m['plain_ms']:.4f} ms, library {m['library_ms']} ms, "
            f"bound {m['bound_ms']:.5f} ms"
            + (f"; device {m['device_ms']:.4f} ms {m['device_split_ms']}, "
               f"wrapper host {m['host_ms']:.4f} ms, against float64 "
               f"{m['err_vs_f64']['kernel']} ({m['tol_used_f64']:.4f} of "
               f"the tolerance)" if "device_ms" in m else ""))
    return dict(launches=launches, main_shapes=main)


# ---------------------------------------------------------------------------
# Phase 5: wkv6 at the serve shape and at a long sequence.
# ---------------------------------------------------------------------------

def wkv_inputs(shape, dev, seed: int = 0, clip_floor: bool = False):
    """r, k, v normal; w in (0.45, 0.95), or every w at the model's clip
    floor; u x 0.1."""
    g = torch.Generator(device=dev).manual_seed(seed)
    r, k, v = (torch.randn(shape, generator=g, device=dev) for _ in range(3))
    w = torch.sigmoid(torch.randn(shape, generator=g, device=dev)) * 0.5 \
        + 0.45
    if clip_floor:
        w = torch.full_like(w, WKV_CLIP_FLOOR)
    u = torch.randn(shape[2:], generator=g, device=dev) * 0.1
    return r, k, v, w, u


def wkv_bound(shape) -> tuple[float, str]:
    """Least time for one WKV-6 call on an H100: r, k, v, w and u read
    once, o and the final state written once, fp32; 4*Dh^2 flops per
    (b, t, h) (r^T S and the state update, as multiply-adds)."""
    b, s, h, dh = shape
    n_bytes = 4 * (5 * b * s * h * dh + h * dh + b * h * dh * dh)
    return bound_of(n_bytes, 4 * dh * dh * b * s * h)


def measure_wkv6(r, k, v, w, u, plain_iters: int) -> dict:
    """Kernel against its plain version on the same inputs (output and
    final state), then both timed; raises beyond tolerance."""
    got = wkv6(r, k, v, w, u)
    want = wkv6_ref(r, k, v, w, u)
    torch.cuda.synchronize()
    err, scale = 0.0, {}
    for name, g, x in zip(("output", "state"), got, want):
        check(g.shape == x.shape and bool(torch.isfinite(g).all()),
              f"wkv6 {name}: shape {tuple(g.shape)} / non-finite")
        err = max(err, float((g - x).abs().max()))
        scale[name] = float(x.abs().max())
        atol = WKV_ATOL * max(1.0, scale[name])
        check(torch.allclose(g, x, rtol=WKV_RTOL, atol=atol),
              f"wkv6 {name}: max abs err {float((g - x).abs().max())} "
              f"beyond rtol={WKV_RTOL}, atol={atol}")
    out = {"shape": list(r.shape), "max_abs_err": err, "max_abs": scale,
           "ms": timed_ms(lambda: wkv6(r, k, v, w, u)),
           "plain_ms": timed_ms(lambda: wkv6_ref(r, k, v, w, u),
                                iters=plain_iters, warmup=1),
           "library_ms": None}
    out["bound_ms"], out["bound_by"] = wkv_bound(r.shape)
    return out


def wkv6_at_shapes(dev: torch.device) -> list:
    """The serve and long shapes, then the serve shape at the clip floor."""
    results = []
    for shape, floor in [(s, False) for s in WKV_SHAPES] + \
            [(WKV_SHAPES[0], True)]:
        m = measure_wkv6(*wkv_inputs(shape, dev, clip_floor=floor),
                         plain_iters=3)
        m["clip_floor"] = floor
        results.append(m)
        log(f"[wkv6] {shape}{' w at the clip floor' if floor else ''}: "
            f"kernel {m['ms']:.4f} ms, plain "
            f"{m['plain_ms']:.4f} ms, bound {m['bound_ms']:.4f} ms "
            f"({m['bound_by']}), max abs err {m['max_abs_err']:.3g} "
            f"(max |plain| {m['max_abs']})")
    return results


# ---------------------------------------------------------------------------
# Phase 6: serve rwkv6-1.6b at full width.
# ---------------------------------------------------------------------------

class ServeRecorder:
    """Time, and keep what they return, the model calls that the serving
    entry point makes (``serve.prefill``, ``serve.decode_step``), with the
    kernel launches inside each (a dict by kernel); keep the arguments of
    the first call of each wrapper in ``wrappers`` (kernel name ->
    (module, attribute) where the model resolves it).  The wrapped
    functions still run and count.  While it records, every decode step
    runs eagerly (``serve.capturable`` reads False), so that each step
    calls the wrapper: a step replayed from a CUDA graph calls nothing."""

    def __init__(self, wrappers: dict):
        self.wrappers = wrappers
        self.steps: list = []          # (batch, logits, ms, launches)
        self.args: dict = {}           # kernel -> (args, kwargs)

    def _timed(self, fn, *args, **kw):
        k0 = ops.kernel_launches()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn(*args, **kw)
        torch.cuda.synchronize()
        k1 = ops.kernel_launches()
        return out, time.perf_counter() - t0, {k: k1[k] - k0[k] for k in k1}

    def _prefill(self, params, batch, cfg, s_max):
        (logits, caches), self.prefill_s, self.prefill_launches = \
            self._timed(self._orig["prefill"], params, batch, cfg,
                        s_max=s_max)
        self.batch, self.logits, self.caches = batch, logits, caches
        return logits, caches

    def _decode(self, params, caches, batch, cfg):
        (logits, caches), sec, n = self._timed(self._orig["decode_step"],
                                               params, caches, batch, cfg)
        self.steps.append((batch, logits, sec * 1e3, n))
        self.last_caches = caches
        return logits, caches

    def _spy(self, name, fn):
        def spy(*args, **kw):
            if name not in self.args:
                self.args[name] = (tuple(a.clone() if isinstance(
                    a, torch.Tensor) else a for a in args), dict(kw))
            return fn(*args, **kw)
        return spy

    def __enter__(self):
        self._orig = {"prefill": serve.prefill,
                      "decode_step": serve.decode_step,
                      "capturable": serve.capturable}
        serve.prefill, serve.decode_step = self._prefill, self._decode
        serve.capturable = lambda *a: False
        for name, (mod, attr) in self.wrappers.items():
            self._orig[name] = getattr(mod, attr)
            setattr(mod, attr, self._spy(name, self._orig[name]))
        return self

    def __exit__(self, *exc):
        serve.prefill = self._orig["prefill"]
        serve.decode_step = self._orig["decode_step"]
        serve.capturable = self._orig["capturable"]
        for name, (mod, attr) in self.wrappers.items():
            setattr(mod, attr, self._orig[name])
        return False


def serve_prompts(n: int = SERVE_PROMPT_BYTES) -> list:
    """Packet-log text (the port's synthetic window as TSV), cut into
    ``SERVE_BATCH`` prompts of ``n`` ASCII bytes."""
    text = records_to_tsv(synth_packets(TrafficConfig(**MAIN_CFG), 2.0))
    prompts = [text[i * n:(i + 1) * n] for i in range(SERVE_BATCH)]
    check(all(len(p.encode()) == n for p in prompts),
          "serve prompts are not all ASCII of the full length")
    return prompts


def profiled_kernels(fn, iters: int = 1,
                     cpu: bool = True) -> tuple[dict, int]:
    """``iters`` calls of ``fn`` under ``torch.profiler``: the device time
    a call of each CUDA kernel (and memset) it ran, by name, in ms (one
    stream, so the times add up), and the number of kernels run.
    ``cpu=False`` traces the device alone, which costs far less for a
    call of tens of thousands of kernels."""
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    acts = ([ProfilerActivity.CPU] if cpu else []) + [ProfilerActivity.CUDA]
    with profile(activities=acts) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    split: dict = {}
    kernels = [e for e in prof.events()
               if e.device_type == torch.autograd.DeviceType.CUDA]
    for e in kernels:
        split[e.name] = split.get(e.name, 0.0) + \
            e.time_range.elapsed_us() / 1e3 / iters
    return split, len(kernels)


def device_share(fn, host_ms: float) -> dict:
    """One call of ``fn`` under ``torch.profiler``: the CUDA kernels it
    ran, their summed device time, and that time's share of ``host_ms``,
    the call's time measured without the profiler.  ``None`` values when
    the profiler saw no device work."""
    split, n_kernels = profiled_kernels(fn)
    if not n_kernels:
        return {"device_kernels": None, "device_ms": None, "busy": None}
    busy_ms = sum(split.values())
    return {"device_kernels": n_kernels, "device_ms": busy_ms,
            "busy": busy_ms / host_ms}


def n_tensor_params(params: dict) -> int:
    """Entries of every parameter tensor (the tree's leaves)."""
    return sum(t.numel() for t in tree_leaves(params))


def rel_err(got: torch.Tensor, want: torch.Tensor) -> float:
    return float((got.float() - want.float()).norm() / want.float().norm())


def logit_err(cfg, got: torch.Tensor, want: torch.Tensor) -> float:
    """:func:`rel_err` over the config's real vocabulary: the padding
    columns hold -1e9 in both and would swamp the norm."""
    return rel_err(got[..., :cfg.vocab], want[..., :cfg.vocab])


def make_model(arch: str, dev: torch.device, tag: str,
               param_dtype: torch.dtype = None, **impls):
    """The full-width config of ``arch`` with ``impls`` and its seeded
    random parameters on the card, each layer cast to ``param_dtype``
    (if given) as it is made."""
    cfg = dataclasses.replace(get_config(arch), **impls)
    t0 = time.perf_counter()
    place = None if param_dtype is None else \
        (lambda path, sub: tree_map(lambda t: t.to(param_dtype), sub))
    params = init_params(cfg, torch.Generator(device=dev).manual_seed(0),
                         place=place)
    torch.cuda.synchronize()
    log(f"[{tag}] {cfg.name}: {cfg.n_layers} layers "
        f"{''.join(cfg.layer_types())}, d_model {cfg.d_model}, "
        f"{cfg.n_heads} heads ({cfg.n_kv_heads} kv) of "
        f"{cfg.resolved_head_dim}, d_ff {cfg.d_ff}, vocab {cfg.vocab}, "
        f"{cfg.dtype}; {n_tensor_params(params) / 1e9:.3f}"
        f" B params made in {time.perf_counter() - t0:.2f} s")
    return cfg, params


def recorded_generate(cfg, params, wrappers: dict, tag: str,
                      prompt_bytes: int = SERVE_PROMPT_BYTES,
                      s_max: int = SERVE_S_MAX, new: int = SERVE_NEW):
    """One warm-up ``generate``, then the recorded one (``new`` decode
    steps, every one
    eager) and the served one (decode steps replayed from a CUDA graph
    where ``serve.capturable`` holds), each with the launch counts zeroed
    just before and read just after; checks the shapes, the logits, that
    decode launched no kernel, and that the served run counts its decode
    paths and gives the recorded run's launch counts and, where the
    graph engaged, its text.  Returns (recorder, the served run's
    launches, times, device shares)."""
    prompts = serve_prompts(prompt_bytes)
    serve.generate(cfg, params, prompts, max_new=2, s_max=s_max)

    ops.reset_launches()
    with ServeRecorder(wrappers) as rec:
        t0 = time.perf_counter()
        outs = serve.generate(cfg, params, prompts, max_new=new,
                              s_max=s_max)
        torch.cuda.synchronize()
        total_s = time.perf_counter() - t0
    eager_launches = ops.kernel_launches()
    check(len(rec.steps) == new and
          all(not any(n.values()) for *_, n in rec.steps),
          f"[{tag}] decode launched a kernel")

    fits = serve.capturable(cfg, rec.caches, params["embed"].device)
    want = ({"captured": 1, "replayed": new - 2, "eager": 1} if fits
            else {"captured": 0, "replayed": 0, "eager": new})
    g0 = serve.decode_graph_counts()
    ops.reset_launches()
    served = serve.generate(cfg, params, prompts, max_new=new,
                            s_max=s_max)
    launches = ops.kernel_launches()
    g1 = serve.decode_graph_counts()
    paths = {p: g1[p] - g0[p] for p in g1}
    log(f"[{tag}] kernel launches {launches}, in prefill "
        f"{rec.prefill_launches}; decode steps by path {paths}")
    check(paths == want, f"[{tag}] decode paths {paths}, want {want}")
    same = sum(a == b for a, b in zip(served, outs))
    log(f"[{tag}] served text equals the eager loop's in {same} of "
        f"{len(outs)} prompts")
    # Unreplayed, both runs are the eager loop, and a bfloat16 MoE's
    # combine (index_add atomics) may round in another order each run.
    check(same == len(outs) or not fits,
          f"[{tag}] replayed decode's text differs from the eager loop's")
    check(launches == eager_launches, f"[{tag}] kernel launches served "
          f"{launches}, eager loop {eager_launches}")
    b, s = rec.batch["tokens"].shape
    check((b, s) == (SERVE_BATCH, prompt_bytes + 1) and
          len(outs) == SERVE_BATCH, f"[{tag}] shapes {(b, s)}, {len(outs)}")
    check(rec.logits.shape == (b, 1, cfg.padded_vocab) and
          all(bool(torch.isfinite(lg).all()) for lg in
              [rec.logits] + [step[1] for step in rec.steps]),
          f"[{tag}] logits: shape / non-finite")

    decode_ms = sum(ms for *_, ms, _ in rec.steps) / len(rec.steps)
    times = {"prefill_s": rec.prefill_s,
             "prefill_tok_per_s": b * s / rec.prefill_s,
             "decode_ms_per_step": decode_ms,
             "decode_tok_per_s": b / decode_ms * 1e3,
             "generate_s": total_s,
             "generate_tok_per_s": b * new / total_s}
    log(f"[{tag}] prefill {b}x{s} tokens: {rec.prefill_s:.4f} s "
        f"({times['prefill_tok_per_s']:.0f} tok/s); decode "
        f"{decode_ms:.3f} ms per step of {b} tokens "
        f"({times['decode_tok_per_s']:.1f} tok/s); generate {b}x{new}"
        f" new tokens in {total_s:.3f} s "
        f"({times['generate_tok_per_s']:.1f} tok/s)")

    busy = {
        "prefill": device_share(lambda: model.prefill(
            params, rec.batch, cfg, s_max=s_max), rec.prefill_s * 1e3),
        "decode_step": device_share(lambda: model.decode_step(
            params, rec.last_caches, rec.steps[-1][0], cfg), decode_ms)}
    for name, d in busy.items():
        log(f"[{tag}] profiled {name}: {d['device_kernels']} device "
            f"kernels, {d['device_ms']} ms on the device, busy share "
            f"{d['busy']}")
    return rec, launches, times, busy


def teacher_forced(params, rec: ServeRecorder, plain, tag: str,
                   s_max: int = SERVE_S_MAX):
    """The plain path on the same weights over the kernel path's tokens:
    its prefill caches, and the relative norm errors of the prefill
    logits and every decode step's logits; it must launch no kernel."""
    k0 = ops.kernel_launches()
    logits, caches = model.prefill(params, rec.batch, plain, s_max=s_max)
    prefill_caches = caches
    errs = {"prefill_logits": logit_err(plain, rec.logits, logits),
            "decode_logits": []}
    for batch, want, *_ in rec.steps:
        logits, caches = model.decode_step(params, caches, batch, plain)
        errs["decode_logits"].append(logit_err(plain, want, logits))
    torch.cuda.synchronize()
    check(ops.kernel_launches() == k0, f"[{tag}] plain path launched a "
          f"kernel: {k0} -> {ops.kernel_launches()}")
    return prefill_caches, errs


def serve_path(dev: torch.device) -> dict:
    """Generate through ``repro_torch.launch.serve`` with the wkv6 kernel
    in prefill, then hold it against the plain (chunked) path on the same
    weights, teacher-forced over the kernel path's tokens."""
    cfg, params = make_model(SERVE_ARCH, dev, "serve", rwkv_impl="pallas")
    rec, launches, times, busy = recorded_generate(
        cfg, params, {"wkv6": (blocks, "wkv6")}, "serve")
    check(launches["wkv6"] == cfg.n_layers and
          rec.prefill_launches["wkv6"] == cfg.n_layers,
          f"wkv6 launches {launches['wkv6']} (prefill "
          f"{rec.prefill_launches}), want one per layer = {cfg.n_layers}")

    plain = dataclasses.replace(cfg, rwkv_impl="chunked")
    caches, errs = teacher_forced(params, rec, plain, "serve")
    w0, p0 = rec.caches[0].wkv, caches[0].wkv
    check(torch.allclose(w0, p0, rtol=FORMS_RTOL, atol=FORMS_ATOL),
          f"layer 0 WKV state: max abs err {float((w0 - p0).abs().max())}"
          f" beyond rtol={FORMS_RTOL}, atol={FORMS_ATOL}")
    errs["layer0_state_max_abs"] = float((w0 - p0).abs().max())
    errs["state"] = [rel_err(a.wkv, c.wkv)
                     for a, c in zip(rec.caches, caches)]
    worst = max([errs["prefill_logits"]] + errs["state"] +
                errs["decode_logits"])
    log(f"[serve] kernel vs plain path, relative norm error: prefill "
        f"logits {errs['prefill_logits']:.3g}, states "
        f"{min(errs['state']):.3g}..{max(errs['state']):.3g}, decode "
        f"logits {min(errs['decode_logits']):.3g}.."
        f"{max(errs['decode_logits']):.3g}; layer 0 state max abs "
        f"{errs['layer0_state_max_abs']:.3g}")
    check(worst <= SERVE_REL,
          f"kernel and plain serve paths differ by {worst:.3g} > {SERVE_REL}")

    main_shape = measure_wkv6(*rec.args["wkv6"][0], plain_iters=3)
    log(f"[serve] wkv6 on layer 0's inputs {main_shape['shape']}: kernel "
        f"{main_shape['ms']:.4f} ms, plain {main_shape['plain_ms']:.4f} ms,"
        f" max abs err {main_shape['max_abs_err']:.3g} (max |plain| "
        f"{main_shape['max_abs']})")
    return dict(launches=launches["wkv6"], times=times, errs=errs,
                busy=busy, main_shape=main_shape)


# ---------------------------------------------------------------------------
# Phase 7: rglru_scan at the serve shape and at a long sequence.
# ---------------------------------------------------------------------------

def rglru_inputs(shape, dev, seed: int = 0):
    """a = exp(-8 softplus(Λ) r) with Λ the model's init (0.9..5 over the
    channels) and r a sigmoid of a normal; b = 0.1 normal."""
    g = torch.Generator(device=dev).manual_seed(seed)
    lam = torch.linspace(0.9, 5.0, shape[2], device=dev)
    r = torch.sigmoid(torch.randn(shape, generator=g, device=dev))
    a = torch.exp(-8.0 * torch.nn.functional.softplus(lam) * r)
    b = torch.randn(shape, generator=g, device=dev) * 0.1
    return a, b


def rglru_bound(shape) -> tuple[float, str]:
    """Least time for one scan on an H100: a and b read once and the
    states written once, fp32; a multiply and an add per element."""
    n = shape[0] * shape[1] * shape[2]
    return bound_of(12 * n, 2 * n)


def measure_rglru(a, b, plain_iters: int) -> dict:
    """Kernel against its plain version on the same inputs (equal bit for
    bit), then both timed; raises on any difference."""
    got = rglru_scan(a, b)
    want = rglru_scan_ref(a, b)
    torch.cuda.synchronize()
    check(got.shape == want.shape and bool(torch.isfinite(got).all()),
          f"rglru_scan: shape {tuple(got.shape)} / non-finite")
    err = float((got - want).abs().max())
    check(torch.equal(got, want), f"rglru_scan: max abs err {err}, want 0")
    out = {"shape": list(a.shape), "max_abs_err": err,
           "max_abs": float(want.abs().max()),
           "ms": timed_ms(lambda: rglru_scan(a, b)),
           "plain_ms": timed_ms(lambda: rglru_scan_ref(a, b),
                                iters=plain_iters, warmup=1),
           "library_ms": None}
    out["bound_ms"], out["bound_by"] = rglru_bound(a.shape)
    return out


def rglru_at_shapes(dev: torch.device) -> list:
    results = []
    for shape, plain_iters in zip(RGLRU_SHAPES, (3, 1)):
        m = measure_rglru(*rglru_inputs(shape, dev), plain_iters=plain_iters)
        results.append(m)
        log(f"[rglru] {shape}: kernel {m['ms']:.4f} ms, plain "
            f"{m['plain_ms']:.4f} ms, bound {m['bound_ms']:.4f} ms "
            f"({m['bound_by']}), max abs err {m['max_abs_err']:.3g}")
    return results


# ---------------------------------------------------------------------------
# Phase 8: flash_attention at the serve shape, a long sequence, GQA f32.
# ---------------------------------------------------------------------------

def flash_inputs(case, dev, seed: int = 0):
    b, s, h, kv, dh, dv, dtype, *_ = case
    g = torch.Generator(device=dev).manual_seed(seed)
    q = torch.randn((b, s, h, dh), generator=g, device=dev)
    k = torch.randn((b, s, kv, dh), generator=g, device=dev)
    v = torch.nn.functional.pad(
        torch.randn((b, s, kv, dv), generator=g, device=dev), (0, dh - dv))
    return q.to(dtype), k.to(dtype), v.to(dtype)


def visible_pairs(sq: int, sk: int, causal: bool, window: int) -> int:
    """(row, key) pairs a mask lets through, rows and keys at 0..S-1."""
    i = np.arange(sq)
    lo = np.maximum(0, i - window + 1) if window else np.zeros_like(i)
    hi = np.minimum(sk - 1, i) if causal else np.full_like(i, sk - 1)
    return int(np.maximum(0, hi - lo + 1).sum())


def flash_bound(q, k, causal: bool, window: int) -> tuple[float, str]:
    """Least time for one attention call on an H100: q, k, v read and o
    written once; 4*Dh flops per visible (row, key) pair (q.k and p.v)
    at the peak of the inputs' type (bf16 tensor cores, or fp32)."""
    b, sq, h, dh = q.shape
    flops = 4 * dh * b * h * visible_pairs(sq, k.shape[1], causal, window)
    n_bytes = 2 * (q.numel() + k.numel()) * q.element_size()
    return bound_of(n_bytes, flops, BF16_FLOPS if q.dtype == torch.bfloat16
                    else FP32_FLOPS)


def sdpa_call(q, k, v, scale: float = None):
    """The library yardstick: one ``scaled_dot_product_attention`` call,
    causal, at ``scale`` (None: Dh^-0.5), on the same values with k and
    v expanded to q's heads, in its (B, H, S, Dh) layout (prepared
    outside the timed call)."""
    g = q.shape[2] // k.shape[2]
    qt = q.transpose(1, 2)
    kt = k.repeat_interleave(g, dim=2).transpose(1, 2)
    vt = v.repeat_interleave(g, dim=2).transpose(1, 2)
    return lambda: torch.nn.functional.scaled_dot_product_attention(
        qt, kt, vt, is_causal=True, scale=scale)


def band_rel_errs(got: torch.Tensor, want: torch.Tensor) -> list:
    """Relative Frobenius error of got against want (B, Sq, H, Dh) in
    each of FLASH_BANDS equal bands of query positions."""
    sq = want.shape[1]
    out = []
    for i in range(FLASH_BANDS):
        band = slice(i * sq // FLASH_BANDS, (i + 1) * sq // FLASH_BANDS)
        out.append(float((got[:, band] - want[:, band]).norm()
                         / want[:, band].norm().clamp_min(1e-30)))
    return out


def measure_flash(q, k, v, causal: bool = True, window: int = 0,
                  scale: float = None, dv: int = None,
                  plain_iters: int = 5) -> dict:
    """Kernel against its plain version on the same inputs (and, for
    bf16, on the same values in float32), then kernel, plain version and
    (where it computes the same function) the library call timed.
    ``scale`` None is Dh^-0.5; v's columns past ``dv`` (default all) are
    zero, and so must the output's be."""
    dv = dv or v.shape[-1]
    got = flash_attention(q, k, v, causal=causal, window=window,
                          scale=scale)
    want = flash_attention_ref(q, k, v, causal, window, scale)
    torch.cuda.synchronize()
    tag = (f"flash_attention {tuple(q.shape)} kv {k.shape[2]} v {dv} "
           f"{q.dtype} scale {scale}")
    check(got.shape == q.shape and got.dtype == q.dtype and
          bool(torch.isfinite(got).all()), f"{tag}: shape / dtype / "
          f"non-finite")
    check(not got[..., dv:].any(), f"{tag}: output past v's {dv} columns "
          f"not zero")
    tol = FLASH_TOL[q.dtype]
    err = float((got.float() - want.float()).abs().max())
    check(torch.allclose(got.float(), want.float(), rtol=tol, atol=tol),
          f"{tag}: max abs err {err} beyond rtol=atol={tol}")
    out = {"shape": list(q.shape), "kv_heads": k.shape[2], "v_dim": dv,
           "scale": scale, "dtype": str(q.dtype).replace("torch.", ""),
           "causal": causal, "window": window, "max_abs_err": err}
    if q.dtype != torch.float32:
        want32 = flash_attention_ref(q.float(), k.float(), v.float(), causal,
                                     window, scale)
        err32 = float((got.float() - want32).abs().max())
        check(torch.allclose(got.float(), want32, rtol=FLASH_F32_TOL,
                             atol=FLASH_F32_TOL),
              f"{tag}: max abs err {err32} against float32 arithmetic "
              f"beyond rtol=atol={FLASH_F32_TOL}")
        out["max_abs_err_vs_f32"] = err32
        bands = band_rel_errs(got.float(), want32)
        check(max(bands) <= FLASH_BAND_TOL,
              f"{tag}: relative Frobenius error against float32 arithmetic "
              f"by quarter of query positions {bands} beyond "
              f"{FLASH_BAND_TOL}")
        out["band_rel_err_vs_f32"] = bands
        del want32
    del got, want
    out["ms"] = timed_ms(lambda: flash_attention(q, k, v, causal=causal,
                                                 window=window, scale=scale))
    out["plain_ms"] = timed_ms(lambda: flash_attention_ref(
        q, k, v, causal, window, scale), iters=plain_iters, warmup=1)
    same = causal and (window == 0 or window >= q.shape[1])
    out["library_ms"] = timed_ms(sdpa_call(q, k, v, scale)) if same \
        else None
    out["bound_ms"], out["bound_by"] = flash_bound(q, k, causal, window)
    return out


def flash_at_shapes(dev: torch.device) -> list:
    results = []
    for case in FLASH_CASES:
        *_, dv, _, causal, window, scale = case
        m = measure_flash(*flash_inputs(case, dev), causal=causal,
                          window=window, scale=scale, dv=dv)
        results.append(m)
        log(f"[flash] {m['shape']} kv {m['kv_heads']} v {dv} {m['dtype']} "
            f"causal {causal} window {window} scale {scale}: kernel "
            f"{m['ms']:.4f} ms, plain "
            f"{m['plain_ms']:.4f} ms, library {m['library_ms']} ms, bound "
            f"{m['bound_ms']:.4f} ms ({m['bound_by']}), max abs err "
            f"{m['max_abs_err']:.3g}, band errors against float32 "
            f"{m.get('band_rel_err_vs_f32')}")
    return results


# ---------------------------------------------------------------------------
# Phase 9: serve recurrentgemma-9b at full width.
# ---------------------------------------------------------------------------

def rg_serve_path(dev: torch.device) -> dict:
    """Generate through ``repro_torch.launch.serve`` with rglru_scan and
    flash_attention in prefill, then hold it against the plain path (log-
    depth scan, naive attention) on the same weights, teacher-forced over
    the kernel path's tokens."""
    torch.cuda.reset_peak_memory_stats()
    cfg, params = make_model(RG_ARCH, dev, "rg-serve", rglru_impl="pallas",
                             attention_impl="pallas")
    types = cfg.layer_types()
    n_r, n_l = types.count("R"), types.count("L")
    check((n_r, n_l) == (26, 12), f"layer types {types}")
    rec, launches, times, busy = recorded_generate(
        cfg, params, {"rglru_scan": (blocks, "rglru_scan"),
                      "flash_attention": (layers, "flash_attention")},
        "rg-serve")
    want = {k: 0 for k in launches}
    want.update(rglru_scan=n_r, flash_attention=n_l)
    check(launches == want and rec.prefill_launches == want,
          f"launches {launches} (prefill {rec.prefill_launches}), want "
          f"{want}")
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    log(f"[rg-serve] peak device memory {peak_gb:.2f} GB")

    plain = dataclasses.replace(cfg, rglru_impl="scan",
                                attention_impl="chunked")
    caches, errs = teacher_forced(params, rec, plain, "rg-serve")
    h0, p0 = rec.caches[0].h, caches[0].h
    errs["layer0_state_max_abs"] = float((h0 - p0).abs().max())
    check(torch.allclose(h0, p0, rtol=RG_STATE_TOL, atol=RG_STATE_TOL),
          f"layer 0 RG-LRU state: max abs err "
          f"{errs['layer0_state_max_abs']} beyond rtol=atol={RG_STATE_TOL}")
    errs["cache"] = []
    for li, (a, c) in enumerate(zip(rec.caches, caches)):
        for name, x, y in zip(a._fields, a, c):
            if name in ("pos", "index"):
                check(x == y if name == "index" else torch.equal(x, y),
                      f"layer {li} cache {name} differs")
            else:
                errs["cache"].append(rel_err(x, y))
    worst = max([errs["prefill_logits"]] + errs["cache"] +
                errs["decode_logits"])
    log(f"[rg-serve] kernel vs plain path, relative norm error: prefill "
        f"logits {errs['prefill_logits']:.3g}, caches "
        f"{min(errs['cache']):.3g}..{max(errs['cache']):.3g}, decode "
        f"logits {min(errs['decode_logits']):.3g}.."
        f"{max(errs['decode_logits']):.3g}; layer 0 state max abs "
        f"{errs['layer0_state_max_abs']:.3g}")
    check(worst <= SERVE_REL,
          f"kernel and plain serve paths differ by {worst:.3g} > {SERVE_REL}")

    args, _ = rec.args["rglru_scan"]
    main_rglru = measure_rglru(*args, plain_iters=3)
    args, kw = rec.args["flash_attention"]
    main_flash = measure_flash(*args, **kw)
    for name, m in (("rglru_scan", main_rglru),
                    ("flash_attention", main_flash)):
        log(f"[rg-serve] {name} on its first layer's inputs {m['shape']}: "
            f"kernel {m['ms']:.4f} ms, plain {m['plain_ms']:.4f} ms, "
            f"library {m['library_ms']}, max abs err {m['max_abs_err']:.3g}, "
            f"band errors against float32 {m.get('band_rel_err_vs_f32')}")
    return dict(launches=launches, times=times, errs=errs, busy=busy,
                peak_gb=peak_gb, main_rglru=main_rglru,
                main_flash=main_flash)


# ---------------------------------------------------------------------------
# Phase 15: serve the MoE, encoder-decoder, vision and latent-attention
# families.
# ---------------------------------------------------------------------------

def host_and_device_ms(fn) -> dict:
    """One timed call of ``fn`` (host clock around a synchronized call),
    then one under ``torch.profiler`` (:func:`device_share`)."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fn()
    torch.cuda.synchronize()
    host_ms = (time.perf_counter() - t0) * 1e3
    return dict(device_share(fn, host_ms), host_ms=host_ms)


def family_model(arch: str, dev, tag: str, **impls):
    """:func:`make_model` with the peak-memory counter reset first and
    the parameter tensors counted against :data:`FAMILY_PARAMS`."""
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    cfg, params = make_model(arch, dev, tag, **impls)
    n = n_tensor_params(params)
    check(n == FAMILY_PARAMS[arch], f"[{tag}] {n} parameter entries, want "
          f"{FAMILY_PARAMS[arch]}")
    return cfg, params


def family_summary(tag: str, cfg, times: dict, busy: dict, **extra) -> dict:
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    log(f"[{tag}] peak device memory {peak_gb:.2f} GB")
    return dict(arch=cfg.name, times=times, device=busy, peak_gb=peak_gb,
                **extra)


def moe_serve(dev) -> dict:
    """(a) granite-moe-3b-a800m at full width through the serving entry
    point: no kernel launched (24 heads padded to 32: a head->kv map,
    which the flash_attention precondition refuses); the share of layer
    0's prefill (token, choice) pairs past capacity; the bf16 prefill
    logits against a float32 prefill on the same weights, held over the
    first MOE_F32_LAYERS layers and logged over all."""
    cfg, params = family_model(MOE_ARCH, dev, "moe", attention_impl="pallas")
    rec, launches, times, busy = recorded_generate(
        cfg, params, {"apply_moe": (blocks, "apply_moe")}, "moe")
    check(not any(launches.values()), f"[moe] kernel launches {launches}")
    m = cfg.moe
    p, x, _ = rec.args["apply_moe"][0]
    C = blocks.moe_capacity(m, x.shape[1])

    def layer0_routing(x, c):
        h = layers.rms_norm(x, blocks._c(p["ln"], c), c.norm_eps)
        probs = torch.softmax(h.float() @ p["router"].float(), dim=-1)
        return blocks._token_choice_dispatch(probs, m.top_k, C)

    # the float32 prefill on the same weights, its layer-0 MoE input kept
    cfg32 = dataclasses.replace(cfg, dtype="float32")
    first = {}
    real = blocks.apply_moe

    def spy(p_, x_, c_):
        first.setdefault("x", x_)
        return real(p_, x_, c_)

    blocks.apply_moe = spy
    try:
        logits32, _ = model.prefill(params, rec.batch, cfg32,
                                    s_max=SERVE_S_MAX)
    finally:
        blocks.apply_moe = real
    errs = {cfg.n_layers: logit_err(cfg, rec.logits, logits32)}
    del logits32
    for n in MOE_F32_LOGGED:
        cut = dict(params, layers=params["layers"][:n])
        cfg_cut = dataclasses.replace(cfg, n_layers=n)
        l16, _ = model.prefill(cut, rec.batch, cfg_cut, s_max=SERVE_S_MAX)
        l32, _ = model.prefill(cut, rec.batch, dataclasses.replace(
            cfg_cut, dtype="float32"), s_max=SERVE_S_MAX)
        errs[n] = logit_err(cfg, l16, l32)
    err = errs[MOE_F32_LAYERS]
    slot, keep, _ = layer0_routing(x, cfg)
    dropped = 1.0 - float(keep.float().mean())
    slot32, keep32, _ = layer0_routing(first["x"], cfg32)
    same_expert = float((slot // C == slot32 // C).float().mean())
    log(f"[moe] layer 0 prefill routing: C = {C} slots an expert, "
        f"{dropped:.4%} of {keep.numel()} (token, choice) pairs dropped by "
        f"capacity (float32 input: {1.0 - float(keep32.float().mean()):.4%})"
        f", {same_expert:.4%} of pairs on the same expert in bf16 and "
        f"float32; bf16 prefill logits against float32, relative norm "
        f"error by the number of layers run {errs} (limit {MOE_F32_REL} "
        f"over {MOE_F32_LAYERS})")
    check(err <= MOE_F32_REL, f"[moe] bf16 against float32 prefill logits "
          f"over {MOE_F32_LAYERS} layer(s) {err:.4g} > {MOE_F32_REL}")
    return family_summary("moe", cfg, times, busy, launches=launches,
                          capacity=C, dropped_share=dropped,
                          same_expert_bf16_f32=same_expert,
                          f32_rel_err_by_layers=errs)


def mla_serve(dev) -> dict:
    """(d) deepseek-v2-lite at full width and depth through the entry
    point, its parameters in bfloat16 (as it is served): one
    ``flash_attention`` launch a layer, all in prefill (the decompressed
    form); decode over the latent rings (the absorbed form) replayed
    from one CUDA graph a call, 1 eager / 1 captured / MLA_NEW - 2
    replayed steps, its text equal to the eager loop's
    (:func:`recorded_generate`); then one more served call, in which
    each layer's two eager decode steps (the first and the captured
    one) count on the latent route and the replays count nothing."""
    cfg, params = family_model(MLA_ARCH, dev, "mla",
                               param_dtype=torch.bfloat16)
    rec, launches, times, busy = recorded_generate(cfg, params, {}, "mla",
                                                   new=MLA_NEW)
    n = cfg.n_layers
    check(launches["flash_attention"] == n and
          rec.prefill_launches["flash_attention"] == n,
          f"[mla] flash_attention launches {launches} (prefill "
          f"{rec.prefill_launches}), want one a layer = {n}")
    g0, a0 = serve.decode_graph_counts(), blocks.attn_decode_counts()
    serve.generate(cfg, params, rec.batch["tokens"], max_new=MLA_NEW,
                   s_max=SERVE_S_MAX)
    paths = {p: c - g0[p] for p, c in serve.decode_graph_counts().items()}
    latent = blocks.attn_decode_counts()["latent"] - a0["latent"]
    log(f"[mla] a served call of {MLA_NEW}: decode steps by path {paths}, "
        f"{latent} latent decode attention calls over {n} layers")
    check(paths == {"captured": 1, "replayed": MLA_NEW - 2, "eager": 1}
          and latent == 2 * n, f"[mla] decode paths {paths}, latent "
          f"calls {latent}, want 1/{MLA_NEW - 2}/1 and {2 * n}")
    return family_summary("mla", cfg, times, busy, launches=launches,
                          decode_paths=paths, latent_calls=latent)


def encdec_serve(dev) -> dict:
    """(b) whisper-large-v3 at full width: generate through the entry
    point (zero frames, as the JAX package's generate), no kernel
    launched; the encoder's device time apart; then seeded normal frames:
    prefill, decode over the generated tokens with the encoder output of
    those frames, teacher-forced against one forward over prompt and
    generated tokens."""
    cfg, params = family_model(ENCDEC_ARCH, dev, "encdec",
                               attention_impl="pallas")
    rec, launches, times, busy = recorded_generate(cfg, params, {}, "encdec")
    check(not any(launches.values()), f"[encdec] kernel launches {launches}")
    busy["encoder"] = host_and_device_ms(lambda: model._encode(
        params, rec.batch["frames"], cfg, "prefill"))
    log(f"[encdec] encoder over {tuple(rec.batch['frames'].shape)} frames: "
        f"{busy['encoder']}")

    k0 = ops.kernel_launches()
    g = torch.Generator(device=dev).manual_seed(1)
    frames = torch.randn(rec.batch["frames"].shape, generator=g, device=dev)
    prompt = rec.batch["tokens"]
    logits, caches = model.prefill(params, {"tokens": prompt,
                                            "frames": frames}, cfg,
                                   s_max=SERVE_S_MAX)
    enc = model._encode(params, frames, cfg, "prefill")
    got = [logits]
    for batch, *_ in rec.steps:
        logits, caches = model.decode_step(params, caches, dict(
            batch, enc_out=enc), cfg)
        got.append(logits)
    gen = torch.cat([b["tokens"] for b, *_ in rec.steps], dim=1)
    x, _ = model.forward(params, {"tokens": torch.cat([prompt, gen], 1),
                                  "frames": frames}, cfg, mode="prefill")
    s = prompt.shape[1]
    errs = [logit_err(cfg, lg, model.logits_from_hidden(
        params, x[:, s - 1 + i:s + i], cfg)) for i, lg in enumerate(got)]
    torch.cuda.synchronize()
    check(ops.kernel_launches() == k0, "[encdec] teacher forcing launched "
          "a kernel")
    log(f"[encdec] seeded frames: prefill and {len(got) - 1} decode steps "
        f"against one forward, relative norm error {min(errs):.3g}.."
        f"{max(errs):.3g} (limit {SERVE_REL})")
    check(max(errs) <= SERVE_REL, f"[encdec] decode against teacher forcing "
          f"{max(errs):.3g} > {SERVE_REL}")
    return family_summary("encdec", cfg, times, busy, launches=launches,
                          tf_rel_err=max(errs))


def vision_serve(dev) -> dict:
    """(c) phi-3-vision-4.2b at full width: 447-byte prompts (S = 448 +
    576 = 1024, where the kernel's precondition holds; 511 bytes would
    give 1088, which it refuses) through the entry point with exactly one
    flash_attention launch a layer, all in prefill; then seeded normal
    image embeddings through the kernel path and the plain path
    (chunked, naive at S = 1024) over the generated tokens."""
    cfg, params = family_model(VISION_ARCH, dev, "vision",
                               attention_impl="pallas")
    for n in (VISION_PROMPT_BYTES, SERVE_PROMPT_BYTES):
        s = n + 1 + cfg.n_img_tokens
        q = torch.empty((SERVE_BATCH, s, cfg.n_heads,
                         cfg.resolved_head_dim), device="meta")
        log(f"[vision] {n}-byte prompts: S = {s}, flash_attention "
            f"precondition {layers._pallas_attention_ok(q, q, cfg.attention_chunk, None)}")
    rec, launches, times, busy = recorded_generate(
        cfg, params, {"flash_attention": (layers, "flash_attention")},
        "vision", prompt_bytes=VISION_PROMPT_BYTES, s_max=VISION_S_MAX)
    want = {k: 0 for k in launches}
    want["flash_attention"] = cfg.n_layers
    check(launches == want and rec.prefill_launches == want,
          f"[vision] launches {launches} (prefill {rec.prefill_launches}), "
          f"want {want}")

    g = torch.Generator(device=dev).manual_seed(2)
    img = torch.randn(rec.batch["img_embeds"].shape, generator=g, device=dev)
    batch = {"tokens": rec.batch["tokens"], "img_embeds": img}
    out = {}
    for name, c in (("kernels", cfg),
                    ("plain", dataclasses.replace(cfg,
                                                  attention_impl="chunked"))):
        k0 = ops.kernel_launches()
        logits, caches = model.prefill(params, batch, c, s_max=VISION_S_MAX)
        lgs = [logits]
        for step, *_ in rec.steps:
            logits, caches = model.decode_step(params, caches, step, c)
            lgs.append(logits)
        torch.cuda.synchronize()
        k1 = ops.kernel_launches()
        out[name] = lgs
        n = k1["flash_attention"] - k0["flash_attention"]
        check(n == (cfg.n_layers if name == "kernels" else 0),
              f"[vision] {name} path: {n} flash_attention launches")
    errs = [logit_err(cfg, a, b)
            for a, b in zip(out["kernels"], out["plain"])]
    log(f"[vision] seeded image embeddings, kernel against plain path: "
        f"prefill logits {errs[0]:.3g}, decode logits {min(errs[1:]):.3g}.."
        f"{max(errs[1:]):.3g} (limit {SERVE_REL})")
    check(max(errs) <= SERVE_REL, f"[vision] kernel and plain paths differ "
          f"by {max(errs):.3g} > {SERVE_REL}")
    args, kw = rec.args["flash_attention"]
    main_flash = measure_flash(*args, **kw)
    log(f"[vision] flash_attention on layer 0's inputs {main_flash['shape']}"
        f": kernel {main_flash['ms']:.4f} ms, plain "
        f"{main_flash['plain_ms']:.4f} ms, library "
        f"{main_flash['library_ms']} ms, bound {main_flash['bound_ms']:.4f}"
        f" ms, band errors {main_flash['band_rel_err_vs_f32']}")
    return family_summary("vision", cfg, times, busy, launches=launches,
                          rel_err=max(errs), main_flash=main_flash)


def smoke_card_vs_cpu(dev) -> dict:
    """(e), (f): qwen3-moe's full parameter tree counted on ``meta``;
    then every family's smoke config (attention_impl="pallas") on the
    card and on the CPU from the same seeded parameters and batch (normal
    frames and image embeddings): float32 prefill logits and 4 decode
    steps' logits within rtol=atol=FAMILY_SMOKE_TOL, layer 0's experts of
    every (token, choice) pair equal (capacity factor 4: no drops)."""
    n = n_tensor_params(model.abstract_params(get_config(QWEN_MOE_ARCH)))
    log(f"[families] {QWEN_MOE_ARCH} full config on meta: {n} parameter "
        f"entries")
    check(n == FAMILY_PARAMS[QWEN_MOE_ARCH], f"{QWEN_MOE_ARCH}: {n} "
          f"parameter entries, want {FAMILY_PARAMS[QWEN_MOE_ARCH]}")
    cpu = torch.device("cpu")
    out = {}
    for arch in (MOE_ARCH, QWEN_MOE_ARCH, ENCDEC_ARCH, VISION_ARCH):
        cfg = dataclasses.replace(smoke_config(arch), attention_impl="pallas")
        params = init_params(cfg, torch.Generator().manual_seed(0))
        # 32 positions in prefill (image prefix included): a multiple of
        # the smoke attention chunk, so every arch reaches the kernel
        offset = cfg.n_img_tokens if cfg.frontend == "vision" else 0
        shape = ShapeConfig("prefill", 32 - offset, 2, "prefill")
        batch = inputs.make_batch(cfg, shape, seed=3, device=cpu)
        steps = np.random.default_rng(4).integers(0, cfg.vocab, (2, 4))
        res = {}
        for where, d in (("cpu", cpu), ("card", dev)):
            set_device(d.type)
            p = tree_map(lambda t: t.to(d), params)
            b = {k: v.to(d) for k, v in batch.items()}
            k0 = ops.kernel_launches()["flash_attention"]
            logits, caches = model.prefill(p, b, cfg, s_max=48)
            lgs = [logits]
            pos = 32
            enc = model._encode(p, b["frames"], cfg, "prefill") \
                if cfg.is_encdec else None
            for i in range(steps.shape[1]):
                db = {"tokens": torch.from_numpy(steps[:, i:i + 1].astype(
                          np.int32)).to(d),
                      "positions": torch.full((2, 1), pos + i,
                                              dtype=torch.int32, device=d)}
                if enc is not None:
                    db["enc_out"] = enc
                logits, caches = model.decode_step(p, caches, db, cfg)
                lgs.append(logits)
            if d.type == "cuda":
                torch.cuda.synchronize()
            n_flash = ops.kernel_launches()["flash_attention"] - k0
            experts = None
            if cfg.moe is not None:      # layer 0's router input, plain
                x, pos, *_ = model._embed_inputs(p, b, cfg, "prefill")
                x, _ = blocks.apply_attn(p["layers"][0]["attn"], x,
                                         blocks.Ctx(pos), dataclasses.replace(
                                             cfg, attention_impl="naive"))
                mlp = p["layers"][0]["mlp"]
                h = layers.rms_norm(x, mlp["ln"], cfg.norm_eps)
                probs = torch.softmax(h @ mlp["router"], dim=-1)
                C = blocks.moe_capacity(cfg.moe, x.shape[1])
                slot, keep, _ = blocks._token_choice_dispatch(
                    probs, cfg.moe.top_k, C)
                check(bool(keep.all()), f"[families] {arch}: smoke "
                      f"routing dropped pairs")
                experts = (slot // C).cpu()
            res[where] = ([t.cpu() for t in lgs], experts, n_flash)
        set_device("cuda")
        (c_lgs, c_exp, _), (g_lgs, g_exp, n_flash) = res["cpu"], res["card"]
        err = max(float((a - b).abs().max()) for a, b in zip(g_lgs, c_lgs))
        check(all(torch.allclose(a, b, rtol=FAMILY_SMOKE_TOL,
                                 atol=FAMILY_SMOKE_TOL)
                  for a, b in zip(g_lgs, c_lgs)),
              f"[families] {arch} smoke: card against CPU max abs err {err}")
        check(c_exp is None or torch.equal(c_exp, g_exp),
              f"[families] {arch} smoke: layer 0 experts differ")
        check(n_flash == cfg.n_layers, f"[families] {arch} smoke: "
              f"{n_flash} flash_attention launches on the card")
        out[arch] = dict(max_abs_err=err, flash_launches=n_flash)
        log(f"[families] {arch} smoke, card against CPU: prefill and "
            f"{steps.shape[1]} decode steps max abs err {err:.3g}, "
            f"{n_flash} flash_attention launches on the card")
    out[QWEN_MOE_ARCH]["full_params"] = n
    return out


def families_path(dev) -> dict:
    """Phase 15: each model freed before the next."""
    t_phase = time.perf_counter()
    out = {}
    for name, fn in (("moe", moe_serve), ("encdec", encdec_serve),
                     ("vision", vision_serve), ("mla", mla_serve),
                     ("smoke", smoke_card_vs_cpu)):
        t0 = time.perf_counter()
        out[name] = fn(dev)
        out[name]["seconds"] = time.perf_counter() - t0
        gc.collect()
        torch.cuda.empty_cache()
    out["seconds"] = time.perf_counter() - t_phase
    log(f"[families] phase 15 in {out['seconds']:.1f} s")
    return out


# ---------------------------------------------------------------------------

# ---------------------------------------------------------------------------
# Phase 13: the gateway over the net store, with the stream attached.
# ---------------------------------------------------------------------------

def http(addr: str, path: str, token: str | None = GW_TOKEN,
         method: str = "GET", body: dict | None = None):
    """One request to the gateway: (status, decoded JSON, headers).  A
    non-2xx status is an answer here, not a failure of the call."""
    hdrs = {} if token is None else {"Authorization": f"Bearer {token}"}
    data = None if body is None else json.dumps(body).encode()
    if data is not None:
        hdrs["Content-Type"] = "application/json"
    r = urllib.request.Request(f"http://{addr}{path}", data=data,
                               headers=hdrs, method=method)
    try:
        with urllib.request.urlopen(r, timeout=GW_HTTP_TIMEOUT) as resp:
            return resp.status, json.loads(resp.read()), dict(resp.headers)
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read() or b"null"), dict(e.headers)


def run_job(addr: str, kind: str, params: dict) -> dict:
    """Submit a background job, poll its status, return its result."""
    s, d, _ = http(addr, "/v1/jobs", method="POST",
                   body={"kind": kind, "params": params})
    check(s == 200, f"[gateway] job {kind} submit: {s} {d}")
    deadline = time.monotonic() + GW_HTTP_TIMEOUT
    while True:
        s, st, _ = http(addr, f"/v1/jobs/{d['job']}")
        check(s == 200 and st["status"] != "failed",
              f"[gateway] job {kind}: {s} {st}")
        if st["status"] == "done":
            break
        check(time.monotonic() < deadline, f"[gateway] job {kind} timed out")
        time.sleep(0.01)
    s, res, _ = http(addr, f"/v1/jobs/{d['job']}/result")
    check(s == 200, f"[gateway] job {kind} result: {s} {res}")
    return res["result"]


def same_json(got, want, path: str = "$") -> None:
    """Keys, strings and integers exactly; floats within PATH_RTOL /
    PATH_ATOL (NaN equal to NaN)."""
    if isinstance(want, dict):
        check(isinstance(got, dict) and set(got) == set(want),
              f"{path}: keys {sorted(got)} != {sorted(want)}")
        for k in want:
            same_json(got[k], want[k], f"{path}.{k}")
    elif isinstance(want, (list, tuple)):
        check(isinstance(got, (list, tuple)) and len(got) == len(want),
              f"{path}: length {len(got)} != {len(want)}")
        for i, (g, w) in enumerate(zip(got, want)):
            same_json(g, w, f"{path}[{i}]")
    elif isinstance(want, float):
        check(isinstance(got, float) and (
            (np.isnan(got) and np.isnan(want)) or
            abs(got - want) <= PATH_ATOL + PATH_RTOL * abs(want)),
            f"{path}: {got} != {want}")
    else:
        check(type(got) is type(want) and got == want,
              f"{path}: {got!r} != {want!r}")


def median_ms(fn, n: int = GW_REPEATS) -> float:
    """Median wall time of ``fn()`` in ms over ``n`` calls after one
    warm-up call."""
    fn()
    ts = []
    for _ in range(n):
        t0 = time.perf_counter()
        fn()
        ts.append((time.perf_counter() - t0) * 1e3)
    return float(np.median(ts))


def device_allocations(fn) -> int:
    """Device tensors allocated during ``fn()``, whichever thread made
    them (the caching allocator's count)."""
    key = "allocation.all.allocated"
    torch.cuda.synchronize()
    a0 = torch.cuda.memory_stats().get(key, 0)
    fn()
    torch.cuda.synchronize()
    return torch.cuda.memory_stats().get(key, 0) - a0


def profiled_device_ms(fn) -> dict:
    """Device time of one ``fn()`` under ``torch.profiler``, kernels and
    copies, whichever thread launched them.  On the card machine the
    profiler drops a call's device records at random once the process
    has run a while (none, some or all of them), so up to
    ``GW_PROFILE_CALLS`` calls are profiled, each alone, and the largest
    device time is kept, stopping after ``GW_PROFILE_HITS`` calls that
    showed any: a lower bound on one call's device time."""
    best = {"device_ms": 0.0, "kernels": 0, "wall_ms": None}
    hits = calls = 0
    while calls < GW_PROFILE_CALLS and hits < GW_PROFILE_HITS:
        t0 = time.perf_counter()
        split, n_kernels = profiled_kernels(fn)
        wall = (time.perf_counter() - t0) * 1e3
        calls += 1
        ms = sum(split.values())
        hits += ms > 0
        if ms > best["device_ms"]:
            best = {"device_ms": ms, "kernels": n_kernels, "wall_ms": wall}
    return dict(best, calls_with_device_time=hits, calls=calls)


def attack_scenario() -> "stream.ScenarioConfig":
    """``tests/test_stream.py``'s ``attack_cfg(seed=3)``: 150 s of diurnal
    background with one c2, scan and ddos attack."""
    return stream.ScenarioConfig(
        duration_s=150.0, n_hosts=96, base_rate=70.0, seed=3,
        t0=1_492_000_000.0, attacks=(
            stream.AttackSpec("c2", start=5, duration=140, n_hosts=8,
                              period_s=2.0, port=6667),
            stream.AttackSpec("scan", start=30, duration=10, rate=60.0),
            stream.AttackSpec("ddos", start=85, duration=10, n_hosts=8,
                              rate=40.0, port=80)))


def stream_scenario(device: str) -> tuple[list, float]:
    """The attack scenario block by block into a second net-backed table
    with the rollup tap: each block flushed, then one detector pass.
    Every attack must be alerted inside its truth window and name its
    C2 server, scanner or victim."""
    cfg = attack_scenario()
    rec, truth = stream.synth_scenario(cfg)
    T2 = DB("Tedge", "TedgeT", "TedgeDeg", backend="net",
            n_instances=GW_SHARDS, io_timeout=GW_HTTP_TIMEOUT)
    sa = stream.StreamAnalytics().attach(T2)
    t0 = time.perf_counter()
    try:
        for _, A in stream.stream_blocks(cfg, rec=rec):
            T2.put(A, sync=False)
            T2.flush()
            sa.step()
        sa.step(force=True)
        alerts = sa.bank.alerts(limit=10_000)
        secs = time.perf_counter() - t0
        n_pkts = sa.rollup.totals("second")["n_packets"]
    finally:
        sa.close()
        T2.close()
        T2.backend.close()
    check(n_pkts == rec.shape[0],
          f"[stream {device}] rollup holds {n_pkts} of {rec.shape[0]} "
          f"packets")
    c2, scan, ddos = truth["attacks"]
    for att in truth["attacks"]:
        check(any(a.kind == att["kind"] and a.window_start < att["stop"]
                  and a.window_stop > att["start"] for a in alerts),
              f"[stream {device}] no {att['kind']} alert in its window")
    check(any(a.victim == c2["victim"] for a in alerts if a.kind == "c2"),
          f"[stream {device}] no c2 alert names {c2['victim']}")
    check(all(scan["attackers"][0] in a.hosts.tolist()
              for a in alerts if a.kind == "scan"),
          f"[stream {device}] a scan alert misses {scan['attackers'][0]}")
    check(all(a.victim == ddos["victim"] for a in alerts
              if a.kind == "ddos"),
          f"[stream {device}] a ddos alert misses {ddos['victim']}")
    kinds = {}
    for a in alerts:
        kinds[a.kind] = kinds.get(a.kind, 0) + 1
    log(f"[stream {device}] {rec.shape[0]} packets in {secs:.2f} s, "
        f"alerts {kinds}")
    return json.loads(json.dumps([a.to_dict() for a in alerts])), secs


def gateway_path(device: str, ref: dict) -> dict:
    """Phase 13 on ``device``: phase 3's window (its incidence matrix
    ``ref["E"]``) into a two-shard net store with the stream attached,
    served by the gateway; every answer is held against ``ref``, phase
    3's results and table on the card."""
    set_device(device)
    on_card = device == "cuda"
    t_phase = time.perf_counter()
    cfg = TrafficConfig(**MAIN_CFG)
    E, n_packets = ref["E"], ref["n_packets"]
    check(n_packets == GW_PACKETS and E.nnz == GW_NNZ,
          f"[gateway {device}] window {n_packets} packets, nnz {E.nnz}")
    T = DB("Tedge", "TedgeT", "TedgeDeg", backend="net",
           n_instances=GW_SHARDS, io_timeout=GW_HTTP_TIMEOUT)
    sa = stream.StreamAnalytics().attach(T)     # before any ingest
    t0 = time.perf_counter()
    put(T, E.putval("1,"))
    T.flush()
    times = {"ingest": time.perf_counter() - t0}
    gw = Gateway(T, TokenAuth({
        GW_TOKEN: Tenant("analyst", rate=1e4, burst=1e4),
        GW_TIGHT: Tenant("tight", rate=0.5, burst=2.0)}),
        stream_analytics=sa)
    default_window = gw.coalescer.window
    addr = gw.start()
    lat, dev_ms, out = {}, {}, {}
    T3 = ref["table"]
    t0 = time.perf_counter()
    try:
        check(get_device().type == device,
              f"[gateway] serves on {get_device()}, want {device}")
        # 8 concurrent top-k requests, batched by the coalescer (its
        # window widened for them, so the batch does not hang on thread
        # start-up; the latencies below use the default window)
        gw.coalescer.window = GW_COALESCE_S
        barrier = threading.Barrier(GW_CONCURRENT)
        answers = []

        def topk_one():
            barrier.wait(timeout=GW_HTTP_TIMEOUT)
            answers.append(http(addr, "/v1/topk?prefix=ip.dst|&k=10"))
        threads = [threading.Thread(target=topk_one)
                   for _ in range(GW_CONCURRENT)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=2 * GW_HTTP_TIMEOUT)
        check(len(answers) == GW_CONCURRENT and
              all(a[0] == 200 and a[1] == answers[0][1] for a in answers),
              f"[gateway {device}] concurrent topk answers differ")
        out["topk"] = answers[0][1]
        gw.coalescer.window = default_window
        s, st, _ = http(addr, "/v1/stats")
        co = st["coalesce"]
        check(co["max_batch"] >= 2 and co["n_batches"] >= 1,
              f"[gateway {device}] topk not coalesced: {co}")
        # degree fit against phase 3's fit_degree_table
        s, d, _ = http(addr, "/v1/degree?prefix=ip.dst|")
        n_dst = T3.degree_assoc("ip.dst|").nnz
        check(s == 200 and d["n"] == n_dst and np.allclose(
            [d["fit"]["alpha"], d["fit"]["r2"]], ref["fit"],
            rtol=PATH_RTOL, atol=PATH_ATOL),
            f"[gateway {device}] degree n {d.get('n')} / {n_dst}, fit "
            f"{d.get('fit')} vs phase 3 {ref['fit']}")
        out["degree"] = d
        # C2 in the top 3, as in phase 3
        c2 = botnet_truth(cfg)["c2"]
        s, d, _ = http(addr, "/v1/c2?top_k=3")
        check(s == 200 and c2 in d["report"]["hosts"] and
              d["report"]["hosts"] == ref["c2"][:3],
              f"[gateway {device}] c2 top 3 {d['report']['hosts']}, "
              f"phase 3 {ref['c2'][:3]}, injected {c2}")
        out["c2"] = d
        # scanners and one column scan against phase 3's memory table
        s, d, _ = http(addr, "/v1/scanners")
        want = analytics.scan_report(T3).hosts.tolist()
        check(s == 200 and d["report"]["hosts"] == want,
              f"[gateway {device}] scanners {d['report']['hosts']} vs {want}")
        out["scanners"] = d
        scan_path = f"/v1/scan?axis=col&prefix=ip.dst|{c2}"
        s, d, _ = http(addr, scan_path)
        r, c, v = T3[:, StartsWith(f"ip.dst|{c2}")].eval().triples()
        want = [[str(a), str(b), str(x)] for a, b, x in zip(r, c, v)]
        check(s == 200 and d["nnz"] == len(want) and
              d["triples"] == want[:len(d["triples"])],
              f"[gateway {device}] scan of {c2}: nnz {d['nnz']} vs "
              f"{len(want)}")
        out["scan"] = d
        # the PageRank job against phase 3's pagerank_table
        pr_params = {"num_iters": 30, "top_k": 5}
        res = run_job(addr, "pagerank", pr_params)
        top = np.argsort(ref["pr"])[::-1][:5]
        check([n["key"] for n in res["nodes"]] ==
              [str(ref["hosts"][i]) for i in top] and np.allclose(
                  [n["rank"] for n in res["nodes"]], ref["pr"][top],
                  rtol=PATH_RTOL, atol=PATH_ATOL),
              f"[gateway {device}] pagerank top 5 {res['nodes']}")
        out["pagerank"] = res
        times["requests"] = time.perf_counter() - t0
        # rollup conservation over the closed windows
        t0 = time.perf_counter()
        sa.step(force=True)
        times["close_windows"] = time.perf_counter() - t0
        for level in ("second", "minute"):
            s, d, _ = http(addr, f"/v1/windows?level={level}&limit=10000")
            got = sum(w["n_packets"] for w in d["windows"])
            check(s == 200 and got == n_packets,
                  f"[gateway {device}] {level} windows hold {got} of "
                  f"{n_packets} packets")
            out[f"windows_{level}"] = d
        s, st, _ = http(addr, "/v1/stats")
        check(st["table"]["writers"]["n_taps"] == 1,
              f"[gateway {device}] n_taps {st['table']['writers']}")
        check(st["kernel_launches"] == X.launch_counts(),
              f"[gateway {device}] stats kernel_launches "
              f"{st['kernel_launches']} vs {X.launch_counts()}")
        # the error surface
        s, d, _ = http(addr, "/v1/topk", token=None)
        check(s == 401, f"[gateway {device}] no token gave {s}")
        codes = [http(addr, "/v1/topk?k=1", token=GW_TIGHT)
                 for _ in range(3)]
        check([c[0] for c in codes] == [200, 200, 429] and
              float(codes[2][2]["Retry-After"]) > 0,
              f"[gateway {device}] past burst: {[c[0] for c in codes]}")
        # the work ran on the card: device allocations and device time of
        # one /v1/c2 request and one PageRank job
        t0 = time.perf_counter()
        if on_card:
            for name, fn in (
                    ("c2", lambda: http(addr, "/v1/c2?top_k=3")),
                    ("pagerank", lambda: run_job(addr, "pagerank",
                                                 pr_params))):
                allocs = device_allocations(fn)
                prof = profiled_device_ms(fn)
                check(allocs > 0 and prof["device_ms"] > 0,
                      f"[gateway] {name}: {allocs} device allocations, "
                      f"profiled {prof}")
                dev_ms[name] = dict(prof, allocations=allocs)
        times["profile"] = time.perf_counter() - t0
        # median latency per endpoint, 5 requests after one warm-up
        t0 = time.perf_counter()
        for name, path in GW_ENDPOINTS + (("scan", scan_path),):
            lat[name] = median_ms(lambda: http(addr, path))
        lat["pagerank_job"] = median_ms(
            lambda: run_job(addr, "pagerank", pr_params))
        times["latency"] = time.perf_counter() - t0
    finally:
        gw.stop()
        T.close()
        T.backend.close()
    out["stream_alerts"], times["stream"] = stream_scenario(device)
    total = time.perf_counter() - t_phase
    ingest_s = times["ingest"]
    log(f"[gateway {device}] ingest into the net store {ingest_s:.3f} s "
        f"({GW_PACKETS} packets, {GW_NNZ} nnz, {GW_SHARDS} shards); "
        f"phase {total:.2f} s: " + json.dumps(
            {k: round(v, 3) for k, v in times.items()}))
    log(f"[gateway {device}] median ms: " + json.dumps(
        {k: round(v, 3) for k, v in lat.items()}))
    if dev_ms:
        log(f"[gateway {device}] profiled: " + json.dumps(dev_ms))
    return dict(out=out, ingest_s=ingest_s, total_s=total, latency_ms=lat,
                device=dev_ms, coalesce=co, times=times)


def compare_gateways(card: dict, cpu: dict) -> None:
    """Card and CPU answers of phase 13 equal: keys and integer counts
    exactly, floats within PATH_RTOL / PATH_ATOL."""
    same_json(card["out"], cpu["out"])


# ---------------------------------------------------------------------------
# Phase 14: training and the mesh on the card.
# ---------------------------------------------------------------------------

def token_batch(stream: TokenStream, vocab: int, dev) -> dict:
    return {k: torch.from_numpy(np.minimum(v, vocab - 1)).to(dev)
            for k, v in stream.next_batch().items()}


def train_full_width(dev: torch.device, pattern: str) -> dict:
    """rwkv6-1.6b at full width and depth through the calls of
    ``launch.train.main`` in its order (the last step's gradient and
    update apart, as ``make_train_step`` composes them, to time the
    update and keep its gradients)."""
    cfg = get_config(TRAIN_ARCH)
    stream = TokenStream(pattern, seq_len=TRAIN_S, batch=TRAIN_B)
    opt = OptConfig(warmup_steps=TRAIN_WARMUP)
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    params, state = init_train_state(
        cfg, torch.Generator(device=dev).manual_seed(0))
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    n_params = sum(p.numel() for p in tree_leaves(params))
    train_step = make_train_step(cfg, opt)
    grad_fn = make_grad_fn(cfg, opt)
    ev = [torch.cuda.Event(enable_timing=True) for _ in range(3)]
    losses, norms, step_s = [], [], []
    ops.reset_launches()
    for step in range(TRAIN_STEPS):
        batch = token_batch(stream, cfg.vocab, dev)
        ev[0].record()
        if step < TRAIN_STEPS - 1:
            params, state, m = train_step(params, state, batch)
            loss, gnorm = m["loss"], m["grad_norm"]
        else:
            loss, grads = grad_fn(params, batch)
            ev[1].record()
            params, state, gnorm = adamw_update(params, grads, state, opt)
        ev[2].record()
        torch.cuda.synchronize()
        losses.append(float(loss))
        norms.append(float(gnorm))
        step_s.append(ev[0].elapsed_time(ev[2]) / 1e3)
    adamw_ms = ev[1].elapsed_time(ev[2])
    launches = ops.kernel_launches()
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    check(all(np.isfinite(losses)) and all(np.isfinite(norms)),
          f"[train] non-finite loss or gradient norm: {losses} {norms}")
    check(np.mean(losses[-3:]) < losses[0],
          f"[train] loss did not fall: {losses}")
    check(not any(launches.values()),
          f"[train] hand-written kernels launched in training: {launches}")
    check(all(bool(torch.isfinite(g).all()) for g in tree_leaves(grads)),
          "[train] non-finite gradients in the last step")
    batch = token_batch(stream, cfg.vocab, dev)
    t0 = time.perf_counter()
    split, n_kernels = profiled_kernels(
        lambda: train_step(params, state, batch), cpu=False)
    profiled_s = time.perf_counter() - t0
    median_s = float(np.median(step_s[1:]))
    out = {"arch": cfg.name, "params_b": n_params / 1e9, "batch": TRAIN_B,
           "seq": TRAIN_S, "dtype": cfg.dtype, "remat": cfg.remat,
           "init_s": init_s, "losses": losses, "grad_norms": norms,
           "step_s": step_s, "median_step_s": median_s,
           "tokens_per_s": TRAIN_B * TRAIN_S / median_s,
           "adamw_ms": adamw_ms,
           "adamw_share": adamw_ms / 1e3 / step_s[-1],
           "peak_gb": peak_gb, "kernel_launches": launches,
           "profiled_step": {"device_ms": sum(split.values()) if n_kernels
                             else None, "device_kernels": n_kernels,
                             "wall_s": profiled_s,
                             "busy_share": sum(split.values()) / 1e3 /
                             median_s if n_kernels else None,
                             "top_kernels_ms": sorted(
                                 split.items(), key=lambda kv: -kv[1])[:6]}}
    log(f"[train] {cfg.name} {n_params / 1e9:.3f} B params, B={TRAIN_B} "
        f"S={TRAIN_S} {cfg.dtype} remat={cfg.remat}: losses "
        f"{[round(x, 4) for x in losses]}, median step {median_s:.4f} s "
        f"({out['tokens_per_s']:.0f} tokens/s), AdamW {adamw_ms:.2f} ms "
        f"({100 * out['adamw_share']:.1f}% of its step), peak "
        f"{peak_gb:.2f} GB, profiled step {out['profiled_step']}")
    del params, state
    return out, grads


def train_smoke_runs(dev: torch.device, pattern: str, dtype: str) -> dict:
    """Two smoke train steps of rwkv6 on the card and on the CPU from the
    same seeded parameters and batches; the card's state is returned for
    the checkpoint round trip."""
    cfg = dataclasses.replace(smoke_config(TRAIN_ARCH), dtype=dtype)
    opt = OptConfig(lr=TRAIN_SMOKE_LR, warmup_steps=1)
    stream = TokenStream(pattern, seq_len=TRAIN_SMOKE_S, batch=TRAIN_SMOKE_B)
    batches = [stream.next_batch() for _ in range(2)]
    runs = {}
    for where in ("cuda", "cpu"):
        set_device(where)
        params, state = init_train_state(cfg, torch.Generator()
                                         .manual_seed(0))
        params, state = tree_map(lambda t: t.to(where), (params, state))
        step = make_train_step(cfg, opt)
        metrics = []
        for b in batches:
            b = {k: torch.from_numpy(np.minimum(v, cfg.vocab - 1)).to(where)
                 for k, v in b.items()}
            params, state, m = step(params, state, b)
            metrics.append((float(m["loss"]), float(m["grad_norm"])))
        runs[where] = dict(params=params, state=state, metrics=metrics)
    set_device("cuda")
    rtol = TRAIN_F32_RTOL if dtype == "float32" else TRAIN_BF16_RTOL
    got, want = np.asarray(runs["cuda"]["metrics"]), \
        np.asarray(runs["cpu"]["metrics"])
    check(np.allclose(got, want, rtol=rtol, atol=0),
          f"[train] {dtype} card {got.tolist()} vs CPU {want.tolist()} "
          f"beyond rtol={rtol}")
    diff = torch.cat([(a.cpu() - b).abs().flatten() for a, b in zip(
        tree_leaves(runs["cuda"]["params"]),
        tree_leaves(runs["cpu"]["params"]))])
    near, share = TRAIN_PARAM_NEAR[dtype]
    got_share = float((diff <= near).float().mean())
    check(float(diff.max()) <= 2 * TRAIN_SMOKE_LR * 2 and got_share >= share,
          f"[train] {dtype} parameters: max diff {float(diff.max())}, "
          f"{got_share:.5f} within {near} (want {share})")
    runs["check"] = {"metrics_card": got.tolist(),
                     "metrics_cpu": want.tolist(),
                     "param_max_diff": float(diff.max()),
                     "param_share_near": got_share}
    log(f"[train] card vs CPU, smoke {dtype}: " + json.dumps(runs["check"]))
    return runs


def same_bits(a, b) -> bool:
    if isinstance(a, torch.Tensor):
        return a.dtype == b.dtype and a.shape == b.shape and torch.equal(
            a.detach().cpu().reshape(-1).view(torch.uint8),
            b.detach().cpu().reshape(-1).view(torch.uint8))
    return np.array_equal(np.asarray(a), np.asarray(b))


def checkpoint_round_trip(run: dict, pattern: str, root: str) -> None:
    """Save the card's smoke state with a sampler state; restore onto the
    card and onto the CPU, bit for bit."""
    stream = TokenStream(pattern, seq_len=TRAIN_SMOKE_S, batch=TRAIN_SMOKE_B)
    stream.next_batch()
    stream.next_batch()
    tree = (run["params"], run["state"], stream.state.to_dict())
    checkpoint.save(root, 1, tree, {"step": 1})
    for where in ("cuda", "cpu"):
        like = (tree_map(lambda t: t.to(where), (run["params"],
                                                 run["state"]))
                + (SamplerState().to_dict(),))
        (p, s, sampler), meta = checkpoint.restore(root, like)
        check(meta == {"step": 1}, f"[train] checkpoint metadata {meta}")
        leaves = tree_leaves((p, s))
        check(all(t.device.type == where for t in leaves),
              f"[train] restored leaves not all on {where}")
        check(all(same_bits(a, b) for a, b in zip(
            leaves, tree_leaves((run["params"], run["state"])))),
              f"[train] checkpoint restored onto {where} is not bit-exact")
        check(SamplerState.from_dict({k: int(v) for k, v in sampler.items()})
              == stream.state, f"[train] sampler state {sampler}")
    log("[train] checkpoint round trip bit-exact onto card and CPU")


def nccl_one_rank(ref: dict, grads, tmp: str) -> dict:
    """A one-rank NCCL world: the sharded PageRank and degrees over a
    (1,) data mesh, and the int8 pod mean, through NCCL's all_reduce."""
    import torch.distributed as dist
    store = dist.FileStore(os.path.join(tmp, "store"), 1)
    dist.init_process_group("nccl", store=store, rank=0, world_size=1)
    try:
        mesh = make_mesh((1,), ("data",))
        check(mesh.group("data") is not None, "[mesh] no NCCL group")
        hosts, pr = analytics.distributed.pagerank_table(ref["table"], mesh,
                                                         30)
        pr = pr.cpu().numpy()
        check(np.array_equal(hosts, ref["hosts"]) and np.allclose(
            pr, ref["pr"], rtol=PATH_RTOL, atol=PATH_ATOL),
            f"[mesh] pagerank_table over NCCL differs from phase 3: max "
            f"abs {np.abs(pr - ref['pr']).max()}")
        T = ref["table"]
        E = T[:, "ip.src|*,"] + T[:, "ip.dst|*,"]
        coo = graph.square(graph.adjacency(E)).device_coo(torch.float32)
        deg = analytics.distributed.degree_sharded(coo, mesh)
        live = coo.cols[coo.rows < coo.shape[0]].long().cpu()
        check(torch.equal(deg, analytics.distributed.degree_sharded(coo)) and
              torch.equal(deg.cpu(), torch.bincount(
                  live, minlength=coo.shape[1]).float()),
              "[mesh] degree_sharded over NCCL is not exact")
        pod = make_mesh((1,), ("pod",))
        q = compressed_pod_mean(grads, pod)
        worst = 0.0
        for g, h in zip(tree_leaves(grads), tree_leaves(q)):
            scale = float(g.abs().max()) / 127
            err = float((h - g).abs().max())
            # scale/2, plus the float32 rounding of the dequantized value
            # (at most 127 scale 2^-24 < 1e-5 scale)
            check(err <= scale * (0.5 + 1e-5),
                  f"[mesh] int8 pod mean error {err} > scale/2 {scale / 2}")
            worst = max(worst, err / max(scale, 1e-30))
    finally:
        dist.destroy_process_group()
    out = {"pagerank_nodes": int(hosts.shape[0]),
           "pagerank_max_abs_vs_phase3": float(np.abs(pr - ref["pr"]).max()),
           "degree_nnz": int(coo.nnz),
           "pod_mean_worst_err_over_scale": worst}
    log("[mesh] one-rank NCCL world: " + json.dumps(out))
    return out


def train_path(dev: torch.device, ref: dict, smi: str) -> dict:
    """Phase 14 on the card, then phase 16 (a) on its corpus; ``ref`` is
    phase 3's result (its table)."""
    t_phase = time.perf_counter()
    times = {}
    with tempfile.TemporaryDirectory(prefix="chip_smoke_train_") as tmp:
        t0 = time.perf_counter()
        pattern = synth_corpus(os.path.join(tmp, "data"))
        times["corpus"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        full, grads = train_full_width(dev, pattern)
        times["full_width"] = time.perf_counter() - t0
        gc.collect()
        torch.cuda.empty_cache()
        t0 = time.perf_counter()
        smoke = {d: train_smoke_runs(dev, pattern, d)
                 for d in ("float32", "bfloat16")}
        times["card_vs_cpu"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        checkpoint_round_trip(smoke["bfloat16"]["cuda"], pattern,
                              os.path.join(tmp, "ckpt"))
        times["checkpoint"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        mesh = nccl_one_rank(ref, grads, tmp)
        times["nccl"] = time.perf_counter() - t0
        del grads
        gc.collect()
        torch.cuda.empty_cache()
        t0 = time.perf_counter()
        sharded = sharded_on_card(dev, pattern, full, tmp, smi)
        times["sharded_16a"] = time.perf_counter() - t0
    times["phase"] = time.perf_counter() - t_phase
    log("[train] phase 14 seconds: " + json.dumps(
        {k: round(v, 2) for k, v in times.items()}))
    return {"full_width": full, "smoke": {d: r["check"]
                                          for d, r in smoke.items()},
            "mesh": mesh, "sharded": sharded, "times": times}


# ---------------------------------------------------------------------------
# Phase 16: the sharded train step and the launch tooling.
# ---------------------------------------------------------------------------

def card_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]


# ---------------------------------------------------------------------------
# Phase 17: the examples on the card.
# ---------------------------------------------------------------------------

def examples_path() -> dict:
    """Phase 17: ``python -m repro_torch.examples.<name>`` for each
    example, one child process each on the default device (the card),
    with the kernel launch counts of its run printed after it; each must
    exit 0, print its closing line and launch exactly the kernels it
    reaches."""
    root = Path(__file__).resolve().parent
    env = dict(os.environ, PYTHONPATH=str(root / "src"))
    env.pop("REPRO_TORCH_DEVICE", None)
    out = {}
    for name, (closing, kernels) in EXAMPLES.items():
        script = (
            "import json, runpy\n"
            "from repro_torch.kernels import ops\n"
            f"runpy.run_module('repro_torch.examples.{name}', "
            "run_name='__main__', alter_sys=True)\n"
            "print('[launches]', json.dumps(ops.kernel_launches()))\n")
        t0 = time.perf_counter()
        try:
            proc = subprocess.run(
                [sys.executable, "-c", script], env=env, cwd=str(root),
                capture_output=True, text=True, timeout=EXAMPLE_TIMEOUT_S)
        except subprocess.TimeoutExpired:
            raise SmokeFailure(f"[examples] {name} not done in "
                               f"{EXAMPLE_TIMEOUT_S} s")
        took = time.perf_counter() - t0
        check(proc.returncode == 0, f"[examples] {name} exited with "
              f"{proc.returncode}: {proc.stderr[-3000:]}")
        lines = proc.stdout.rstrip().splitlines()
        check(len(lines) >= 2 and lines[-1].startswith("[launches] "),
              f"[examples] {name} printed no launch counts")
        launches = json.loads(lines[-1][len("[launches] "):])
        printed = lines[:-1]
        check(any(x.startswith(closing) for x in printed[-6:]),
              f"[examples] {name}: no closing line {closing!r} in "
              f"{printed[-6:]}")
        reached = sorted(k for k, n in launches.items() if n)
        check(reached == sorted(kernels),
              f"[examples] {name} launched {launches}, want {kernels}")
        out[name] = {"seconds": took, "launches": launches,
                     "last_lines": printed[-3:]}
        log(f"[examples] {name}: {took:.1f} s, launches {launches}, "
            f"ends {printed[-1]!r}")
    return out


def dryrun_cells(out_dir: str) -> dict:
    """Phase 16 (b)'s dry runs in a process of their own on the host (no
    card: they count a fake world); each cell's seconds."""
    script = (
        "import json, sys, time\n"
        "from repro_torch.launch import dryrun\n"
        f"for arch, shape in {list(DRYRUN_CELLS)!r}:\n"
        "    t0 = time.time()\n"
        "    dryrun.main(['--arch', arch, '--shape', shape, '--mesh',\n"
        "                 'single', '--force'])\n"
        "    print(json.dumps({'arch': arch, 'shape': shape,\n"
        "                      'seconds': time.time() - t0}), flush=True)\n")
    root = Path(__file__).resolve().parent
    env = dict(os.environ, PYTHONPATH=str(root / "src"),
               REPRO_TORCH_DEVICE="cpu", CUDA_VISIBLE_DEVICES="")
    try:
        proc = subprocess.run(
            [sys.executable, "-c", script], env=env, cwd=str(root),
            capture_output=True, text=True, timeout=DRYRUN_TIMEOUT_S)
    except subprocess.TimeoutExpired:
        raise SmokeFailure(f"[dryrun] not done in {DRYRUN_TIMEOUT_S} s")
    with open(os.path.join(out_dir, "dryrun.out"), "w") as f:
        f.write(proc.stdout)
    check(proc.returncode == 0, f"[dryrun] exited with {proc.returncode}: "
          f"{proc.stderr[-3000:]}")
    return {(d["arch"], d["shape"]): d["seconds"]
            for d in (json.loads(x) for x in proc.stdout.splitlines()
                      if x.startswith("{"))}


class _StandInMesh:
    def __init__(self, shape, axes):
        self.shape = dict(zip(axes, shape))
        self.axis_names = tuple(axes)


def local_shard_bytes(tree, specs, mesh) -> int:
    """Bytes of a rank's shards of ``tree`` under ``specs`` on ``mesh``
    (each dim divided by the sizes of the axes its entry names)."""
    total = 0
    for t, spec in zip(tree_leaves(tree), leaves_at(specs, tree)):
        n = t.numel()
        for ax in spec:
            for a in (ax if isinstance(ax, tuple) else (ax,)):
                if a is not None:
                    n //= mesh.shape[a]
        total += n * t.element_size()
    return total


def expected_argument_bytes(arch: str, shape_name: str) -> int:
    """The local shard bytes ``param_specs`` implies on the (16, 16)
    mesh: parameters (and for training AdamW's moments and its int32
    step), plus the batch's rows a rank holds."""
    cfg = get_config(arch)
    shape = shape_by_name(shape_name)
    mesh = _StandInMesh((16, 16), ("data", "model"))
    params = model.abstract_params(cfg)
    shard = local_shard_bytes(params, sharding.param_specs(params, mesh),
                              mesh)
    batch = 0
    for v in inputs.input_specs(cfg, shape).values():
        n = v.numel() * v.element_size()
        batch += n // 16 if v.shape[0] % 16 == 0 else n
    if shape.kind == "train":
        return 3 * shard + 4 + batch
    return shard + batch


def dryrun_path(smi: str) -> dict:
    """Phase 16 (b): the dry runs, then their records held."""
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory(prefix="chip_smoke_dryrun_") as tmp:
        seconds = dryrun_cells(tmp)
    took = time.perf_counter() - t0
    out = {}
    for arch, shape in DRYRUN_CELLS:
        path = os.path.join(dryrun.RESULTS_DIR,
                            f"{canonical(arch)}__{shape}__single.json")
        with open(path) as f:
            rec = json.load(f)
        check(rec.get("ok") and not rec.get("skipped"),
              f"[dryrun] {arch} {shape} failed: {rec.get('error')} "
              f"{rec.get('traceback', '')[-2000:]}")
        want = expected_argument_bytes(arch, shape)
        check(rec["memory"]["argument_bytes"] == want,
              f"[dryrun] {arch} {shape} argument_bytes "
              f"{rec['memory']['argument_bytes']} != the specs' {want}")
        terms = roofline.analyze(rec)
        out[f"{arch} {shape}"] = {
            "seconds": seconds[(arch, shape)], "lower_s": rec["lower_s"],
            "compile_s": rec["compile_s"], "flops": rec["flops"],
            "bytes_accessed": rec["bytes_accessed"],
            "collective_bytes": rec["collective_bytes"],
            "collective_calls": rec["collective_calls"],
            "memory": rec["memory"],
            "per_device_gib": (rec["memory"]["argument_bytes"]
                               + rec["memory"]["temp_bytes"]) / 2**30,
            "roofline": {k: terms[k] for k in (
                "t_compute_s", "t_memory_s", "t_collective_s", "dominant",
                "model_flops", "roofline_fraction")}}
    log(f"[dryrun] {smi}: {took:.1f} s in all: " + json.dumps(out))
    return out


def device_rates(smi: str) -> dict:
    """The card's own bf16 matmul TFLOP/s at 8192³ and device copy GB/s
    (CUDA events, after a warm-up)."""
    n = MATMUL_N
    a = torch.randn(n, n, device="cuda", dtype=torch.bfloat16)
    b = torch.randn(n, n, device="cuda", dtype=torch.bfloat16)
    mm_ms = timed_ms(lambda: torch.matmul(a, b), iters=10)
    del a, b
    x = torch.empty(COPY_BYTES // 4, device="cuda", dtype=torch.float32)
    y = torch.empty_like(x)
    cp_ms = timed_ms(lambda: y.copy_(x), iters=10)
    del x, y
    out = {"matmul_bf16_tflops": 2 * n ** 3 / (mm_ms / 1e3) / 1e12,
           "matmul_ms": mm_ms, "peak_tflops": roofline.PEAK_FLOPS / 1e12,
           "copy_gbs": 2 * COPY_BYTES / (cp_ms / 1e3) / 1e9,
           "copy_ms": cp_ms, "peak_gbs": roofline.HBM_BW / 1e9}
    log(f"[roofline] {smi}: " + json.dumps(out))
    return out


def sharded_on_card(dev, pattern: str, full: dict, tmp: str,
                    smi: str) -> dict:
    """Phase 16 (a) (and (c)'s counted FLOPs) in a one-rank NCCL world."""
    import torch.distributed as dist
    from torch.distributed.tensor import DTensor
    from torch.utils.flop_counter import FlopCounterMode
    store = dist.FileStore(os.path.join(tmp, "store16"), 1)
    dist.init_process_group("nccl", store=store, rank=0, world_size=1)
    try:
        mesh = make_mesh((1, 1), ("data", "model"))
        cfg = get_config(TRAIN_ARCH)
        opt = OptConfig(warmup_steps=TRAIN_WARMUP)
        stream = TokenStream(pattern, seq_len=TRAIN_S, batch=TRAIN_B)
        torch.cuda.reset_peak_memory_stats()
        params, state = init_train_state(
            cfg, torch.Generator(device=dev).manual_seed(0), mesh)
        step = make_train_step(cfg, opt, mesh)
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
        losses, norms, step_s = [], [], []
        ops.reset_launches()
        for _ in range(SHARDED_STEPS):
            batch = token_batch(stream, cfg.vocab, dev)
            ev[0].record()
            params, state, m = step(params, state, batch)
            ev[1].record()
            torch.cuda.synchronize()
            losses.append(float(m["loss"]))
            norms.append(float(m["grad_norm"]))
            step_s.append(ev[0].elapsed_time(ev[1]) / 1e3)
        launches = ops.kernel_launches()
        peak_gb = torch.cuda.max_memory_allocated() / 1e9
        check(all(isinstance(x, DTensor)
                  for x in tree_leaves((params, state["m"], state["v"]))),
              "[sharded] the state is not DTensors after the steps")
        check(not any(launches.values()),
              f"[sharded] hand-written kernels launched: {launches}")
        want = np.asarray([full["losses"][:SHARDED_STEPS],
                           full["grad_norms"][:SHARDED_STEPS]])
        got = np.asarray([losses, norms])
        check(np.allclose(got, want, rtol=TRAIN_BF16_RTOL, atol=0),
              f"[sharded] losses/norms {got.tolist()} vs phase 14 "
              f"{want.tolist()} beyond rtol={TRAIN_BF16_RTOL}")
        with FlopCounterMode(display=False) as fc:
            step(params, state, batch)
        torch.cuda.synchronize()
        counted = float(fc.get_total_flops())
        split, n_kernels = profiled_kernels(
            lambda: step(params, state, batch), cpu=False)
        del params, state
    finally:
        dist.destroy_process_group()
    out = {"losses": losses, "grad_norms": norms, "step_s": step_s,
           "phase14_median_step_s": full["median_step_s"],
           "host_cost_s": float(np.median(step_s)) - full["median_step_s"],
           "peak_gb": peak_gb, "counted_flops": counted,
           "max_rel_vs_phase14": float(np.abs(got / want - 1).max()),
           "profiled_step": {"device_ms": sum(split.values()),
                             "device_kernels": n_kernels}}
    log(f"[sharded] {smi}: " + json.dumps(out))
    return out


def step_roofline(full: dict, sharded: dict, rates: dict, smi: str) -> dict:
    """Phase 16 (c): phase 14's measured step against the perf model and
    the 6·N·T model FLOPs at the card's peak."""
    cfg = get_config(TRAIN_ARCH)
    shape = ShapeConfig("phase14", TRAIN_S, TRAIN_B, "train")
    perf = perfmodel.train_cell(cfg, shape, perfmodel.MeshDims(1, 1, 1),
                                perfmodel.PerfKnobs(grad_accum=1))
    model_flops = 6.0 * cfg.n_active_params() * TRAIN_B * TRAIN_S
    median = full["median_step_s"]
    t_c = perf.flops / roofline.PEAK_FLOPS
    t_m = perf.hbm_bytes / roofline.HBM_BW
    out = {"perfmodel_flops": perf.flops, "perfmodel_hbm_bytes":
           perf.hbm_bytes, "perfmodel_coll_bytes": perf.coll_bytes,
           "t_compute_s": t_c, "t_memory_s": t_m,
           "counted_flops": sharded["counted_flops"],
           "model_flops": model_flops,
           "model_flops_s": model_flops / roofline.PEAK_FLOPS,
           "median_step_s": median,
           "roofline_fraction": model_flops / roofline.PEAK_FLOPS / median,
           "achieved_tflops": model_flops / median / 1e12,
           "share_of_card_matmul_rate": model_flops / median / 1e12
           / rates["matmul_bf16_tflops"]}
    log(f"[roofline] {smi}: phase 14 step " + json.dumps(out))
    return out


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is "
              "false)", file=sys.stderr)
        return 2
    dev = torch.device("cuda")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t_start = time.perf_counter()
    log(f"torch {torch.__version__} cuda {torch.version.cuda} "
        f"python {sys.version.split()[0]}")

    t0 = time.perf_counter()
    ops.build_all()
    log(f"[build] nvcc sm_90a for {sorted(ops.SIGNATURES)} in "
        f"{time.perf_counter() - t0:.1f} s -> {ops.BUILD_DIR}")
    smi = card_line()
    return phases(dev, smi, t_start)


def phases(dev, smi: str, t_start: float) -> int:
    """Phases 2-16 after the build."""

    window, new_window = kernels_at_window(dev)
    wkv = wkv6_at_shapes(dev)

    ops.reset_launches()
    with CaptureKernelInputs() as cap:
        card = main_path("cuda")
    launches = ops.kernel_launches()
    log(f"[main cuda] kernel launches {launches}")
    for name in KERNELS:
        check(launches[name] > 0, f"{name} was not launched on the main path")

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

    t0 = time.perf_counter()
    piped = pipeline_path(dev)
    log(f"[pipeline] phases 11-12 in {time.perf_counter() - t0:.1f} s")

    ops.reset_launches()
    gw_card = gateway_path("cuda", card)
    gw_launches = ops.kernel_launches()
    check(not any(gw_launches.values()),
          f"[gateway] the gateway path launched kernels: {gw_launches}")
    gw_cpu = gateway_path("cpu", card)
    set_device("cuda")
    compare_gateways(gw_card, gw_cpu)
    del cpu["table"], cpu["E"], card["E"]     # phase 14 reads card's table
    log("[gateway] " + json.dumps({"gateway": {
        dev: {k: r[k] for k in ("ingest_s", "total_s", "times",
                                "latency_ms", "device", "coalesce")}
        for dev, r in (("cuda", gw_card), ("cpu", gw_cpu))},
        "kernel_launches": gw_launches}))
    log("[compare] card and CPU gateway answers agree")

    served = serve_path(dev)
    rglru = rglru_at_shapes(dev)
    flash = flash_at_shapes(dev)
    gc.collect()                      # the rwkv6 weights went with phase 6
    torch.cuda.empty_cache()
    log(f"[rg-serve] device memory before: "
        f"{torch.cuda.memory_allocated() / 1e9:.2f} GB allocated")
    rg = rg_serve_path(dev)

    gc.collect()
    torch.cuda.empty_cache()
    log(f"[families] device memory before: "
        f"{torch.cuda.memory_allocated() / 1e9:.2f} GB allocated")
    fam = families_path(dev)

    gc.collect()
    torch.cuda.empty_cache()
    log(f"[train] device memory before: "
        f"{torch.cuda.memory_allocated() / 1e9:.2f} GB allocated")
    trained = train_path(dev, card, smi)
    rates = device_rates(smi)
    roof = step_roofline(trained["full_width"], trained["sharded"], rates,
                         smi)
    examples = examples_path()
    # the host-heavy dry runs after the last timed phase
    dry = dryrun_path(smi)

    for a in ops.kernel_attributes():
        log(f"[attrs] {a['kernel']}: {a['registers']} registers, "
            f"{a['static_smem']} B static + {a['dynamic_smem']} B dynamic "
            f"shared, {a['local_bytes']} B local")

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
    head, long_, floor = wkv
    rows.append({
        "name": "wkv6", "route": "cuda", "source": WKV_SOURCE,
        "replaces": WKV_REPLACES, "launches": served["launches"],
        "max_abs_err": max(head["max_abs_err"], long_["max_abs_err"],
                           floor["max_abs_err"],
                           served["main_shape"]["max_abs_err"]),
        "ms": head["ms"], "kernel_ms": head["ms"],
        "plain_ms": head["plain_ms"], "bound_ms": head["bound_ms"],
        "bound_by": head["bound_by"], "library_ms": None,
        "library": "none: no single PyTorch call computes WKV-6",
        "shape": head["shape"],
        "long": {k: long_[k] for k in ("shape", "ms", "plain_ms",
                                       "bound_ms", "max_abs_err")},
        "clip_floor": {k: floor[k] for k in ("shape", "ms", "plain_ms",
                                             "max_abs_err", "max_abs")},
        "main_path": {k: served["main_shape"][k] for k in
                      ("shape", "ms", "plain_ms", "bound_ms",
                       "max_abs_err")},
        "serve": dict(served["times"], device=served["busy"]),
    })
    head, long_ = rglru
    main_r = rg["main_rglru"]
    rows.append({
        "name": "rglru_scan", "route": "cuda", "source": RGLRU_SOURCE,
        "replaces": RGLRU_REPLACES, "launches": rg["launches"]["rglru_scan"],
        "max_abs_err": max(head["max_abs_err"], long_["max_abs_err"],
                           main_r["max_abs_err"]),
        "ms": head["ms"], "kernel_ms": head["ms"],
        "plain_ms": head["plain_ms"], "bound_ms": head["bound_ms"],
        "bound_by": head["bound_by"], "library_ms": None,
        "library": "none: no single PyTorch call computes the recurrence",
        "shape": head["shape"],
        "long": {k: long_[k] for k in ("shape", "ms", "plain_ms",
                                       "bound_ms", "max_abs_err")},
        "main_path": {k: main_r[k] for k in ("shape", "ms", "plain_ms",
                                             "bound_ms", "max_abs_err")},
    })
    head, long_, gqa, vision, *mla = flash
    main_f = rg["main_flash"]
    main_v = fam["vision"].pop("main_flash")
    keys = ("shape", "kv_heads", "dtype", "window", "ms", "plain_ms",
            "library_ms", "bound_ms", "bound_by", "max_abs_err")
    bf16_keys = keys + ("band_rel_err_vs_f32",)
    rows.append({
        "name": "flash_attention", "route": "cuda", "source": FLASH_SOURCE,
        "replaces": FLASH_REPLACES,
        "launches": rg["launches"]["flash_attention"]
        + fam["vision"]["launches"]["flash_attention"],
        "launches_by_path": {
            RG_ARCH: rg["launches"]["flash_attention"],
            VISION_ARCH: fam["vision"]["launches"]["flash_attention"]},
        "max_abs_err": max(m["max_abs_err"]
                           for m in flash + [main_f, main_v]),
        "ms": head["ms"], "kernel_ms": head["ms"],
        "plain_ms": head["plain_ms"], "bound_ms": head["bound_ms"],
        "bound_by": head["bound_by"], "library_ms": head["library_ms"],
        "library": "scaled_dot_product_attention(is_causal=True), k and v "
                   "expanded to 16 heads",
        "shape": head["shape"], "kv_heads": head["kv_heads"],
        "max_abs_err_vs_f32": head["max_abs_err_vs_f32"],
        "band_rel_err_vs_f32": head["band_rel_err_vs_f32"],
        "long": {k: long_[k] for k in bf16_keys},
        "gqa_f32": {k: gqa[k] for k in keys},
        "vision_mha": {k: vision[k] for k in bf16_keys},
        "mla": [{k: m[k] for k in bf16_keys + ("v_dim", "scale")}
                for m in mla],
        "main_path": {k: main_f[k] for k in bf16_keys},
        "main_path_vision": {k: main_v[k] for k in bf16_keys},
        "serve": dict(rg["times"], device=rg["busy"],
                      peak_gb=rg["peak_gb"]),
    })
    keys = ("shape", "ms", "plain_ms", "library_ms", "bound_ms", "bound_by",
            "max_abs_err")
    seg_keys = keys + ("device_ms", "device_split_ms", "host_ms",
                       "err_vs_f64", "tol_used_f64")
    for name, spec in SEGSUMS.items():
        head, main_m = new_window[name], piped["main_shapes"][name]
        rows.append({
            "name": name, "route": "cuda", "source": SEGSUM_SOURCE,
            "replaces": spec["replaces"], "launches": piped["launches"][name],
            "max_abs_err": max(head["max_abs_err"], main_m["max_abs_err"]),
            "ms": head["ms"], "kernel_ms": head["ms"],
            "plain_ms": head["plain_ms"], "bound_ms": head["bound_ms"],
            "bound_by": head["bound_by"], "library_ms": head["library_ms"],
            "library": "torch.zeros(S).index_add_(0, ids, vals), ids outside "
                       "[0, S) masked out beforehand",
            "shape": head["shape"], "err_vs_f64": head["err_vs_f64"],
            "tol_used": head["tol_used"], "tol_used_f64": head["tol_used_f64"],
            "device_ms": head["device_ms"],
            "device_split_ms": head["device_split_ms"],
            "host_ms": head["host_ms"],
            "bit_identical": head.get("bit_identical"),
            "main_path": {k: main_m[k] for k in seg_keys},
        })
    sel_w, main_m = new_window["spgemm_sel"], piped["main_shapes"]["spgemm_sel"]
    head = sel_w["plus_times"]
    rows.append({
        "name": "spgemm_sel", "route": "cuda", "source": SOURCE,
        "replaces": SEL_REPLACES, "launches": piped["launches"]["spgemm_sel"],
        "max_abs_err": max([m["max_abs_err"] for m in sel_w.values()]
                           + [main_m["max_abs_err"]]),
        "ms": head["ms"], "kernel_ms": head["ms"],
        "plain_ms": head["plain_ms"], "bound_ms": head["bound_ms"],
        "bound_by": head["bound_by"], "library_ms": head["library_ms"],
        "library": "torch.sparse.mm(CSR A, dense one-hot (C, 8))",
        "shape": head["shape"],
        "max_times": {k: sel_w["max_times"][k] for k in
                      ("ms", "plain_ms", "bound_ms", "max_abs_err")},
        "main_path": {k: main_m[k] for k in keys},
    })
    log("[pipeline] " + json.dumps({
        "pipeline": {"stages": piped["stats"]["stages"],
                     "db_entries": piped["stats"]["db_entries"],
                     "seconds": piped["times"], "c2_ranks": piped["ranks"]}}))
    log("[families] " + json.dumps({"families": fam}))
    log("[train] " + json.dumps({"train": trained}))
    log("[phase16] " + json.dumps({"card": smi, "dryrun": dry,
                                   "rates": rates, "roofline": roof}))
    log("[phase17] " + json.dumps({"card": smi, "examples": examples}))
    log(f"[done] {time.perf_counter() - t_start:.1f} s")
    print(smi)
    print(json.dumps({"kernels": rows}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
