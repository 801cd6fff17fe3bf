"""Batches of long-document requests in a closed loop through the port's
serving path for a latent-attention model (DeepSeek-V2-Lite:
``repro_torch.launch.serve.generate``, one prefill through the flash
kernel in the decompressed form, then decode steps over the latent
rings in the absorbed form, replayed from one CUDA graph a call).

The loop is ``bench/loops/serve.py``'s, over this configuration's
published keys and weights: set-up resolves the program's configuration
first (a commit that lacks it fails here, within seconds), checks it
against every number of the configuration file, draws the weights from
the seed in the published layout (``bench/traffic/deepseek_v2_weights
.py``) and has the program load them through its own loader
(``repro_torch.models.params_from_published``), then runs one warm-up
batch of each prompt length at the window's shapes, with two decode
steps.  The window runs cycles of batches back to back: a batch holds
``batch`` requests of one prompt length, the lengths in the workload's
fixed order, each prompt's ids drawn uniformly over the vocabulary from
the seed; each request generates ``new_tokens`` greedily with ``s_max``
= prompt + new_tokens.  The window closes at the first cycle boundary
after ``seconds``; ``requests_per_s`` is the requests completed over
the time from the window's start to the last batch's end.

Once the window has closed, every sequence of the last batch of each
length runs through the plain reference (``bench/reference/
deepseek_v2.py``, float32, reading the same weights drawn again from
the seed) over its prompt and its generated tokens, teacher-forced, and
the timed run's logits (the prompt's last position and every decode
step) are compared with the reference's, position by position:
``logits_rel`` is the largest relative norm error of any position of
any sequence.
"""
from __future__ import annotations

import time

import numpy as np

from bench.harness.common import BenchError, Check, Run
from bench.harness.raw_profile import RawDeviceProfile
from bench.harness.spans import host_intervals
from bench.loops.serve import SEED_MASK, position_errors
from bench.reference import deepseek_v2 as ref
from bench.traffic.deepseek_v2_weights import Weights


def program_config(cfg: dict):
    """The program's configuration named by ``cfg["arch"]`` (its smoke
    size where ``cfg`` says ``smoke``), checked against the file's
    numbers."""
    try:
        from repro_torch.configs import get_config, smoke_config
        mcfg = (smoke_config if cfg.get("smoke") else get_config)(cfg["arch"])
        got = as_published(mcfg)
    except (ImportError, AttributeError) as e:
        raise BenchError(f"the program has no configuration "
                         f"{cfg['arch']!r}: {e}") from e
    bad = {k: (v, cfg.get(k)) for k, v in got.items() if cfg.get(k) != v}
    m = mcfg.moe
    if m is None or not m.dropless or m.d_shared % m.d_expert:
        bad["moe"] = (m, "dropless, shared width a multiple of "
                         "moe_intermediate_size")
    if bad:
        raise BenchError(f"the program's {cfg['arch']} differs from "
                         f"{cfg['name']}: {bad}")
    return mcfg


def as_published(mcfg) -> dict:
    """The program's configuration under the published config's keys
    (its fixed choices, such as the greedy softmax router, no q-LoRA
    and gates unscaled, among them)."""
    from repro_torch.models.config import ATTN, rope_for
    r, m = rope_for(mcfg, ATTN), mcfg.moe
    return {
        "num_hidden_layers": mcfg.n_layers, "hidden_size": mcfg.d_model,
        "num_attention_heads": mcfg.n_heads,
        "num_key_value_heads": mcfg.n_kv_heads, "vocab_size": mcfg.vocab,
        "kv_lora_rank": mcfg.kv_lora_rank, "q_lora_rank": None,
        "qk_nope_head_dim": mcfg.qk_nope_head_dim,
        "qk_rope_head_dim": mcfg.qk_rope_head_dim,
        "v_head_dim": mcfg.v_head_dim,
        "first_k_dense_replace": mcfg.first_dense,
        "intermediate_size": mcfg.d_ff,
        "n_routed_experts": m and m.n_experts,
        "num_experts_per_tok": m and m.top_k,
        "moe_intermediate_size": m and m.d_expert,
        "n_shared_experts": m and m.d_shared // m.d_expert,
        "norm_topk_prob": m and m.norm_topk_prob,
        "routed_scaling_factor": 1,
        "moe_layer_freq": 1, "n_group": 1, "topk_group": 1,
        "topk_method": "greedy", "scoring_func": "softmax",
        "hidden_act": "silu", "rope_theta": r.theta,
        "rope_scaling": {"type": r.kind, "factor": r.factor,
                         "original_max_position_embeddings":
                         r.original_max_position, "beta_fast": r.beta_fast,
                         "beta_slow": r.beta_slow, "mscale": r.mscale,
                         "mscale_all_dim": r.mscale_all_dim},
        "rms_norm_eps": mcfg.norm_eps, "attention_bias": mcfg.qkv_bias,
        "tie_word_embeddings": mcfg.tie_embeddings,
    }


class Server:
    """The program under test: the configuration, its weights on the
    device, and one batch of requests served."""

    def __init__(self, cfg: dict, wl: dict, seed: int):
        self.mcfg = program_config(cfg)
        from repro_torch.device import get_device
        from repro_torch.launch.serve import generate
        from repro_torch.models import params_from_published
        self._generate = generate
        self.wl, self.dev = wl, get_device()
        self.weights = Weights(cfg, seed, self.dev)
        self.params = params_from_published(self.mcfg, self.weights)
        self.rng = np.random.default_rng([seed & SEED_MASK, 0xD5A2])

    def prompts(self, length: int) -> np.ndarray:
        return self.rng.integers(0, self.mcfg.vocab, (int(self.wl["batch"]),
                                 length), dtype=np.int32)

    def serve(self, prompts: np.ndarray, new: int = 0):
        """``prompts`` through ``generate``: ``new`` decode steps (the
        workload's by default) into caches sized for the workload's."""
        import torch
        steps = int(self.wl["new_tokens"])
        return self._generate(self.mcfg, self.params,
                              torch.from_numpy(prompts),
                              max_new=new or steps,
                              s_max=prompts.shape[1] + steps, details=True)


def run(cfg: dict, wl: dict, seed: int, seconds: float, trace: bool,
        sync, profile_cls) -> Run:
    """One run of the cell, as ``bench/loops/serve.py`` runs its own (a
    traced window profiled by ``RawDeviceProfile``)."""
    import torch
    from torch.profiler import record_function
    from repro_torch.kernels.ops import kernel_launches
    from repro_torch.obs import Tracer

    t_setup = time.perf_counter()
    prog = Server(cfg, wl, seed)
    lengths = [int(n) for n in wl["prompt_lengths"]]
    for n in lengths:                       # warm-up: every length once
        prog.serve(prog.prompts(n), new=2)
        sync()
    setup_s = time.perf_counter() - t_setup

    tracer = Tracer(max_traces=1 << 12, max_spans=1 << 14) if trace else None
    last = {}       # length -> (prompts, Generated) of its last batch
    done = []       # (length, wall start, wall end, flash launches, trace,
    #                  served)
    failed, errors = 0, []
    prof = RawDeviceProfile().__enter__() if trace else None
    t_start = time.perf_counter()
    t_end = t_start
    while time.perf_counter() - t_start < seconds:
        for n in lengths:
            prompts, tid, ok = prog.prompts(n), None, True
            flash0 = kernel_launches()["flash_attention"]
            w0 = time.time()
            try:
                if tracer is not None:
                    root = tracer.start("batch", length=n)
                    tid = root.trace_id
                    with root, record_function("bench.batch"):
                        out = prog.serve(prompts)
                        sync()
                else:
                    out = prog.serve(prompts)
                    sync()
                # the logits kept for the check wait on the host, so no
                # batch leaves blocks in the card's pool for later ones
                last[n] = (prompts, out._replace(
                    logits=[lg.cpu() for lg in out.logits]))
            except Exception as e:          # counted; the run is not correct
                failed += 1
                last.pop(n, None)
                ok = False
                errors.append(f"length {n}: {type(e).__name__}: {e}")
            t_end = time.perf_counter()
            done.append((n, w0, time.time(),
                         kernel_launches()["flash_attention"] - flash0, tid,
                         ok))
    if prof is not None:
        prof.__exit__(None, None, None)
    peak = torch.cuda.max_memory_allocated() if torch.cuda.is_available() \
        else 0
    window_s = t_end - t_start
    batch = int(wl["batch"])

    checks, checked, notes = check_logits(prog, cfg, wl, last)
    notes.insert(0, f"serve_mla: {len(done)} batches of {batch} in "
                    f"{window_s:.4f} s after {setup_s:.4f} s of set-up; "
                    f"flash launches a batch "
                    f"{sorted({d[3] for d in done})}")
    notes[1:1] = [f"serve_mla: failed batch, {e}" for e in errors[:3]]
    layer = {"done": done, "window_s": window_s, "batch": batch,
             "new_tokens": int(wl["new_tokens"]), "cfg": cfg,
             "on_card": torch.cuda.is_available(), "checked": checked,
             "weights": prog.weights}
    if tracer is not None:
        layer["spans"] = [tracer.spans(d[4]) for d in done]
        layer["host"] = [h for sp in layer["spans"]
                         for h in host_intervals(sp)]
    return Run(attempted=batch * len(done), failed=batch * failed,
               metrics={"requests_per_s": batch * (len(done) - failed)
                        / window_s, "setup_s": setup_s},
               checks=checks, extra_correct=failed == 0 and bool(last),
               notes=notes, layer=layer, profile=prof, peak_bytes=peak)


def check_logits(prog: Server, cfg: dict, wl: dict, last: dict):
    """The compared number: every sequence of the last batch of each
    length, the timed run's logits against the reference's forward over
    prompt + generated tokens, position by position."""
    import torch
    new = int(wl["new_tokens"])
    V = prog.mcfg.vocab
    worst, checked, notes = 0.0, [], []
    for n, (prompts, out) in sorted(last.items()):
        seqs = [torch.cat([torch.from_numpy(p).long(), t]).to(prog.dev)
                for p, t in zip(prompts, out.tokens)]
        with torch.no_grad():
            want = ref.forward(prog.weights, seqs, cfg, last=new + 1)
        got = torch.stack(out.logits, 1)[..., :V].to(want[0].device)
        per = torch.stack([position_errors(g, w)
                           for g, w in zip(got, want)])
        worst = max(worst, float(per.max()))
        checked.append((seqs, want))
        notes.append(f"reference: length {n}, {len(seqs)} sequences: "
                     f"logits_rel {float(per.max())!r} (median "
                     f"{float(per.median())!r}; the prompts' last "
                     f"positions {float(per[:, 0].max())!r})")
    limit = float(wl["limits"]["logits_rel"])
    return [Check("logits_rel", worst, limit)], checked, notes


def control_checks(wl: dict, run: Run) -> dict:
    """The control's reading of one run: the reference with every
    product's inputs rounded to float8_e4m3fn (below the bfloat16 the
    configuration states) in the program's place, on the same
    sequences."""
    import torch
    cfg, new = run.layer["cfg"], int(wl["new_tokens"])
    worst = 0.0
    for seqs, want in run.layer["checked"]:
        with torch.no_grad():
            got = ref.forward(run.layer["weights"], seqs, cfg, last=new + 1,
                              round_to=torch.float8_e4m3fn)
        worst = max(worst, max(float(position_errors(g, w).max())
                               for g, w in zip(got, want)))
    return {"logits_rel": worst}
