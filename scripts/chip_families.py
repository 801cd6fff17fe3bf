#!/usr/bin/env python3
"""chip_smoke's model-family checks alone, on one CUDA card: the kernel
build, phase 8's phi-3-vision case of ``flash_attention`` (8, 1024, 32,
96) bf16 MHA against its plain version, and phase 15 (granite-moe,
whisper and phi-3-vision at full width through ``generate``, qwen3-moe
counted on ``meta``, every family's smoke config card against CPU).
About a minute and a half on an H100, against chip_smoke's five.

    PYTHONPATH=src python3 scripts/chip_families.py

Exits 2 without a CUDA device; any failed check raises.
"""
from __future__ import annotations

import json
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

import torch  # noqa: E402

import chip_smoke as C  # noqa: E402


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_families: no CUDA device", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")
    t0 = time.perf_counter()
    C.ops.build_all()
    C.log(f"[build] {time.perf_counter() - t0:.1f} s")
    case = next(c for c in C.FLASH_CASES if c[3] == c[2] and c[4] == 96)
    m = C.measure_flash(*C.flash_inputs(case, dev), causal=case[6],
                        window=case[7])
    C.log("[flash] " + json.dumps(m))
    fam = C.families_path(dev)
    C.log("[families] " + json.dumps({"families": fam}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
