#!/usr/bin/env python3
"""``bench/control.py`` for a cell whose loop computes its own control
(``control_checks(wl, run)`` in ``bench/loops/<loop>.py``: the serving
loop's reference with float8 products); other loops as there.

    python3 bench/serve_control.py --workload mellum2-12b.repo-ctx \\
        --seeds 11,12,13 --seconds 51 [--out control.json]

Each seed is one run of the cell as ``bench/run.py`` drives it; prints
one JSON line a seed with the program's compared numbers and the
control's.
"""
from __future__ import annotations

import importlib
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

from bench import control  # noqa: E402

by_loop = control.control_checks


def control_checks(wl: dict, run) -> dict:
    loop = importlib.import_module(f"bench.loops.{wl['loop']}")
    own = getattr(loop, "control_checks", None)
    return own(wl, run) if own is not None else by_loop(wl, run)


control.control_checks = control_checks

if __name__ == "__main__":
    sys.exit(control.main())
