"""What every cell's run shares: finding the cell's files by name, the
run's context, the device record, the compared numbers and the result
line."""
from __future__ import annotations

import dataclasses
import importlib.util
import json
import math
import os
import sys
from pathlib import Path
from typing import Callable, Optional

BENCH = Path(__file__).resolve().parents[1]
ROOT = BENCH.parent
SRC = ROOT / "src"

# top-level module names that may not be loaded in a run's process: JAX
# and the JAX package the port was made from (names compared whole, so
# the port's own ``repro_torch`` is not among them)
FORBIDDEN_MODULES = ("jax", "jaxlib", "flax", "repro")


class BenchError(RuntimeError):
    """A run that cannot give a result (no card, a missing file)."""


def load_json(kind: str, name: str) -> dict:
    """``bench/<kind>/<name>.json``: a configuration or a workload."""
    path = BENCH / kind / f"{name}.json"
    if not path.is_file():
        raise BenchError(f"no {kind[:-1]} named {name!r} ({path})")
    with open(path) as f:
        return json.load(f)


def load_module(kind: str, name: str):
    """``bench/<kind>/<name>.py`` as a module (metric readers and loops
    are found by the name BENCHMARK.json or a workload gives them)."""
    path = BENCH / kind / f"{name}.py"
    if not path.is_file():
        raise BenchError(f"no {kind[:-1]} named {name!r} ({path})")
    spec = importlib.util.spec_from_file_location(
        f"bench_{kind}_{name.replace('.', '_').replace('-', '_')}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def benchmark_spec() -> dict:
    with open(ROOT / "BENCHMARK.json") as f:
        return json.load(f)


def forbidden_loaded() -> list:
    """Names in ``sys.modules`` whose top-level name is JAX's or the JAX
    package's."""
    return sorted({m for m in sys.modules
                   if m.split(".")[0] in FORBIDDEN_MODULES})


@dataclasses.dataclass
class Check:
    """One compared number beside its limit (passes when ``value`` is at
    most ``limit``)."""
    name: str
    value: float
    limit: float

    @property
    def ok(self) -> bool:
        return math.isfinite(self.value) and self.value <= self.limit


@dataclasses.dataclass
class Run:
    """What a cell's loop hands back: the end-to-end numbers, the
    compared numbers, and the raw material the per-layer readers read."""
    attempted: int
    failed: int
    metrics: dict                   # end-to-end name -> value
    checks: list                    # [Check]
    extra_correct: bool = True      # answers that never came, and the like
    notes: list = dataclasses.field(default_factory=list)   # stderr lines
    layer: dict = dataclasses.field(default_factory=dict)   # reader input
    profile: Optional[object] = None    # harness.profile.DeviceProfile
    peak_bytes: int = 0             # device memory peak, read at the close

    @property
    def correct(self) -> bool:
        return self.extra_correct and all(c.ok for c in self.checks)


def percentile(values, q: float) -> float:
    """Nearest-rank percentile (a failed request counts as infinite)."""
    v = sorted(values)
    if not v:
        return math.inf
    k = max(int(math.ceil(q / 100.0 * len(v))) - 1, 0)
    return v[k]


def emit(run: Run, metric_names: list, units: dict, device: dict,
         breakdown: Optional[dict], log: Callable = print) -> None:
    """Print the compared numbers last on standard error, then the
    result line last on standard output with ``checks`` as its last
    key."""
    for line in run.notes:
        print(line, file=sys.stderr)
    metrics = {}
    for name in metric_names:
        if name in run.metrics and run.metrics[name] is not None:
            metrics[name] = {"value": run.metrics[name], "unit": units[name]}
    checks = {c.name: {"value": c.value, "limit": c.limit}
              for c in run.checks}
    for c in run.checks:
        print(f"check {c.name} {c.value!r} limit {c.limit!r} "
              f"{'ok' if c.ok else 'FAILED'}", file=sys.stderr)
    out = {"correct": run.correct, "attempted": run.attempted,
           "failed": run.failed, "metrics": metrics, "device": device}
    if breakdown is not None:
        out["breakdown"] = breakdown
    out["checks"] = checks
    sys.stderr.flush()
    log(json.dumps(out))
    sys.stdout.flush()


def setup_paths() -> None:
    """Make the port importable from the checkout's ``src`` and keep the
    run's caches inside the checkout."""
    if str(SRC) not in sys.path:
        sys.path.insert(0, str(SRC))
    if str(ROOT) not in sys.path:
        sys.path.insert(0, str(ROOT))
    os.environ.setdefault("USE_FLAX", "0")
    os.environ["TRITON_CACHE_DIR"] = str(ROOT / "build" / "triton_cache")
    os.environ["TORCH_EXTENSIONS_DIR"] = str(ROOT / "build" /
                                             "torch_extensions")
