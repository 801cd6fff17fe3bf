"""The PyTorch port stands alone: it never imports ``jax`` or the JAX
package ``repro``, and it imports on a CPU-only torch without building
or launching anything."""
import ast
import os
import subprocess
import sys
import textwrap
from pathlib import Path

import numpy as np
import pytest

ROOT = Path(__file__).resolve().parents[1]
PORT = ROOT / "src" / "repro_torch"
SOURCES = sorted(PORT.rglob("*.py")) + [ROOT / "chip_smoke.py"]


def imported_roots(path: Path) -> set:
    roots = set()
    for node in ast.walk(ast.parse(path.read_text(), filename=str(path))):
        if isinstance(node, ast.Import):
            roots.update(a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            roots.add(node.module.split(".")[0])
    return roots


@pytest.mark.parametrize("path", SOURCES, ids=lambda p: str(p.relative_to(ROOT)))
def test_no_jax_or_reference_import(path):
    bad = imported_roots(path) & {"jax", "jaxlib", "repro"}
    assert not bad, f"{path.relative_to(ROOT)} imports {sorted(bad)}"


def test_imports_with_jax_and_reference_blocked():
    script = textwrap.dedent("""
        import sys
        for name in ("jax", "jaxlib", "repro"):
            sys.modules[name] = None        # any import of them raises
        import pkgutil, importlib
        import repro_torch
        names = [m.name for m in pkgutil.walk_packages(
            repro_torch.__path__, "repro_torch.")]
        for name in names:
            importlib.import_module(name)
        import chip_smoke
        assert not any(m == "jax" or m.startswith(("jax.", "repro."))
                       for m in sys.modules if sys.modules[m] is not None)
        from repro_torch.kernels import ops
        assert not ops._LIBS                # nothing built at import
        print(len(names))
    """)
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [str(ROOT / "src"), str(ROOT)]), REPRO_TORCH_DEVICE="cpu")
    out = subprocess.run([sys.executable, "-c", script], env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert int(out.stdout.strip()) >= 20


@pytest.mark.parametrize("module", [
    "repro_torch.models", "repro_torch.configs", "repro_torch.data",
    "repro_torch.launch.serve", "repro_torch.models.layers",
    "repro_torch.models.blocks", "repro_torch.kernels.rglru",
    "repro_torch.kernels.flash_attention"])
def test_serving_modules_import_with_jax_and_reference_blocked(module):
    """The serving slice's packages import on their own, and resolve
    every config, with jax and the JAX package made unimportable."""
    script = textwrap.dedent(f"""
        import sys
        for name in ("jax", "jaxlib", "repro"):
            sys.modules[name] = None
        import importlib
        importlib.import_module({module!r})
        from repro_torch.configs import ARCHS, get_config
        assert len({{get_config(a).name for a in ARCHS}}) == len(ARCHS)
        assert not any(m == "jax" or m.startswith(("jax.", "repro."))
                       for m in sys.modules if sys.modules[m] is not None)
    """)
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"),
               REPRO_TORCH_DEVICE="cpu")
    out = subprocess.run([sys.executable, "-c", script], env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr


@pytest.mark.parametrize("module", [
    "repro_torch.pipeline.runner", "repro_torch.pipeline.stages",
    "repro_torch.pipeline.driver", "repro_torch.kernels.segsum",
    "repro_torch.db.lsmstore"])
def test_pipeline_modules_import_with_jax_and_reference_blocked(module):
    """The pipeline slice's modules import on their own with jax and the
    JAX package made unimportable, and pull in neither."""
    script = textwrap.dedent(f"""
        import sys
        for name in ("jax", "jaxlib", "repro"):
            sys.modules[name] = None
        import importlib
        importlib.import_module({module!r})
        assert not any(m == "jax" or m.startswith(("jax.", "repro."))
                       for m in sys.modules if sys.modules[m] is not None)
        from repro_torch.kernels import ops
        assert not ops._LIBS
    """)
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"),
               REPRO_TORCH_DEVICE="cpu")
    out = subprocess.run([sys.executable, "-c", script], env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr


@pytest.mark.parametrize("module", [
    "repro_torch.analytics.dimensional", "repro_torch.db.netstore",
    "repro_torch.stream", "repro_torch.stream.windows",
    "repro_torch.stream.detectors", "repro_torch.stream.synth",
    "repro_torch.serve", "repro_torch.serve.app", "repro_torch.serve.auth",
    "repro_torch.serve.coalesce", "repro_torch.serve.jobs",
    "repro_torch.serve.ratelimit", "repro_torch.serve.routes",
    "repro_torch.serve.stream", "repro_torch.serve.__main__"])
def test_gateway_modules_import_with_jax_and_reference_blocked(module):
    """The gateway slice's modules import on their own with jax and the
    JAX package made unimportable, pull in neither, and build nothing."""
    script = textwrap.dedent(f"""
        import sys
        for name in ("jax", "jaxlib", "repro"):
            sys.modules[name] = None
        import importlib
        importlib.import_module({module!r})
        assert not any(m == "jax" or m.startswith(("jax.", "repro."))
                       for m in sys.modules if sys.modules[m] is not None)
        from repro_torch.kernels import ops
        assert not ops._LIBS
    """)
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"),
               REPRO_TORCH_DEVICE="cpu")
    out = subprocess.run([sys.executable, "-c", script], env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr


def test_gateway_cli_serves_with_jax_and_reference_blocked(tmp_path):
    """``python -m repro_torch.serve --backend net --stream`` on the CPU,
    with jax and the JAX package unimportable: it prints ``LISTENING``,
    answers a request, and stops on SIGTERM."""
    import signal
    import threading
    import urllib.request
    boot = tmp_path / "boot.py"
    boot.write_text(textwrap.dedent("""
        import runpy, sys
        for name in ("jax", "jaxlib", "repro"):
            sys.modules[name] = None
        sys.argv = ["repro_torch.serve"] + sys.argv[1:]
        runpy.run_module("repro_torch.serve", run_name="__main__")
    """))
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"),
               REPRO_TORCH_DEVICE="cpu")
    proc = subprocess.Popen(
        [sys.executable, str(boot), "--backend", "net", "--n-instances",
         "2", "--token", "smoke:ci:100:200", "--demo-rows", "2000",
         "--stream"], env=env, stdout=subprocess.PIPE, text=True)
    try:
        line = []
        t = threading.Thread(target=lambda: line.append(
            proc.stdout.readline()), daemon=True)
        t.start()
        t.join(timeout=90)
        assert line and line[0].startswith("LISTENING "), line
        r = urllib.request.Request(
            f"http://{line[0].split()[1]}/v1/topk?prefix=ip.dst|&k=3",
            headers={"Authorization": "Bearer smoke"})
        with urllib.request.urlopen(r, timeout=20) as resp:
            body = resp.read().decode()
        assert '"hosts"' in body and '"ip.dst|' in body
    finally:
        proc.send_signal(signal.SIGTERM)
        assert proc.wait(timeout=30) == 0


def test_chip_smoke_refuses_without_card():
    """No result and a non-zero exit where no CUDA device is visible."""
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    out = subprocess.run([sys.executable, str(ROOT / "chip_smoke.py")],
                         env=env, capture_output=True, text=True, timeout=120,
                         cwd=ROOT)
    assert out.returncode != 0
    assert '"ok"' not in out.stdout


def test_chip_smoke_alone_fails(tmp_path):
    """Copied out of the repository, the script finds no port and fails."""
    (tmp_path / "chip_smoke.py").write_text(
        (ROOT / "chip_smoke.py").read_text())
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run([sys.executable, "chip_smoke.py"], env=env,
                         capture_output=True, text=True, timeout=120,
                         cwd=tmp_path)
    assert out.returncode != 0
    assert '"ok"' not in out.stdout


@pytest.mark.parametrize("module", [
    "repro_torch.tree", "repro_torch.launch.mesh", "repro_torch.launch.train",
    "repro_torch.train", "repro_torch.train.optimizer",
    "repro_torch.train.compression", "repro_torch.train.sharding",
    "repro_torch.train.trainer", "repro_torch.data.stream",
    "repro_torch.checkpoint", "repro_torch.checkpoint.manager"])
def test_training_modules_import_with_jax_and_reference_blocked(module):
    """The training slice's modules import on their own with jax and the
    JAX package made unimportable, pull in neither, and build nothing."""
    script = textwrap.dedent(f"""
        import sys
        for name in ("jax", "jaxlib", "repro"):
            sys.modules[name] = None
        import importlib
        importlib.import_module({module!r})
        assert not any(m == "jax" or m.startswith(("jax.", "repro."))
                       for m in sys.modules if sys.modules[m] is not None)
        from repro_torch.kernels import ops
        assert not ops._LIBS
    """)
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"),
               REPRO_TORCH_DEVICE="cpu")
    out = subprocess.run([sys.executable, "-c", script], env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr


def test_train_cli_runs_with_jax_and_reference_blocked(tmp_path):
    """``python -m repro_torch.launch.train --smoke --steps 2`` on the
    CPU, with jax and the JAX package unimportable: it synthesizes the
    corpus through the port's pipeline, trains two steps with finite
    losses and exits 0."""
    boot = tmp_path / "boot.py"
    boot.write_text(textwrap.dedent("""
        import runpy, sys
        for name in ("jax", "jaxlib", "repro"):
            sys.modules[name] = None
        sys.argv = ["repro_torch.launch.train"] + sys.argv[1:]
        runpy.run_module("repro_torch.launch.train", run_name="__main__")
        assert not any(m == "jax" or m.startswith(("jax.", "repro."))
                       for m in sys.modules if sys.modules[m] is not None)
    """))
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"),
               REPRO_TORCH_DEVICE="cpu")
    out = subprocess.run(
        [sys.executable, str(boot), "--smoke", "--steps", "2",
         "--workdir", str(tmp_path / "work")], env=env, capture_output=True,
        text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-3000:]
    steps = [line.split() for line in out.stdout.splitlines()
             if line.startswith("step ")]
    assert [s[1] for s in steps] == ["0", "1"]
    assert all(np.isfinite(float(s[3])) for s in steps)


@pytest.mark.parametrize("module", [
    "repro_torch.models.shard_ctx", "repro_torch.launch.census",
    "repro_torch.launch.dryrun", "repro_torch.launch.perfmodel",
    "repro_torch.launch.roofline", "repro_torch.launch.calibrate",
    "repro_torch.launch.hillclimb"])
def test_launch_tooling_imports_with_jax_and_reference_blocked(module):
    """The launch tooling (dry run, census, perf model, roofline,
    calibration, hill climb) and the activation-sharding context import
    with jax and the JAX package unimportable, and pull in neither: the
    perf model's parity holds without the JAX package's dryrun (which
    sets ``XLA_FLAGS`` at import)."""
    script = textwrap.dedent(f"""
        import os, sys
        for name in ("jax", "jaxlib", "repro"):
            sys.modules[name] = None
        flags = os.environ.get("XLA_FLAGS")
        import importlib
        importlib.import_module({module!r})
        from repro_torch.launch import perfmodel
        perfmodel.cell_perf("rwkv6-1.6b", "train_4k", "single")
        assert os.environ.get("XLA_FLAGS") == flags
        assert not any(m == "jax" or m.startswith(("jax.", "repro."))
                       for m in sys.modules if sys.modules[m] is not None)
        import torch.distributed as dist
        assert not dist.is_initialized()
    """)
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"),
               REPRO_TORCH_DEVICE="cpu")
    out = subprocess.run([sys.executable, "-c", script], env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr


@pytest.mark.parametrize("name", ["quickstart", "pcap_analytics",
                                  "pcap_pipeline", "train_packet_lm"])
def test_examples_import_with_jax_and_reference_blocked(tmp_path, name):
    """``repro_torch.examples``: each module imports with jax and the JAX
    package unimportable, pulls in neither and builds nothing;
    ``python -m repro_torch.examples.quickstart`` runs to its PageRank
    line on the CPU so."""
    boot = tmp_path / "boot.py"
    boot.write_text(textwrap.dedent(f"""
        import importlib, runpy, sys
        for name in ("jax", "jaxlib", "repro"):
            sys.modules[name] = None
        importlib.import_module("repro_torch.examples.{name}")
        if {name!r} == "quickstart":
            runpy.run_module("repro_torch.examples.quickstart",
                             run_name="__main__")
        assert not any(m == "jax" or m.startswith(("jax.", "repro."))
                       for m in sys.modules if sys.modules[m] is not None)
        from repro_torch.kernels import ops
        assert not ops._LIBS
    """))
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"),
               REPRO_TORCH_DEVICE="cpu")
    out = subprocess.run([sys.executable, str(boot)], env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr[-3000:]
    if name == "quickstart":
        assert out.stdout.splitlines()[-1].startswith("pagerank: [")
