"""The first milestone: the port's examples (``repro_torch.examples``)
against the call sequences of the JAX package's ``examples/``, at the
examples' own configurations, with the same answers.

Each port example's ``run`` gives its results as plain values; the JAX
side runs the reference example's calls here.  Host results (tables,
field statistics and correlated pairs, detector hosts, scan sources,
connection counts, stage bytes, entries) must be equal exactly; device
floats (the rank-size fit, C2 scores, PageRank) within rtol=1e-5,
atol=1e-7.  The analytics run on the memory and the LSM backend, as the
example offers both.  Each example's ``main`` prints its results and
closing line from ``run``'s values; quickstart's printed lines equal the
reference script's."""
import contextlib
import glob
import importlib
import io
import os
import runpy
import sys
from pathlib import Path

import numpy as np
import pytest

from repro_torch.device import set_device
from repro_torch.examples import (pcap_analytics, pcap_pipeline, quickstart,
                                  train_packet_lm)
from repro_torch.models import params_from_jax

RTOL, ATOL = 1e-5, 1e-7
PACKAGES = ("repro_torch", "repro")
ROOT = Path(__file__).resolve().parents[1]


@pytest.fixture(autouse=True)
def _cpu():
    prev = set_device("cpu")
    yield
    set_device(prev)


def mod(pkg, name):
    return importlib.import_module(f"{pkg}.{name}")


def printed(example, results, monkeypatch, *args) -> str:
    """What an example module's ``main`` prints for ``results`` (its
    ``run`` replaced by one that returns them)."""
    monkeypatch.setattr(example, "run", lambda *a, **k: results)
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        example.main(*args)
    return out.getvalue()


# ---------------------------------------------------------------------------
# examples/quickstart.py
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def quickstart_runs():
    """The port's ``run`` and printed lines, the reference script's
    globals and printed lines."""
    prev = set_device("cpu")
    got = quickstart.run()
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        quickstart.main()
    set_device(prev)
    ref, path = io.StringIO(), list(sys.path)
    try:
        with contextlib.redirect_stdout(ref):
            g = runpy.run_path(str(ROOT / "examples" / "quickstart.py"))
    finally:
        sys.path[:] = path          # the script puts src/ first
    return got, out.getvalue(), g, ref.getvalue()


class TestQuickstart:
    def test_tables_exact(self, quickstart_runs):
        got, _, g, _ = quickstart_runs
        assert [got[k] for k in ("dense", "incidence", "connections",
                                 "adjacency", "degree")] == \
            [str(g[k]) for k in ("A", "E", "conns", "Adj", "deg")]
        assert got["src_nnz"] == g["src_block"].nnz
        assert got["edges"] == list(zip(*g["heavy"].triples()[:2]))

    def test_pagerank(self, quickstart_runs):
        got, _, g, _ = quickstart_runs
        np.testing.assert_allclose(got["pagerank"], np.asarray(g["pr"]),
                                   rtol=RTOL, atol=ATOL)

    def test_printed_lines_equal_the_reference(self, quickstart_runs):
        _, lines, _, ref = quickstart_runs
        assert lines == ref


def analytics_example(backend, path):
    """``examples/pcap_analytics.py``'s calls through the JAX package,
    results as ``repro_torch.examples.pcap_analytics.run`` gives them."""
    from repro import analytics, core, db, pipeline
    from repro.pipeline import pcap
    traffic = pipeline.TrafficConfig(n_hosts=512, pkt_rate=400.0, n_bots=16,
                                     beacon_period_s=4.0, seed=7)
    T = db.DB("Tedge", "TedgeT", "TedgeDeg", backend=backend, path=path,
              n_instances=2, tablets_per_instance=4)
    rec = pcap.synth_packets(traffic, 60.0)
    E = core.val2col(core.parse_tsv(pcap.records_to_tsv(rec)))
    db.put(T, E.putval("1,"))
    T.flush()
    del E
    window = T[:, :].eval()
    out = {"shape": tuple(window.shape), "n_entries": T.n_entries,
           "field_stats": analytics.field_stats(window),
           "top_pairs": analytics.top_correlated_pairs(window, top_k=3),
           "field_names": analytics.field_names(window)}
    corr = analytics.field_correlation(window, "ip.src", "tcp.dstport")
    out["corr"] = [np.asarray(x).tolist() for x in corr.triples()]
    fit = analytics.fit_degree_table(T, "ip.dst|")
    out["fit"] = [float(fit.alpha), float(fit.r2)]
    truth = pipeline.botnet_truth(traffic)
    rep = analytics.detect_c2(T, top_k=5)
    out["c2"], out["c2_truth"] = rep.hosts.tolist(), truth["c2"]
    out["c2_scores"] = np.asarray(rep.scores, float).tolist()
    out["scanners"] = np.asarray(
        analytics.scan_detect(T, min_fanout=24)).tolist()
    c2 = truth["c2"]
    touched = T[:, f"ip.src|{c2},"].sum(1) + T[:, f"ip.dst|{c2},"].sum(1)
    conns = (touched.logical().T * T[:, "ip.dst|*,"]) \
        + (touched.logical().T * T[:, "ip.src|*,"])
    out["connections_nnz"] = conns.eval().nnz
    hosts, pr = analytics.distributed.pagerank_table(T, num_iters=30)
    pr = np.asarray(pr, np.float64)
    top = np.argsort(pr)[::-1][:5]
    out["pagerank"] = ([str(hosts[i]) for i in top], pr[top].tolist())
    T.close()
    return out


@pytest.fixture(scope="module", params=["memory", "lsm"])
def analytics_runs(request, tmp_path_factory):
    prev = set_device("cpu")
    path = {pkg: (str(tmp_path_factory.mktemp(f"{pkg}_lsm"))
                  if request.param == "lsm" else None) for pkg in PACKAGES}
    out = {"repro_torch": pcap_analytics.run(request.param,
                                             path["repro_torch"]),
           "repro": analytics_example(request.param, path["repro"])}
    set_device(prev)
    return out


class TestAnalyticsExample:
    @pytest.mark.parametrize("key", ["shape", "n_entries", "field_names",
                                     "field_stats", "top_pairs", "corr"])
    def test_dimensional_exact(self, analytics_runs, key):
        got, want = analytics_runs["repro_torch"], analytics_runs["repro"]
        assert got[key] == want[key]

    def test_rank_size_fit(self, analytics_runs):
        got, want = analytics_runs["repro_torch"], analytics_runs["repro"]
        np.testing.assert_allclose(got["fit"], want["fit"], rtol=RTOL,
                                   atol=ATOL)

    def test_c2_top5_and_truth(self, analytics_runs):
        got, want = analytics_runs["repro_torch"], analytics_runs["repro"]
        assert got["c2"] == want["c2"]
        assert got["c2"][0] == got["c2_truth"]
        np.testing.assert_allclose(got["c2_scores"], want["c2_scores"],
                                   rtol=RTOL, atol=ATOL)

    def test_scan_sources_and_connections(self, analytics_runs):
        got, want = analytics_runs["repro_torch"], analytics_runs["repro"]
        assert got["scanners"] == want["scanners"]
        assert got["connections_nnz"] == want["connections_nnz"] > 0

    def test_pagerank_top5(self, analytics_runs):
        (keys, ranks) = analytics_runs["repro_torch"]["pagerank"]
        (jkeys, jranks) = analytics_runs["repro"]["pagerank"]
        assert keys == jkeys
        np.testing.assert_allclose(ranks, jranks, rtol=RTOL, atol=ATOL)

    def test_main_prints_the_c2_line(self, analytics_runs, monkeypatch):
        got = analytics_runs["repro_torch"]
        text = printed(pcap_analytics, got, monkeypatch,
                       [got["backend"]] + ([got["path"]] if got["path"]
                                           else []))
        c2 = got["c2_truth"]
        assert f"  candidate {c2:16s} score=" in text
        assert text.rstrip().splitlines()[-6] == "top PageRank hosts:"
        assert "reopened" not in text


class TestDimensional:
    """The four functions of ``analytics.dimensional`` on small seeded
    incidence arrays: equal to the reference exactly."""

    @pytest.mark.parametrize("seed", range(3))
    def test_all_four_functions(self, seed):
        out = {}
        for pkg in PACKAGES:
            Assoc = mod(pkg, "core").Assoc
            an = mod(pkg, "analytics")
            n = 300
            rows = np.asarray([f"p{i:04d}" for i in range(n)] * 3)
            cols = np.concatenate([
                [f"ip.src|{x}" for x in np.random.default_rng(seed)
                 .integers(0, 20, n)],
                [f"ip.dst|{x}" for x in np.random.default_rng(seed + 1)
                 .integers(0, 9, n)],
                [f"tcp.dstport|{x}" for x in np.random.default_rng(seed + 2)
                 .zipf(2.0, n) % 50]])
            E = Assoc(rows, cols.astype(str), np.ones(3 * n))
            C = an.field_correlation(E, "ip.src", "tcp.dstport")
            out[pkg] = (an.field_names(E), an.field_stats(E),
                        [np.asarray(x).tolist() for x in C.triples()],
                        an.top_correlated_pairs(E, top_k=5),
                        an.top_correlated_pairs(E, sep="|", top_k=1))
        assert out["repro_torch"] == out["repro"]
        assert out["repro"][0] == ["ip.dst", "ip.src", "tcp.dstport"]


def pipeline_example(workdir):
    """``examples/pcap_pipeline.py``'s calls through the JAX package,
    results as ``repro_torch.examples.pcap_pipeline.run`` gives them."""
    from repro import analytics, db, pipeline
    from repro.core.assoc import Assoc
    traffic = pipeline.TrafficConfig(n_hosts=256, pkt_rate=150.0, n_bots=12,
                                     beacon_period_s=5.0, seed=42)
    cfg = pipeline.PipelineConfig(workdir=workdir, n_files=2,
                                  duration_per_file_s=45.0,
                                  split_size=128 * 1024, traffic=traffic,
                                  n_workers=4)
    store = db.MultiInstanceDB(n_instances=2, tablets_per_instance=4)
    stats = pipeline.run_pipeline(cfg, store)
    truth = pipeline.botnet_truth(traffic)
    c2 = truth["c2"]
    E = Assoc()
    for p in sorted(glob.glob(os.path.join(workdir, "*.E.npz"))):
        E = E + Assoc.load(p)
    rep = analytics.detect_c2(E, top_k=5)
    return {
        "bytes": {s: (st.get("bytes_in"), st.get("bytes_out"))
                  for s, st in stats["stages"].items()},
        "db_entries": stats["db_entries"],
        "connections": store.connections(c2),
        "degree": store.degree(f"ip.dst|{c2}"),
        "shape": tuple(E.shape),
        "c2": rep.hosts.tolist(), "c2_truth": c2,
        "scores": np.asarray(rep.scores, float).tolist(),
        "fanin": np.asarray(rep.fanin, float).tolist(),
    }


@pytest.fixture(scope="module")
def pipeline_runs(tmp_path_factory):
    prev = set_device("cpu")
    out = {"repro_torch": pcap_pipeline.run(
               str(tmp_path_factory.mktemp("repro_torch"))),
           "repro": pipeline_example(str(tmp_path_factory.mktemp("repro")))}
    set_device(prev)
    return out


class TestPipelineExample:
    @pytest.mark.parametrize("key", ["bytes", "db_entries", "connections",
                                     "degree", "shape", "fanin"])
    def test_exact(self, pipeline_runs, key):
        assert pipeline_runs["repro_torch"][key] == pipeline_runs["repro"][key]

    def test_c2_top3(self, pipeline_runs):
        got, want = pipeline_runs["repro_torch"], pipeline_runs["repro"]
        assert got["c2"][:3] == want["c2"][:3]
        assert got["c2_truth"] in got["c2"][:3]
        np.testing.assert_allclose(got["scores"], want["scores"], rtol=RTOL,
                                   atol=ATOL)

    def test_main_prints_the_closing_line(self, pipeline_runs, monkeypatch):
        text = printed(pcap_pipeline, pipeline_runs["repro_torch"],
                       monkeypatch)
        assert "  <-- injected C2" in text
        assert text.rstrip().endswith(
            "injected C2 recovered from the traffic. pipeline complete.")


# ---------------------------------------------------------------------------
# examples/train_packet_lm.py
# ---------------------------------------------------------------------------

TRAIN_STEPS = 30
STEP0_RTOL = 1e-3       # the examples' shared tolerance for step 0's loss


def train_example(workdir, jax_params):
    """``examples/train_packet_lm.py``'s calls through the JAX package at
    its own config, from its seeded parameters; the losses and the
    generated text, as ``repro_torch.examples.train_packet_lm.run``
    gives them."""
    import jax
    import jax.numpy as jnp
    from repro import configs, data
    from repro import train as T
    from repro.launch import serve, train
    from repro.launch.mesh import make_smoke_mesh
    pattern = train.synth_corpus(os.path.join(workdir, "data"), n_files=2)
    stream = data.TokenStream(pattern, seq_len=128, batch=4)
    cfg = configs.smoke_config("rwkv6-1.6b")
    opt = T.OptConfig(lr=1e-3, warmup_steps=5)
    params = jax.tree.map(jnp.asarray, jax_params)
    step_fn = jax.jit(T.make_train_step(cfg, opt, make_smoke_mesh(1)))
    opt_state = T.adamw_init(params)
    losses = []
    for _ in range(TRAIN_STEPS):
        batch = {k: jnp.minimum(jnp.asarray(v), cfg.vocab - 1)
                 for k, v in stream.next_batch().items()}
        params, opt_state, m = step_fn(params, opt_state, batch)
        losses.append(float(m["loss"]))
    outs = serve.generate(cfg, params, ["64.22."], max_new=24, s_max=192)
    return {"losses": losses, "outs": outs}


@pytest.fixture(scope="module")
def train_runs(tmp_path_factory):
    import jax
    from repro.configs import smoke_config
    from repro.models import init_params
    prev = set_device("cpu")
    jax_params = jax.tree.map(np.asarray, init_params(
        smoke_config("rwkv6-1.6b"), jax.random.key(0)))
    cfg = smoke_config("rwkv6-1.6b")
    out = {"repro_torch": train_packet_lm.run(
               str(tmp_path_factory.mktemp("repro_torch")),
               params_from_jax(cfg, jax_params, "cpu")),
           "repro": train_example(str(tmp_path_factory.mktemp("repro")),
                                  jax_params)}
    set_device(prev)
    return out


class TestTrainExample:
    def test_step0_loss(self, train_runs):
        np.testing.assert_allclose(train_runs["repro_torch"]["losses"][0],
                                   train_runs["repro"]["losses"][0],
                                   rtol=STEP0_RTOL)

    @pytest.mark.parametrize("pkg", PACKAGES)
    def test_loss_improves(self, train_runs, pkg):
        losses = train_runs[pkg]["losses"]
        assert len(losses) == TRAIN_STEPS and np.isfinite(losses).all()
        assert np.mean(losses[-5:]) < np.mean(losses[:5])

    def test_generate_returns_text(self, train_runs):
        outs = train_runs["repro_torch"]["outs"]
        assert len(outs) == 1 and isinstance(outs[0], str)

    def test_main_prints_the_closing_line(self, train_runs, monkeypatch):
        text = printed(train_packet_lm, train_runs["repro_torch"],
                       monkeypatch)
        assert text.startswith("step   0  loss ")
        assert text.rstrip().endswith(
            "trained on pipeline output; loss improved. done.")
