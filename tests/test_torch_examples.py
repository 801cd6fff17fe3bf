"""The first milestone: the call sequences of ``examples/pcap_analytics.py``
and ``examples/pcap_pipeline.py``, at the examples' own configurations,
through the port and through the JAX package, with the same answers.

Host results (field statistics and correlated pairs, detector hosts,
scan sources, connection counts, stage bytes, entries) must be equal
exactly; device floats (the rank-size fit, C2 scores, PageRank) within
rtol=1e-5, atol=1e-7.  The analytics run on the memory and the LSM
backend, as the example offers both."""
import glob
import importlib
import os

import numpy as np
import pytest

from repro_torch.device import set_device

RTOL, ATOL = 1e-5, 1e-7
PACKAGES = ("repro_torch", "repro")


@pytest.fixture(autouse=True)
def _cpu():
    prev = set_device("cpu")
    yield
    set_device(prev)


def mod(pkg, name):
    return importlib.import_module(f"{pkg}.{name}")


def analytics_example(pkg, backend, path):
    """``examples/pcap_analytics.py``'s calls, results as plain values."""
    analytics, core, db = mod(pkg, "analytics"), mod(pkg, "core"), \
        mod(pkg, "db")
    pipeline, pcap = mod(pkg, "pipeline"), mod(pkg, "pipeline.pcap")
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
    pr = np.asarray(pr.cpu() if hasattr(pr, "cpu") else pr, np.float64)
    top = np.argsort(pr)[::-1][:5]
    out["pagerank"] = ([str(hosts[i]) for i in top], pr[top].tolist())
    T.close()
    return out


@pytest.fixture(scope="module", params=["memory", "lsm"])
def analytics_runs(request, tmp_path_factory):
    prev = set_device("cpu")
    out = {}
    for pkg in PACKAGES:
        path = (str(tmp_path_factory.mktemp(f"{pkg}_lsm"))
                if request.param == "lsm" else None)
        out[pkg] = analytics_example(pkg, request.param, path)
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


def pipeline_example(pkg, workdir):
    """``examples/pcap_pipeline.py``'s calls, results as plain values."""
    pipeline, db = mod(pkg, "pipeline"), mod(pkg, "db")
    Assoc = mod(pkg, "core.assoc").Assoc
    analytics = mod(pkg, "analytics")
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
    out = {pkg: pipeline_example(pkg, str(tmp_path_factory.mktemp(pkg)))
           for pkg in PACKAGES}
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


# ---------------------------------------------------------------------------
# examples/train_packet_lm.py
# ---------------------------------------------------------------------------

TRAIN_STEPS = 30
STEP0_RTOL = 1e-3       # the examples' shared tolerance for step 0's loss


def train_example(pkg, workdir, jax_params):
    """``examples/train_packet_lm.py``'s calls at its own config, from the
    JAX package's seeded parameters (carried across for the port); the
    losses and the generated text."""
    configs, data = mod(pkg, "configs"), mod(pkg, "data")
    serve, train = mod(pkg, "launch.serve"), mod(pkg, "launch.train")
    T = mod(pkg, "train")
    pattern = train.synth_corpus(os.path.join(workdir, "data"), n_files=2)
    stream = data.TokenStream(pattern, seq_len=128, batch=4)
    cfg = configs.smoke_config("rwkv6-1.6b")
    opt = T.OptConfig(lr=1e-3, warmup_steps=5)
    if pkg == "repro":
        import jax
        import jax.numpy as jnp
        params = jax.tree.map(jnp.asarray, jax_params)
        step_fn = jax.jit(T.make_train_step(cfg, opt,
                                            mod(pkg, "launch.mesh")
                                            .make_smoke_mesh(1)))

        def batch_of(b):
            return {k: jnp.minimum(jnp.asarray(v), cfg.vocab - 1)
                    for k, v in b.items()}
    else:
        import torch
        params = mod(pkg, "models").params_from_jax(cfg, jax_params, "cpu")
        step_fn = T.make_train_step(cfg, opt, mod(pkg, "launch.mesh")
                                    .make_smoke_mesh(1))

        def batch_of(b):
            return {k: torch.from_numpy(np.minimum(v, cfg.vocab - 1))
                    for k, v in b.items()}
    opt_state = T.adamw_init(params)
    losses = []
    for _ in range(TRAIN_STEPS):
        params, opt_state, m = step_fn(params, opt_state,
                                       batch_of(stream.next_batch()))
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
    out = {pkg: train_example(pkg, str(tmp_path_factory.mktemp(pkg)),
                              jax_params) for pkg in PACKAGES}
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
