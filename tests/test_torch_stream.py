"""The port's streaming analytics (``repro_torch.stream``) against the JAX
package's, on the same seeded scenarios: the scenario generator, the
hierarchical rollup (every window summary, per-level totals and their
conservation), the online detectors' alerts, and root-cause ranking.

Counts, keys and host names must match exactly.  Floats that come from
the device (rank-size fits, fused C2 scores, PageRank) match within
rtol=1e-5, atol=1e-7: float32 in both packages, reduced in another order.
Everything else (SPC z-scores, shares) is float64 host code and matches
exactly."""
import json
import math
import threading

import numpy as np
import pytest

from _hyp import given, settings, st  # hypothesis, skipping when absent
from repro import stream as jstream
from repro.db import DB as JDB
from repro_torch import stream
from repro_torch.analytics import fit_degree_table
from repro_torch.db import DB
from repro_torch.device import set_device
from repro_torch.stream.windows import _pow2_pad

RTOL, ATOL = 1e-5, 1e-7
T0 = 1_492_000_000.0


@pytest.fixture(autouse=True)
def _cpu():
    prev = set_device("cpu")
    yield
    set_device(prev)


def attack_cfg(pkg, seed=3):
    """``tests/test_stream.py``'s canonical mix (diurnal background plus
    one c2, scan and ddos attack), built with ``pkg``'s classes."""
    return pkg.ScenarioConfig(
        duration_s=150.0, n_hosts=96, base_rate=70.0, seed=seed, t0=T0,
        attacks=(
            pkg.AttackSpec("c2", start=5, duration=140, n_hosts=8,
                           period_s=2.0, port=6667),
            pkg.AttackSpec("scan", start=30, duration=10, rate=60.0),
            pkg.AttackSpec("ddos", start=85, duration=10, n_hosts=8,
                           rate=40.0, port=80),
        ))


def clean_cfg(pkg):
    return pkg.ScenarioConfig(duration_s=120.0, n_hosts=64, base_rate=70.0,
                              seed=0, t0=T0)


def same_json(got, want, path="$"):
    """Recursive equality of JSON-shaped values: keys, strings, bools and
    integers exactly; floats within RTOL/ATOL (NaN equals NaN)."""
    if isinstance(want, dict):
        assert isinstance(got, dict) and set(got) == set(want), \
            (path, sorted(got), sorted(want))
        for k in want:
            same_json(got[k], want[k], f"{path}.{k}")
    elif isinstance(want, (list, tuple)):
        assert isinstance(got, (list, tuple)) and len(got) == len(want), \
            (path, got, want)
        for i, (g, w) in enumerate(zip(got, want)):
            same_json(g, w, f"{path}[{i}]")
    elif isinstance(want, float) and not isinstance(want, bool):
        assert isinstance(got, (float, int)) and not isinstance(got, bool), \
            (path, got, want)
        if math.isnan(want):
            assert math.isnan(got), (path, got)
        else:
            assert abs(got - want) <= ATOL + RTOL * abs(want), \
                (path, got, want)
    else:
        assert type(got) is type(want) and got == want, (path, got, want)


def as_json(x):
    return json.loads(json.dumps(x))


def drive(pkg, cfg):
    """Stream a scenario block by block through a rollup and detector
    bank, running the detectors as windows close (the reference test's
    ``driven`` fixture)."""
    rec, truth = pkg.synth_scenario(cfg)
    roll = pkg.TemporalRollup(lateness_s=2.0)
    bank = pkg.DetectorBank(roll)
    alerts = []
    for _, A in pkg.stream_blocks(cfg, rec=rec):
        roll.ingest(*A.triples())
        alerts.extend(bank.process())
    alerts.extend(bank.process(force=True))
    return dict(cfg=cfg, rec=rec, truth=truth, roll=roll, bank=bank,
                alerts=alerts)


@pytest.fixture(scope="module")
def driven():
    prev = set_device("cpu")
    out = {"port": drive(stream, attack_cfg(stream)),
           "ref": drive(jstream, attack_cfg(jstream))}
    set_device(prev)
    return out


class TestSynth:
    @pytest.mark.parametrize("cfg", [attack_cfg, clean_cfg])
    def test_scenario_equals_reference(self, cfg):
        rec, truth = stream.synth_scenario(cfg(stream))
        jrec, jtruth = jstream.synth_scenario(cfg(jstream))
        assert rec.dtype == jrec.dtype and np.array_equal(rec, jrec)
        assert truth == jtruth

    def test_blocks_and_incidence_equal_reference(self, driven):
        d, j = driven["port"], driven["ref"]
        got = list(stream.stream_blocks(d["cfg"], rec=d["rec"]))
        want = list(jstream.stream_blocks(j["cfg"], rec=j["rec"]))
        assert [s for s, _ in got] == [s for s, _ in want]
        for (_, A), (_, B) in zip(got, want):
            for x, y in zip(A.triples(), B.triples()):
                assert np.asarray(x).tolist() == np.asarray(y).tolist()
        A, ta = stream.scenario_incidence(d["cfg"])
        B, tb = jstream.scenario_incidence(j["cfg"])
        assert A.nnz == B.nnz and ta == tb
        assert [a["kind"] for a in d["truth"]["attacks"]] == \
            ["c2", "scan", "ddos"]


class TestRollup:
    @pytest.mark.parametrize("level", ["second", "minute", "hour"])
    def test_summaries_equal_reference(self, driven, level):
        got = [w.to_dict() for w in
               driven["port"]["roll"].summaries(level, limit=10_000)]
        want = [w.to_dict() for w in
                driven["ref"]["roll"].summaries(level, limit=10_000)]
        assert got
        same_json(as_json(got), as_json(want))

    def test_window_summary_fields_and_roundtrip(self, driven):
        assert stream.WindowSummary._fields == jstream.WindowSummary._fields
        w = driven["port"]["roll"].summaries("minute", limit=1)[0]
        back = stream.WindowSummary.from_dict(json.loads(w.to_json()))
        assert back.n_cells == w.n_cells and back.top_dst == w.top_dst
        assert back.alpha == pytest.approx(w.alpha)

    def test_totals_conserve_and_equal_reference(self, driven):
        roll, jroll = driven["port"]["roll"], driven["ref"]["roll"]
        tots = {lv: roll.totals(lv) for lv, _ in roll.levels}
        for lv, t in tots.items():
            j = jroll.totals(lv)
            assert t["n_cells"] == j["n_cells"]
            assert t["n_packets"] == j["n_packets"]
            assert t["deg"] == j["deg"]
        # conservation: every level holds the same cells, packets, degrees
        assert len({t["n_cells"] for t in tots.values()}) == 1
        assert len({t["n_packets"] for t in tots.values()}) == 1
        assert tots["second"]["n_packets"] == driven["port"]["rec"].shape[0]
        secs = {w.start: w for w in roll.summaries("second", limit=10_000)}
        for m in roll.summaries("minute", limit=10_000):
            kids = [w for s, w in secs.items()
                    if m.start <= s < m.start + m.width]
            assert sum(w.n_cells for w in kids) == m.n_cells
            assert sum(w.n_packets for w in kids) == m.n_packets
        assert roll.stats() == jroll.stats()

    def test_slice_equals_reference(self, driven):
        lo, hi = T0 + 20.0, T0 + 23.0
        A = driven["port"]["roll"].slice(lo, hi)
        B = driven["ref"]["roll"].slice(lo, hi)
        for x, y in zip(A.triples(), B.triples()):
            assert np.asarray(x).tolist() == np.asarray(y).tolist()

    def test_degree_view_fit_equals_reference(self, driven):
        from repro.analytics import fit_degree_table as jfit
        roll, jroll = driven["port"]["roll"], driven["ref"]["roll"]
        start = roll.summaries("minute", limit=1)[0].start
        fit = fit_degree_table(roll.degree_view("minute", start), "ip.dst|")
        jf = jfit(jroll.degree_view("minute", start), "ip.dst|")
        for a, b in ((fit.alpha, jf.alpha), (fit.r2, jf.r2)):
            assert float(a) == pytest.approx(float(b), rel=RTOL, abs=ATOL)

    @settings(max_examples=25, deadline=None)
    @given(n=st.integers(0, 300))
    def test_pow2_pad_equals_reference(self, n):
        from repro.stream.windows import _pow2_pad as jpad
        d = np.arange(n, dtype=np.float32)
        got = _pow2_pad(d)
        assert np.array_equal(got, jpad(d))
        assert got.shape[0] >= max(n, 1) and got.shape[0] & \
            (got.shape[0] - 1) == 0


class TestDetectors:
    def test_alerts_equal_reference(self, driven):
        got = [a.to_dict() for a in driven["port"]["alerts"]]
        want = [a.to_dict() for a in driven["ref"]["alerts"]]
        assert {a["kind"] for a in want} >= {"c2", "scan", "ddos"}
        same_json(as_json(got), as_json(want))
        assert driven["port"]["bank"].stats() == driven["ref"]["bank"].stats()

    def test_each_attack_alerted_and_named(self, driven):
        d = driven["port"]
        c2, scan, ddos = d["truth"]["attacks"]
        for att in (c2, scan, ddos):
            assert [a for a in d["alerts"] if a.kind == att["kind"]
                    and a.window_start < att["stop"]
                    and a.window_stop > att["start"]], att["kind"]
        assert any(a.victim == c2["victim"] for a in d["alerts"]
                   if a.kind == "c2")
        for a in d["alerts"]:
            if a.kind == "scan":
                assert scan["attackers"][0] in a.hosts.tolist()
            if a.kind == "ddos":
                assert a.victim == ddos["victim"]

    def test_clean_diurnal_equal_reference_and_quiet(self):
        got = drive(stream, clean_cfg(stream))["alerts"]
        want = drive(jstream, clean_cfg(jstream))["alerts"]
        same_json(as_json([a.to_dict() for a in got]),
                  as_json([a.to_dict() for a in want]))
        assert not [a for a in got if a.kind in ("c2", "scan", "ddos")]
        assert len(got) <= 2

    def test_root_cause_equals_reference(self, driven):
        """The DDoS window's root cause at the defaults (30 iterations):
        the same hosts in the same order, ranks within tolerance, and
        injected attackers in the top 3."""
        att = driven["port"]["truth"]["attacks"][2]
        args = (att["start"] - 1.0, att["stop"] + 1.0, [att["victim"]])
        rc = stream.root_cause(driven["port"]["roll"], *args, top_k=3)
        jrc = jstream.root_cause(driven["ref"]["roll"], *args, top_k=3)
        assert rc.hosts.tolist() == jrc.hosts.tolist()
        np.testing.assert_allclose(rc.ranks, np.asarray(jrc.ranks),
                                   rtol=RTOL, atol=ATOL)
        assert rc.seeds.tolist() == jrc.seeds.tolist()
        assert len([h for h in rc.hosts if h in att["attackers"]]) >= 2
        assert att["victim"] not in rc.hosts
        back = stream.RootCauseReport.from_dict(json.loads(rc.to_json()))
        assert np.array_equal(np.asarray(back.hosts, dtype=str), rc.hosts)

    def test_stream_analytics_seeds_from_alerts(self, driven):
        """With no seeds, the newest overlapping alert supplies them (the
        DDoS victim), so the ranking equals the explicit one."""
        d = driven["port"]
        att = d["truth"]["attacks"][2]
        sa = stream.StreamAnalytics(rollup=d["roll"], bank=d["bank"])
        rc = sa.root_cause(att["start"] - 1.0, att["stop"] + 1.0, top_k=3,
                           num_iters=10)
        explicit = stream.root_cause(d["roll"], att["start"] - 1.0,
                                     att["stop"] + 1.0, rc.seeds.tolist(),
                                     top_k=3, num_iters=10)
        assert rc.seeds.shape[0] >= 1
        assert rc.hosts.tolist() == explicit.hosts.tolist()

    @settings(max_examples=20, deadline=None)
    @given(seed=st.integers(0, 10_000), shift=st.floats(0.0, 40.0),
           floor=st.sampled_from([0.0, 0.05, 0.15]))
    def test_western_electric_equals_reference(self, seed, shift, floor):
        rng = np.random.default_rng(seed)
        xs = np.r_[100 + rng.normal(0, 3, 40), 100 + shift
                   + rng.normal(0, 3, 20)]
        we = stream.WesternElectric(min_baseline=10, sigma_floor_frac=floor)
        jwe = jstream.WesternElectric(min_baseline=10,
                                      sigma_floor_frac=floor)
        assert [we.update(x) for x in xs] == [jwe.update(x) for x in xs]


class TestIngestTap:
    def test_tap_on_net_table_equals_reference(self):
        """The rollup as a WriterPool ingest tap on a net-backed table,
        blocks put from four threads: totals equal a batch recount of the
        table and the reference's tap on its own net table."""
        out = {}
        for tag, pkg, mk in (("port", stream, DB), ("ref", jstream, JDB)):
            cfg = pkg.ScenarioConfig(duration_s=30.0, n_hosts=48,
                                     base_rate=50.0, seed=9, t0=T0)
            blocks = list(pkg.stream_blocks(cfg))
            T = mk("Tedge", "TedgeT", "TedgeDeg", backend="net",
                   n_instances=2, tablets_per_instance=2)
            sa = pkg.StreamAnalytics().attach(T)
            lanes = [blocks[i::4] for i in range(4)]
            threads = [threading.Thread(
                target=lambda bl: [T.put(A, sync=False) for _, A in bl],
                args=(lane,)) for lane in lanes]
            for t in threads:
                t.start()
            for t in threads:
                t.join(timeout=60)
            T.flush()
            A = T[:, :].eval()
            roll = sa.rollup
            for lv, _ in roll.levels:
                assert roll.totals(lv)["n_cells"] == A.nnz
            assert T.writer().stats()["n_taps"] == 1
            assert T.writer().stats()["tap_errors"] == 0
            out[tag] = ({lv: roll.totals(lv) for lv, _ in roll.levels},
                        [w.to_dict() for w in
                         (roll.close_due(force=True))])
            sa.close()
            T.close()
            T.backend.close()
        assert out["port"][0] == out["ref"][0]
        same_json(as_json(out["port"][1]), as_json(out["ref"][1]))
