"""The general request-mix generator: a workload's ``arrivals`` and
``mix`` parameters to a schedule of gateway requests.

Every seed gets the same set of sizes and arrivals in another order, so
that two seeds differ in what the traffic exercises no more than two
runs of one seed do:

* ``n`` events at ``rate_per_s`` over the window: the inter-arrival gaps
  are the ``n`` mid-quantiles of the exponential distribution, shuffled
  by the seed and scaled to span the window (a Poisson process's gaps,
  in a seeded order);
* each event is ``burst`` requests due at the same instant (a route may
  give its own ``burst``);
* routes are dealt by their ``share`` (largest remainder), each route's
  parameter lists are cycled evenly, and both are shuffled by the seed;
* a scanned host is the window's destination at a mid-quantile of its
  packet distribution (popular hosts as often as they carry packets),
  from all destinations, or from a ``hot_hosts``-strong hot set drawn
  the same way.
"""
from __future__ import annotations

import itertools
import urllib.parse

import numpy as np


def _deal(shares: list, n: int) -> np.ndarray:
    """Route index of each of ``n`` requests, by largest remainder."""
    want = np.asarray(shares, np.float64) / sum(shares) * n
    got = np.floor(want).astype(np.int64)
    for i in np.argsort(-(want - got), kind="stable")[:n - got.sum()]:
        got[i] += 1
    return np.repeat(np.arange(len(shares)), got)


def _quantile_hosts(hosts: np.ndarray, counts: np.ndarray, n: int,
                    rng) -> np.ndarray:
    """``n`` hosts at the mid-quantiles of the packet distribution,
    shuffled."""
    cdf = np.cumsum(counts) / counts.sum()
    idx = np.searchsorted(cdf, (np.arange(n) + 0.5) / n)
    return rng.permutation(hosts[np.minimum(idx, hosts.shape[0] - 1)])


def _combos(params: dict) -> list:
    """Every combination of a route's list-valued parameters."""
    keys = sorted(params)
    vals = [v if isinstance(v, list) else [v] for v in
            (params[k] for k in keys)]
    return [dict(zip(keys, c)) for c in itertools.product(*vals)]


def request(route: str, p: dict, host: str | None = None) -> dict:
    """One request of ``route`` with parameters ``p`` (and, for a scan,
    its host): method, path, body, and what the check needs."""
    q = urllib.parse.urlencode
    if route == "topk":
        return {"method": "GET", "route": route, "params": p,
                "path": f"/v1/topk?{q({'prefix': p['prefix'], 'k': p['k']})}"}
    if route == "scan":
        key = f"{p['field']}|{host}"
        return {"method": "GET", "route": route,
                "params": dict(p, key=key),
                "path": "/v1/scan?" + q({"axis": "col", "keys": key + ",",
                                         "max_cells": p["max_cells"]})}
    if route == "degree":
        return {"method": "GET", "route": route, "params": p,
                "path": f"/v1/degree?{q({'prefix': p['prefix'], 'bins': p['bins']})}"}
    if route == "c2":
        return {"method": "GET", "route": route, "params": p,
                "path": f"/v1/c2?{q({'top_k': p['top_k']})}"}
    if route == "pagerank_job":
        return {"method": "POST", "route": route, "params": p, "job": True,
                "path": "/v1/jobs",
                "body": {"kind": "pagerank",
                         "params": {"top_k": p["top_k"],
                                    "num_iters": p["num_iters"]}}}
    raise ValueError(f"unknown route {route!r}")


def schedule(wl: dict, seed: int, seconds: float, hosts: np.ndarray,
             counts: np.ndarray, rate: float | None = None) -> list:
    """The window's requests in due order, each with its ``due`` time;
    ``rate`` (events a second) overrides the workload's (rate sweeps)."""
    rng = np.random.default_rng([seed, 0x5C4ED])
    rate = float(rate if rate is not None else wl["arrivals"]["rate_per_s"])
    burst = int(wl.get("burst", 1))
    n = max(int(round(rate * seconds)), 1)
    gaps = -np.log1p(-(np.arange(n) + 0.5) / n)
    gaps = rng.permutation(gaps) * (seconds / gaps.sum())
    due = np.concatenate([[0.0], np.cumsum(gaps)[:-1]])
    mix = wl["mix"]
    routes = rng.permutation(_deal([m["share"] for m in mix], n))
    pool = hosts
    if wl.get("hot_hosts"):
        pool = _quantile_hosts(hosts, counts, int(wl["hot_hosts"]), rng)
        counts = np.ones(pool.shape[0])
    sizes = [int(m.get("burst", burst)) for m in mix]
    combos = [_combos(m.get("params", {})) for m in mix]
    per_route = [iter(rng.permutation(
        np.arange(int((routes == i).sum()) * sizes[i]) % len(c)).tolist())
        for i, c in enumerate(combos)]
    n_scan = sum(int((routes == i).sum()) * sizes[i]
                 for i, m in enumerate(mix) if m["route"] == "scan")
    scan_hosts = iter(_quantile_hosts(pool, counts, max(n_scan, 1), rng)
                      .tolist())
    out = []
    for t, i in zip(due.tolist(), routes.tolist()):
        m = mix[i]
        for _ in range(sizes[i]):
            p = combos[i][next(per_route[i])]
            host = next(scan_hosts) if m["route"] == "scan" else None
            out.append(dict(request(m["route"], p, host), due=t))
    return out


def warmup(wl: dict, hosts: np.ndarray) -> tuple:
    """Set-up's requests: every route and parameter combination of the
    mix once, on the most popular host (to be sent one after another),
    and one burst of each route (to be sent at once)."""
    one = [dict(request(m["route"], p, str(hosts[0])), due=0.0)
           for m in wl["mix"] for p in _combos(m.get("params", {}))]
    burst = []
    for m in wl["mix"]:
        n = int(m.get("burst", wl.get("burst", 1)))
        p = _combos(m.get("params", {}))[0]
        if n > 1:
            burst += [dict(request(m["route"], p,
                                   str(hosts[j % hosts.shape[0]])), due=0.0)
                      for j in range(n)]
    return one, burst
