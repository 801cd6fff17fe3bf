"""Share of the coalescer's requests that a batched eval served: 100 x
the window's change of ``repro_coalesce_coalesced_total`` over that of
coalesced plus ``repro_coalesce_solo_total``, from
``obs.metrics.REGISTRY`` in the gateway's process.  Moves
``request_p95_ms``."""


def _count(snapshot: dict, name: str) -> float:
    return sum(v for (n, _), v in snapshot.items() if n == name)


def read(run):
    if "before" not in run.layer:
        return None
    d = {k: _count(run.layer["after"], k) - _count(run.layer["before"], k)
         for k in ("repro_coalesce_coalesced_total",
                   "repro_coalesce_solo_total")}
    n = sum(d.values())
    return 100.0 * d["repro_coalesce_coalesced_total"] / n if n else None
