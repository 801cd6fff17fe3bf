"""Writer time a million packets: the ``ingest`` and ``flush`` stages'
``total_s`` from ``run_pipeline``'s per-stage stats (puts through
``db.binding`` into the writer pool, and the flush barrier), summed over
the traced window's passes, over their packets in millions.  Moves
``ingest_pkts_per_s``."""


def read(run):
    passes, n = run.layer.get("passes"), run.layer.get("packets")
    if not passes or not n:
        return None
    s = sum(st["stages"].get(k, {}).get("total_s", 0.0)
            for st, _ in passes for k in ("ingest", "flush"))
    return s / (n / 1e6)
