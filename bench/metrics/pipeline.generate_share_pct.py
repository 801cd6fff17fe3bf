"""Share of the pipeline's task time that Stage 0 takes: the
``generate`` stage's ``total_s`` (the capture emulation a pass contains)
over all stages' ``total_s``, from ``run_pipeline``'s per-stage stats,
summed over the traced window's passes, in %.  Moves
``ingest_pkts_per_s``."""


def read(run):
    passes = run.layer.get("passes")
    if not passes:
        return None
    gen = sum(st["stages"].get("generate", {}).get("total_s", 0.0)
              for st, _ in passes)
    every = sum(v.get("total_s", 0.0) for st, _ in passes
                for v in st["stages"].values())
    return 100.0 * gen / every if every else None
