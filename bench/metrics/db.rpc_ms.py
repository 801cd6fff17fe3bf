"""Time a request spends in the net store's RPCs: the summed duration of
the program's ``rpc.*`` spans (the shard client's calls and streams)
over the traced window's requests, over the number of requests, in ms.
Job executions run on the gateway's job threads, outside any request's
trace, so a job request counts its submission only.  Moves
``request_p95_ms``."""

from bench.harness.spans import total


def read(run):
    spans = run.layer.get("spans")
    if not spans:
        return None
    return 1e3 * sum(total(s, ("rpc.*",)) for s in spans) / len(spans)
