"""Mean time of one decode step of a batch over the traced window: the
program's ``model.decode_step`` spans (one token a sequence through
every layer and the caches, the tokens on the host), in ms.  ``None``
when the program records no such span.  Moves ``requests_per_s``."""


def read(run):
    durs = [s["dur_s"] for sp in run.layer.get("spans") or ()
            for s in sp if s["name"] == "model.decode_step"]
    return 1e3 * sum(durs) / len(durs) if durs else None
