"""Mean time of a batch's prefill over the traced window: the program's
``model.prefill`` spans (``repro_torch.launch.serve.generate``: the
prompt through every layer, the caches built, the first tokens on the
host), in ms.  ``None`` when the program records no such span.  Moves
``requests_per_s``."""


def read(run):
    durs = [s["dur_s"] for sp in run.layer.get("spans") or ()
            for s in sp if s["name"] == "model.prefill"]
    return 1e3 * sum(durs) / len(durs) if durs else None
