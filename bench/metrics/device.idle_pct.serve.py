"""Share of the serving cell's traced window in which nothing ran on
the card: 100 x (1 - union of the device's kernel, copy and memset
intervals / the window), from ``torch.profiler``.  Moves
``requests_per_s``."""


def read(run):
    p = run.profile
    if p is None or not p.window_s or not p.events:
        return None
    return 100.0 * (1.0 - p.busy_s / p.window_s)
