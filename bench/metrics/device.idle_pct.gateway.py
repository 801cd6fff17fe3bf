"""Share of a gateway cell's traced window in which nothing ran on the
card: 100 x (1 - union of the device's kernel, copy and memset intervals
/ the window), from ``torch.profiler`` in the gateway's process.  Moves
``request_p95_ms``."""


def read(run):
    p = run.profile
    if p is None or not p.window_s or not p.events:
        return None
    return 100.0 * (1.0 - p.busy_s / p.window_s)
