"""``DeviceProfile`` of the card's side alone, read from the profiler's
raw records.

A serving window enqueues millions of operations.  Recording the host's
side of each as well, and ``torch.profiler``'s ``events()``, which
builds a Python object and a tree node for every record (~80 µs a
record on a CPU), took a traced serving window of the card over five
minutes to read.  This profile records the card's activity only and
reads the raw kineto records (~4 µs each).  The readings are
``DeviceProfile``'s: the card's kernels, copies and memsets, not the
annotations mirrored onto its timeline, in absolute profiler µs.  With
no host records there is no marker: the records' clock is the wall
clock (kineto stamps Unix time), which ``offset_check`` measures
against a marker.
"""
from __future__ import annotations

import time

from .profile import _MARK, DeviceProfile


class RawDeviceProfile(DeviceProfile):
    def __enter__(self):
        import torch
        from torch.profiler import ProfilerActivity, profile
        acts = [ProfilerActivity.CPU]       # the CPU tests: nothing to read
        if torch.cuda.is_available():
            torch.cuda.synchronize()
            acts = [ProfilerActivity.CUDA]
        self._prof = profile(activities=acts)
        self._prof.__enter__()
        self.wall0 = time.time()
        return self

    def __exit__(self, *exc):
        import torch
        if torch.cuda.is_available():
            torch.cuda.synchronize()
        self.wall1 = time.time()
        self._prof.__exit__(*exc)
        cuda = torch.autograd.DeviceType.CUDA
        for e in self._prof.profiler.kineto_results.events():
            if e.device_type() == cuda and not (
                    e.is_user_annotation() or e.name().startswith("bench.")):
                self.events.append((e.name(), e.start_ns() / 1e3,
                                    e.end_ns() / 1e3))
        self._offset_us = 0.0
        self.events.sort(key=lambda t: t[1])
        self._prof = None
        return False


def offset_check() -> float:
    """Seconds between the records' clock and the wall clock, by a
    marker recorded at a known wall time (``DeviceProfile``'s way)."""
    import torch
    from torch.profiler import ProfilerActivity, profile, record_function
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        wall = time.time()
        with record_function(_MARK):
            pass
        torch.ones(1, device="cuda").add_(1)
    for e in prof.profiler.kineto_results.events():
        if e.name() == _MARK:
            return wall - e.start_ns() / 1e9
    raise RuntimeError("no marker recorded")
