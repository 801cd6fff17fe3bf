"""The device's side of a traced window, from ``torch.profiler``.

One profiler over the whole window, tracing the host and the card.
Device records (kernels, copies, memsets: every record on the CUDA side)
give the busy time as the union of their intervals, the operations that
took most time, and the idle gaps.  Host intervals that the loops hand
in (requests and the program's spans, on the wall clock) name what the
host was doing in each gap; the profiler's clock is tied to the wall
clock by a marker recorded at a known wall time.
"""
from __future__ import annotations

import time
from typing import Optional

_MARK = "bench.clock"


class DeviceProfile:
    def __init__(self):
        self._prof = None
        self.wall0 = self.wall1 = None
        self.events = []            # (name, start_us, end_us) on the card
        self._offset_us = 0.0       # wall-clock µs = profiler µs + offset

    def __enter__(self):
        import torch
        from torch.profiler import ProfilerActivity, profile, \
            record_function
        acts = [ProfilerActivity.CPU]
        if torch.cuda.is_available():
            torch.cuda.synchronize()
            acts.append(ProfilerActivity.CUDA)
        self._prof = profile(activities=acts)
        self._prof.__enter__()
        self._mark_wall = time.time()
        with record_function(_MARK):
            pass
        self.wall0 = time.time()
        return self

    def __exit__(self, *exc):
        import torch
        if torch.cuda.is_available():
            torch.cuda.synchronize()
        self.wall1 = time.time()
        self._prof.__exit__(*exc)
        cuda = torch.autograd.DeviceType.CUDA
        mark = None
        for e in self._prof.events():
            if e.device_type != cuda:
                if mark is None and e.name == _MARK:
                    mark = e.time_range.start
            elif not (getattr(e, "is_user_annotation", False) or
                      e.name.startswith("bench.")):
                # a record_function's range mirrored on the card's
                # timeline is an annotation, not work the card did
                self.events.append((e.name, e.time_range.start,
                                    e.time_range.end))
        if mark is not None:
            self._offset_us = self._mark_wall * 1e6 - mark
        else:
            self._offset_us = (self._prof.profiler.kineto_results
                               .trace_start_ns() / 1e3)
        self.events.sort(key=lambda t: t[1])
        self._prof = None
        return False

    # -- readings -----------------------------------------------------------
    @property
    def window_s(self) -> float:
        return self.wall1 - self.wall0

    def wall(self, us: float) -> float:
        """Profiler µs to wall-clock seconds."""
        return (us + self._offset_us) / 1e6

    def _busy(self):
        """Union of the device intervals inside the window, as wall-clock
        (start, end) pairs in seconds."""
        out = []
        for _, s, e in self.events:
            s, e = max(self.wall(s), self.wall0), min(self.wall(e), self.wall1)
            if e <= s:
                continue
            if out and s <= out[-1][1]:
                out[-1][1] = max(out[-1][1], e)
            else:
                out.append([s, e])
        return out

    @property
    def busy_s(self) -> float:
        return sum(e - s for s, e in self._busy())

    def device_ops(self, n: int = 10) -> list:
        """The ``n`` device operations that took most time: [name, s]."""
        tot: dict = {}
        for name, s, e in self.events:
            tot[name] = tot.get(name, 0.0) + (e - s) / 1e6
        top = sorted(tot.items(), key=lambda kv: -kv[1])[:n]
        return [[k[:120], v] for k, v in top]

    def kernel_intervals(self, fragment: str) -> list:
        """Wall-clock (start, end) of the device records whose name holds
        ``fragment``."""
        return [(self.wall(s), self.wall(e)) for name, s, e in self.events
                if fragment in name]

    def idle_gaps(self, host: list, n: int = 10) -> list:
        """The ``n`` longest idle gaps: [what the host was doing, s].
        ``host`` holds (start, end, name, depth) on the wall clock; a gap
        is named after the deepest interval open at its midpoint, with the
        outermost one before it, or ``host`` when none was open."""
        gaps, t = [], self.wall0
        for s, e in self._busy():
            if s > t:
                gaps.append((t, s))
            t = max(t, e)
        if self.wall1 > t:
            gaps.append((t, self.wall1))
        gaps.sort(key=lambda g: g[0] - g[1])
        out = []
        for s, e in gaps[:n]:
            mid = 0.5 * (s + e)
            open_ = sorted((h for h in host if h[0] <= mid <= h[1]),
                           key=lambda h: h[3])
            if not open_:
                name = "host"
            elif len(open_) == 1 or open_[0][2] == open_[-1][2]:
                name = open_[-1][2]
            else:
                name = f"{open_[0][2]} > {open_[-1][2]}"
            out.append([name, e - s])
        return out

    def breakdown(self, host: list) -> dict:
        return {"device_ops": self.device_ops(),
                "idle_gaps": self.idle_gaps(host)}


def device_fields(prof: Optional[DeviceProfile]) -> dict:
    if prof is None:
        return {}
    return {"busy_s": prof.busy_s, "window_s": prof.window_s}
