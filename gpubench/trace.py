"""The device trace of a measured window, reduced to what the per-layer
metrics read.

``start_profiler()`` runs ``torch.profiler`` (CPU and CUDA activity) around
the window; ``summarize()`` turns its raw events (``kineto_results.events()``, each
kernel launch, copy and set as the device ran it) into a ``TraceSummary``.
Device events are clipped to the window, which the harness marks with the
annotation ``WINDOW``.  The arithmetic follows ``chip_smoke.profile_steps``
and ``tools/step_compare.py`` (device time a GPU, ``Memcpy PtoP`` by name),
with two differences: every event is kept, not only those ``key_averages``
folds by name, and busy time is the union of the device's intervals, so that
two streams running at once count once.
"""

from __future__ import annotations

import bisect
import contextlib
import re
from dataclasses import dataclass, field

WINDOW = "gpubench.window"
#: device idle gaps shorter than this are not named by a host op
MIN_GAP_NS = 2_000


@dataclass
class Span:
    name: str
    start_ns: int
    end_ns: int


@dataclass
class TraceSummary:
    window_s: float
    #: seconds with at least one kernel, copy or set running, by device index
    busy_s: dict
    #: device seconds and launches by name, over every device
    device_s: dict
    device_n: dict
    #: device seconds by device index and name
    by_device: dict
    #: idle seconds of the devices by the innermost host op that overlapped
    #: the gap's middle ("host: python" where none did)
    idle_by_host: dict = field(default_factory=dict)

    def seconds(self, pattern: str) -> float:
        """Device seconds of the ops whose name matches ``pattern``."""
        rx = re.compile(pattern)
        return sum(s for n, s in self.device_s.items() if rx.search(n))

    def count(self, pattern: str) -> int:
        rx = re.compile(pattern)
        return sum(c for n, c in self.device_n.items() if rx.search(n))

    def idle_percent(self, devices: list) -> float:
        """The share of the window in which no kernel, copy or set ran,
        %, the mean over ``devices``."""
        busy = [self.busy_s.get(d.index, 0.0) for d in devices]
        return 100.0 * (1.0 - sum(busy) / len(busy) / self.window_s)

    def breakdown(self, k: int = 10, width: int = 160) -> dict:
        """The ``k`` device ops that took the most time and the ``k`` host
        ops behind the most idle time, names cut to ``width`` characters."""
        top = sorted(self.device_s.items(), key=lambda kv: -kv[1])[:k]
        gaps = sorted(self.idle_by_host.items(), key=lambda kv: -kv[1])[:k]
        return {"device_ops": [[n[:width], s] for n, s in top],
                "idle_gaps": [[n[:width], s] for n, s in gaps]}


def _merge(intervals: list) -> list:
    out = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return out


def reduce(device: list, host: list, window: Span) -> TraceSummary:
    """``device``: (device index, name, start ns, end ns) of each kernel,
    copy and set; ``host``: ``Span``s of the host ops of the thread that ran
    the window.  Everything is clipped to ``window``."""
    w0, w1 = window.start_ns, window.end_ns
    device_s: dict = {}
    device_n: dict = {}
    by_device: dict = {}
    intervals: dict = {}
    for idx, name, s, e in device:
        s, e = max(s, w0), min(e, w1)
        if e <= s:
            continue
        sec = (e - s) / 1e9
        device_s[name] = device_s.get(name, 0.0) + sec
        device_n[name] = device_n.get(name, 0) + 1
        per = by_device.setdefault(idx, {})
        per[name] = per.get(name, 0.0) + sec
        intervals.setdefault(idx, []).append((s, e))
    merged = {i: _merge(iv) for i, iv in intervals.items()}
    busy = {i: sum(e - s for s, e in m) / 1e9 for i, m in merged.items()}

    hosts = sorted((h for h in host if h.name != WINDOW), key=lambda h: h.start_ns)
    starts = [h.start_ns for h in hosts]
    idle: dict = {}
    for m in merged.values():
        edges = [w0] + [x for s, e in m for x in (s, e)] + [w1]
        for g0, g1 in zip(edges[::2], edges[1::2]):
            if g1 - g0 < MIN_GAP_NS:
                continue
            mid = (g0 + g1) // 2
            name = "host: python"
            j = bisect.bisect_right(starts, mid) - 1
            for k in range(j, max(j - 256, -1), -1):  # innermost op holding mid
                if hosts[k].end_ns >= mid:
                    name = hosts[k].name
                    break
            idle[name] = idle.get(name, 0.0) + (g1 - g0) / 1e9
    n_dev = max(len(merged), 1)
    for name in idle:
        idle[name] /= n_dev
    return TraceSummary((w1 - w0) / 1e9, busy, device_s, device_n, by_device, idle)


def start_profiler():
    """A started ``torch.profiler.profile`` of CPU and CUDA activity."""
    from torch.profiler import ProfilerActivity, profile

    prof = profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA])
    prof.start()
    return prof


def warm_device_tracing() -> None:
    """One short profiler window over one kernel.  In a process whose first
    profiler window comes after a CUDA graph's capture, the graph's copies
    read near 0 (``chip_smoke.start_device_tracing``): a run that traces
    calls this in set-up, before its step is captured."""
    import torch

    prof = start_profiler()
    torch.ones(8, device="cuda").add_(1)
    torch.cuda.synchronize()
    prof.stop()


@contextlib.contextmanager
def window_annotation():
    from torch.profiler import record_function

    with record_function(WINDOW):
        yield


def summarize(prof) -> "TraceSummary | None":
    """Reduce a stopped profiler's raw events; the host ops are those of the
    thread that opened the window.  None when it holds no window annotation
    or no device activity."""
    from torch.autograd import DeviceType

    device, cpu, window = [], [], None
    for e in prof.profiler.kineto_results.events():
        if e.device_type() == DeviceType.CUDA:
            if not e.is_user_annotation():
                device.append((e.device_index(), e.name(), e.start_ns(), e.end_ns()))
        elif e.name() == WINDOW:
            window = (Span(e.name(), e.start_ns(), e.end_ns()), e.start_thread_id())
        else:
            cpu.append((e.start_thread_id(), Span(e.name(), e.start_ns(), e.end_ns())))
    if window is None or not device:
        return None
    span, thread = window
    # CUDA runtime calls carry the tracer's own thread ids: keep them all
    return reduce(device, [s for t, s in cpu if t == thread or s.name.startswith("cuda")], span)
