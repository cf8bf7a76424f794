"""The traced stretch of a ``--trace 1`` run, read from ``torch.profiler``'s
Chrome trace: the benchmark's own span around each call, the program's
spans, the host operators, and the device's kernels, copies and memsets.
Times are microseconds on the trace's clock.
"""
from __future__ import annotations

from collections import defaultdict

CALL_SPAN = "bench.call"
DEVICE_KINDS = {"kernel": "kernel", "gpu_memcpy": "memcpy",
                "gpu_memset": "memset"}
HOST_CATS = ("cpu_op", "user_annotation", "cuda_runtime", "cuda_driver")


def short_name(name: str, limit: int = 160) -> str:
    """A device operation's name without its argument list (a kernel's
    demangled signature), at most ``limit`` characters."""
    name = name.replace("(anonymous namespace)", "(anon)")
    depth = 0
    for i, ch in enumerate(name):
        if ch == "<":
            depth += 1
        elif ch == ">":
            depth -= 1
        elif ch == "(" and depth == 0 and i > 0 and name[i - 1] != " ":
            name = name[:i]
            break
    return name[:limit]


def union(intervals):
    """The sorted, merged union of ``(start, end)`` intervals."""
    out = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return out


def covered(merged, lo, hi) -> float:
    """How much of ``[lo, hi]`` the merged intervals cover."""
    return sum(max(0.0, min(e, hi) - max(s, lo)) for s, e in merged)


class Trace:
    """The events of a traced stretch of calls."""

    def __init__(self, events):
        self.calls = []
        self.spans = defaultdict(list)
        self.device = []
        self.host = []
        for ev in events:
            if ev.get("ph") != "X" or "dur" not in ev:
                continue
            cat, name = ev.get("cat", ""), ev.get("name", "")
            s = float(ev["ts"])
            e = s + float(ev["dur"])
            if cat == "user_annotation":
                if name == CALL_SPAN:
                    self.calls.append((s, e))
                else:
                    self.spans[name].append((s, e))
            if cat in DEVICE_KINDS:
                self.device.append((name, s, e, DEVICE_KINDS[cat]))
            elif cat in HOST_CATS:
                self.host.append((name, s, e))
        self.calls.sort()
        if not self.calls:
            raise ValueError("the trace holds no call span")
        self.window = (self.calls[0][0], self.calls[-1][1])
        self._busy = union([(s, e) for _, s, e, _ in self.device])

    @property
    def ncalls(self) -> int:
        return len(self.calls)

    @property
    def window_us(self) -> float:
        return self.window[1] - self.window[0]

    def busy_us(self, lo=None, hi=None) -> float:
        """Time in ``[lo, hi]`` (default: the window) in which a kernel, a
        copy or a memset ran on the device."""
        lo = self.window[0] if lo is None else lo
        hi = self.window[1] if hi is None else hi
        return covered(self._busy, lo, hi)

    def device_us(self, kinds=("kernel",)) -> float:
        """Summed device time of the window's operations of ``kinds``."""
        lo, hi = self.window
        return sum(max(0.0, min(e, hi) - max(s, lo))
                   for _, s, e, k in self.device if k in kinds)

    def device_count(self, kinds=("kernel", "memcpy", "memset")) -> int:
        lo, hi = self.window
        return sum(1 for _, s, e, k in self.device
                   if k in kinds and s < hi and e > lo)

    def spans_in(self, name, lo, hi) -> list:
        """The program's spans named ``name`` that lie inside ``[lo, hi]``."""
        return [(s, e) for s, e in self.spans.get(name, ())
                if s >= lo and e <= hi]

    def top_device_ops(self, n=10) -> list:
        """``[[name, seconds], ...]``: the device operations that took most
        time in the window, summed by name."""
        tot = defaultdict(float)
        lo, hi = self.window
        for name, s, e, _ in self.device:
            tot[short_name(name)] += max(0.0, min(e, hi) - max(s, lo))
        top = sorted(tot.items(), key=lambda kv: -kv[1])[:n]
        return [[k, v / 1e6] for k, v in top if v > 0]

    def idle_gaps(self, n=10) -> list:
        """``[[host activity, seconds], ...]``: the window's idle device
        time, each gap cut at the calls' edges and each piece named by the
        innermost host operator or span that covers its middle (the call
        span where nothing finer does; "between calls" outside every call),
        summed by name, longest first."""
        lo, hi = self.window
        edges = sorted({t for c in self.calls for t in c})
        gaps, t = [], lo
        for s, e in self._busy + [[hi, hi]]:
            if e <= lo or s > hi:
                continue
            if s > t:
                cuts = [t] + [x for x in edges if t < x < s] + [s]
                gaps += list(zip(cuts[:-1], cuts[1:]))
            t = max(t, e)
        hosts = self.host + [(k, s, e) for k, v in self.spans.items()
                             for s, e in v]
        hosts += [(CALL_SPAN, s, e) for s, e in self.calls]
        tot = defaultdict(float)
        for g0, g1 in gaps:
            mid = 0.5 * (g0 + g1)
            inner = [(e - s, name) for name, s, e in hosts if s <= mid <= e]
            name = min(inner)[1] if inner else "between calls"
            tot[name] += g1 - g0
        top = sorted(tot.items(), key=lambda kv: -kv[1])[:n]
        return [[k, v / 1e6] for k, v in top]


def roofline_share(ctx, core: str, metric: str):
    """The share (%) of the least time of ``core``'s work in the device
    time of every kernel the calls launched (copies left out), or None
    where the configuration has no such work or the trace no kernel.  The
    bound and the times go into ``ctx.notes[metric]``."""
    from benchmark import work
    if core not in ctx.work:
        return None
    kernel_ms = ctx.trace.device_us(("kernel",)) / ctx.trace.ncalls / 1e3
    if kernel_ms <= 0:
        return None
    flops, nbytes = ctx.work[core]
    ms, bound = work.least_ms(flops, nbytes, ctx.card)
    ctx.notes[metric] = dict(bound=bound, least_ms=ms, kernel_ms=kernel_ms,
                             operations=flops, bytes=nbytes)
    return 100.0 * ms / kernel_ms
