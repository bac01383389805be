"""The port's spans and counters, on the profiler's clock.

Tracing is on exactly while a torch profiler records: the check is
``torch.autograd.profiler._is_profiler_enabled``, the Python mirror of
``torch.autograd._profiler_enabled()`` that the profiler sets at its start
and clears at its stop for fast checks (a module attribute, where the
function is a call into C++).  The benchmark's traced window and
``cli/profile.py`` turn it on; nothing else does, and there is no flag.

  * `span(name, device=None)`: a context manager around a layer's work.
    Off, it costs the one check.  On, it opens the profiler range
    ``regnet::<name>`` (`RANGE`; so the span lies on the profiler's host
    timeline, the clock its device activity is correlated to; the prefix
    keeps a short name such as ``rn`` from being read as a mangled C++
    type) and adds to `name`'s aggregates: the
    calls, the host seconds (``perf_counter_ns``), the seconds its child
    spans cover (self time is the duration less them), the syncs and
    their wait, the parent spans it opened under, and the requests or steps
    it ran in (the occurrences of the outermost span open).  Given a CUDA
    `device`, it also records a pair of CUDA timing events on the device's
    current stream at its ends: the milliseconds from the stream reaching
    the first to it reaching the second.  That is the span's wall time on
    the card's stream, the stream's idle gaps inside it included, not the
    card's work in it: where the host paces the card, it is mostly the
    host's pace.
  * `to_host(t, where)`, `to_device(t, device, where)` and
    `waiting(where)`: every wait of the host for the card on the port's
    serving and training paths goes through one of them (``.cpu()``; an
    upload from pageable memory, which PyTorch follows with a wait for the
    stream, as it does for a tensor made from Python values on the card;
    `waiting` around any other op that synchronizes).  On, each counts one
    sync and the host seconds blocked in it, at `where` and on the
    innermost span.  `to_host` and `waiting` count on every device,
    though on the CPU nothing waits; `to_device` counts where it copies.
  * `count(name, n)`: host counters (``read_bytes``, ``upload_bytes``).
  * `totals()`: everything since the window began, with ``_cuda.launches``
    and ``_cuda.fallbacks`` beside it; `reset()` empties it.  A window
    begins with the first span, wait or count traced after one that ran
    untraced, so each profiled window reads alone.
  * `device_timeline(prof)`: a profile's device busy time (the union
    of its activity intervals) and its longest idle gaps, each labelled with
    the innermost program span open on the host in it.

The spans (`SPANS`): a forward is ``regnet`` > ``sn`` (ScoreNet, with the
slab sort), ``grn`` (center selection, grouping, pool, TwoStageHead,
decode, pose search), ``rn`` (the refine rounds, guard and acceptance);
``extract`` the grasp sets on the host; a training step ``step`` >
``forward`` (``regnet`` and the losses), ``backward`` and ``update``; the
input ``data.prep`` > ``data.read`` and ``data.upload``.  The spans run on
one thread, the caller's.
"""

from __future__ import annotations

import time

import torch
from torch.autograd import profiler as _profiler

# the prefix of the spans' profiler ranges (``cli/profile.py``'s ranges
# share it)
RANGE = "regnet::"
# the program's spans; the stream-timed ones take a `device`
SPANS = ("regnet", "sn", "grn", "rn", "extract", "step", "forward",
         "backward", "update", "data.prep", "data.read", "data.upload")
# pending CUDA event pairs of one span that are folded into its stream
# time once the card has passed them
_FOLD_AT = 64


class _Off:
    """The span and the wait while nothing traces: entering and leaving
    call ``"".format`` (a C function that ignores its arguments and
    returns the falsy ""), so that a span off runs no Python frame but
    `span`'s and leaves an exception to propagate."""

    __slots__ = ()
    __enter__ = __exit__ = staticmethod("".format)


_OFF = _Off()
# set by every span, wait and count made untraced: the next traced one
# begins a window
_idle = True
# the spans open, innermost last
_stack: list = []


class _Stat:
    """One span name's aggregates."""

    __slots__ = ("calls", "host_ns", "child_ns", "syncs", "wait_ns",
                 "self_syncs", "self_wait_ns", "parents", "units",
                 "last_unit", "stream_ms", "pending")

    def __init__(self):
        self.calls = self.host_ns = self.child_ns = 0
        self.syncs = self.wait_ns = self.self_syncs = self.self_wait_ns = 0
        self.parents: dict = {}
        self.units = 0
        self.last_unit = -1
        self.stream_ms = None
        self.pending: list = []

    def fold(self, wait: bool) -> None:
        """The pending event pairs into `stream_ms`: all of them after a
        wait for the last, else those the card has passed."""
        if wait and self.pending:
            self.pending[-1][1].synchronize()
        while self.pending and (wait or self.pending[0][1].query()):
            a, b = self.pending.pop(0)
            self.stream_ms = (self.stream_ms or 0.0) + a.elapsed_time(b)


class _Open:
    """A span while it is open."""

    __slots__ = ("name", "parent", "unit", "range", "t0", "child_ns",
                 "syncs", "wait_ns", "self_syncs", "self_wait_ns",
                 "start", "stream")

    def __init__(self, name, parent, unit):
        self.name, self.parent, self.unit = name, parent, unit
        self.child_ns = self.syncs = self.wait_ns = 0
        self.self_syncs = self.self_wait_ns = 0
        self.start = self.stream = None


class Registry:
    """The aggregates of the spans, waits and counters of one window."""

    def __init__(self):
        self.reset()

    def reset(self) -> None:
        self.stats: dict = {}
        self.sites: dict = {}
        self.counters: dict = {}
        self.syncs = 0
        self.wait_ns = 0
        self.units = 0

    def _begin(self) -> None:
        """At a window's first traced event, what an earlier window left
        goes."""
        global _idle
        if _idle:
            _idle = False
            self.reset()

    # -- spans -----------------------------------------------------------
    def open(self, name: str, device) -> _Open:
        from torch.profiler import record_function
        self._begin()
        parent = _stack[-1] if _stack else None
        if parent is None:
            self.units += 1
            unit = self.units
        else:
            unit = parent.unit
        s = _Open(name, parent, unit)
        s.range = record_function(RANGE + name)
        s.range.__enter__()
        if device is not None and device.type == "cuda":
            s.stream = torch.cuda.current_stream(device)
            s.start = torch.cuda.Event(enable_timing=True)
            s.start.record(s.stream)
        _stack.append(s)
        s.t0 = time.perf_counter_ns()
        return s

    def close(self, s: _Open) -> None:
        dt = time.perf_counter_ns() - s.t0
        pair = None
        if s.start is not None:
            end = torch.cuda.Event(enable_timing=True)
            end.record(s.stream)
            pair = (s.start, end)
        s.range.__exit__(None, None, None)
        if _stack and _stack[-1] is s:
            _stack.pop()
        p = s.parent
        if p is not None:
            p.child_ns += dt
            p.syncs += s.syncs
            p.wait_ns += s.wait_ns
        st = self.stats.get(s.name)
        if st is None:
            st = self.stats[s.name] = _Stat()
        st.calls += 1
        st.host_ns += dt
        st.child_ns += s.child_ns
        st.syncs += s.syncs
        st.wait_ns += s.wait_ns
        st.self_syncs += s.self_syncs
        st.self_wait_ns += s.self_wait_ns
        key = None if p is None else p.name
        st.parents[key] = st.parents.get(key, 0) + 1
        if s.unit != st.last_unit:
            st.units += 1
            st.last_unit = s.unit
        if pair is not None:
            st.stream_ms = st.stream_ms or 0.0
            st.pending.append(pair)
            if len(st.pending) >= _FOLD_AT:
                st.fold(wait=False)

    # -- waits and counters ----------------------------------------------
    def waited(self, where: str, ns: int) -> None:
        self._begin()
        if _stack:
            s = _stack[-1]
            s.syncs += 1
            s.wait_ns += ns
            s.self_syncs += 1
            s.self_wait_ns += ns
        self.syncs += 1
        self.wait_ns += ns
        n, t = self.sites.get(where, (0, 0))
        self.sites[where] = (n + 1, t + ns)

    def count(self, name: str, n: int) -> None:
        self._begin()
        self.counters[name] = self.counters.get(name, 0) + n

    # -- reading ---------------------------------------------------------
    def totals(self) -> dict:
        """{"spans": {name: {calls, units, parents, host_ms, self_ms,
        stream_ms (None unless stream-timed), syncs, wait_ms, self_syncs,
        self_wait_ms}}, "syncs", "wait_ms", "sites": {where: {syncs,
        wait_ms}}, "counters", "units" (outermost spans), "launches",
        "fallbacks"}.  Waits for the card to pass the stream-timed spans'
        last events."""
        from regnet_for_3d_grasping_torch.ops import _cuda
        spans = {}
        for name, st in self.stats.items():
            st.fold(wait=True)
            spans[name] = {
                "calls": st.calls, "units": st.units,
                "parents": dict(st.parents),
                "host_ms": st.host_ns / 1e6,
                "self_ms": (st.host_ns - st.child_ns) / 1e6,
                "stream_ms": st.stream_ms,
                "syncs": st.syncs, "wait_ms": st.wait_ns / 1e6,
                "self_syncs": st.self_syncs,
                "self_wait_ms": st.self_wait_ns / 1e6}
        out = {"spans": spans, "syncs": self.syncs,
               "wait_ms": self.wait_ns / 1e6,
               "sites": {w: {"syncs": n, "wait_ms": t / 1e6}
                         for w, (n, t) in self.sites.items()},
               "counters": dict(self.counters), "units": self.units}
        out["launches"] = {k: v for k, v in _cuda.launches.items() if v}
        out["fallbacks"] = {"fp3_slab": _cuda.fallbacks["fp3_slab"]}
        return out


REGISTRY = Registry()


class _Span:
    __slots__ = ("name", "device", "open")

    def __init__(self, name, device):
        self.name, self.device = name, device

    def __enter__(self):
        self.open = REGISTRY.open(self.name, self.device)
        return self.open

    def __exit__(self, kind, value, tb):
        REGISTRY.close(self.open)
        return None


def span(name: str, device: torch.device | None = None):
    """The span `name` around the block; timed on the card's stream where
    `device` is a CUDA device.  Off: one check."""
    if _profiler._is_profiler_enabled:
        return _Span(name, device)
    global _idle
    _idle = True
    return _OFF


class _Wait:
    __slots__ = ("where", "t0")

    def __init__(self, where):
        self.where = where

    def __enter__(self):
        self.t0 = time.perf_counter_ns()

    def __exit__(self, kind, value, tb):
        REGISTRY.waited(self.where, time.perf_counter_ns() - self.t0)
        return None


def waiting(where: str):
    """Around one op that makes the host wait for the card: counted and
    timed at `where`.  Off: one check."""
    if _profiler._is_profiler_enabled:
        return _Wait(where)
    global _idle
    _idle = True
    return _OFF


def to_host(t: torch.Tensor, where: str) -> torch.Tensor:
    """``t.cpu()``, a wait counted and timed at `where`."""
    with waiting(where):
        return t.cpu()


def to_device(t: torch.Tensor, device, where: str) -> torch.Tensor:
    """``t.to(device)``: from the host, an upload from pageable memory,
    which waits for the card's queue to drain, counted and timed at
    `where`; `t` itself, uncounted, where it is on `device` already."""
    device = torch.device(device)
    if t.device.type == device.type and device.index in (None,
                                                          t.device.index):
        return t
    with waiting(where):
        return t.to(device)


def count(name: str, n: int) -> None:
    """Adds `n` to the host counter `name` (bytes read, uploaded)."""
    global _idle
    if _profiler._is_profiler_enabled:
        REGISTRY.count(name, n)
    else:
        _idle = True


def totals() -> dict:
    return REGISTRY.totals()


def reset() -> None:
    REGISTRY.reset()


# -- reading a profile ----------------------------------------------------
def device_timeline(prof, gaps: int = 10) -> dict:
    """From a torch profile: {"busy_us" (the union of the device's
    activity intervals, not the sum of kernel times), "gaps": the `gaps`
    longest idle intervals between device activity, longest first, as
    [span, us] with the innermost program span open on the host at the
    gap's middle ("no span" where none is)}.  The ranges that
    record_function shows on the device's timeline are not device
    activity."""
    cuda = torch.autograd.DeviceType.CUDA
    events = list(prof.events())
    device = sorted((e.time_range.start, e.time_range.end) for e in events
                    if e.device_type == cuda
                    and not getattr(e, "is_user_annotation", False)
                    and not e.name.startswith(RANGE))
    busy, holes, cur = 0.0, [], None
    for s, t in device:
        if cur is None:
            cur = [s, t]
        elif s > cur[1]:
            busy += cur[1] - cur[0]
            holes.append((cur[1], s))
            cur = [s, t]
        else:
            cur[1] = max(cur[1], t)
    if cur is not None:
        busy += cur[1] - cur[0]
    spans = {RANGE + n for n in SPANS}
    ranges = [(e.time_range.start, e.time_range.end, e.name[len(RANGE):])
              for e in events if e.device_type != cuda and e.name in spans]
    out = []
    for s, t in sorted(holes, key=lambda h: h[0] - h[1])[:gaps]:
        mid = (s + t) / 2
        inner = [r for r in ranges if r[0] <= mid <= r[1]]
        label = (min(inner, key=lambda r: r[1] - r[0])[2] if inner
                 else "no span")
        out.append([label, t - s])
    return {"busy_us": busy, "gaps": out}
