"""Nestable wall-clock spans with a thread-safe in-process collector (port
of `repro.telemetry.spans`; DESIGN.md §7).

The whole subsystem is OFF by default: `span(...)` returns a shared no-op
context manager until `enable()` installs a collector, so instrumented hot
paths (the survey dispatch loop, the tile loop) pay a global read and
nothing else.

Two measurement regimes:

  host spans      `with span("survey.dispatch", bucket=key):` around host
                  code.  CUDA launches are ASYNC, so a span that should
                  time device work must sync: `span(..., device_sync=x)` or
                  `sp.sync(result)` registers values (tensors, or tuples,
                  lists and dicts of them, or a callable returning one) on
                  whose CUDA devices the span calls `torch.cuda.synchronize`
                  at exit — otherwise it times the enqueue, not the compute.
  regions         `with annotate("ops.tile_pass", T=4):` — a span that also
                  enters `torch.profiler.record_function`, so the region is
                  named on a `torch.profiler` timeline.

With `enable(torch_profiler=True)` (or ``REPRO_TELEMETRY_TORCH=1``) every
span also enters `torch.profiler.record_function`.

Exporters: `chrome_trace()` emits the Chrome ``chrome://tracing`` /
Perfetto JSON (phase-"X" complete events, microsecond timestamps);
`flat()` a plain list of span dicts; `export(path)` / `export_flat(path)`
write them.
"""
from __future__ import annotations

import json
import os
import threading
import time
from typing import Any, Dict, List, Optional


class SpanRecord:
    """One completed span (durations in seconds, starts relative to the
    collector's epoch so traces from one process line up)."""

    __slots__ = ("name", "start", "dur", "depth", "tid", "attrs")

    def __init__(self, name: str, start: float, dur: float, depth: int,
                 tid: int, attrs: Dict[str, Any]):
        self.name = name
        self.start = start
        self.dur = dur
        self.depth = depth
        self.tid = tid
        self.attrs = attrs

    def to_dict(self) -> dict:
        return {"name": self.name, "start_s": self.start, "dur_s": self.dur,
                "depth": self.depth, "tid": self.tid, "attrs": self.attrs}

    def __repr__(self):
        return (f"SpanRecord({self.name!r}, start={self.start:.6f}, "
                f"dur={self.dur:.6f}, depth={self.depth})")


def _jsonable(v):
    """Attrs must survive json.dump (tuples of ints, numpy scalars...)."""
    if isinstance(v, (tuple, list)):
        return [_jsonable(x) for x in v]
    if isinstance(v, dict):
        return {str(k): _jsonable(x) for k, x in v.items()}
    if isinstance(v, (bool, int, float, str)) or v is None:
        return v
    import numpy as np
    if isinstance(v, np.integer):
        return int(v)
    if isinstance(v, np.floating):
        return float(v)
    return repr(v)


def _cuda_devices(v, out: set) -> set:
    """The CUDA devices of every tensor in `v` (nested tuples, lists,
    dicts)."""
    import torch
    if isinstance(v, torch.Tensor):
        if v.is_cuda:
            out.add(v.device)
    elif isinstance(v, (tuple, list)):
        for x in v:
            _cuda_devices(x, out)
    elif isinstance(v, dict):
        for x in v.values():
            _cuda_devices(x, out)
    return out


def device_sync(value):
    """Wait for the CUDA devices holding any tensor of `value` (a tensor or
    a nest of tuples, lists and dicts of them) to finish their queued work;
    a value on the CPU needs no wait.  Returns `value`."""
    devices = _cuda_devices(value, set())
    if devices:
        import torch
        for d in devices:
            torch.cuda.synchronize(d)
    return value


class _Span:
    """The live context-manager object `span()` yields while collecting."""

    __slots__ = ("_collector", "name", "attrs", "_sync", "_t0",
                 "_cancelled", "_region", "_profiled")

    def __init__(self, collector: "SpanCollector", name: str,
                 device_sync=None, attrs: Optional[dict] = None,
                 profiled: bool = False):
        self._collector = collector
        self.name = name
        self.attrs = attrs or {}
        self._sync = [] if device_sync is None else [device_sync]
        self._t0 = None
        self._cancelled = False
        self._region = None
        self._profiled = profiled or collector.torch_profiler

    def sync(self, value):
        """Register a value whose CUDA work the span waits for at exit (so
        it times device compute, not the enqueue).  Returns the value
        unchanged for inline use."""
        self._sync.append(value)
        return value

    def cancel(self):
        """Drop this span: nothing is recorded at exit."""
        self._cancelled = True

    def __enter__(self):
        c = self._collector
        if self._profiled:
            import torch
            self._region = torch.profiler.record_function(self.name)
            self._region.__enter__()
        c._enter()
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, exc_type, exc, tb):
        for v in self._sync:
            device_sync(v() if callable(v) else v)
        t1 = time.perf_counter()
        depth = self._collector._exit()
        if self._region is not None:
            self._region.__exit__(exc_type, exc, tb)
        if not self._cancelled:
            self._collector.add_span(self.name, self._t0, t1 - self._t0,
                                     nest_depth=depth, **self.attrs)
        return False


class _NullSpan:
    """Shared no-op stand-in when telemetry is disabled."""

    __slots__ = ()

    def sync(self, value):
        return value

    def cancel(self):
        pass

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


_NULL = _NullSpan()


class SpanCollector:
    """Thread-safe in-process span store.

    Spans nest per thread (a thread-local depth stack); records carry
    (name, start, dur, depth, tid, attrs) and export either as a flat
    JSON list or as a Chrome-trace/Perfetto event stream.
    """

    def __init__(self, torch_profiler: bool = False):
        self.torch_profiler = bool(torch_profiler)
        self.epoch = time.perf_counter()
        self._records: List[SpanRecord] = []
        self._lock = threading.Lock()
        self._local = threading.local()

    # --- nesting bookkeeping ------------------------------------------------

    def _depth(self) -> int:
        return getattr(self._local, "depth", 0)

    def _enter(self) -> int:
        d = self._depth()
        self._local.depth = d + 1
        return d

    def _exit(self) -> int:
        d = self._depth() - 1
        self._local.depth = d
        return d

    # --- recording ----------------------------------------------------------

    def span(self, name: str, device_sync=None, **attrs) -> _Span:
        return _Span(self, name, device_sync=device_sync, attrs=attrs)

    def add_span(self, name: str, start: float, dur: float,
                 nest_depth: Optional[int] = None, **attrs):
        """Record an already-measured interval (`start` from
        `time.perf_counter()`): the manual twin of `span()`, for code that
        knows only afterwards what the interval was.  `nest_depth` is the
        nesting level (default: the thread's current depth)."""
        rec = SpanRecord(name, start - self.epoch, dur,
                         self._depth() if nest_depth is None else nest_depth,
                         threading.get_ident(), _jsonable(attrs))
        with self._lock:
            self._records.append(rec)

    # --- reading / exporting ------------------------------------------------

    def records(self) -> List[SpanRecord]:
        with self._lock:
            return list(self._records)

    def names(self) -> List[str]:
        return [r.name for r in self.records()]

    def clear(self):
        with self._lock:
            self._records.clear()

    def flat(self) -> List[dict]:
        return [r.to_dict() for r in self.records()]

    def chrome_trace(self) -> dict:
        """Chrome ``chrome://tracing`` / Perfetto JSON object format:
        phase-"X" (complete) events with microsecond ts/dur — nesting is
        reconstructed by the viewer from containment per tid."""
        pid = os.getpid()
        events = []
        for r in sorted(self.records(), key=lambda r: (r.start, -r.dur)):
            events.append({
                "name": r.name, "ph": "X", "cat": r.name.split(".")[0],
                "ts": r.start * 1e6, "dur": r.dur * 1e6,
                "pid": pid, "tid": r.tid, "args": r.attrs,
            })
        return {"traceEvents": events, "displayTimeUnit": "ms"}

    def export(self, path: str) -> str:
        """Write the Chrome trace JSON; returns the path."""
        d = os.path.dirname(os.path.abspath(path))
        os.makedirs(d, exist_ok=True)
        with open(path, "w") as f:
            json.dump(self.chrome_trace(), f, indent=1)
        return path

    def export_flat(self, path: str) -> str:
        d = os.path.dirname(os.path.abspath(path))
        os.makedirs(d, exist_ok=True)
        with open(path, "w") as f:
            json.dump(self.flat(), f, indent=1)
        return path


# ---------------------------------------------------------------------------
# Module-level switchboard (the API call sites use)
# ---------------------------------------------------------------------------

_ACTIVE: Optional[SpanCollector] = None


def enable(torch_profiler: Optional[bool] = None) -> SpanCollector:
    """Install (and return) a fresh process-wide collector.
    `torch_profiler` defaults from ``REPRO_TELEMETRY_TORCH`` (truthy ->
    every span also enters `torch.profiler.record_function`)."""
    global _ACTIVE
    if torch_profiler is None:
        torch_profiler = os.environ.get("REPRO_TELEMETRY_TORCH", "") not in \
            ("", "0", "false")
    _ACTIVE = SpanCollector(torch_profiler=torch_profiler)
    return _ACTIVE


def disable():
    global _ACTIVE
    _ACTIVE = None


def collector() -> Optional[SpanCollector]:
    return _ACTIVE


def active() -> bool:
    return _ACTIVE is not None


def span(name: str, device_sync=None, **attrs):
    """A timing span — no-op (shared null object) when telemetry is off."""
    c = _ACTIVE
    if c is None:
        return _NULL
    return c.span(name, device_sync=device_sync, **attrs)


def add_span(name: str, start: float, dur: float, **attrs):
    """Manually record an interval on the active collector (no-op off)."""
    c = _ACTIVE
    if c is not None:
        c.add_span(name, start, dur, **attrs)


def annotate(name: str, **attrs):
    """A span that also enters `torch.profiler.record_function`, naming the
    region on a profiler timeline.  No-op when telemetry is off."""
    c = _ACTIVE
    if c is None:
        return _NULL
    return _Span(c, name, attrs={"trace_region": True, **attrs},
                 profiled=True)


__all__ = ["SpanCollector", "SpanRecord", "enable", "disable", "collector",
           "active", "span", "add_span", "annotate", "device_sync"]
