"""Autotune-plan cache: one sweep per configuration, ever (port of
`repro.survey.plan_cache`; DESIGN.md §6).

The `(tile, T, outer_T, overlap)` sweep of `core.temporal_blocking` is
pure host-side arithmetic, but every launcher that needs a plan would
rerun it — thousands of times over a survey whose configuration never
changes.  Results are memoized in memory and, optionally, on disk, keyed
by EVERY input that can change the sweep's output — physics, grid depth,
order, dtype width, candidate tiles/depths, window budget, hardware
constants, and the mesh block.  With the same sweep arguments and every
default passed explicitly, a key equals the reference's.

The cached value is JSON (`TBPlan.to_dict` / `HierPlan.to_dict` plus the
winning sweep-log entry), so the disk cache is a directory of small
self-describing files — safe to delete at any time, shared across
processes.  Consumers: `survey.engine.SurveyEngine` and
`launch/stencil_dist.py --auto-plan`.

Set ``REPRO_PLAN_CACHE_DIR`` to point the default cache's disk tier
somewhere persistent (default: in-memory only, so tests and one-shot
runs never leave files behind).
"""
from __future__ import annotations

import hashlib
import inspect
import json
import os
import threading
import warnings
from typing import Optional, Tuple

from repro_torch.core.temporal_blocking import (HierPlan, TBPlan,
                                                autotune_plan,
                                                plan_for_physics,
                                                plan_hierarchy)
from repro_torch.telemetry import metrics as _tm
from repro_torch.telemetry import spans as _spans

# Bump when the sweep/cost LOGIC changes in a way the resolved parameter
# values cannot express (new pricing terms, different tie-breaking):
# persistent disk caches from older schemas then miss instead of serving
# stale winners.
_KEY_SCHEMA = 1


# `plan_for_physics` arguments that are the caller's checks, not values: a
# key cannot hold them, so a caller that passes one folds what it checks
# against into `key_extra`
_CALLER_CHECKS = frozenset({"feasible"})


def _resolved_defaults(sweep_kwargs: dict) -> dict:
    """The autotune parameters the caller did NOT pass, resolved from
    `autotune_plan`'s own signature defaults — folded into the key so a
    changed default (a recalibrated `link_bw`, a new VMEM budget) can
    never alias a plan swept under the old one."""
    out = {}
    for name, p in inspect.signature(autotune_plan).parameters.items():
        if p.default is inspect.Parameter.empty or name in sweep_kwargs:
            continue
        try:
            out[name] = _canonical(p.default)
        except TypeError:
            pass  # non-literal default (none today); physics fills these
    return out


def _canonical(v):
    """JSON-stable form of one key component (tuples -> lists, recursively)."""
    if isinstance(v, (tuple, list)):
        return [_canonical(x) for x in v]
    if isinstance(v, (bool, int, str)) or v is None:
        return v
    if isinstance(v, float):
        return float(repr(v))  # repr round-trips; str() may truncate
    raise TypeError(f"unsupported plan-cache key component {v!r}")


def plan_cache_key(physics: str, nz: int, order: int,
                   block: Optional[Tuple[int, int]] = None,
                   dtype: str = "float32", key_extra: Optional[dict] = None,
                   **sweep_kwargs) -> str:
    """Stable cache key over everything that can change a sweep's output.

    `sweep_kwargs` is the exact kwargs dict handed to
    `plan_for_physics`/`plan_hierarchy` (tiles, depths, vmem_budget,
    peak_flops, hbm_bw, link_bw, link_latency, ...) — all of it keys, so a
    perturbed hardware model or candidate space can never alias a stale
    plan; `key_extra` folds in caller context the sweep never sees (e.g.
    the survey engine's full grid shape).  The key is
    `<physics>-<nz>-o<order>[-b<bx>x<by>]-<digest>`: human-greppable
    prefix, collision-proof suffix.
    """
    canon = {"schema": _KEY_SCHEMA,
             "physics": physics, "nz": int(nz), "order": int(order),
             "block": None if block is None else [int(b) for b in block],
             "dtype": str(dtype),
             "extra": {k: _canonical(v)
                       for k, v in sorted((key_extra or {}).items())},
             "defaults": _resolved_defaults(sweep_kwargs),
             "kwargs": {k: _canonical(v)
                        for k, v in sorted(sweep_kwargs.items())
                        if k not in _CALLER_CHECKS}}
    digest = hashlib.sha256(
        json.dumps(canon, sort_keys=True).encode()).hexdigest()[:16]
    blk = "" if block is None else f"-b{int(block[0])}x{int(block[1])}"
    return f"{physics}-{int(nz)}-o{int(order)}{blk}-{digest}"


class CacheInfo:
    """What one cache consultation did (for the hit/miss reporting)."""

    def __init__(self, key: str, hit: bool):
        self.key = key
        self.hit = hit

    def __repr__(self):
        return f"CacheInfo(key={self.key!r}, hit={self.hit})"


class PlanCache:
    """Memory + optional-disk cache of autotune sweep results.

    Values are JSON-serializable dicts.  Counters live in a per-instance
    `telemetry.metrics.MetricsRegistry` (mirrored into the process-wide
    registry under ``plan_cache.*`` so `--telemetry` snapshots see them):
      hits          lookups answered from memory or disk
      misses        lookups that fell through (caller sweeps + stores)
      sweeps        actual autotune sweeps run via the cached_* helpers —
                    the number the acceptance test pins to 1
      disk_corrupt  unreadable/torn/schema-invalid disk entries served as
                    misses (the next `store` overwrites the bad file)
    """

    def __init__(self, disk_dir: Optional[str] = None):
        self.disk_dir = disk_dir
        self._mem = {}
        self._lock = threading.Lock()
        self.metrics = _tm.MetricsRegistry()

    def _count(self, name: str, n: int = 1):
        self.metrics.counter(name).inc(n)
        _tm.registry().counter(f"plan_cache.{name}").inc(n)

    # the historical counter attributes stay as the public read API
    # (tests pin `cache.sweeps == 1`)
    @property
    def hits(self) -> int:
        return self.metrics.counter("hits").value

    @property
    def misses(self) -> int:
        return self.metrics.counter("misses").value

    @property
    def sweeps(self) -> int:
        return self.metrics.counter("sweeps").value

    @property
    def disk_corrupt(self) -> int:
        return self.metrics.counter("disk_corrupt").value

    def _path(self, key: str) -> str:
        return os.path.join(self.disk_dir, f"{key}.json")

    def lookup(self, key: str) -> Optional[dict]:
        with self._lock:
            if key in self._mem:
                self._count("hits")
                return self._mem[key]
        if self.disk_dir:
            path = self._path(key)
            if os.path.exists(path):
                # ValueError covers JSONDecodeError AND UnicodeDecodeError
                # (binary garbage); a non-dict payload is equally unusable.
                try:
                    with open(path) as f:
                        val = json.load(f)
                    if not isinstance(val, dict):
                        raise ValueError(f"expected object, got "
                                         f"{type(val).__name__}")
                except (OSError, ValueError) as e:
                    self._report_corrupt(key, e)
                    val = None  # treat as miss; next store overwrites
                if val is not None:
                    with self._lock:
                        self._mem[key] = val
                        self._count("hits")
                    return val
        with self._lock:
            self._count("misses")
        return None

    def invalidate(self, key: str, reason: Exception):
        """Drop a cached value that failed deserialization downstream
        (valid JSON, wrong schema — e.g. a file written by an old layout).
        Counted as corrupt; the caller falls through to a sweep whose
        `store` overwrites the bad disk entry."""
        with self._lock:
            self._mem.pop(key, None)
        self._report_corrupt(key, reason)

    def _report_corrupt(self, key: str, e: Exception):
        self._count("disk_corrupt")
        warnings.warn(f"plan cache: corrupt entry for {key!r} "
                      f"({type(e).__name__}: {e}); treating as a miss — "
                      "the next sweep overwrites it", stacklevel=3)

    def store(self, key: str, value: dict):
        with self._lock:
            self._mem[key] = value
        if self.disk_dir:
            os.makedirs(self.disk_dir, exist_ok=True)
            tmp = self._path(key) + f".tmp{os.getpid()}"
            with open(tmp, "w") as f:
                json.dump(value, f, indent=1)
            os.replace(tmp, self._path(key))  # atomic: no torn reads

    def count_sweep(self):
        """Record one actual autotune sweep (counter is internally locked:
        concurrent consults that race past `lookup` must not lose
        increments — a doubled sweep is benign, a corrupted counter
        breaks the amortization assertions)."""
        self._count("sweeps")

    def clear(self):
        with self._lock:
            self._mem.clear()
            self.metrics.clear()

    def stats(self) -> dict:
        return {"hits": self.hits, "misses": self.misses,
                "sweeps": self.sweeps, "disk_corrupt": self.disk_corrupt,
                "entries": len(self._mem)}


_DEFAULT: Optional[PlanCache] = None
_DEFAULT_DIR: Optional[str] = None


def default_cache() -> PlanCache:
    """The process-wide cache every launcher/benchmark consults unless
    handed its own instance.  ``REPRO_PLAN_CACHE_DIR`` is re-read on
    every call, so enabling the disk tier after import (a notebook
    setting os.environ late) takes effect on the next consult."""
    global _DEFAULT, _DEFAULT_DIR
    d = os.environ.get("REPRO_PLAN_CACHE_DIR") or None
    if _DEFAULT is None or d != _DEFAULT_DIR:
        _DEFAULT = PlanCache(disk_dir=d)
        _DEFAULT_DIR = d
    return _DEFAULT


def _entry_jsonable(entry: dict) -> dict:
    out = {}
    for k, v in entry.items():
        out[k] = list(v) if isinstance(v, tuple) else v
    return out


def cached_plan_for_physics(physics: str, nz: int, order: int,
                            cache: Optional[PlanCache] = None,
                            dtype: str = "float32",
                            key_extra: Optional[dict] = None, **kwargs
                            ) -> Tuple[TBPlan, dict, CacheInfo]:
    """`plan_for_physics` behind the cache (single-level plans).

    Returns (plan, winning sweep-log entry, CacheInfo).  The full sweep
    log is NOT cached — only the winner and its model terms, which is all
    any downstream consumer reads.
    """
    cache = cache or default_cache()
    key = plan_cache_key(physics, nz, order, block=kwargs.get("mesh_block"),
                         dtype=dtype, key_extra=key_extra, **kwargs)
    val = cache.lookup(key)
    if val is not None:
        try:
            return (TBPlan.from_dict(val["plan"]), dict(val["entry"]),
                    CacheInfo(key, True))
        except (KeyError, TypeError, ValueError) as e:
            cache.invalidate(key, e)  # schema-corrupt entry -> sweep
    cache.count_sweep()
    with _spans.span("plan.sweep", key=key):
        plan, log = plan_for_physics(physics, nz, order, **kwargs)
    entry = _entry_jsonable(log[log.best_key])
    cache.store(key, {"plan": plan.to_dict(), "entry": entry,
                      "best_key": list(log.best_key)})
    return plan, entry, CacheInfo(key, False)


def cached_plan_hierarchy(physics: str, nz: int, order: int,
                          block: Tuple[int, int],
                          cache: Optional[PlanCache] = None,
                          dtype: str = "float32",
                          key_extra: Optional[dict] = None, **kwargs
                          ) -> Tuple[HierPlan, dict, CacheInfo]:
    """`plan_hierarchy` behind the cache (two-level sharded plans).

    Returns (hier, winning sweep-log entry, CacheInfo); the entry carries
    the model terms (`compute_s`/`memory_s`/`comm_s`/`split_s`/`cost_s`),
    so a cache hit rebuilds a plan report without re-sweeping.
    """
    cache = cache or default_cache()
    key = plan_cache_key(physics, nz, order, block=tuple(block),
                         dtype=dtype, key_extra=key_extra, **kwargs)
    val = cache.lookup(key)
    if val is not None:
        try:
            return (HierPlan.from_dict(val["hier"]), dict(val["entry"]),
                    CacheInfo(key, True))
        except (KeyError, TypeError, ValueError) as e:
            cache.invalidate(key, e)  # schema-corrupt entry -> sweep
    cache.count_sweep()
    with _spans.span("plan.sweep", key=key):
        hier, log = plan_hierarchy(physics, nz, order, block, **kwargs)
    entry = _entry_jsonable(log[log.best_key])
    cache.store(key, {"hier": hier.to_dict(), "entry": entry,
                      "best_key": list(log.best_key)})
    return hier, entry, CacheInfo(key, False)


__all__ = ["PlanCache", "CacheInfo", "plan_cache_key", "default_cache",
           "cached_plan_for_physics", "cached_plan_hierarchy"]
