"""Structured observability for the TB pipeline (port of
`repro.telemetry`; DESIGN.md §7).

  spans    nestable wall-clock spans + Chrome-trace/flat-JSON export
           (`span`, `annotate`, `enable`, `collector`);
  metrics  named counters/gauges/histograms behind a process registry
           (`registry().counter("plan_cache.hits").inc()`);
  drift    predicted-vs-measured ledger for the cost model
           (`predict_plan_terms`, `DriftLedger`, `last_drift`).

Spans are OFF until `enable()` (the `--telemetry` flag); metrics are always
on; drift is explicit bookkeeping.  This package imports nothing from
kernels, distributed or survey, so every layer can instrument itself
without import cycles (`drift` depends only on `core.temporal_blocking`).
"""
from repro_torch.telemetry import metrics  # noqa: F401
from repro_torch.telemetry.drift import (  # noqa: F401
    DEFAULT_PATH as DRIFT_PATH, DriftLedger, last_drift, predict_hier_terms,
    predict_plan_terms)
from repro_torch.telemetry.metrics import (MetricsRegistry,  # noqa: F401
                                           merge_snapshots, registry)
from repro_torch.telemetry.spans import (SpanCollector,  # noqa: F401
                                         active, add_span, annotate,
                                         collector, device_sync, disable,
                                         enable, span)

__all__ = [
    "DRIFT_PATH", "DriftLedger", "MetricsRegistry", "SpanCollector",
    "active", "add_span", "annotate", "collector", "device_sync", "disable",
    "enable", "last_drift", "merge_snapshots", "metrics",
    "predict_hier_terms", "predict_plan_terms", "registry", "span",
]
