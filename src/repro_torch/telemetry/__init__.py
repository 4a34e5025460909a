"""Structured observability for the TB pipeline (port of
`repro.telemetry`; DESIGN.md §7).

  spans    nestable wall-clock spans + Chrome-trace/flat-JSON export
           (`span`, `annotate`, `enable`, `collector`);
  metrics  named counters/gauges/histograms behind a process registry
           (`registry().counter("plan_cache.hits").inc()`).

Spans are OFF until `enable()` (the `--telemetry` flag); metrics are always
on.  The reference's cost-model drift ledger comes with the sharded slice
of the port.  This package imports nothing from kernels or survey, so
every layer can instrument itself without import cycles.
"""
from repro_torch.telemetry import metrics  # noqa: F401
from repro_torch.telemetry.metrics import (MetricsRegistry,  # noqa: F401
                                           merge_snapshots, registry)
from repro_torch.telemetry.spans import (SpanCollector,  # noqa: F401
                                         active, add_span, annotate,
                                         collector, device_sync, disable,
                                         enable, span)

__all__ = [
    "MetricsRegistry", "SpanCollector", "active", "add_span", "annotate",
    "collector", "device_sync", "disable", "enable", "merge_snapshots",
    "metrics", "registry", "span",
]
