"""Multi-shot survey engine (port of `repro.survey`; DESIGN.md §6).

A seismic survey fires many independent shots over ONE model; this layer
amortizes everything shot-invariant across them:

  plan_cache   memory+disk cache over the autotune sweeps of
               `core.temporal_blocking`, keyed by the full pricing
               configuration — one sweep per configuration, ever.
  shots        `Shot`/`Survey` descriptions plus bucketing by padded
               (nsrc, nrec), so the number of distinct shapes is bounded
               regardless of survey size.
  engine       `SurveyEngine`: one executable per (physics, bucket),
               running a batch of shots through the TB tile loop
               (`kernels/ops.tb_propagate_prepared`) with one kernel launch
               per time tile, and receiver-trace readback double-buffered
               against device compute; `run_sharded` instead runs the
               shots one by one through the sharded layer
               (`distributed/halo.py`), domain-parallel per shot.
"""
from repro_torch.survey.plan_cache import (CacheInfo,  # noqa: F401
                                           PlanCache,
                                           cached_plan_for_physics,
                                           cached_plan_hierarchy,
                                           default_cache, plan_cache_key)
from repro_torch.survey.shots import Shot, Survey, bucket_shots  # noqa: F401
from repro_torch.survey.engine import (RUN_STATS_KEYS,  # noqa: F401
                                       SurveyEngine, SurveyResult)
