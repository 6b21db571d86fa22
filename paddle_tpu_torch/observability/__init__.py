"""Runtime telemetry of the serving path (counterpart of
``paddle_tpu/observability``): the metrics registry, request traces, the
per-rank telemetry spool and the serving roofline join.

Ported: ``metrics`` (pure-Python tier), ``trace_context`` (spans and the
recorder), ``fleet`` (the spool and ``autospool_tick``) and
``roofline_attr.observe_serving_step``. The exporters, the fleet
aggregation and findings, the flight recorder, the waterfall, ledger,
anomaly, SLO and opprof planes are not ported yet.
"""
from . import fleet, metrics, roofline_attr, trace_context
from .metrics import (Counter, Gauge, Histogram, MetricsRegistry,
                      get_registry)
from .trace_context import (TraceContext, TraceRecorder, TraceSpan,
                            get_recorder, new_trace)

__all__ = ["fleet", "metrics", "roofline_attr", "trace_context",
           "Counter", "Gauge", "Histogram", "MetricsRegistry",
           "get_registry", "TraceContext", "TraceRecorder", "TraceSpan",
           "get_recorder", "new_trace"]
