"""Unified observability layer: span tracer, metrics registry, slow-query
log, and EXPLAIN ANALYZE.

    from repro_torch import obs

    obs.set_tracing(True)            # spans (default off, <=2% when off)
    obs.REGISTRY.snapshot()          # counters / gauges / histograms
    obs.TRACER.chrome_trace()        # Perfetto-loadable trace JSON
    obs.SLOW_LOG.configure(0.05)     # log queries slower than 50ms
"""
from .analyze import (Analyzed, actuals_from, make_annotator,  # noqa: F401
                      shard_actuals)
from .metrics import (DEFAULT_LATENCY_BUCKETS, REGISTRY,  # noqa: F401
                      Counter, Gauge, Histogram, MetricsRegistry)
from .slowlog import SLOW_LOG, SlowQueryLog  # noqa: F401
from .trace import (NULL_SPAN, TRACER, Span, Tracer,  # noqa: F401
                    current_span, enabled, force_tracing, record_span,
                    set_tracing, span)
