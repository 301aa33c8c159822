"""Host-side telemetry: metrics registry, per-request traces, spans."""
from .metrics import Counter, Gauge, Histogram, MetricsRegistry  # noqa: F401
from .spans import Span, SpanRecorder                              # noqa: F401
from .trace import Trace, latency_summary, percentiles             # noqa: F401
