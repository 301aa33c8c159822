"""Serving observability: a labelled metrics registry, per-request
lifecycle traces, span timelines and their Chrome-trace export, kernel
profiling hooks, a live embedding-quality probe (``obs.quality``) and the
launcher's reporter (``obs.report``).

Port of ``repro.obs``. ``obs.profiling`` names kernel dispatches with
``torch.profiler.record_function`` and, opt-in, times each dispatch into
the registry; ``obs.export`` renders ``obs.spans`` rings as Chrome-trace
JSON that Perfetto loads directly.
"""
from .metrics import (Counter, Gauge, Histogram,        # noqa: F401
                      MetricsRegistry, StatsView)
from .trace import Trace, latency_summary, percentiles  # noqa: F401
from .profiling import (annotate, dispatch,             # noqa: F401
                        disable_kernel_timing, enable_kernel_timing)
from .spans import Span, SpanRecorder                   # noqa: F401
from .export import chrome_trace, dump_chrome_trace     # noqa: F401
