"""Shared utilities: metric logging, profiling hooks, compile cache."""

from bignn.utils.compile_cache import enable_compile_cache
from bignn.utils.logging import MetricLogger
from bignn.utils.profiling import profile_trace

__all__ = ["MetricLogger", "enable_compile_cache", "profile_trace"]
