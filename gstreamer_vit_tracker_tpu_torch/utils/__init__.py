"""Utilities: rolling timing stats, profiling hooks."""

from . import profiling, timing  # noqa: F401
from .profiling import PhaseTimer, device_trace  # noqa: F401
from .timing import TimingStats  # noqa: F401
