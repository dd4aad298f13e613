"""Cross-cutting utilities: progress, tracing, configuration."""

from .progress import Progress, ProgressTracker
from .tracing import span, trace_event, init_tracing
from .config import EngineConfig

__all__ = [
    "Progress",
    "ProgressTracker",
    "span",
    "trace_event",
    "init_tracing",
    "EngineConfig",
]
