from .device import resolve_device
from .logging import RunLogger
from .timing import RuntimeStats, Timer

__all__ = ["RunLogger", "RuntimeStats", "Timer", "resolve_device"]
