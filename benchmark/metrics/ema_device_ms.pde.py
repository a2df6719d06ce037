"""ema_device_ms.pde: device ms a step launched inside ``train.ema``
(``program_spans.ema_device_ms``)."""
from benchmark.program_spans import ema_device_ms as read  # noqa: F401
