"""engine_pointwise_device_ms.pde: device ms a step launched inside
``op.apply`` and outside the engine's product spans
(``program_spans.engine_pointwise_device_ms``)."""
from benchmark.program_spans import engine_pointwise_device_ms as read  # noqa: F401
