"""engine_product_device_ms.pde: device ms a step of the forward engine's
product calls (its ``fwdlap.*`` product spans)
(``program_spans.engine_product_device_ms``)."""
from benchmark.program_spans import engine_product_device_ms as read  # noqa: F401
