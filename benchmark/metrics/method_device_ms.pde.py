"""method_device_ms.pde: device ms a step inside the loss route, the operator
left out (``readers.method_device_ms``)."""
from benchmark.readers import method_device_ms as read  # noqa: F401
