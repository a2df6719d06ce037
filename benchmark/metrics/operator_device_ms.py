"""operator_device_ms: device ms a step inside the operator span
(``readers.operator_device_ms``)."""
from benchmark.readers import operator_device_ms as read  # noqa: F401
