"""tower_forward_device_ms.cdk: device ms a step launched inside
``model.forward``: both towers' forward (``program_spans.tower_forward_device_ms``)."""
from benchmark.program_spans import tower_forward_device_ms as read  # noqa: F401
