"""update_device_ms.cdk: device ms a step outside the loss route (batch gather,
clip, skip, SGD) (``readers.update_device_ms``)."""
from benchmark.readers import update_device_ms as read  # noqa: F401
