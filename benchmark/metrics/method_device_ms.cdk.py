"""method_device_ms.cdk: device ms a step inside the loss route (both towers,
the CDK loss) (``readers.method_device_ms``)."""
from benchmark.readers import method_device_ms as read  # noqa: F401
