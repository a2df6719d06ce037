"""update_device_ms.pde: device ms a step outside the loss route (draw, norm,
skip, RMSprop, EMA) (``readers.update_device_ms``)."""
from benchmark.readers import update_device_ms as read  # noqa: F401
