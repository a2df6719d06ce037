"""device_idle_share.pde: the traced window's idle share over graph replays
(``readers.device_idle_share``)."""
from benchmark.readers import device_idle_share as read  # noqa: F401
