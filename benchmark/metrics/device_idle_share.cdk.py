"""device_idle_share.cdk: the traced window's idle share over eager steps
(``readers.device_idle_share``)."""
from benchmark.readers import device_idle_share as read  # noqa: F401
