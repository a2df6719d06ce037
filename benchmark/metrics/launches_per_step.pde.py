"""launches_per_step.pde: kernels a step over whole graph replays
(``readers.launches_per_step``)."""
from benchmark.readers import launches_per_step as read  # noqa: F401
