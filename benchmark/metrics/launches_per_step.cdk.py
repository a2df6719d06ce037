"""launches_per_step.cdk: kernels a step over eager steps
(``readers.launches_per_step``)."""
from benchmark.readers import launches_per_step as read  # noqa: F401
