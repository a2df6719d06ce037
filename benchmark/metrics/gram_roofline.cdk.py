"""gram_roofline.cdk: the gram work's share of its roofline at (B, L+1) =
(4096, 513) (``readers.gram_roofline``)."""
from benchmark.readers import gram_roofline as read  # noqa: F401
