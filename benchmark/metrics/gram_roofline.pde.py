"""gram_roofline.pde: the gram work's share of its roofline at (B/2, L) = (256,
16) (``readers.gram_roofline``)."""
from benchmark.readers import gram_roofline as read  # noqa: F401
