"""Data parallelism on ``torch.distributed`` (port of ``neuralsvd_tpu/parallel``).

The mesh is in ``parallel.mesh``; the dp train steps, which build on
``training``, are in ``parallel.sharding`` and are not imported here, so
that the layers below (ops, methods, training) can import
``parallel.collectives`` and ``parallel.mesh``.
"""
from neuralsvd_tpu_torch.parallel.mesh import make_mesh, parse_mesh_spec

__all__ = ["make_mesh", "parse_mesh_spec"]
