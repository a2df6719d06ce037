"""The mesh of data parallelism on ``torch.distributed``, and its groups.

Port of ``parse_mesh_spec`` (``neuralsvd_tpu/parallel/sharding.py``
:51-95), the CLI's ``--mesh`` grammar, exactly, and of ``make_mesh``
(:29-48): a ``torch.distributed.device_mesh.DeviceMesh`` with
``mesh_dim_names`` over the default process group, which
``init_process_group`` starts where none runs: under ``torchrun`` from its
environment (``RANK``, ``WORLD_SIZE``, ``LOCAL_RANK``), otherwise as a
one-rank group on an in-process ``HashStore``, so ``--mesh dp`` runs on
one card.  NCCL for CUDA devices, gloo for the CPU.  With the helpers the
drivers share: the dp group of a mesh, the writing rank, a barrier, the
check that a CUDA graph may capture a group's collectives, and a rank's
rows of a batch.

A ``tp`` axis above 1 (the GSPMD mode sharding of ParallelMLP and of the
CDK towers' last layer) raises ``NotImplementedError`` naming ROADMAP item
[9b].  A gloo group's collectives cannot be captured in a CUDA graph
(``require_capturable``); a graph request on one raises, and only eager
steps run there.
"""
from __future__ import annotations

import os
from typing import Optional

import numpy as np
import torch
import torch.distributed as dist

from neuralsvd_tpu_torch.parallel.collectives import axis_size

__all__ = ["TP_REFUSAL", "barrier", "check_method_axis", "dp_group", "init_process_group",
           "is_writer", "local_rows", "make_mesh", "mesh_sizes", "parse_mesh_spec",
           "rank_device", "require_capturable"]

TP_REFUSAL = ("a tp mesh axis above 1 (GSPMD mode-axis sharding) is not ported "
              "yet (ROADMAP item [9b]); use --mesh dp[=N]")


def parse_mesh_spec(spec: str, n_avail: int):
    """Parse a CLI mesh spec: 'dp' | 'dp=4' | 'dp=4,tp=2' -> (axes, shape).

    One axis may omit its size and absorbs the remaining ranks ('dp,tp=2'
    on 8 -> dp=4).  Size-1 axes are dropped.  Raises on over-subscription,
    on more than one unsized axis, and on unknown axis names (dp/tp only).
    """
    axes, sizes = [], []
    for part in spec.split(","):
        part = part.strip()
        if not part:
            continue
        if "=" in part:
            name, n = part.split("=", 1)
            n = int(n)
        else:
            name, n = part, -1
        name = name.strip()
        if name not in ("dp", "tp"):
            raise ValueError(f"unknown mesh axis {name!r} (use dp/tp)")
        if name in axes:
            raise ValueError(f"duplicate mesh axis {name!r}")
        axes.append(name)
        sizes.append(n)
    if not axes:
        raise ValueError(f"empty mesh spec {spec!r}")
    if sizes.count(-1) > 1:
        raise ValueError(f"more than one unsized axis in {spec!r}")
    fixed = int(np.prod([s for s in sizes if s > 0])) if any(
        s > 0 for s in sizes) else 1
    if -1 in sizes:
        if n_avail % fixed:
            raise ValueError(
                f"{n_avail} devices not divisible by fixed axes ({fixed})")
        sizes[sizes.index(-1)] = n_avail // fixed
    total = int(np.prod(sizes))
    if total > n_avail:
        raise ValueError(f"mesh {spec!r} needs {total} devices, "
                         f"only {n_avail} available")
    keep = [(a, s) for a, s in zip(axes, sizes) if s > 1]
    if not keep:  # all axes trivial: a one-device mesh
        keep = [(axes[0], 1)]
    return tuple(a for a, _ in keep), tuple(s for _, s in keep)


def _world_size() -> int:
    if dist.is_initialized():
        return dist.get_world_size()
    return int(os.environ.get("WORLD_SIZE", "1"))


def mesh_sizes(spec: str) -> dict:
    """{axis: size} of ``spec`` over the ranks of the default group (or of
    the ``torchrun`` environment, or 1, before one runs); raises
    ``NotImplementedError`` for a tp axis above 1, given or absorbed, before
    it counts the ranks."""
    given = dict(part.strip().split("=", 1) for part in spec.split(",") if "=" in part)
    if int(given.get("tp", 1)) > 1:
        raise NotImplementedError(TP_REFUSAL)
    axes, shape = parse_mesh_spec(spec, _world_size())
    sizes = dict(zip(axes, shape))
    if sizes.get("tp", 1) > 1:
        raise NotImplementedError(TP_REFUSAL)
    return sizes


def rank_device(device=None) -> torch.device:
    """This rank's device: ``device`` where given, else ``cuda:LOCAL_RANK``
    (0 without ``torchrun``), which must be a visible card; no silent
    fallback to the CPU."""
    dev = (torch.device("cuda", int(os.environ.get("LOCAL_RANK", "0")))
           if device is None else torch.device(device))
    if dev.type != "cuda":
        return dev
    if not torch.cuda.is_available():
        raise RuntimeError("a CUDA device was requested (the default) but torch "
                           "sees none; pass device='cpu' to run on the CPU")
    if dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    if dev.index >= torch.cuda.device_count():
        raise RuntimeError(
            f"{dev} (LOCAL_RANK {os.environ.get('LOCAL_RANK', 0)}) is not a visible card "
            f"({torch.cuda.device_count()} visible); start at most one process per card")
    return dev


def init_process_group(device=None, backend: Optional[str] = None) -> torch.device:
    """Start the default process group unless one runs, and return this
    rank's device (``rank_device``).  ``backend`` defaults to NCCL on a
    CUDA device and gloo elsewhere."""
    dev = rank_device(device)
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    if dist.is_initialized():
        return dev
    backend = backend or ("nccl" if dev.type == "cuda" else "gloo")
    kw = {"device_id": dev} if backend == "nccl" else {}
    if "RANK" in os.environ and "WORLD_SIZE" in os.environ:  # torchrun
        dist.init_process_group(backend, init_method="env://", **kw)
    else:
        dist.init_process_group(backend, store=dist.HashStore(), rank=0,
                                world_size=1, **kw)
    return dev


def make_mesh(spec: str, device=None, backend: Optional[str] = None):
    """A ``DeviceMesh`` of ``spec`` (``parse_mesh_spec``) over every rank
    of the default group, started by ``init_process_group`` where none
    runs.  Raises ``NotImplementedError`` for tp above 1 and ValueError
    where the mesh leaves ranks out."""
    from torch.distributed.device_mesh import DeviceMesh

    dev = init_process_group(device, backend)
    sizes = mesh_sizes(spec)
    world = dist.get_world_size()
    if int(np.prod(list(sizes.values()))) != world:
        raise ValueError(f"mesh {spec!r} ({sizes}) must span all {world} ranks of "
                         "the process group: start one process per mesh device")
    ranks = torch.arange(world).reshape(tuple(sizes.values()))
    return DeviceMesh(dev.type, ranks, mesh_dim_names=tuple(sizes))


def dp_group(mesh, dp_axis: str = "dp"):
    """The process group of ``mesh``'s ``dp_axis``, None where it has
    none (a one-device mesh); raises ``NotImplementedError`` for a tp axis
    above 1."""
    names = tuple(mesh.mesh_dim_names or ())
    if "tp" in names and mesh.size(names.index("tp")) > 1:
        raise NotImplementedError(TP_REFUSAL)
    if dp_axis not in names:
        return None
    return mesh.get_group(dp_axis)


def is_writer() -> bool:
    """True on the rank that writes logs and files: rank 0, or the only
    process where no group runs."""
    return not dist.is_initialized() or dist.get_rank() == 0


def barrier(group) -> None:
    """Wait for every rank of ``group`` (nothing without one)."""
    if group is not None:
        dist.barrier(group=group)


def require_capturable(group, device) -> None:
    """Raise ValueError where a CUDA graph on ``device`` would have to
    capture the collectives of ``group``, which only NCCL allows."""
    if group is None or torch.device(device).type != "cuda":
        return
    backend = dist.get_backend(group)
    if backend != "nccl":
        raise ValueError(f"a CUDA graph cannot capture the collectives of a {backend} "
                         "group; run its steps eagerly (use_graph=False)")


def check_method_axis(method, group) -> None:
    """Raise ValueError unless ``method`` was built with ``axis_name``
    ``group``, both None without data parallelism: a step that sums the
    gradients over a group needs a method that averages its grams over the
    same group (JAX's shard_map steps refuse the same)."""
    axis = getattr(method, "axis_name", None)
    if axis is not group:
        raise ValueError(f"method.axis_name={axis!r} must be the step's data-parallel "
                         f"group ({group!r})")


def local_rows(x, group):
    """This rank's contiguous 1/n of the rows of ``x`` (a ragged tail past
    a multiple of n dropped), or ``x`` without a group."""
    if group is None:
        return x
    n = axis_size(group)
    k = x.shape[0] // n
    r = dist.get_rank(group)
    return x[r * k:(r + 1) * k]
