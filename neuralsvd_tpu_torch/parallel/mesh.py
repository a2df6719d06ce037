"""The mesh on ``torch.distributed``, and its groups.

Port of ``parse_mesh_spec`` (``neuralsvd_tpu/parallel/sharding.py``
:51-95), the CLI's ``--mesh`` grammar, exactly, and of ``make_mesh``
(:29-48): a ``torch.distributed.device_mesh.DeviceMesh`` with
``mesh_dim_names`` (``("dp",)``, ``("tp",)`` or both, in the spec's order)
over the default process group, which ``init_process_group`` starts where
none runs: under ``torchrun`` from its environment (``RANK``,
``WORLD_SIZE``, ``LOCAL_RANK``), otherwise as a one-rank group on an
in-process ``HashStore``, so ``--mesh dp`` runs on one card.  NCCL for
CUDA devices, gloo for the CPU.  With the helpers the drivers share: the
dp and tp groups of a mesh, the modes a tp rank holds (``mode_range``,
``ModeShards``), the writing rank, a barrier, the check that a CUDA graph
may capture a group's collectives, and a rank's rows of a batch
(``local_rows`` on the dp path, ``half_rows`` on the tp path).

A gloo group's collectives cannot be captured in a CUDA graph
(``require_capturable``); a graph request on one raises, and only eager
steps run there.
"""
from __future__ import annotations

import os
from dataclasses import dataclass, field
from typing import Dict, Optional

import numpy as np
import torch
import torch.distributed as dist

from neuralsvd_tpu_torch.parallel.collectives import (
    all_gather_modes,
    axis_index,
    axis_size,
    mode_chunk,
)

__all__ = ["ModeShards", "barrier", "check_method_axis", "dp_group", "given_sizes",
           "half_rows", "init_process_group", "is_writer", "local_rows", "make_mesh",
           "mesh_sizes", "method_state_axes", "mode_layout", "mode_range",
           "parse_mesh_spec", "rank_device", "require_capturable", "tp_group"]


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


def given_sizes(spec: str) -> dict:
    """{axis: size} of the axes ``spec`` gives a size, without counting
    ranks (the checks a CLI makes before it starts a group)."""
    return {name.strip(): int(n) for name, n in
            (part.strip().split("=", 1) for part in spec.split(",") if "=" in part)}


def mesh_sizes(spec: str) -> dict:
    """{axis: size} of ``spec`` over the ranks of the default group (or of
    the ``torchrun`` environment, or 1, before one runs)."""
    axes, shape = parse_mesh_spec(spec, _world_size())
    return dict(zip(axes, shape))


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
    runs; a dp x tp mesh gives both groups.  Raises ValueError where the
    mesh leaves ranks out."""
    from torch.distributed.device_mesh import DeviceMesh

    dev = init_process_group(device, backend)
    sizes = mesh_sizes(spec)
    world = dist.get_world_size()
    if int(np.prod(list(sizes.values()))) != world:
        raise ValueError(f"mesh {spec!r} ({sizes}) must span all {world} ranks of "
                         "the process group: start one process per mesh device")
    ranks = torch.arange(world).reshape(tuple(sizes.values()))
    return DeviceMesh(dev.type, ranks, mesh_dim_names=tuple(sizes))


def _axis_group(mesh, axis: str):
    names = tuple(mesh.mesh_dim_names or ()) if mesh is not None else ()
    if axis not in names:
        return None
    return mesh.get_group(axis)


def dp_group(mesh, dp_axis: str = "dp"):
    """The process group of ``mesh``'s ``dp_axis``, None where it has
    none (a one-device or a tp-only mesh)."""
    return _axis_group(mesh, dp_axis)


def tp_group(mesh, tp_axis: str = "tp"):
    """The process group of ``mesh``'s ``tp_axis`` (the mode axis), None
    where it has none; ``parse_mesh_spec`` drops a tp axis of size 1."""
    return _axis_group(mesh, tp_axis)


def mode_range(n_modes: int, group) -> tuple:
    """(lo, hi): the modes ``[lo, hi)`` this rank of the tp ``group``
    holds, ceil(L / M) a rank in rank order and the rest on the last (L 55
    at tp=2: 28 and 27, as GSPMD pads 55 to 56); ``(0, L)`` without a
    group.  Raises ValueError where a rank would hold no mode."""
    if group is None:
        return 0, n_modes
    c = mode_chunk(n_modes, group)
    if c * (axis_size(group) - 1) >= n_modes:
        raise ValueError(f"{n_modes} modes leave a rank of tp={axis_size(group)} "
                         "without a mode")
    lo = axis_index(group) * c
    return lo, min(lo + c, n_modes)


@dataclass(frozen=True)
class ModeShards:
    """How a model's parameters lie on the tp ``group``: ``axes`` maps each
    per-mode parameter (its slot l feeds mode l only) to its mode axis, of
    which this rank holds ``mode_range``'s slice; ``pre_gather`` names the
    replicated parameters that act before the modes are gathered (a
    two-tower network's hidden layers), whose gradient each rank holds only
    in part and which the step sums over the group.  Every other parameter
    is replicated and acts after the gather, so its gradient is whole on
    every rank (the JAX package's GSPMD shardings: ``mode_sharded_params``,
    ``cdk_mode_shardings``, ``neuralsvd_tpu/parallel/sharding.py:98,222``)."""

    group: object
    n_modes: int
    axes: Dict[str, int]
    pre_gather: frozenset = field(default_factory=frozenset)

    @property
    def range(self) -> tuple:
        return mode_range(self.n_modes, self.group)

    def narrow(self, name: str, t):
        """This rank's slice of the whole tensor ``t`` of parameter
        ``name`` (``t`` itself for a replicated one)."""
        if name not in self.axes:
            return t
        lo, hi = self.range
        return t.narrow(self.axes[name], lo, hi - lo)

    def narrow_tree(self, tree):
        """This rank's share of a state tree (parameters, optimizer moments,
        EMA: dicts keyed by parameter name, in dicts, lists and (named)
        tuples); other leaves as they are.  Matched by name, where the JAX
        package matches by shape (``_shardings_like``, sharding.py:245)."""
        return _map_named(tree, self.narrow)

    def gather_tree(self, tree):
        """The whole state tree from every rank's share (new tensors for
        the sharded leaves, the others as they are); ``narrow_tree``'s
        inverse."""
        def gather(name, t):
            if name not in self.axes:
                return t
            return all_gather_modes(t, self.group, self.n_modes, self.axes[name])

        return _map_named(tree, gather)

    def narrow_state(self, tree, axes):
        """This rank's share of a method state: each leaf that ``axes`` (a
        tree of the same dicts, the method's ``state_mode_axes()``) gives
        an int is narrowed on that axis, every other leaf kept; None keeps
        the whole tree.  Matched by place, not by name: SpIN's ``j_avg`` is
        keyed by parameter name but has its modes on another axis."""
        lo, hi = self.range
        return _map_axes(tree, axes, lambda t, a: t.narrow(a, lo, hi - lo))

    def gather_state(self, tree, axes):
        """``narrow_state``'s inverse: the whole method state from every
        rank's share (new tensors for the sharded leaves)."""
        return _map_axes(tree, axes, lambda t, a: all_gather_modes(
            t, self.group, self.n_modes, a))

    def narrow_fields(self, tree: dict, method_axes):
        """This rank's share of a TrainState's fields ({field: tree}, e.g.
        a checkpoint's): ``method_state`` by ``narrow_state`` on
        ``method_axes``, the others by ``narrow_tree``."""
        return {name: (self.narrow_state(t, method_axes) if name == "method_state"
                       else self.narrow_tree(t)) for name, t in tree.items()}


def mode_layout(model) -> tuple:
    """({name: mode axis} of ``model``'s per-mode parameters
    (``model.mode_axes()``, none where it names none), the replicated
    parameters that act before the modes are gathered
    (``model.pre_gather_parameters()`` where it names them, else every
    other parameter: a wavefunction's are all upstream of its output))."""
    axes = dict(getattr(model, "mode_axes", dict)())
    if hasattr(model, "pre_gather_parameters"):
        return axes, frozenset(model.pre_gather_parameters())
    return axes, frozenset(name for name, _ in model.named_parameters() if name not in axes)


def method_state_axes(method):
    """The mode axes of ``method``'s state (its ``state_mode_axes()``),
    None where every leaf of it is replicated over tp."""
    axes = getattr(method, "state_mode_axes", None)
    return None if axes is None else axes()


def _map_axes(tree, axes, fn):
    """``fn(tensor, axis)`` on every tensor of ``tree`` to which ``axes``
    gives an int at the same place (dict keys and list positions)."""
    if axes is None:
        return tree
    if isinstance(axes, int):
        return fn(tree, axes)
    if isinstance(tree, dict):
        return {k: _map_axes(v, axes.get(k), fn) for k, v in tree.items()}
    if isinstance(tree, (tuple, list)):
        return type(tree)(_map_axes(v, a, fn) for v, a in zip(tree, axes))
    return tree


def _map_named(tree, fn, key=None):
    """``fn(name, tensor)`` on every tensor of ``tree``, ``name`` the key
    of the nearest dict above it."""
    if isinstance(tree, torch.Tensor):
        return fn(key, tree)
    if isinstance(tree, dict):
        return {k: _map_named(v, fn, k) for k, v in tree.items()}
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*(_map_named(v, fn, key) for v in tree))
    if isinstance(tree, (tuple, list)):
        return type(tree)(_map_named(v, fn, key) for v in tree)
    return tree


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


def half_rows(x, group):
    """This rank's 1/n of each half of the rows of ``x`` (the tp path's
    global batch, whose halves are the loss's f1 and f2), concatenated:
    the ranks' f1 rows are then slices of the global f1 and the dp mean of
    their grams is the global gram.  ``x`` without a group."""
    if group is None:
        return x
    return torch.cat([local_rows(h, group) for h in torch.chunk(x, 2)])
