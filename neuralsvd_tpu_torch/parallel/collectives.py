"""The collectives of the mesh axes, on ``torch.distributed`` groups.

The JAX package names its data-parallel axis by a string (``axis_name``)
inside ``shard_map`` and reduces with ``lax.psum``/``lax.pmean``; here the
axis is a process group, and ``None`` means no axis: every function then
returns its input unchanged and makes no call.  The reductions return new
tensors and leave their inputs as they were.

gloo has no ``ReduceOp.AVG``, so a mean is a SUM divided by the group
size, on every backend alike.  ``pmean_grad`` is the differentiable mean
that NeuralEF's batch norm and SpINx's losses take inside the model: the
JAX package maps with ``shard_map(check_vma=False)``, under which the
transpose of psum is psum, so its backward is the mean of the summed
cotangents, ``psum(ct) / n`` (not ``ct / n``).  A forward-Laplacian dual
(ops/forward_laplacian.py) is reduced channel by channel: the mean is
linear.

The tensor-parallel (``tp``) axis shards the mode axis L: ``gather_modes``
is the autograd all-gather of the ranks' modes that GSPMD inserts in the
JAX package (``neuralsvd_tpu/parallel/sharding.py:129-152``), padded to
ceil(L / M) modes a rank where M does not divide L, as GSPMD pads;
``all_gather_modes`` gathers a state tensor the same way.
"""
from __future__ import annotations

from typing import List, Sequence

import torch
import torch.distributed as dist


def axis_size(group) -> int:
    """The number of ranks of ``group`` (1 for no group)."""
    return 1 if group is None else dist.get_world_size(group)


def axis_index(group) -> int:
    """This process's rank in ``group`` (0 for no group)."""
    return 0 if group is None else dist.get_rank(group)


def psum(x: torch.Tensor, group) -> torch.Tensor:
    """The sum of ``x`` over the ranks of ``group``."""
    if group is None:
        return x
    out = x.detach().clone(memory_format=torch.contiguous_format)
    dist.all_reduce(out, op=dist.ReduceOp.SUM, group=group)
    return out


def pmean(x: torch.Tensor, group) -> torch.Tensor:
    """The mean of ``x`` over the ranks of ``group``."""
    if group is None:
        return x
    return psum(x, group) / axis_size(group)


class _PSum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return psum(x, group)

    @staticmethod
    def backward(ctx, ct):
        return psum(ct, ctx.group), None


def pmean_grad(x: torch.Tensor, group) -> torch.Tensor:
    """``pmean`` that autograd differentiates, backward psum(ct) / n."""
    if group is None:
        return x
    from neuralsvd_tpu_torch.ops.forward_laplacian import Dual, make_dual

    if isinstance(x, Dual):
        return make_dual(*(None if c is None else pmean_grad(c, group)
                           for c in (x.v, x.j, x.l)))
    return _PSum.apply(x, group) / axis_size(group)


def psum_flat(tensors: Sequence[torch.Tensor], group, mean: bool = False
              ) -> List[torch.Tensor]:
    """The sums (means with ``mean``) of ``tensors`` over ``group``, one
    all-reduce per dtype on one flat buffer: the results are views of it,
    shaped as the inputs and in their order."""
    tensors = list(tensors)
    if group is None:
        return tensors
    n = axis_size(group)
    out: List[torch.Tensor] = [None] * len(tensors)
    for dtype in dict.fromkeys(t.dtype for t in tensors):
        idx = [i for i, t in enumerate(tensors) if t.dtype == dtype]
        flat = torch.cat([tensors[i].detach().reshape(-1) for i in idx])
        dist.all_reduce(flat, op=dist.ReduceOp.SUM, group=group)
        if mean:
            flat.div_(n)
        for i, part in zip(idx, flat.split([tensors[i].numel() for i in idx])):
            out[i] = part.view(tensors[i].shape)
    return out


def all_gather_rows(x: torch.Tensor, group) -> torch.Tensor:
    """The rows of ``x`` of every rank of ``group``, concatenated in rank
    order (the global batch order of a row-sharded batch)."""
    if group is None:
        return x
    parts = [torch.empty_like(x) for _ in range(axis_size(group))]
    dist.all_gather(parts, x.contiguous(), group=group)
    return torch.cat(parts)


def mode_chunk(n_modes: int, group) -> int:
    """The modes a rank of ``group`` holds at most: ceil(L / M), the size
    GSPMD pads the mode axis to on each of M devices."""
    return -(-n_modes // axis_size(group))


class _GatherModes(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, n_modes):
        c = mode_chunk(n_modes, group)
        lo = axis_index(group) * c
        ctx.lo, ctx.n = lo, x.shape[1]
        if x.shape[1] < c:  # the last rank of an uneven L: pad to the chunk
            pad = x.new_zeros((x.shape[0], c - x.shape[1]) + tuple(x.shape[2:]))
            x = torch.cat([x, pad], dim=1)
        parts = [torch.empty_like(x, memory_format=torch.contiguous_format)
                 for _ in range(axis_size(group))]
        dist.all_gather(parts, x.contiguous(), group=group)
        return torch.cat(parts, dim=1)[:, :n_modes]

    @staticmethod
    def backward(ctx, ct):
        # every rank of the group takes the same loss of the same gathered
        # tensor, so this rank's slice of the cotangent is its modes' whole
        # gradient: no collective
        return ct[:, ctx.lo:ctx.lo + ctx.n].contiguous(), None, None


def gather_modes(x: torch.Tensor, group, n_modes: int) -> torch.Tensor:
    """(B, L_r, ...) -> (B, L, ...): the modes of every rank of ``group``
    (the tensor-parallel axis) concatenated in rank order along axis 1, a
    rank holding ``parallel.mesh.mode_range``'s modes.  Differentiable:
    the backward is this rank's slice of the cotangent, which is right only
    because every rank computes the same loss of the gathered tensor.
    ``x`` itself without a group."""
    if group is None:
        return x
    return _GatherModes.apply(x, group, n_modes)


def all_gather_modes(x: torch.Tensor, group, n_modes: int, axis: int = 0) -> torch.Tensor:
    """A rank's slice of a per-mode tensor (its modes along ``axis``) ->
    the whole tensor, for the state (parameters, moments, EMA); not
    differentiable."""
    if group is None:
        return x
    moved = torch.movedim(x.detach(), axis, 1) if x.ndim > 1 else x.detach()[None]
    with torch.no_grad():
        full = _GatherModes.apply(moved, group, n_modes)
    return torch.movedim(full, 1, axis) if x.ndim > 1 else full[0]
