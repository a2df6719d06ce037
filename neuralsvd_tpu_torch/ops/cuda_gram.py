"""Hand-written CUDA kernels for the NestedLoRA losses, and their packaging.

Port of ``neuralsvd_tpu/ops/pallas_gram.py``.  Each wrapper replaces one
Pallas kernel and keeps its plain PyTorch version beside it:

==================  ==========================================  =====================
wrapper             replaces (neuralsvd_tpu/ops/pallas_gram.py)  plain version
==================  ==========================================  =====================
masked_gram_pair    _masked_gram_kernel :64, pallas_call :102    masked_gram_pair_ref
weighted_dot        _weighted_dot_kernel :137, pallas_call :161  weighted_dot_ref
metric_grads        _metric_grads_kernel :184, pallas_call :208  metric_grads_ref
==================  ==========================================  =====================

Dispatch is by the tensors' device alone: CPU tensors take the plain
version; CUDA tensors launch the kernel (``csrc/gram_kernels.cu``) or
raise.  There is no fallback from a failed launch to the plain version.
Each wrapper counts its launches in ``<wrapper>.launches``.

Two packagings run them: ``nestedlora_evd_loss_kernels`` (the E4 path)
and ``nestedlora_cdk_loss_kernels`` (the CDK two-tower path).

Bound on an H100 SXM (3.35 TB/s, 67 TFLOP/s f32 without tensor cores): at
the E4 shapes (half-batches of 256 rows, L = 16) each call moves 35-67 KB
and does at most 0.27 MFLOP, so its bound is 10-20 ns, set by bytes; launch
latency, microseconds, is what a call costs.  At the CDK shape (f, g: 4096
x 513) K1's symmetric grams need 2.16 GFLOP (bound 32 us, operations), K3
4.3 GFLOP (64 us) and K2 moves 16.8 MB (5 us, bytes).  K2 is one launch
at every shape: warps along the rows, weights in registers, and the
block that draws the last integer ticket sums the blocks' partials in
order (``k2_plan``; csrc/gram_kernels.cu).  K1 and K3 are
register-blocked f32 FFMA tiles fed by a cp.async ring; K1 computes only
the upper 64x64 tiles of each gram (a SYRK, from the table
``upper_tiles``) over a few fixed row chunks (``k1_plan``, a function of B
and L alone, so results repeat bit for bit; 8.4 MB of partials at the CDK
shape), and its finish pass writes M⊙Λ1 and M⊙Λ2, which the backward keeps
in place of Λ and K3 streams.  Rows whose start is not 16-byte aligned
(L = 513) take 4-byte copies, which bound both kernels there; see
csrc/gram_kernels.cu.

Unlike the TPU kernels, nothing pads L to 128 or B to 512: any B >= 1 and
L >= 1 are taken as they are.
"""
from __future__ import annotations

import functools
from typing import NamedTuple

import numpy as np
import torch

from neuralsvd_tpu_torch.ops.cuda_build import load_library
from neuralsvd_tpu_torch.ops.gram import compute_loss_metric
from neuralsvd_tpu_torch.ops.nestedlora import (
    cdk_backward,
    cdk_inputs,
    density_ratios,
)

NUM_SMS = 132  # an H100 SXM; K1's chunking is planned for it
K1_TILE = 64  # K1's output tile edge (csrc kSyrkTile)
K1_BK = 16  # rows a cp.async stage holds (csrc kBK); chunks are multiples
K1_FINISH_TILE = 32  # K1's finish-pass tile edge (csrc kFinishTile)
K1_MAX_CHUNKS = 16
K1_SCRATCH_BYTES = 16 * 2 ** 20  # partial buffer, kept well inside the 50 MB L2
# the plan's cost model, in rows one block sums: a block's fixed cost (ring
# fill, tile store) and a chunk's cost in the finish pass
K1_BLOCK_OVERHEAD_ROWS = 64
K1_FINISH_ROWS_PER_CHUNK = 32
DOT_WARPS = 8  # warps a block (csrc kThreads / 32)
DOT_UNROLL = 4  # row groups a warp loads at once (csrc kDotUnroll)
DOT_MAX_BLOCKS = 4 * NUM_SMS  # enough loads in flight to stream 4096 x 513
_MAX_ELEMS = 2 ** 31 - 2 ** 20  # int32 indexing in the kernels


# ---------------------------------------------------------------------------
# plain versions (the einsum math of ops/nestedlora.py)
# ---------------------------------------------------------------------------

def masked_gram_pair_ref(f1, f2, mmask):
    """(Σ M⊙Λ1⊙Λ2, Λ1 = f1ᵀf1/B1, Λ2 = f2ᵀf2/B2, M⊙Λ1, M⊙Λ2)."""
    loss, lam1, lam2 = compute_loss_metric(f1, f2, mmask)
    return loss, lam1, lam2, mmask * lam1, mmask * lam2


def weighted_dot_ref(f, Tf, vmask):
    """Σ_b Σ_l w_l f[b,l] Tf[b,l] (un-normalized)."""
    return torch.einsum("l,bl,bl->", vmask, f, Tf)


def metric_grads_ref(f1, f2, mlam1, mlam2, scale1: float, scale2: float):
    """g1 = scale1·f1·(M⊙Λ2), g2 = scale2·f2·(M⊙Λ1), from mlam = M⊙Λ."""
    g1 = scale1 * torch.einsum("bl,lm->bm", f1, mlam2)
    g2 = scale2 * torch.einsum("bl,lm->bm", f2, mlam1)
    return g1, g2


# ---------------------------------------------------------------------------
# dispatch helpers
# ---------------------------------------------------------------------------

def _cdiv(a: int, b: int) -> int:
    return -(-a // b)


def _on_cpu(*tensors) -> bool:
    """True when every tensor is on the CPU; False when every one is on
    the same CUDA device; raises on anything else."""
    devices = {t.device for t in tensors}
    if len(devices) != 1:
        raise ValueError(f"tensors on several devices: {sorted(map(str, devices))}")
    dev = devices.pop()
    if dev.type == "cpu":
        return True
    if dev.type != "cuda":
        raise ValueError(f"unsupported device {dev}")
    return False


def _check(name: str, t: torch.Tensor, shape) -> None:
    if t.dtype != torch.float32:
        raise TypeError(f"{name}: expected float32, got {t.dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name}: expected shape {tuple(shape)}, got {tuple(t.shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: expected a contiguous tensor")


def _check_sizes(B: int, L: int) -> None:
    if B < 1 or L < 1 or B * L > _MAX_ELEMS:
        raise ValueError(f"unsupported sizes B={B}, L={L}")


def _launch(name: str, *args) -> None:
    """Call a C launcher of csrc/gram_kernels.cu; raise if CUDA refused it."""
    lib = load_library()
    rc = getattr(lib, name)(*args)
    if rc != 0:
        msg = lib.gram_error_string(rc).decode()
        raise RuntimeError(f"{name} launch failed: CUDA error {rc} ({msg})")


def _vec(L: int, *tensors) -> int:
    """Floats per copy (cp.async in K1/K3, a load in K2): 4 (16 bytes) when
    every row of L floats starts 16-byte aligned, else 1 (4 bytes; L = 513
    rows are 2052 bytes)."""
    aligned = L % 4 == 0 and all(t.data_ptr() % 16 == 0 for t in tensors)
    return 4 if aligned else 1


def _stream(t: torch.Tensor) -> int:
    if t.device.index != torch.cuda.current_device():
        raise ValueError(f"tensor on {t.device} but the current device is "
                         f"cuda:{torch.cuda.current_device()}")
    return torch.cuda.current_stream(t.device).cuda_stream


# ---------------------------------------------------------------------------
# K1: fused pair-gram + masked metric loss
# ---------------------------------------------------------------------------

@functools.cache
def upper_tiles(L: int) -> np.ndarray:
    """(n, 2) int32 origins (l0, m0), l0 <= m0, of the K1_TILE-wide tiles
    that cover every (l, m) with l <= m exactly once (a SYRK's tiles)."""
    starts = range(0, L, K1_TILE)
    return np.array([(l0, m0) for l0 in starts for m0 in starts if l0 <= m0],
                    dtype=np.int32)


_TILE_TABLES: dict = {}


def _tile_table(L: int, device) -> torch.Tensor:
    """``upper_tiles(L)`` on ``device``, copied there once."""
    key = (L, device)
    if key not in _TILE_TABLES:
        _TILE_TABLES[key] = torch.as_tensor(upper_tiles(L), device=device)
    return _TILE_TABLES[key]


class K1Plan(NamedTuple):
    nchunk: int  # row chunks of pass 1
    rows_per_chunk: int
    blocks: int  # pass 1's grid: upper tiles x 2 grams x chunks
    finish_blocks: int  # pass 2's grid; pass 3 runs when it exceeds 1
    scratch_bytes: int  # the (nchunk, 2, L, L) partials and the loss shares
    launches: int  # CUDA kernels a call


@functools.cache
def k1_plan(B: int, L: int) -> K1Plan:
    """K1's split-K over rows, a function of B and L alone (so results
    repeat bit for bit).  Each candidate count of chunks is costed as the
    rows one SM sums, whole waves of NUM_SMS blocks times the rows of a
    chunk plus a block's fixed cost, plus the finish pass's cost a chunk;
    the partials stay under K1_SCRATCH_BYTES.  At 4096 x 513: 4 chunks of
    1024 rows, 360 blocks."""
    tiles = len(upper_tiles(L))
    candidates = []
    for n in range(1, K1_MAX_CHUNKS + 1):
        rows = _cdiv(_cdiv(B, n), K1_BK) * K1_BK
        nchunk = _cdiv(B, rows)
        if nchunk > 1 and 4 * nchunk * 2 * L * L > K1_SCRATCH_BYTES:
            break
        blocks = 2 * tiles * nchunk
        cost = (_cdiv(blocks, NUM_SMS) * (rows + K1_BLOCK_OVERHEAD_ROWS)
                + nchunk * K1_FINISH_ROWS_PER_CHUNK)
        candidates.append((cost, nchunk, rows, blocks))
    # two blocks an SM keep its FMA pipes busy: take two waves where any
    # candidate gives them
    waves = [c for c in candidates if c[3] >= 2 * NUM_SMS]
    _, nchunk, rows, blocks = min(waves or candidates)
    finish_blocks = _cdiv(L, K1_FINISH_TILE) ** 2
    loss_shares = finish_blocks if finish_blocks > 1 else 0
    return K1Plan(nchunk=nchunk, rows_per_chunk=rows, blocks=blocks,
                  finish_blocks=finish_blocks,
                  scratch_bytes=4 * (nchunk * 2 * L * L + loss_shares),
                  launches=2 + (finish_blocks > 1))


def masked_gram_pair(f1: torch.Tensor, f2: torch.Tensor, mmask: torch.Tensor):
    """(metric_loss, lam1, lam2, mlam1, mlam2), normalized by the batch
    size; mlam = M⊙Λ, the backward's coefficients.

    f1, f2: (B, L) float32 half-batches (B1 must equal B2); mmask: (L, L).
    """
    if _on_cpu(f1, f2, mmask):
        return masked_gram_pair_ref(f1, f2, mmask)
    B, L = f1.shape
    _check("f1", f1, (B, L))
    _check("f2", f2, (B, L))
    _check("mmask", mmask, (L, L))
    _check_sizes(B, L)
    plan = k1_plan(B, L)
    tiles = _tile_table(L, f1.device)
    opts = dict(device=f1.device, dtype=torch.float32)
    partial = torch.empty((plan.nchunk, 2, L, L), **opts)
    loss_part = (torch.empty((plan.finish_blocks,), **opts)
                 if plan.finish_blocks > 1 else None)
    lam1, lam2, mlam1, mlam2 = torch.empty((4, L, L), **opts).unbind(0)
    loss = torch.empty((), **opts)
    _launch("gram_masked_gram_pair", f1.data_ptr(), f2.data_ptr(),
            mmask.data_ptr(), tiles.data_ptr(), len(tiles),
            partial.data_ptr(),
            None if loss_part is None else loss_part.data_ptr(),
            lam1.data_ptr(), lam2.data_ptr(), mlam1.data_ptr(),
            mlam2.data_ptr(), loss.data_ptr(), B, L, plan.rows_per_chunk,
            _vec(L, f1, f2, partial), _stream(f1))
    masked_gram_pair.launches += 1
    return loss, lam1, lam2, mlam1, mlam2


masked_gram_pair.launches = 0


# ---------------------------------------------------------------------------
# K2: operator term, streaming weighted dot
# ---------------------------------------------------------------------------

class K2Plan(NamedTuple):
    slots: int  # warps per row chunk
    blocks: int


@functools.cache
def k2_plan(B: int, L: int, vec: int) -> K2Plan:
    """K2's grid, a function of (B, L, vec) alone (so results repeat bit
    for bit).  Rows of at most 32 vectors of ``vec`` floats fill a warp
    with whole rows (a row group), wider rows are cut into chunks of 32
    vectors; each (chunk, slot) warp takes DOT_UNROLL row groups a round.
    One block where whole-row warps need at most two rounds (a one-block
    grid skips the ticket), else one round a warp where that fits in
    DOT_MAX_BLOCKS blocks, else the most warps that hold whole chunks.
    E4 (512 x 16, vec 4): 8 slots, 1 block; 4096 x 513 (vec 1): 17
    chunks x 248 slots, 527 blocks."""
    cols = L // vec
    nchunks = 1 if cols <= 32 else _cdiv(cols, 32)
    groups = _cdiv(B, max(1, 32 // cols)) if cols <= 32 else B
    if nchunks == 1 and _cdiv(groups, DOT_WARPS * DOT_UNROLL) <= 2:
        slots = min(DOT_WARPS, _cdiv(groups, DOT_UNROLL))  # one block
    else:
        slots = min(_cdiv(groups, DOT_UNROLL),
                    DOT_MAX_BLOCKS * DOT_WARPS // nchunks)
    return K2Plan(slots=slots, blocks=_cdiv(slots * nchunks, DOT_WARPS))


_TICKETS: dict = {}


def _ticket(device, stream: int) -> torch.Tensor:
    """K2's ticket counter for launches on ``stream``: one int32 zero
    made once; every launch leaves it at zero."""
    key = (device, stream)
    if key not in _TICKETS:
        _TICKETS[key] = torch.zeros((1,), dtype=torch.int32, device=device)
    return _TICKETS[key]


def weighted_dot(f: torch.Tensor, Tf: torch.Tensor, vmask: torch.Tensor):
    """Σ_b Σ_l w_l f[b,l] Tf[b,l] (un-normalized); f, Tf: (B, L), w: (L,)."""
    if _on_cpu(f, Tf, vmask):
        return weighted_dot_ref(f, Tf, vmask)
    B, L = f.shape
    _check("f", f, (B, L))
    _check("Tf", Tf, (B, L))
    _check("vmask", vmask, (L,))
    _check_sizes(B, L)
    vec = _vec(L, f, Tf, vmask)
    plan = k2_plan(B, L, vec)
    opts = dict(device=f.device, dtype=torch.float32)
    out = torch.empty((), **opts)
    partial = torch.empty((plan.blocks,), **opts)
    stream = _stream(f)
    _launch("gram_weighted_dot", f.data_ptr(), Tf.data_ptr(),
            vmask.data_ptr(), partial.data_ptr(),
            _ticket(f.device, stream).data_ptr(), out.data_ptr(), B, L,
            plan.slots, plan.blocks, vec, stream)
    weighted_dot.launches += 1
    return out


weighted_dot.launches = 0


# ---------------------------------------------------------------------------
# K3: fused backward, both metric gradients
# ---------------------------------------------------------------------------

def metric_grads(f1, f2, mlam1, mlam2, scale1: float, scale2: float):
    """g1[b,m] = scale1 Σ_l f1[b,l] (M⊙Λ2)[l,m];  g2 symmetric; mlam1 and
    mlam2 are M⊙Λ1 and M⊙Λ2, as ``masked_gram_pair`` returns them."""
    if _on_cpu(f1, f2, mlam1, mlam2):
        return metric_grads_ref(f1, f2, mlam1, mlam2, scale1, scale2)
    B, L = f1.shape
    _check("f1", f1, (B, L))
    _check("f2", f2, (B, L))
    _check("mlam1", mlam1, (L, L))
    _check("mlam2", mlam2, (L, L))
    _check_sizes(B, L)
    g1 = torch.empty_like(f1)
    g2 = torch.empty_like(f2)
    _launch("gram_metric_grads", f1.data_ptr(), f2.data_ptr(),
            mlam1.data_ptr(), mlam2.data_ptr(), float(scale1), float(scale2),
            g1.data_ptr(), g2.data_ptr(), B, L,
            _vec(L, f1, f2, mlam1, mlam2, g1, g2), _stream(f1))
    metric_grads.launches += 1
    return g1, g2


metric_grads.launches = 0

KERNELS = (masked_gram_pair, weighted_dot, metric_grads)


def reset_launch_counts() -> None:
    for fn in KERNELS:
        fn.launches = 0


def launch_counts() -> dict:
    return {fn.__name__: fn.launches for fn in KERNELS}


# ---------------------------------------------------------------------------
# packaged loss with the same custom-backward contract as ops/nestedlora.py
# ---------------------------------------------------------------------------

class NestedLoRAEVDLossKernels(torch.autograd.Function):
    """Port of ``nestedlora_evd_loss_pallas`` (pallas_gram.py:239-261).

    Forward: K1 and K2, loss = -2·op/B + metric; K1's M⊙Λ1 and M⊙Λ2 are
    kept for the backward.  Backward: -4/B·w⊙Tf to f, nothing to Tf, and
    (g1, g2) from K3 with s = 2/B_half.  (B, L) only.
    """

    @staticmethod
    def forward(ctx, f, Tf, f1, f2, vector_mask, matrix_mask):
        metric_loss, _, _, mlam1, mlam2 = masked_gram_pair(f1, f2, matrix_mask)
        op = weighted_dot(f, Tf, vector_mask)
        loss = -2.0 * op / f.shape[0] + metric_loss
        ctx.save_for_backward(Tf, f1, f2, mlam1, mlam2, vector_mask)
        return loss

    @staticmethod
    def backward(ctx, g):
        Tf, f1, f2, mlam1, mlam2, vector_mask = ctx.saved_tensors
        operator_f = (-4.0 / Tf.shape[0]) * (vector_mask[None, :] * Tf)
        g1, g2 = metric_grads(f1, f2, mlam1, mlam2, 2.0 / f1.shape[0],
                              2.0 / f2.shape[0])
        return g * operator_f, None, g * g1, g * g2, None, None


def nestedlora_evd_loss_kernels(f, Tf, f1, f2, vector_mask, matrix_mask):
    """NestedLoRA EVD loss through K1-K3 (plain versions on the CPU)."""
    return NestedLoRAEVDLossKernels.apply(f, Tf, f1, f2, vector_mask,
                                          matrix_mask)


class NestedLoRACDKLossKernels(torch.autograd.Function):
    """Port of ``nestedlora_cdk_loss_pallas`` (pallas_gram.py:276-326).

    Forward: const padding and batch weights (ops/nestedlora.py), then K1
    on (f, g) and K2 on (f, g); loss = -2·op/B + metric.  Backward: K3
    with s = 2/B plus the -2/B·w⊙g and -2/B·w⊙f terms, the constant column
    stripped.  The density-ratio gram stays a ``torch.matmul``, as it sits
    outside any kernel in the JAX package, and runs only on request.
    """

    @staticmethod
    def forward(ctx, f, g, vector_mask, matrix_mask, batch_weights,
                set_first_mode_const, return_ratios):
        f, g = cdk_inputs(f, g, set_first_mode_const, batch_weights)
        B = f.shape[0]
        loss_metric, _, _, mlam_f, mlam_g = masked_gram_pair(f, g, matrix_mask)
        loss_operator = -2.0 * weighted_dot(f, g, vector_mask) / B
        loss = loss_operator + loss_metric
        rs = density_ratios(f, g) if return_ratios else (None, None)
        ctx.save_for_backward(f, g, mlam_f, mlam_g, vector_mask)
        ctx.set_first_mode_const = set_first_mode_const
        ctx.mark_non_differentiable(loss_operator, loss_metric,
                                    *(r for r in rs if r is not None))
        return loss, loss_operator, loss_metric, *rs

    @staticmethod
    def backward(ctx, gout, *_):
        f, g, mlam_f, mlam_g, vector_mask = ctx.saved_tensors
        B = f.shape[0]
        metric_f, metric_g = metric_grads(f, g, mlam_f, mlam_g, 2.0 / B,
                                          2.0 / B)
        grad_f, grad_g = cdk_backward(f, g, metric_f, metric_g, vector_mask,
                                      ctx.set_first_mode_const, gout)
        return grad_f, grad_g, None, None, None, None, None


def nestedlora_cdk_loss_kernels(set_first_mode_const, f, g, vector_mask,
                                matrix_mask, batch_weights=None,
                                return_ratios: bool = False):
    """NestedLoRA CDK loss through K1-K3 (plain versions on the CPU); the
    signature and outputs of ``ops.nestedlora.nestedlora_cdk_loss``."""
    return NestedLoRACDKLossKernels.apply(f, g, vector_mask, matrix_mask,
                                          batch_weights, set_first_mode_const,
                                          return_ratios)
