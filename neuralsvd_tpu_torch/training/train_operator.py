"""Operator-EVD training: the step, the multi-step block and the host driver.

Port of ``neuralsvd_tpu/training/train_operator.py``: ``make_train_step``
(:39-124), ``make_scanned_train_step`` (:127-155), ``_batch_stats``
(:158-181) and ``train_operator`` (:177-429).

The step draws a batch, applies the operator, takes the NestedLoRA loss
and its custom backward, clips, updates with the optimizer and updates the
parameter EMA.  A non-finite loss or gradient norm skips the whole update,
selected on the device with ``torch.where``.  Every update is an in-place
copy into the fixed buffers of the ``TrainState`` and the step counter is
a device tensor, so the step reads nothing on the host and may be captured
in a CUDA graph.

JAX's ``lax.scan`` block becomes ``ScannedTrainStep``: on a CUDA device it
captures one step with ``torch.cuda.graph`` (after an eager warm-up on the
capture stream, whose changes to the state are undone) and replays it
``steps_per_call`` times, filling (steps_per_call,) device traces of loss,
gnorm and skipped.  Elsewhere it runs the same step eagerly in a loop.  A
failed capture raises; nothing falls back to the eager loop.

Random numbers: JAX folds the absolute iteration into one key.  Here the
sample generator (and, for a stochastic operator, a probe generator) are
seeded on the host from (seed, absolute iteration) at the start of every
block and advance within it; both are registered with the graph, whose
replays advance them as eager steps do.  So a block gives the same batches
as a graph, as eager steps, or after a resume.

The operator is any of the port's: a PDE operator, or a fixed-landmark
``operators.base.KernelOperator`` (the JAX package's kernel EVD,
``tests/test_training.py:130-168``), whose landmarks are kept on the
device once, so its step captures too.

The mode rescue (``rescue_init_fn``, training/rescue.py) and the SpINx
weight refresh (``spinx_refresh``) run at an eval, between blocks, on the
host, and change the state in place: the driver goes on replaying the
same captured graph.

Data parallelism (``mesh``, JAX's shard_map path): every rank runs the
same driver on replicated state.  The step (``make_train_step(dp_axis=
group)``) draws the rank's own local batch from generators seeded from
(seed, block start, stream, rank) (rank 0 keeps the words of a run without
a mesh, so a one-rank mesh draws what such a run draws), sums the
gradients and averages the method state over the group, each in one flat
all-reduce, before the finite/clip/skip decision.  On NCCL the blocks'
CUDA graphs record these all-reduces (the eager warm-up runs them first,
which makes the communicator; a one-rank group reduces in place and
records none); a gloo group cannot be captured and a graph request on one
raises.  Every rank runs the evals, the rescue and the
SpINx refresh on identical state, so the ranks stay identical; only rank 0
writes the CSV log, the checkpoints and the profile, and the others wait
for it at a barrier.

Tensor parallelism (a ``tp`` axis above 1, JAX's GSPMD path,
``neuralsvd_tpu/training/train_operator.py:256-286``) switches to the
semantics of a global batch, where JAX's ``gspmd`` flag does: every rank
draws the whole batch from generators that do not fold in the rank, and
with dp as well keeps its 1/dp of each half (``mesh.half_rows``), so the
ranks' f1 and f2 rows are slices of the global halves and the dp mean of
their grams is the one-process gram; only a stochastic operator's probes
fold in the dp rank.  A tp rank holds its modes' slices of the per-mode
parameters, their moments and EMA (``shards``, a ``mesh.ModeShards``); the
method (built with ``mode_axis`` the tp group) gathers f and Tf along the
modes before the loss, the step sums the gradients of the replicated
parameters used before the gather over tp, and the optimizer's norms are
those of the whole tensors.  So the run is the one-process run up to
reduction order.  The evals, the rescue and the checkpoints run on the
gathered state (``eval_method``: the method on the whole model), and the
rescue's edits are narrowed back into each rank's share in place.  A
method state with sharded leaves (SpIN's ``j_avg``, whose modes lie on the
axis the method names in ``state_mode_axes``) is gathered only for a
checkpoint, the rescue and the returned state: an eval reads only its
replicated ``chol``.
"""
from __future__ import annotations

import dataclasses
import logging
import math
import os
import time
from typing import Callable, Dict, Optional

import numpy as np
import torch
import torch.distributed as dist
from torch.utils._pytree import tree_flatten, tree_unflatten

from neuralsvd_tpu_torch.ops import cuda_gram
from neuralsvd_tpu_torch.parallel.collectives import axis_index, pmean, psum_flat
from neuralsvd_tpu_torch.parallel.mesh import (
    barrier,
    check_method_axis,
    dp_group,
    half_rows,
    is_writer,
    method_state_axes,
    require_capturable,
    tp_group,
)
from neuralsvd_tpu_torch.training.optimizers import global_norm, grad_norm, select_state
from neuralsvd_tpu_torch.training.train_state import (
    STATE_FIELDS,
    TrainState,
    assign_state,
    clone_tree,
    ema_update,
    init_train_state,
    load_state_tree,
    state_pointers,
)

__all__ = ["ScannedTrainStep", "batch_stats", "block_seed", "global_norm",
           "make_scanned_train_step", "make_train_step", "train_operator"]

log = logging.getLogger(__name__)

SAMPLE_STREAM = 0
PROBE_STREAM = 0x0BE5
RESCUE_STREAM = 0x0DE5
REFRESH_STREAM = 0x5F1E
GRAPH_WARMUP_STEPS = 3  # eager steps on the capture stream before capture
# The profiler keeps a kernel only if its device timestamp, converted to
# host time, falls inside the trace window, and on an H100 that conversion
# was seen off by up to ~1.5 ms: a window that opens or closes on a busy
# device loses kernels at its edges.  So a window opens and closes on an
# idle device, with this margin of idle time inside it.
PROFILE_MARGIN_S = 0.1


def block_seed(seed: int, start: int, stream: int = SAMPLE_STREAM,
               rank: int = 0) -> int:
    """The seed of generator ``stream`` for the block that starts at
    absolute iteration ``start`` of a run seeded ``seed``, on data-parallel
    rank ``rank`` (a further word of the seed after rank 0)."""
    words = [seed, start, stream] + ([rank] if rank else [])
    hi, lo = np.random.SeedSequence(words).generate_state(2)
    return ((int(hi) << 32) | int(lo)) & (2 ** 63 - 1)


def _erf_percentiles() -> np.ndarray:
    pts = [math.erf(x / math.sqrt(2)) for x in range(-3, 4)]
    return 100 * (1 + np.array(pts)) / 2


def batch_stats(values: torch.Tensor) -> torch.Tensor:
    """(B, L) -> (9, L): 7 erf-spaced percentiles, the mean, the mean again
    (the slow slot), the statistics ``EWMMonitor.update_stats`` takes."""
    qs = torch.as_tensor(_erf_percentiles() / 100, dtype=values.dtype,
                         device=values.device)
    pct = torch.quantile(values, qs, dim=0)  # (7, L)
    mean = torch.mean(values, dim=0, keepdim=True)
    return torch.cat([pct, mean, mean], dim=0)


def _mean_state(state, group):
    """``state`` with its floating tensors averaged over ``group`` in one
    flat all-reduce (other leaves, equal on every rank, kept)."""
    leaves, spec = tree_flatten(state)
    floats = [i for i, t in enumerate(leaves)
              if isinstance(t, torch.Tensor) and t.is_floating_point()]
    for i, m in zip(floats, psum_flat([leaves[i] for i in floats], group, mean=True)):
        leaves[i] = m
    return tree_unflatten(leaves, spec)


def make_train_step(method, operator, optimizer, sampler: Callable,
                    importance: Optional[Callable] = None,
                    ema_decay: float = 0.99, grad_clip: float = 0.0,
                    monitor: bool = False, dp_axis=None, tp_axis=None, shards=None):
    """Build the train step: (TrainState, generator[, probes]) ->
    (TrainState, metrics).

    ``sampler(generator)`` returns the batch; ``probes`` is the generator
    of a stochastic (``needs_key``) operator's probes; without one the step
    keeps a generator of its own per device, seeded once from the sample
    generator's initial seed.  ``grad_clip`` > 0 clips the global gradient
    norm.  The state is updated in place and returned.  ``metrics`` hold
    device tensors ``loss``, ``gnorm``, ``skipped`` and, with ``monitor``,
    the (9, L) ``quad_stats`` and ``sqnorm_stats``.

    ``dp_axis``: a data-parallel process group (the method built with the
    same ``axis_name``), or None.  With one the gradients (partial sums over
    the local rows, normalised by the global batch) are SUMMED over the
    group and the method state averaged, each in one flat all-reduce,
    BEFORE the finite/clip/skip decision, so every rank takes the same
    update; the monitor's statistics are averaged too.  Each rank passes
    its own generators.  The method must be built with ``axis_name``
    ``dp_axis`` (else ValueError).

    ``tp_axis``: a tensor-parallel group (the module docstring): the
    sampler draws the global batch, of which the step keeps this dp rank's
    share of each half; ``shards`` (a ``ModeShards`` on ``tp_axis``, None
    where the model has no per-mode parameter and every rank holds all of
    it) says which parameters this rank holds a slice of; the method must
    be built with ``mode_axis`` its group (else ValueError).  The gradients
    of ``shards.pre_gather`` are summed over ``tp_axis`` (one flat
    all-reduce) before the dp sum, and the clip and the finite test read
    the whole gradient's norm.
    """
    check_method_axis(method, dp_axis)
    mode_group = None if shards is None else shards.group
    if getattr(method, "mode_axis", None) is not mode_group:
        raise ValueError(f"method.mode_axis={getattr(method, 'mode_axis', None)!r} must be "
                         f"the step's mode-sharding group ({mode_group!r})")
    pre_gather = [] if shards is None else sorted(shards.pre_gather)
    stochastic_op = getattr(operator, "needs_key", False)
    own_probes: Dict[torch.device, torch.Generator] = {}

    def default_probes(device, generator):
        if device not in own_probes:
            seed = generator.initial_seed() if generator is not None else 0
            own_probes[device] = torch.Generator(device=device).manual_seed(
                block_seed(seed, 0, PROBE_STREAM))
        return own_probes[device]

    def step(ts: TrainState, generator, probes=None) -> tuple:
        x = sampler(generator)
        x = x.reshape(x.shape[0], -1)
        if tp_axis is not None:
            x = half_rows(x, dp_axis)
        op = operator
        if stochastic_op:
            gen = probes if probes is not None else default_probes(x.device, generator)
            op = lambda f, xv, importance=None, **kw: operator(  # noqa: E731
                f, xv, importance, generator=gen, **kw)
        loss, grads, aux, method_state = method.loss_and_grad(
            ts.params, ts.method_state, x, op, importance)
        if pre_gather:
            grads.update(zip(pre_gather, psum_flat([grads[k] for k in pre_gather],
                                                   shards.group)))
        if dp_axis is not None:
            grads = dict(zip(grads, psum_flat(grads.values(), dp_axis)))
            method_state = _mean_state(method_state, dp_axis)
        gnorm = grad_norm(grads, shards)
        finite = torch.isfinite(loss) & torch.isfinite(gnorm)
        with torch.no_grad():
            if grad_clip > 0:
                scale = torch.clamp(grad_clip / (gnorm + 1e-12), max=1.0)
                grads = {k: g * scale for k, g in grads.items()}
            grads = {k: torch.where(finite, g, torch.zeros_like(g))
                     for k, g in grads.items()}
            updates, opt_state = optimizer.update(grads, ts.opt_state, ts.params)
            for k, p in ts.params.items():
                p.copy_(torch.where(finite, p + updates[k], p))
            assign_state(ts.opt_state, select_state(finite, opt_state, ts.opt_state))
            assign_state(ts.ema_params, ema_update(ts.ema_params, ts.params,
                                                   ema_decay, step=ts.step))
            assign_state(ts.method_state, method_state)
            ts.step.add_(1)
        metrics = {"loss": loss, "gnorm": gnorm,
                   "skipped": torch.logical_not(finite)}
        if monitor:
            f, Tf = aux["f"], aux["Tf"]
            metrics["quad_stats"] = pmean(batch_stats(f * Tf), dp_axis)  # local energies
            metrics["sqnorm_stats"] = pmean(batch_stats(f * f), dp_axis)
        return ts, metrics

    step.needs_probes = stochastic_op
    return step


class ScannedTrainStep:
    """``steps_per_call`` train steps a call: (ts, start[, n]) -> (ts,
    metrics), metrics {loss, gnorm, skipped} of shape (n,), n defaulting to
    ``steps_per_call``; ``start`` is the block's absolute iteration.

    A full block on a CUDA device replays a captured step (``use_graph``);
    a shorter block, a CPU device or ``use_graph=False`` runs the same
    step eagerly n times.  The host reads nothing inside a block.  The
    graph reads and writes the state's tensors as they were at capture:
    a later block on the same TrainState raises if one was replaced.
    ``group``: the data-parallel group of a step made with ``dp_axis``; the
    rank is a further word of the generators' seeds, and a capture on a
    group that cannot be captured (gloo) raises ValueError.  ``tp_group``:
    the tensor-parallel group of a step made with ``tp_axis``; then the
    sample generator is seeded as without a mesh on every rank (the global
    batch) and only the probe generator takes the dp rank.
    """

    def __init__(self, step, steps_per_call: int, seed: int = 0,
                 use_graph: bool = True, group=None, tp_group=None):
        self.step = step
        self.steps_per_call = steps_per_call
        self.seed = seed
        self.use_graph = use_graph
        self.group = group
        self.tp_group = tp_group
        self.rank = axis_index(group)
        self.sample_rank = 0 if tp_group is not None else self.rank
        self.graph: Optional[torch.cuda.CUDAGraph] = None
        self._graph_state: Optional[TrainState] = None
        self._graph_ptrs: tuple = ()
        self._buffers: Dict[torch.device, tuple] = {}

    def buffers(self, device):
        """(sample generator, probe generator or None, traces
        (steps_per_call, 3), position) on ``device``, made once."""
        device = torch.device(device)
        if device not in self._buffers:
            probes = (torch.Generator(device=device)
                      if getattr(self.step, "needs_probes", False) else None)
            self._buffers[device] = (
                torch.Generator(device=device), probes,
                torch.zeros((self.steps_per_call, 3), device=device),
                torch.zeros((), dtype=torch.int64, device=device))
        return self._buffers[device]

    def begin_block(self, device, start: int) -> None:
        """Seed the generators from (seed, start) and rewind the traces."""
        sample, probes, _, pos = self.buffers(device)
        sample.manual_seed(block_seed(self.seed, start, SAMPLE_STREAM, self.sample_rank))
        if probes is not None:
            probes.manual_seed(block_seed(self.seed, start, PROBE_STREAM, self.rank))
        pos.zero_()

    def eager_step(self, ts: TrainState) -> dict:
        """One step, its metrics written into the traces' next row."""
        sample, probes, traces, pos = self.buffers(ts.step.device)
        _, metrics = self.step(ts, sample, probes)
        with torch.no_grad():
            row = torch.stack([metrics["loss"], metrics["gnorm"],
                               metrics["skipped"].to(torch.float32)])
            traces.index_copy_(0, pos.reshape(1), row[None])
            pos.add_(1)
        return metrics

    def _capture(self, ts: TrainState) -> None:
        if not hasattr(torch.cuda.CUDAGraph, "register_generator_state"):
            raise RuntimeError("this PyTorch cannot register a generator with "
                               "a CUDA graph (needs torch >= 2.5)")
        device = ts.step.device
        require_capturable(self.group, device)
        require_capturable(self.tp_group, device)
        sample, probes, _, _ = self.buffers(device)
        with torch.no_grad():
            saved = {name: clone_tree(getattr(ts, name)) for name in STATE_FIELDS}
        stream = torch.cuda.Stream(device)
        stream.wait_stream(torch.cuda.current_stream(device))
        # the warm-up makes on the capture stream what a step creates on
        # first use (kernel tickets, tile tables, masks, cuBLAS workspaces,
        # a data-parallel group's NCCL communicator)
        with torch.cuda.stream(stream):
            for _ in range(GRAPH_WARMUP_STEPS):
                self.eager_step(ts)
        torch.cuda.current_stream(device).wait_stream(stream)
        load_state_tree(ts, saved)
        graph = torch.cuda.CUDAGraph()
        graph.register_generator_state(sample)
        if probes is not None:
            graph.register_generator_state(probes)
        with torch.cuda.graph(graph, stream=stream):
            self.eager_step(ts)
        self.graph, self._graph_state = graph, ts
        self._graph_ptrs = state_pointers(ts)
        log.info("captured a CUDA graph of one train step")

    def __call__(self, ts: TrainState, start: int, n: Optional[int] = None):
        n = self.steps_per_call if n is None else n
        if not 0 < n <= self.steps_per_call:
            raise ValueError(f"a block of {n} steps (at most {self.steps_per_call})")
        device = ts.step.device
        graph = (self.use_graph and device.type == "cuda"
                 and n == self.steps_per_call)
        if graph and self._graph_state is not ts:
            self._capture(ts)
        elif graph and state_pointers(ts) != self._graph_ptrs:
            raise RuntimeError(
                "a tensor of the TrainState was replaced after the block was "
                "captured; the graph would go on writing the old one (update "
                "the state in place, e.g. with train_state.assign_state)")
        self.begin_block(device, start)
        if graph:
            for _ in range(n):
                self.graph.replay()
        else:
            for _ in range(n):
                self.eager_step(ts)
        traces = self.buffers(device)[2][:n]
        return ts, {"loss": traces[:, 0].clone(), "gnorm": traces[:, 1].clone(),
                    "skipped": traces[:, 2] > 0}


def make_scanned_train_step(method, operator, optimizer, sampler,
                            importance=None, ema_decay: float = 0.99,
                            steps_per_call: int = 100, grad_clip: float = 0.0,
                            seed: int = 0, use_graph: bool = True):
    """The multi-step block, a ``ScannedTrainStep`` over ``make_train_step``."""
    step = make_train_step(method, operator, optimizer, sampler,
                           importance=importance, ema_decay=ema_decay,
                           grad_clip=grad_clip)
    return ScannedTrainStep(step, steps_per_call, seed=seed, use_graph=use_graph)


def _sync(device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _open_profile(device):
    """Start a ``torch.profiler`` trace on an idle device."""
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if device.type == "cuda":
        activities.append(ProfilerActivity.CUDA)
    _sync(device)
    prof = profile(activities=activities)
    prof.__enter__()
    if device.type == "cuda":
        time.sleep(PROFILE_MARGIN_S)
    return prof


def _close_profile(prof, device, profile_dir: str) -> None:
    """End the trace on an idle device and write ``profile_dir/trace.json``."""
    _sync(device)
    if device.type == "cuda":
        time.sleep(PROFILE_MARGIN_S)
    prof.__exit__(None, None, None)
    os.makedirs(profile_dir, exist_ok=True)
    prof.export_chrome_trace(os.path.join(profile_dir, "trace.json"))


def train_operator(
    method,
    operator,
    sampler: Callable,
    optimizer,
    model: torch.nn.Module,
    num_iters: int,
    importance_train: Optional[Callable] = None,
    importance_val: Optional[Callable] = None,
    val_batches: Optional[Callable] = None,
    ema_decay: float = 0.99,
    eval_freq: int = 50_000,
    print_freq: int = 1_000,
    log_writer=None,
    seed: int = 42,
    monitor: bool = False,
    post_align: bool = False,
    normalize: Optional[bool] = None,
    checkpoint_fn: Optional[Callable] = None,
    spinx_refresh: Optional[Callable] = None,
    profile_dir: Optional[str] = None,
    profile_start: int = 100,
    profile_steps: int = 20,
    grad_clip: float = 0.0,
    mesh=None,
    dp_axis: str = "dp",
    rescue_init_fn: Optional[Callable] = None,
    rescue_until: float = 0.7,
    initial_ts: Optional[TrainState] = None,
    start_iter: int = 0,
    use_graph: bool = True,
    timings: Optional[dict] = None,
    shards=None,
    eval_method=None,
):
    """Host driver: blocks of ``print_freq`` steps, a print row after each,
    an eval of the EMA parameters every ``eval_freq`` steps with its
    mode-health report, and ``checkpoint_fn(ts, it, outputs)`` after it.
    With ``rescue_init_fn`` (``generator -> fresh params``) set, an eval
    in the first ``rescue_until`` fraction of training that diagnoses dead
    or duplicate modes also repairs them in place (training/rescue.py):
    ParallelMLP towers by perturbed clones of healthy modes with matched
    amplitudes, other models by fresh draws; its random numbers come from
    a CPU generator seeded from (seed + 1, iteration).  ``spinx_refresh(ts,
    generator)`` runs after ``checkpoint_fn`` at every eval and refreshes
    SpINx's loss weights in place from a batch it draws from a generator
    on the device seeded from (seed, iteration, ``REFRESH_STREAM``); JAX
    draws it with the key of the block's last step
    (``neuralsvd_tpu/training/train_operator.py:372``), a stream torch
    cannot reproduce, so the refresh batch differs from JAX's.

    Full blocks (``print_freq`` > 1, ``num_iters`` >= ``print_freq``, no
    ``monitor``) run as ``ScannedTrainStep`` blocks: a replayed CUDA graph
    on the card unless ``use_graph`` is false, eager steps elsewhere; a
    shorter block runs eager steps.  ``monitor`` runs eager steps and feeds
    each step's (9, L) statistics to per-mode ``EWMMonitor``s.  Both paths
    seed the generators at the same block boundaries, so they draw the same
    batches.  ``initial_ts``/``start_iter`` resume a run.  With
    ``profile_dir`` set, a ``torch.profiler`` trace of the blocks from
    ``profile_start`` on, ``profile_steps`` steps or more, is written there.
    Given a dict ``timings``, the wall seconds of each block
    (``block_graph`` or ``block_eager``, keyed by its steps), of each eval
    (``eval``), checkpoint (``checkpoint``) and SpINx refresh
    (``spinx_refresh``) are appended to it; each ends in a device sync.
    ``mesh``: a ``DeviceMesh`` (parallel/mesh.py) whose ``dp_axis``
    group the method was built with (``axis_name``): data parallelism as
    the module docstring says, the sampler's batch per rank.  A ``tp``
    axis above 1 in ``mesh``: tensor parallelism (module docstring), the
    sampler's batch global; ``model`` and ``method`` are then this rank's
    share of the modes (``shards``, None on a model with no per-mode
    parameter) and ``eval_method`` the method on the whole model, which
    the evals and the rescue use (default: ``method``).

    Returns (final TrainState, all_eigvals, all_norms); under tp the
    TrainState gathered from every rank's share, the method state's too.
    """
    from neuralsvd_tpu_torch.methods.spectrum import (
        compute_spectrum_evd,
        format_mode_health,
        mode_health,
    )
    from neuralsvd_tpu_torch.training.ewm import EWMMonitor

    ts = (initial_ts if initial_ts is not None
          else init_train_state(model, optimizer, method))
    device = ts.step.device
    writer = mesh is None or is_writer()
    timings = {} if timings is None else timings
    if normalize is None:
        normalize = method.name in ("nestedlora", "neuralsvd")

    monitors_quad = monitors_sqnorm = None
    if monitor:
        monitors_quad = [EWMMonitor() for _ in range(method.neigs)]
        monitors_sqnorm = [EWMMonitor() for _ in range(method.neigs)]

    use_scan = not monitor and num_iters >= print_freq > 1
    step_kw = dict(importance=importance_train, ema_decay=ema_decay,
                   grad_clip=grad_clip, monitor=monitor)
    group = None if mesh is None else dp_group(mesh, dp_axis)
    tp = None if mesh is None else tp_group(mesh)
    everyone = None if mesh is None else dist.group.WORLD  # waits for the writer
    eval_method = method if eval_method is None else eval_method
    step = make_train_step(method, operator, optimizer, sampler, dp_axis=group,
                           tp_axis=tp, shards=shards, **step_kw)
    blocks = ScannedTrainStep(step, max(print_freq, 1), seed=seed,
                              use_graph=use_graph and use_scan, group=group,
                              tp_group=tp)

    method_axes = method_state_axes(method)

    def whole_state() -> TrainState:
        """The TrainState of all modes: ``ts``, or under tp every rank's
        share gathered (new tensors) but the method state, which stays
        this rank's (``with_method_state`` gathers it)."""
        if shards is None:
            return ts
        return TrainState(step=ts.step, method_state=ts.method_state,
                          **{name: shards.gather_tree(getattr(ts, name))
                             for name in ("params", "opt_state", "ema_params")})

    def with_method_state(whole: TrainState) -> TrainState:
        """``whole`` with the method state of all modes (gathered under tp)."""
        if shards is None or whole.method_state is not ts.method_state:
            return whole
        return dataclasses.replace(
            whole, method_state=shards.gather_state(ts.method_state, method_axes))
    path = "graph" if blocks.use_graph and device.type == "cuda" else "eager"
    log.info("train steps: %s blocks of %d", path, max(print_freq, 1))
    if isinstance(ts.method_state, dict) and ts.method_state:
        log.info("method state bytes on this rank: %s", {
            k: sum(t.numel() * t.element_size() for t in tree_flatten(v)[0]
                   if isinstance(t, torch.Tensor))
            for k, v in ts.method_state.items()})

    all_eigvals, all_norms = [], []

    def run_eval(it_done):
        t0 = time.perf_counter()
        whole = whole_state()
        outputs = compute_spectrum_evd(
            (eval_method.eval_apply, whole.ema_params, whole.method_state),
            val_batches(), operator, importance_train=importance_train,
            importance_val=importance_val, post_align=post_align,
            normalize=normalize, device=device)
        all_eigvals.append(outputs["eigvals"])
        all_norms.append(outputs["norms"])
        log.info("it%d eigvals: %s", it_done, outputs["eigvals"])
        # the health report reads real norms: undo normalize's cov rescale
        norms = np.asarray(outputs["norms"])
        cov = np.asarray(outputs["cov"])
        if normalize:
            cov = cov * np.sqrt(np.outer(norms, norms))
        health = mode_health(cov, np.asarray(outputs["quad"]))
        report = format_mode_health(health)
        if report:
            log.warning("it%d mode health:\n%s", it_done, report)
        else:
            log.info("it%d mode health: all %d modes healthy", it_done,
                     method.neigs)
        if (rescue_init_fn is not None and not health["healthy"].all()
                and it_done <= rescue_until * num_iters):
            whole = run_rescue(whole, it_done, cov, np.asarray(outputs["quad"]))
        timings.setdefault("eval", []).append(time.perf_counter() - t0)
        if checkpoint_fn is not None:
            t0 = time.perf_counter()
            whole = with_method_state(whole)
            if writer:
                checkpoint_fn(whole, it_done, outputs)
            barrier(everyone)
            timings.setdefault("checkpoint", []).append(time.perf_counter() - t0)
        if spinx_refresh is not None:
            t0 = time.perf_counter()
            pointers = state_pointers(ts)
            spinx_refresh(ts, torch.Generator(device=device).manual_seed(
                block_seed(seed, it_done, REFRESH_STREAM)))
            if state_pointers(ts) != pointers:
                raise RuntimeError("the SpINx refresh replaced a tensor of the TrainState")
            _sync(device)
            timings.setdefault("spinx_refresh", []).append(time.perf_counter() - t0)

    rescue_grace: list = []

    def run_rescue(whole, it_done, cov, quad):
        from neuralsvd_tpu_torch.models.wavefunctions import scale_mode_amplitudes
        from neuralsvd_tpu_torch.training.rescue import rescue_modes

        def measure_norms(params):
            # batch norms on one val batch (a relative measure only)
            x = torch.as_tensor(next(iter(val_batches())), device=device)
            with torch.no_grad():
                f = eval_method.eval_apply(params, whole.method_state, x)
            return torch.mean(f * f, dim=0).cpu().numpy()

        scale_fn = (scale_mode_amplitudes
                    if any(k.startswith("base.ws.") for k in whole.params)  # ParallelMLP
                    else None)
        pointers = state_pointers(ts)
        whole = with_method_state(whole)
        generator = torch.Generator().manual_seed(
            block_seed(seed + 1, it_done, RESCUE_STREAM))
        _, info = rescue_modes(
            whole, rescue_init_fn, generator, cov, quad, method.neigs,
            measure_norms=measure_norms if scale_fn else None,
            scale_fn=scale_fn, clone_healthy_tail=scale_fn is not None,
            grace_slots=rescue_grace)
        if shards is not None:  # every rank's share of the rescued modes
            load_state_tree(ts, shards.narrow_fields(
                {name: getattr(whole, name) for name in STATE_FIELDS}, method_axes))
        if state_pointers(ts) != pointers:
            raise RuntimeError("the rescue replaced a tensor of the TrainState")
        rescue_grace[:] = list(info["tail_slots"]) if info["n_spurious"] else []
        log.warning("it%d rescue: exiled + re-initialized %d modes", it_done,
                    info["n_spurious"])
        if info["n_spurious"]:
            log.info("it%d rescue: tail slots %s, clone sources %s, amplitude "
                     "factors %s; state tensors kept in place", it_done,
                     info["tail_slots"].tolist(),
                     np.asarray(info.get("clone_sources", [])).tolist(),
                     np.asarray(info["amplitude_factors"]).tolist())
        return whole

    total_skips = 0
    start = time.time()
    it = start_iter
    prof = None
    profile_end = 0
    while it < num_iters:
        if profile_dir is not None and writer and prof is None and it >= profile_start:
            prof = _open_profile(device)
            profile_end = it + profile_steps
        n = min(print_freq - (it % print_freq), num_iters - it)
        t0 = time.perf_counter()
        if not monitor:
            ts, metrics = blocks(ts, it, n)
            kind = "block_graph" if (path == "graph" and n == blocks.steps_per_call) else "block_eager"
            loss_v, skips = torch.stack(
                [metrics["loss"][-1], metrics["skipped"].sum().to(torch.float32)]).tolist()
            total_skips += int(skips)
            cuda_gram.check_tickets()
        else:
            kind = "block_eager"
            blocks.begin_block(device, it)
            for _ in range(n):
                metrics = blocks.eager_step(ts)
                qs = metrics["quad_stats"].cpu().numpy()
                ns = metrics["sqnorm_stats"].cpu().numpy()
                for i in range(method.neigs):
                    monitors_quad[i].update_stats(qs[:, i])
                    monitors_sqnorm[i].update_stats(ns[:, i])
                total_skips += int(metrics["skipped"])
            loss_v = float(metrics["loss"])
        timings.setdefault(kind, []).append((n, time.perf_counter() - t0))
        it += n
        if prof is not None and it >= profile_end:
            _close_profile(prof, device, profile_dir)
            prof, profile_dir = None, None
            log.info("profiler trace written")
        if it % print_freq == 0 or it == num_iters:
            elapsed = time.time() - start
            row = {"iter": it, "train_loss": loss_v, "time": elapsed,
                   "steps_per_sec": (it - start_iter) / elapsed}
            if total_skips:
                row["skips"] = total_skips
            log.info("%s", row)
            if log_writer is not None and writer:
                log_writer.writerow(
                    {k: row.get(k) for k in
                     ("iter", "train_loss", "time", "steps_per_sec")})
        if val_batches is not None and (it // eval_freq) > ((it - n) // eval_freq):
            run_eval(it)
    if prof is not None:  # the loop ended inside the trace window
        _close_profile(prof, device, profile_dir)
    return with_method_state(whole_state()), all_eigvals, all_norms
