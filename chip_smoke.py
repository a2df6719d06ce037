"""Smoke test of the PyTorch/CUDA port (neuralsvd_tpu_torch) on one GPU.

    python3 chip_smoke.py

Run from the repository root on a machine with an NVIDIA Hopper GPU and the
CUDA toolkit (nvcc).  It imports nothing of JAX nor of the JAX package
(neuralsvd_tpu).  Phases, each printing one JSON line with its elapsed
seconds:

1. device   the GPU's name and nvidia-smi's name/power-limit line;
2. build    the hand-written kernels, one nvcc call into an emptied
            neuralsvd_tpu_torch/csrc/build/;
3. kernels  each kernel against its plain PyTorch version at three shapes,
            and CUDA-event timings of kernel, plain version and library call;
4. trainer  the hydrogen-2D E4 configuration at full width (L = 16,
            B = 512, per-mode 128³ softplus towers, 1024 Fourier maps +
            radial + 4 envelopes, gaussian_mixture sampling with √w
            conjugation, exact nested-JVP Laplacian, operator_scale 100,
            sequential nesting, RMSprop, EMA): kernel vs plain loss on one
            batch, TRAIN_STEPS steps through the kernels with their launch
            counts, steps/s, a GPU-vs-CPU check of the operator on a small
            batch, and the EMA model's 16 Rayleigh eigenvalues.

Then the {"kernels": [...]} line, the nvidia-smi line and, last,
{"ok": true, "device": {...}}.  Any failed check raises: the exit code is
then non-zero and the last line is never printed.  Without a GPU it raises
before printing anything.
"""
import json
import shutil
import statistics
import subprocess
import time

import numpy as np
import torch

from neuralsvd_tpu_torch.data.samplers import get_sampler
from neuralsvd_tpu_torch.methods.nestedlora import NestedLoRA
from neuralsvd_tpu_torch.methods.spectrum import compute_spectrum_evd
from neuralsvd_tpu_torch.models.wavefunctions import make_wavefunctions
from neuralsvd_tpu_torch.operators.problems import get_problem
from neuralsvd_tpu_torch.ops import cuda_build, cuda_gram
from neuralsvd_tpu_torch.ops.masks import (
    joint_nesting_masks,
    sequential_nesting_masks,
    step_weights,
)
from neuralsvd_tpu_torch.training.optimizers import torch_rmsprop
from neuralsvd_tpu_torch.training.train_operator import make_train_step
from neuralsvd_tpu_torch.training.train_state import init_train_state

# E4 (bench.py:29-92, BASELINE.md E4)
NEIGS, BATCH, NDIM = 16, 512, 2
HIDDEN = [128, 128, 128]
FOURIER = 1024
MIX_SCALES = (0.5, 2.0, 6.0, 16.0)
ENVELOPES = tuple(1.0 / (n + 0.5) for n in range(4))
LR, ALPHA, EMA_DECAY, OPERATOR_SCALE = 1e-4, 0.999, 0.995, 100.0
TRAIN_STEPS = 200
WARMUP_STEPS = 20
VAL_POINTS = 4096
SEED = 0
DEVICE = "cuda"

# full batches (B, L); K1/K3 see the two halves (B/2, L), K2 the whole
KERNEL_SHAPES = [("E4", BATCH, NEIGS), ("unaligned", 96, 5), ("wide", 2048, 64)]
KERNEL_RTOL = 1e-5   # of the plain version on |inputs|: f32 rounding scale
LOSS_RTOL = 1e-5     # kernel vs plain loss on one batch
GRAD_RTOL, GRAD_ATOL = 1e-4, 1e-6  # atol in units of the largest entry
OPERATOR_RTOL = 1e-4  # GPU vs CPU Tf, fs: f32 second derivatives

# H100 SXM peaks (NVIDIA data sheet, at a 700 W power limit)
HBM_BYTES_PER_S = 3.35e12
F32_FLOP_PER_S = 67e12

KERNEL_SOURCE = "neuralsvd_tpu_torch/csrc/gram_kernels.cu"
REPLACES = {
    "masked_gram_pair": "neuralsvd_tpu/ops/pallas_gram.py:64",
    "weighted_dot": "neuralsvd_tpu/ops/pallas_gram.py:137",
    "metric_grads": "neuralsvd_tpu/ops/pallas_gram.py:184",
}

_T0 = time.perf_counter()


def emit(phase, **fields):
    row = {"phase": phase, "t": round(time.perf_counter() - _T0, 3), **fields}
    print(json.dumps(row), flush=True)


def check(cond, msg):
    if not cond:
        raise RuntimeError(msg)


def time_ms(fn, iters=100, reps=7):
    """Median per-call milliseconds over ``reps`` CUDA-event windows of
    ``iters`` back-to-back calls, after a warm-up."""
    for _ in range(10):
        fn()
    torch.cuda.synchronize()
    out = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(iters):
            fn()
        end.record()
        end.synchronize()
        out.append(start.elapsed_time(end) / iters)
    return statistics.median(out)


def bound(nbytes, flops):
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / F32_FLOP_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


# ---------------------------------------------------------------------------
# phases
# ---------------------------------------------------------------------------

def phase_device():
    check(torch.cuda.is_available(), "no CUDA device: this smoke needs a GPU")
    smi = subprocess.run(
        ["nvidia-smi", "-i", "0", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60).stdout.strip()
    name = torch.cuda.get_device_name(0)
    emit("device", name=name, nvidia_smi=smi, count=torch.cuda.device_count(),
         capability=list(torch.cuda.get_device_capability(0)),
         torch=torch.__version__, cuda=torch.version.cuda)
    return name, smi


def phase_build():
    shutil.rmtree(cuda_build.BUILD_DIR, ignore_errors=True)
    t0 = time.perf_counter()
    lib = cuda_build.build()
    seconds = time.perf_counter() - t0
    cuda_build.load_library()
    log = lib.with_name(lib.name + ".log").read_text().splitlines()
    ptxas = [ln.strip() for ln in log if "registers" in ln or "Compiling entry" in ln]
    emit("build", seconds=round(seconds, 3), library=lib.name, nvcc_calls=1,
         ptxas=ptxas)


def _kernel_inputs(B, L, gen):
    dev = DEVICE
    f = torch.randn(B, L, generator=gen, device=dev)
    Tf = torch.randn(B, L, generator=gen, device=dev)
    if L == NEIGS:
        vmask, mmask = sequential_nesting_masks(L)
    else:
        vmask, mmask = joint_nesting_masks(step_weights(L))
    f1, f2 = torch.chunk(f, 2)
    return (f, Tf, f1, f2, torch.as_tensor(vmask, device=dev),
            torch.as_tensor(mmask, device=dev))


def phase_kernels():
    """Every kernel against its plain version; timings at each shape."""
    gen = torch.Generator(device=DEVICE).manual_seed(SEED)
    rows = {k: [] for k in REPLACES}
    for label, B, L in KERNEL_SHAPES:
        f, Tf, f1, f2, vmask, mmask = _kernel_inputs(B, L, gen)
        Bh = B // 2
        s = 2.0 / Bh
        lam1 = torch.einsum("bl,bm->lm", f1, f1) / Bh
        lam2 = torch.einsum("bl,bm->lm", f2, f2) / Bh
        cases = {
            "masked_gram_pair": dict(
                run=lambda: cuda_gram.masked_gram_pair(f1, f2, mmask),
                plain=lambda: cuda_gram.masked_gram_pair_ref(f1, f2, mmask),
                scale=lambda: cuda_gram.masked_gram_pair_ref(f1.abs(), f2.abs(), mmask),
                library=None,
                nbytes=4 * (2 * Bh * L + L * L + 1 + 2 * L * L),
                flops=2 * 2 * Bh * L * L + 3 * L * L),
            "weighted_dot": dict(
                run=lambda: cuda_gram.weighted_dot(f, Tf, vmask),
                plain=lambda: cuda_gram.weighted_dot_ref(f, Tf, vmask),
                scale=lambda: cuda_gram.weighted_dot_ref(f.abs(), Tf.abs(), vmask),
                library=lambda: torch.einsum("l,bl,bl->", vmask, f, Tf),
                nbytes=4 * (2 * B * L + L + 1),
                flops=3 * B * L),
            "metric_grads": dict(
                run=lambda: cuda_gram.metric_grads(f1, f2, lam1, lam2, mmask, s, s),
                plain=lambda: cuda_gram.metric_grads_ref(f1, f2, lam1, lam2, mmask, s, s),
                scale=lambda: cuda_gram.metric_grads_ref(
                    f1.abs(), f2.abs(), lam1.abs(), lam2.abs(), mmask, s, s),
                library=None,
                nbytes=4 * (2 * Bh * L + 3 * L * L + 2 * Bh * L),
                flops=2 * 2 * Bh * L * L + 2 * 2 * L * L),
        }
        for name, c in cases.items():
            got = c["run"]()
            torch.cuda.synchronize()
            want, scale = c["plain"](), c["scale"]()
            got, want, scale = (x if isinstance(x, tuple) else (x,)
                                for x in (got, want, scale))
            err = max((g - w).abs().max().item() for g, w in zip(got, want))
            rel = max(((g - w).abs().max() / sc.abs().max()).item()
                      for g, w, sc in zip(got, want, scale))
            check(rel <= KERNEL_RTOL,
                  f"{name} at {label} ({B}x{L}): error {rel:.3g} of scale "
                  f"> {KERNEL_RTOL}")
            ms = time_ms(c["run"])
            plain_ms = time_ms(c["plain"])
            library_ms = time_ms(c["library"]) if c["library"] else None
            bound_ms, bound_by = bound(c["nbytes"], c["flops"])
            rows[name].append(dict(shape=label, B=B, L=L, max_abs_err=err,
                                   rel_err=rel, ms=ms, plain_ms=plain_ms,
                                   library_ms=library_ms, bound_ms=bound_ms,
                                   bound_by=bound_by))
    emit("kernels", rtol=KERNEL_RTOL, results=rows)
    return rows


def _e4_setup(device):
    model = make_wavefunctions(
        ndim=NDIM, neigs=NEIGS, mlp_hidden_dims=HIDDEN,
        nonlinearity="softplus", parallel=True, use_fourier_feature=True,
        fourier_mapping_size=FOURIER, fourier_scale=0.1,
        fourier_append_radial=True, fourier_append_envelopes=ENVELOPES,
        apply_boundary=False, seed=SEED, device=device)
    operator, ground_truth, _ = get_problem(
        problem="sch", potential_type="hydrogen", ndim=NDIM, neigs=NEIGS,
        laplacian_eps=-1.0, laplacian_mode="jvp", operator_scale=OPERATOR_SCALE)
    sampler, importance = get_sampler("gaussian_mixture", BATCH, 1, NDIM,
                                      MIX_SCALES, device=device)
    return model, operator, ground_truth, sampler, importance


def _check_grads(got, ref):
    worst = 0.0
    for k, r in ref.items():
        tol = GRAD_RTOL * r.abs() + GRAD_ATOL * r.abs().max()
        excess = ((got[k] - r).abs() / tol).max().item()
        check(excess <= 1.0, f"kernel vs plain gradient of {k}: {excess:.3g}x tolerance")
        worst = max(worst, excess)
    return worst


def phase_trainer():
    model, operator, ground_truth, sampler, importance = _e4_setup(DEVICE)
    feature_dim = model.base.feature_map.feature_dim
    check(feature_dim == 2 * FOURIER + 1 + len(ENVELOPES), "feature width")
    method = NestedLoRA(model, neigs=NEIGS, sequential=True)  # kernels on CUDA
    plain = NestedLoRA(model, neigs=NEIGS, sequential=True, use_pallas=False)
    optimizer = torch_rmsprop(LR, alpha=ALPHA)
    ts = init_train_state(model, optimizer, method)
    gen = torch.Generator(device=DEVICE).manual_seed(SEED)

    # kernel path vs plain path on one batch, same params
    x = sampler(gen)
    loss_k, grads_k, _, _ = method.loss_and_grad(ts.params, {}, x, operator, importance)
    loss_p, grads_p, _, _ = plain.loss_and_grad(ts.params, {}, x, operator, importance)
    loss_rel = abs(loss_k.item() - loss_p.item()) / abs(loss_p.item())
    check(loss_rel <= LOSS_RTOL, f"kernel vs plain loss: rel {loss_rel:.3g}")
    grad_excess = _check_grads(grads_k, grads_p)

    # GPU vs CPU on a small batch: the same operator on a CPU copy
    cpu_model, cpu_op, _, _, cpu_imp = _e4_setup("cpu")
    cpu_model.load_state_dict(model.state_dict())
    xs = x[:64]
    Tf_g, fs_g = operator(model, xs, importance)
    Tf_c, fs_c = cpu_op(cpu_model, xs.cpu(), cpu_imp)
    op_rel = max(((a.detach().cpu() - b.detach()).abs().max() / b.abs().max()).item()
                 for a, b in ((Tf_g, Tf_c), (fs_g, fs_c)))
    check(op_rel <= OPERATOR_RTOL, f"GPU vs CPU operator: rel {op_rel:.3g}")

    # the main path: TRAIN_STEPS steps through the kernels
    step = make_train_step(method, operator, optimizer, sampler,
                           importance=importance, ema_decay=EMA_DECAY)
    cuda_gram.reset_launch_counts()
    losses, skipped = [], []
    for i in range(TRAIN_STEPS):
        if i == WARMUP_STEPS:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
        ts, metrics = step(ts, gen)
        losses.append(metrics["loss"])
        skipped.append(metrics["skipped"])
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    counts = cuda_gram.launch_counts()
    losses = torch.stack(losses).cpu().numpy()
    n_skipped = int(torch.stack(skipped).sum().item())
    check(np.isfinite(losses).all(), "non-finite training loss")
    check(n_skipped == 0, f"{n_skipped} skipped steps")
    check(all(n == TRAIN_STEPS for n in counts.values()),
          f"launch counts {counts} != {TRAIN_STEPS} each")
    steps_per_s = (TRAIN_STEPS - WARMUP_STEPS) / seconds
    peak_gib = torch.cuda.max_memory_allocated() / 2 ** 30

    # spectrum of the EMA model on one validation batch
    val_sampler, _ = get_sampler("gaussian_mixture", VAL_POINTS, 1, NDIM,
                                 MIX_SCALES, device=DEVICE)
    x_val = val_sampler(torch.Generator(device=DEVICE).manual_seed(SEED + 1))
    out = compute_spectrum_evd((method.eval_apply, ts.ema_params, ts.method_state),
                               [x_val], operator, importance_train=importance,
                               importance_val=importance, device=DEVICE)
    eigvals = np.asarray(out["eigvals"])
    check(eigvals.shape == (NEIGS,) and np.isfinite(eigvals).all(),
          f"eigenvalues {eigvals}")
    emit("trainer", L=NEIGS, B=BATCH, hidden=HIDDEN, feature_dim=feature_dim,
         kernel_vs_plain_loss_rel=loss_rel, kernel_vs_plain_grad_tol_used=grad_excess,
         gpu_vs_cpu_operator_rel=op_rel, steps=TRAIN_STEPS,
         first_loss=float(losses[0]), last_loss=float(losses[-1]),
         skipped=n_skipped, launches=counts, steps_per_s=steps_per_s,
         timed_steps=TRAIN_STEPS - WARMUP_STEPS, peak_mem_gib=peak_gib,
         eigvals=eigvals.tolist(), ground_truth=np.asarray(ground_truth).tolist())
    return counts


def main():
    # full f32 products: TF32 keeps ~3 digits and would break the tolerances
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    name, smi = phase_device()
    phase_build()
    rows = phase_kernels()
    counts = phase_trainer()
    kernels = []
    for kname, results in rows.items():
        e4 = results[0]
        kernels.append({
            "name": kname, "route": "cuda", "source": KERNEL_SOURCE,
            "replaces": REPLACES[kname], "launches": counts[kname],
            "max_abs_err": e4["max_abs_err"], "ms": e4["ms"],
            "plain_ms": e4["plain_ms"], "bound_ms": e4["bound_ms"],
            "bound_by": e4["bound_by"], "library_ms": e4["library_ms"]})
    print(json.dumps({"kernels": kernels}), flush=True)
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": name,
                                             "count": torch.cuda.device_count()}}),
          flush=True)


if __name__ == "__main__":
    main()
