"""Smoke test of the PyTorch/CUDA port (neuralsvd_tpu_torch) on one GPU.

    python3 chip_smoke.py

Run from the repository root on a machine with an NVIDIA Hopper GPU and the
CUDA toolkit (nvcc).  It imports nothing of JAX nor of the JAX package
(neuralsvd_tpu).  Phases, each printing one JSON line with its elapsed
seconds:

1. device     the GPU's name and nvidia-smi's name/power-limit line;
2. build      the hand-written kernels, one nvcc call into an emptied
              neuralsvd_tpu_torch/csrc/build/, and each kernel's registers,
              shared memory and spills from ptxas (no spill allowed);
3. kernels    each kernel against its plain PyTorch version at five shapes
              (E4, two odd ones, 1000 x 129 halves one column past K1's
              64-wide tiles, and the CDK path's 4096 x 513 pair), and
              CUDA-event timings of kernel, plain version and library call;
4. trainer    the hydrogen-2D E4 configuration at full width (L = 16,
              B = 512, per-mode 128³ softplus towers, 1024 Fourier maps +
              radial + 4 envelopes, gaussian_mixture sampling with √w
              conjugation, exact nested-JVP Laplacian, operator_scale 100,
              sequential nesting, RMSprop, EMA): kernel vs plain loss on one
              batch, TRAIN_STEPS steps through the kernels with their launch
              counts, steps/s, a GPU-vs-CPU check of the operator on a small
              batch, and the EMA model's 16 Rayleigh eigenvalues;
5. cdk_loss   the CDK loss at the paper's width (B 4096, L 512 + the
              constant mode) on the towers' outputs: kernel packaging vs
              plain loss, with and without batch weights, ratios included;
              the towers on the GPU vs a CPU copy on a small batch;
6. cdk_train  the Sketchy CDK trainer (cli/sketchy.py::run_training) at the
              paper's width (512-8192-512 lrelu0.2 towers, L 512, B 4096,
              SGD momentum 0.9, lr 5e-3 warmup-cosine, grad clip 1.0, joint
              nesting) on synthetic class-correlated 512-d features, two
              epochs of CDK_STEPS steps, with retrieval, spectrum and the
              truncation sweep; every loss finite, no skipped step, one
              launch of each kernel per step; the run's seconds by part
              (steps with loader and copies, eval, checkpoint, ratios,
              spectrum, truncation sweep); then steps/s of the train step
              alone on device-resident batches and its peak device memory.

Then the {"kernels": [...]} line (numbers at the CDK shape, launches of
both main paths, per-path numbers under "paths"), the nvidia-smi line and,
last, {"ok": true, "device": {...}}.  Any failed check raises: the exit
code is then non-zero and the last line is never printed.  Without a GPU it
raises before printing anything.
"""
import copy
import csv
import json
import os
import shutil
import statistics
import subprocess
import tempfile
import time

import numpy as np
import torch

from neuralsvd_tpu_torch.cli.sketchy import get_args, make_trainer, run_training
from neuralsvd_tpu_torch.data.samplers import get_sampler
from neuralsvd_tpu_torch.data.sketchy import ArrayPairLoader
from neuralsvd_tpu_torch.methods.nestedlora import NestedLoRA
from neuralsvd_tpu_torch.methods.spectrum import compute_spectrum_evd
from neuralsvd_tpu_torch.models.mlp import parse_dims
from neuralsvd_tpu_torch.models.wavefunctions import make_wavefunctions
from neuralsvd_tpu_torch.operators.problems import get_problem
from neuralsvd_tpu_torch.ops import cuda_build, cuda_gram
from neuralsvd_tpu_torch.ops.cuda_gram import nestedlora_cdk_loss_kernels
from neuralsvd_tpu_torch.ops.masks import (
    joint_nesting_masks,
    sequential_nesting_masks,
    step_weights,
)
from neuralsvd_tpu_torch.ops.nestedlora import nestedlora_cdk_loss
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

# CDK: the Sketchy paper's configuration (scripts/exps/sketchy.sh:15-36) on
# synthetic features; joint nesting (the script's intent, see ROADMAP §3)
CDK_ARGV = ["--network_dims", "8192,512", "--neigs", "512", "--batch_size", "4096",
            "--optimizer", "sgd", "--momentum", "0.9", "--base_lr", "5e-3",
            "--use_lr_scheduler", "--grad_clip", "1.0", "--mu", "16",
            "--neuralsvd.step", "1", "--neuralsvd.set_first_mode_const", "true",
            "--activation", "lrelu0.2", "--n_retrievals", "100", "--return_map_all",
            "--randperm", "--trunc_dims", "1", "8", "64", "-64", "512", "--seed", "0"]
CDK_DIM, CDK_CLASSES, CDK_B, CDK_L = 512, 25, 4096, 512
CDK_STEPS, CDK_EPOCHS, CDK_EVAL = 16, 2, 8192  # steps an epoch, epochs, eval items
CDK_TIMED, CDK_WARMUP = 50, 10
CDK_TOWER_RTOL = 1e-4  # GPU vs CPU towers: f32 products of depth 8192

# full batches (B, L); K1/K3 see the two halves (B/2, L), K2 the whole on
# the EVD path and the two halves (f, g) on the CDK path
KERNEL_SHAPES = [("E4", BATCH, NEIGS), ("unaligned", 96, 5), ("wide", 2048, 64),
                 ("edge", 2000, 129), ("cdk", 2 * CDK_B, CDK_L + 1)]
KERNEL_RTOL = 1e-5   # of the plain version on |inputs|: f32 rounding scale
LOSS_RTOL = 1e-5     # kernel vs plain loss on one batch
GRAD_RTOL, GRAD_ATOL = 1e-4, 1e-6  # atol in units of the largest entry
OPERATOR_RTOL = 1e-4  # GPU vs CPU Tf, fs: f32 second derivatives

# H100 SXM peaks (NVIDIA data sheet, at a 700 W power limit)
HBM_BYTES_PER_S = 3.35e12
F32_FLOP_PER_S = 67e12

KERNEL_SOURCE = "neuralsvd_tpu_torch/csrc/gram_kernels.cu"
# the kernels of csrc/gram_kernels.cu, as ptxas names them (mangled)
CUDA_KERNELS = ("masked_gram_syrk_kernel", "masked_gram_finish_kernel",
                "weighted_dot_partial_kernel", "sum_partials_kernel",
                "metric_grads_kernel")
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


def ptxas_report(log_lines):
    """Registers, shared memory and spills of each kernel entry in nvcc's
    -Xptxas -v output; a template's copy width is kept as <1> or <4>."""
    report, current = [], None
    for ln in log_lines:
        if "Compiling entry function" in ln:
            mangled = ln.split("'")[1]
            short = next((k for k in CUDA_KERNELS if k in mangled), mangled)
            for vec in ("1", "4"):
                if f"ILi{vec}E" in mangled:
                    short += f"<{vec}>"
            current = {"kernel": short}
            report.append(current)
        elif current is not None and "spill stores" in ln:
            words = ln.replace(",", " ").split()
            current["spill_stores"] = int(words[words.index("spill") - 2])
            current["spill_loads"] = int(words[-4])
        elif current is not None and "Used" in ln and "registers" in ln:
            words = ln.replace(",", " ").split()
            current["registers"] = int(words[words.index("registers") - 1])
            current["smem_bytes"] = (int(words[words.index("smem") - 2])
                                     if "smem" in words else 0)
    return report


def phase_build():
    shutil.rmtree(cuda_build.BUILD_DIR, ignore_errors=True)
    t0 = time.perf_counter()
    lib = cuda_build.build()
    seconds = time.perf_counter() - t0
    cuda_build.load_library()
    log = lib.with_name(lib.name + ".log").read_text().splitlines()
    report = ptxas_report(log)
    for name in CUDA_KERNELS:
        check(any(r["kernel"].startswith(name) for r in report),
              f"ptxas reported no entry for {name}")
    spills = [r for r in report if r.get("spill_stores") or r.get("spill_loads")]
    check(not spills, f"kernels spill registers: {spills}")
    emit("build", seconds=round(seconds, 3), library=lib.name, nvcc_calls=1,
         ptxas=report)


def _kernel_inputs(label, B, L, gen):
    dev = DEVICE
    f = torch.randn(B, L, generator=gen, device=dev)
    Tf = torch.randn(B, L, generator=gen, device=dev)
    if label in ("E4", "edge"):
        vmask, mmask = sequential_nesting_masks(L)
    elif label == "cdk":
        vmask, mmask = joint_nesting_masks(step_weights(L - 1), set_first_mode_const=True)
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
        f, Tf, f1, f2, vmask, mmask = _kernel_inputs(label, B, L, gen)
        Bh = B // 2
        # K2's operands: (f, Tf) on the EVD path, the pair (f, g) on the CDK path
        dot_a, dot_b = (f1, f2) if label == "cdk" else (f, Tf)
        Bd = dot_a.shape[0]
        s = 2.0 / Bh
        mlam1 = mmask * torch.einsum("bl,bm->lm", f1, f1) / Bh
        mlam2 = mmask * torch.einsum("bl,bm->lm", f2, f2) / Bh
        cases = {
            "masked_gram_pair": dict(
                run=lambda: cuda_gram.masked_gram_pair(f1, f2, mmask),
                plain=lambda: cuda_gram.masked_gram_pair_ref(f1, f2, mmask),
                scale=lambda: cuda_gram.masked_gram_pair_ref(f1.abs(), f2.abs(), mmask),
                library=None,
                # reads f1, f2, M; writes the loss, Λ1, Λ2, M⊙Λ1, M⊙Λ2
                nbytes=4 * (2 * Bh * L + L * L + 1 + 4 * L * L),
                # Λ1, Λ2 are symmetric: each gram needs only its L(L+1)/2
                # distinct entries (a SYRK), 2·Bh flops each
                flops=2 * Bh * L * (L + 1) + 3 * L * L),
            "weighted_dot": dict(
                run=lambda: cuda_gram.weighted_dot(dot_a, dot_b, vmask),
                plain=lambda: cuda_gram.weighted_dot_ref(dot_a, dot_b, vmask),
                scale=lambda: cuda_gram.weighted_dot_ref(dot_a.abs(), dot_b.abs(), vmask),
                library=lambda: torch.einsum("l,bl,bl->", vmask, dot_a, dot_b),
                nbytes=4 * (2 * Bd * L + L + 1),
                flops=3 * Bd * L),
            "metric_grads": dict(
                run=lambda: cuda_gram.metric_grads(f1, f2, mlam1, mlam2, s, s),
                plain=lambda: cuda_gram.metric_grads_ref(f1, f2, mlam1, mlam2, s, s),
                scale=lambda: cuda_gram.metric_grads_ref(
                    f1.abs(), f2.abs(), mlam1.abs(), mlam2.abs(), s, s),
                library=None,
                # reads f1, f2, M⊙Λ1, M⊙Λ2; writes g1, g2
                nbytes=4 * (2 * Bh * L + 2 * L * L + 2 * Bh * L),
                flops=2 * 2 * Bh * L * L + 2 * Bh * L),
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


def _cdk_data():
    """Synthetic class-correlated 512-d features, made in bulk from SEED
    (the recipe of tests/test_cdk_retrieval.py:63-77): per-class centres
    plus unit noise, CDK_CLASSES balanced classes."""
    rng = np.random.default_rng(SEED)
    centers_x = 3 * rng.standard_normal((CDK_CLASSES, CDK_DIM), dtype=np.float32)
    centers_y = 3 * rng.standard_normal((CDK_CLASSES, CDK_DIM), dtype=np.float32)

    def split(n, seed):
        cls = np.arange(n) % CDK_CLASSES
        x = centers_x[cls] + rng.standard_normal((n, CDK_DIM), dtype=np.float32)
        y = centers_y[cls] + rng.standard_normal((n, CDK_DIM), dtype=np.float32)
        return ArrayPairLoader(x, y, cls, batch_size=CDK_B, seed=seed)

    return (split(CDK_STEPS * CDK_B, SEED), split(CDK_EVAL, SEED + 1),
            split(CDK_EVAL, SEED + 2))


def _cdk_args(log_dir):
    return get_args(CDK_ARGV + ["--num_epochs", str(CDK_EPOCHS),
                                "--log_dir", log_dir, "--device", DEVICE])


def phase_cdk_loss(train):
    """Kernel packaging vs plain CDK loss on the towers' outputs for one
    full-width batch; the towers on the GPU vs a CPU copy."""
    tr = make_trainer(_cdk_args(""), CDK_DIM, CDK_STEPS)
    x, y, _ = next(iter(train))
    x = torch.as_tensor(x, device=DEVICE)
    y = torch.as_tensor(y, device=DEVICE)
    with torch.no_grad():
        fx, gy = tr.model(x, y)
    check(fx.shape == (CDK_B, CDK_L) and torch.isfinite(fx).all().item(), "tower output")
    vmask, mmask = tr.method.masks(DEVICE)
    gen = torch.Generator(device=DEVICE).manual_seed(SEED)
    results = {}
    for label, bw in (("no_weights", None),
                      ("weights", torch.rand(CDK_B, 1, generator=gen, device=DEVICE) + 0.5)):
        outs, grads = [], []
        for fn in (nestedlora_cdk_loss_kernels, nestedlora_cdk_loss):
            a, b = fx.clone().requires_grad_(), gy.clone().requires_grad_()
            out = fn(True, a, b, vmask, mmask, bw, return_ratios=True)
            grads.append(dict(zip("fg", torch.autograd.grad(out[0], [a, b]))))
            outs.append(out)
        rel = {}
        for name, got, want in zip(("loss", "loss_operator", "loss_metric"),
                                   outs[0], outs[1]):
            rel[name] = abs(got.item() - want.item()) / abs(want.item())
            check(rel[name] <= LOSS_RTOL, f"cdk {label} {name}: rel {rel[name]:.3g}")
        for name, got, want in zip(("rs_joint", "rs_indep"), outs[0][3:], outs[1][3:]):
            check(got.shape == want.shape, f"cdk {label} {name} shape")
            rel[name] = ((got - want).abs().max() / want.abs().max()).item()
            check(rel[name] <= LOSS_RTOL, f"cdk {label} {name}: rel {rel[name]:.3g}")
        rel["grad_tol_used"] = _check_grads(grads[0], grads[1])
        results[label] = rel
    # the towers on the GPU vs a CPU copy of the same parameters, 64 rows
    cpu_model = copy.deepcopy(tr.model).cpu()
    with torch.no_grad():
        ref = cpu_model(x[:64].cpu(), y[:64].cpu())
    tower_rel = max(((a[:64].cpu() - r).abs().max() / r.abs().max()).item()
                    for a, r in zip((fx, gy), ref))
    check(tower_rel <= CDK_TOWER_RTOL, f"GPU vs CPU towers: rel {tower_rel:.3g}")
    emit("cdk_loss", B=CDK_B, L=CDK_L, columns=CDK_L + 1, loss=outs[1][0].item(),
         kernel_vs_plain=results, gpu_vs_cpu_towers_rel=tower_rel)


def _csv_rows(log_dir):
    rows = []
    for name in sorted(os.listdir(log_dir)):
        if name.endswith(".csv"):
            with open(os.path.join(log_dir, name)) as fh:
                rows.extend(csv.DictReader(fh))
    return rows


def phase_cdk_train(train, test, valid):
    """The CDK trainer through its normal arguments, then the step's rate."""
    with tempfile.TemporaryDirectory() as log_dir:
        args = _cdk_args(log_dir)
        torch.cuda.reset_peak_memory_stats()
        cuda_gram.reset_launch_counts()
        timings = {}
        t0 = time.perf_counter()
        _, trunc = run_training(args, train, test, valid, input_dim=CDK_DIM,
                                timings=timings)
        torch.cuda.synchronize()
        run_s = time.perf_counter() - t0
        counts = cuda_gram.launch_counts()
        run_peak_gib = torch.cuda.max_memory_allocated() / 2 ** 30
        rows = _csv_rows(log_dir)
        stats = np.load(os.path.join(log_dir, "best_stats.npz"))
        spectrum = stats["spectrum"]
    steps = CDK_EPOCHS * train.max_steps
    check(len(rows) == CDK_EPOCHS, f"{len(rows)} log rows")
    check(all(np.isfinite(float(r["loss"])) for r in rows), "non-finite CDK loss")
    check(int(rows[-1]["skips"]) == 0, f"{rows[-1]['skips']} skipped CDK steps")
    check(all(n == steps for n in counts.values()),
          f"CDK launch counts {counts} != {steps} each")
    check(spectrum.shape == (CDK_L + 1,) and np.isfinite(spectrum).all(), "spectrum")
    check(set(trunc) == set(args.trunc_dims), f"truncation sweep {sorted(trunc)}")
    # the driver's steps, loader and host-to-device copies included; the
    # last epoch, past the first steps' warm-up
    driver_steps_per_s = train.max_steps / timings["steps"][-1]

    # steps/s of the train step alone, on device-resident batches
    tr = make_trainer(_cdk_args(""), CDK_DIM, CDK_STEPS)
    batches = [tuple(torch.as_tensor(a, device=DEVICE) for a in b[:2])
               for _, b in zip(range(4), train)]
    params, opt_state = tr.params, tr.opt_state
    skips = torch.zeros((), dtype=torch.int32, device=DEVICE)
    torch.cuda.reset_peak_memory_stats()
    losses = []
    for i in range(CDK_WARMUP + CDK_TIMED):
        if i == CDK_WARMUP:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
        x, y = batches[i % len(batches)]
        params, opt_state, _, loss, _, skips = tr.step(params, opt_state, {}, x, y, skips)
        losses.append(loss)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    check(torch.isfinite(torch.stack(losses)).all().item() and int(skips) == 0,
          "timed CDK steps")
    emit("cdk_train", B=CDK_B, L=CDK_L, dims=[CDK_DIM] + parse_dims(args.network_dims),
         classes=CDK_CLASSES,
         epochs=CDK_EPOCHS, steps=steps, launches=counts, run_s=run_s,
         run_parts_s=timings, run_other_s=run_s - sum(map(sum, timings.values())),
         driver_steps_per_s=driver_steps_per_s, run_peak_mem_gib=run_peak_gib,
         per_epoch=[{k: float(v) for k, v in r.items()} for r in rows],
         trunc=trunc, spectrum_head=spectrum[:8].tolist(),
         timed_steps=CDK_TIMED, steps_per_s=CDK_TIMED / seconds,
         ms_per_step=seconds / CDK_TIMED * 1e3,
         step_peak_mem_gib=torch.cuda.max_memory_allocated() / 2 ** 30)
    return counts


def main():
    # full f32 products: TF32 keeps ~3 digits and would break the tolerances
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    name, smi = phase_device()
    phase_build()
    rows = phase_kernels()
    counts = {"e4": phase_trainer()}
    train, test, valid = _cdk_data()
    phase_cdk_loss(train)
    counts["cdk"] = phase_cdk_train(train, test, valid)
    kernels = []
    for kname, results in rows.items():
        at = {r["shape"]: r for r in results}
        paths = {path: {"launches": counts[path][kname],
                        **{k: at[shape][k] for k in ("B", "L", "max_abs_err", "ms",
                                                      "plain_ms", "bound_ms",
                                                      "bound_by", "library_ms")}}
                 for path, shape in (("e4", "E4"), ("cdk", "cdk"))}
        cdk = paths["cdk"]
        kernels.append({
            "name": kname, "route": "cuda", "source": KERNEL_SOURCE,
            "replaces": REPLACES[kname],
            "launches": sum(p["launches"] for p in paths.values()),
            "max_abs_err": cdk["max_abs_err"], "ms": cdk["ms"],
            "plain_ms": cdk["plain_ms"], "bound_ms": cdk["bound_ms"],
            "bound_by": cdk["bound_by"], "library_ms": cdk["library_ms"],
            "paths": paths})
    print(json.dumps({"kernels": kernels}), flush=True)
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": name,
                                             "count": torch.cuda.device_count()}}),
          flush=True)


if __name__ == "__main__":
    main()
