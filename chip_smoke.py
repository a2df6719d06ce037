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
3. kernels    each kernel against its plain PyTorch version at ten shapes
              (E4, two odd ones, 1000 x 129 halves one column past K1's
              64-wide tiles, the CDK path's 4096 x 513 pair, the two PDE
              recipes' 512 x 36 and 512 x 55, the Fokker–Planck
              recipe's 512 x 7, and the kernel-operator path's 4096 x 16
              and its split batch, (f1, f2) and (f1, Kf1) of 2048 x 16),
              and CUDA-event timings of kernel, plain version and library
              call; and the EVD packaging of the three (forward and
              backward) against the plain EVD loss at the E4, recipe,
              Fokker–Planck and kernel-path shapes, timed beside the sum of
              its kernels' bounds;
4. trainer    the hydrogen-2D E4 configuration at full width (L = 16,
              B = 512, per-mode 128³ softplus towers, 1024 Fourier maps +
              radial + 4 envelopes, gaussian_mixture sampling with √w
              conjugation, the exact Laplacian by the forward-Laplacian
              engine (the JAX default, laplacian_mode="forward"),
              operator_scale 100, sequential nesting, RMSprop, EMA): kernel
              vs plain loss on one batch, forward vs nested-JVP Laplacian,
              gradient and fs on that batch, a GPU-vs-CPU check of the
              operator on a small batch, TRAIN_STEPS steps through the
              kernels with their launch counts and the engine's fallback
              count (0), steps/s, the EMA model's 16 Rayleigh eigenvalues,
              and steps/s of the same number of steps on the nested-JVP
              Laplacian;
5. hutchinson the Hutchinson Laplacian (Rademacher probes through the same
              engine) at that width: the mean of HUTCH_DRAWS estimates
              against the exact Laplacian on one batch, within HUTCH_Z
              standard errors at every entry, and HUTCH_STEPS train steps
              with laplacian_probes=2, every loss finite;
6. cdk_loss   the CDK loss at the paper's width (B 4096, L 512 + the
              constant mode) on the towers' outputs: kernel packaging vs
              plain loss, with and without batch weights, ratios included,
              and the CUDA-event ms of each one's forward + backward;
              the towers on the GPU vs a CPU copy on a small batch;
7. pde_cli    the PDE entry point (neuralsvd_tpu_torch.cli.pde.main) on the
              E4 flags (PDE_E4_ARGV) for PDE_ITERS steps in graph blocks of
              PDE_BLOCK with an eval every PDE_EVAL: every loss finite, no
              skipped step, the checkpoints, CSV, stats.npz and health
              report there; the kernels' launches measured in that run:
              the wrappers count the eager ones (the warm-up before the
              capture) and the trace of the CLI's own --profile window
              over one of its graph blocks counts the replayed ones, one
              launch of each kernel a step, replay by replay (the tracer
              loses a record now and then: _replay_launches); then --resume to PDE_RESUME_ITERS from the last
              checkpoint; one block replayed as a graph against the same
              block as eager steps from the same state and seed; one
              replayed block under the profiler (device busy share,
              kernels a step, one K1, K2 and K3 launch a step); the README
              quick start's model (shared trunk, box mask, finite
              differences) for PDE_DEFAULT_ITERS steps and one eval, its
              launches measured in the same way; and steps/s of E4 CLI
              runs as eager steps and as graph blocks (cli.pde.main's
              use_graph), in turns (eager, graph, graph, eager);
8. pde_recipes the paper's two PDE recipes (scripts/exps/pde/hydrogen.sh
              and oscillator.sh, --loss neuralsvd) through the PDE entry
              point at full width in graph blocks of RECIPE_BLOCK: hydrogen
              (L 36, the mode rescue) runs to a checkpoint at an eval, has
              one mode made a copy of another there (params, EMA, moments)
              and resumes; its next eval must flag the copy, rescue it in
              place (one capture in the resumed run, the tail's EMA equal
              to its params, each rescued slot off its clone source) and
              the blocks after it stay finite with no skipped step;
              oscillator (L 55, the learnable exponential mask) trains with
              one eval, its mask scales move off 10, and the forward
              -Laplacian engine takes the exp-masked model with no
              fallback call and agrees with nested JVPs.  For both: kernel
              vs plain loss and grads on one batch, each kernel's launches
              measured as in pde_cli (one a step), steps/s of a graph block;
9. pde_methods NeuralEF on hydrogen.sh (its args=( ... ) list with --loss
              neuralef: L 36, finite differences, the batch-L2 norm and
              its EMAs) and the repo's 2D Fokker–Planck recipe
              (scripts/validate_fokker_planck.py: --problem fp, L 7,
              64³ towers, the forward engine with return_grad, shift 4,
              sequential NestedLoRA, Adam) through the PDE entry point in
              graph blocks of RECIPE_BLOCK with one eval each: every loss
              finite, no skipped step; NeuralEF: no gram kernel launched,
              the norm EMA off its ones, one block as a graph against the
              same block as eager steps, and the loss and grads on the card
              against a CPU copy on a small batch (float64, rtol 1e-4);
              Fokker–Planck: one launch of each kernel a step (measured as
              in pde_cli), kernel vs plain loss and grads at the initial
              parameters, no fallback-rule call; both runs' graph-block
              steps/s and eval seconds; Nyström (an RBF kernel on 2000
              points of the FP domain, numpy samples and no device) runs
              on the card and equals the CPU run;
10. pde_spin  SpIN and SpINx on hydrogen.sh (its args=( ... ) list with
              --loss spin, then spinx: L 36, 10.67M parameters, B 512,
              finite differences at eps 0.01, --rescue true, --spin.decay
              0.01) through the PDE entry point in graph blocks of
              RECIPE_BLOCK with two evals, the first inside the rescue's
              window: every loss finite, no skipped step, no gram kernel
              launched, one capture; SpIN's compact j_avg of 36·P·4 bytes
              and the peak device memory; SpINx's weights refreshed off
              their ones; each checkpoint's bytes and write seconds; one
              block as a graph against the same block as eager steps; one
              loss_and_grad on the card against a CPU copy (float64, 64
              rows: loss, grads and the new state); SpIN's compact j_avg
              against the dense one on the card at hydrogen.sh's widths
              with L 4; and where a SpIN step's time goes (the device time
              of its three profiler ranges over eager steps, and the busy
              share of a replayed block);
11. cdk_train the Sketchy CDK trainer (cli/sketchy.py::run_training) at the
              paper's width (512-8192-512 lrelu0.2 towers, L 512, B 4096,
              SGD momentum 0.9, lr 5e-3 warmup-cosine, grad clip 1.0, joint
              nesting) on synthetic class-correlated 512-d features, two
              epochs of CDK_STEPS steps, with retrieval, spectrum and the
              truncation sweep; every loss finite, no skipped step, one
              launch of each kernel per step; the run's seconds by part
              (steps with loader and copies, eval, checkpoint, ratios,
              spectrum, truncation sweep); then steps/s of the train step
              alone on device-resident batches and its peak device memory;
12. pde_tiers the PDE entry point on the E4 flags with --matmul_precision
              highest, high (3xTF32), default (one TF32 pass) and
              highest@1,high, one run each in graph blocks of RECIPE_BLOCK:
              every loss finite, no skipped step, one launch of each kernel
              a step (measured as in pde_cli), no fallback-rule call, the
              float32 matmul precision "highest" before and after each run,
              the tower outputs against a float64 copy on TIER_ROWS rows
              (per head and tail for the split), the plain EVD loss on fixed
              float32 inputs computed in hooks inside a tiered
              loss_and_grad equal bit for bit to the same loss outside;
              graph-block steps/s in turns; and the E4 towers in bf16
              (compute_dtype) on the card against a CPU copy, with their
              forward-engine Laplacian finite;
13. pde_spin_exact  SpIN and SpINx on the E4 flags with the exact
              Laplacian's forward engine in grad mode (--loss spin|spinx,
              --laplacian_eps -1 --laplacian_mode forward, full width),
              SPIN_EXACT_ITERS steps each in graph blocks of RECIPE_BLOCK
              with one eval, then SpIN on SPIN_HUTCH_PROBES Hutchinson
              probes for SPIN_HUTCH_ITERS: every loss finite, no skipped
              step, one capture, no fallback-rule call, no gram kernel
              launched, one block as a graph against the same block as
              eager steps, one loss_and_grad on the card against a CPU
              copy (float64, 64 rows); steps/s, peak device memory and
              j_avg bytes (16·P·4); and the checkpoint API on SpIN's state:
              save_resumable after a block, load_resumable into a fresh
              template on the card, the next block bit for bit with the
              straight run, and load_pretrained of the run's ckpt EMA
              parameters into a fresh model whose eval outputs equal the
              run's (bytes and seconds of each);
14. kernel_evd the kernel-operator EVD path: an RBF kernel on 2D
              standard-normal samples at B KEVD_B, L KEVD_L, per-mode 128³
              towers and the weight-normalized bias-free shared trunk 128³:
              NestedLoRA's loss_and_grad_kernel with and without
              split_batch through K1-K3 (one launch each a call) against
              the plain path; NeuralEF, SpIN and SpINx on the card against
              a CPU copy (float64); then train_operator on a fixed
              KEVD_B-landmark KernelOperator for KEVD_ITERS steps in graph
              blocks with one eval: losses finite, no skipped step,
              eigenvalues positive (the kernel is PSD), one capture, the
              kernels' launches measured as in pde_cli, steps/s;
15. cdk_bf16  the Sketchy script as written (CDK_ARGV plus --compute_dtype
              bf16) through run_training: every loss finite, no skipped
              step, one launch of each kernel a step, float32 master
              weights, P@100 and mAP beside the f32 run's; the card's bf16
              tower products against float64 products of the same bf16
              operands on BF16_ROWS rows (cuBLAS's bf16 reduced-precision
              reduction on and off, each timed); the bare train step at
              f32, TF32 (the switch set around the f32 step: a measurement
              only) and bf16 in turns on the same batches; and a few
              profiled steps of each (device ms, busy share, device ms by
              group: GEMMs, gram kernels, the rest; costliest kernels).
16. sketchy_cli the Sketchy CLI's own entry point (cli/sketchy.py::main)
              on feature files at Sketchy Extended scale: (a) VGG16 (random
              weights, both towers on the card) through
              extract_features_main on made-up 224² images of 125
              classes, split 1_0: the card against a CPU copy (TF32 off),
              images/s, the npz files read back by the loader; (b)
              scripts/exps/sketchy.sh's list as written (SKETCHY_ARGV: two
              epochs, --neuralsvd.sequential dropped) on ~75.5k sketches and
              ~73k photos of 512-d features made up from SEED and written
              with write_feature_files (90/10/25 classes, ~54k train
              sketches, 14 steps an epoch), pairs from the native sampler:
              every loss finite, no skipped step, one launch of each kernel
              a step, the CSV, best, ckpt and retrieval files, test P@100
              beside chance; the run's seconds by part; the loader's host
              ms a batch, native against use_native=False in turns (the
              native pair draw at least 5x faster); the test retrieval in
              parts (top_k_retrievals, its device work and index copy, the
              numpy metrics) at K 100 and the whole gallery; (c) on the
              trained towers: the online heads card vs CPU with a zero
              tower gradient, kNN (k 200, T 0.1) against a train-photo
              and a test-photo bank, the multi-head probe (20 SGD steps,
              towers unchanged); (d) ResNet-18 (224², batch 64), CIFAR
              ResNet-20 and WRN-28-2 (32², batch 128) and SiamNetwork
              (512-8192-512, plain, separation, batch_l2norm; batch 4096)
              card vs CPU, then 5 SGD steps each: images or rows a second.
17. dp        data parallelism (--mesh dp, parallel/sharding.py): (a) the
              E4 flags on the plain loss through cli.pde.main on a
              one-rank NCCL group, DP_ITERS steps in graph blocks of
              DP_BLOCK with one eval (on one rank NCCL reduces in place
              and the graph holds no collective), no gram
              kernel launched, against the same flags without --mesh
              (bit for bit expected) and against itself as eager steps;
              the NCCL events and kernels a step of a traced block;
              graph-block steps/s in turns: dp on the plain loss, no mesh
              on the plain loss, no mesh on K1-K3; (b) the Sketchy script
              (one epoch, on sketchy_cli's feature files) with --mesh dp
              against the run without it on --use_pallas false; (c)
              SpIN at hydrogen.sh's flags with --mesh dp against no mesh
              in turns: steps/s and peak device memory (the flat mean of
              the 1.54 GB j_avg a step), the states held to each other;
              (d) two
              gloo ranks on the one card (spawned processes, CUDA
              tensors, the group through make_mesh's torchrun path with
              backend gloo, which refuses a CUDA graph): one eager E4 step
              at dp=2 against the single-process step on the
              half-consistent union batch and one paper-width float32
              CDK step against the single-process step on the same pairs,
              both with SGD and no grad clip, so the gradient's scale
              shows.
18. tp        tensor parallelism (--mesh tp=2, parallel/sharding.py) on two
              gloo ranks on the one card (spawned, CUDA tensors; eager
              steps, as gloo refuses a CUDA graph): (a) the E4 flags on SGD
              through cli.pde.main, TP_E4_ITERS steps with one eval and a
              checkpoint, each rank holding 8 of the 16 modes and gathering
              f and Tf before the loss, against the same run without a mesh
              (every parameter leaf at rtol 2e-4, atol 2e-5, the ranks bit
              for bit alike), the checkpoint loaded into a one-process
              TrainState; one step on Adam and on RMSprop (TP_E4_RUNS),
              their optimizer states (the gradient's moments) at that
              tolerance with atol scaled by each leaf's largest entry, and
              each parameter outside it one whose gradient is under
              TP_FLIP_GRAD of its leaf's largest (a sign-like first update
              follows the rounding there); (b) the paper-width f32 CDK
              step (512-8192-512 towers, L 512 + the constant, B 4096, 256 mode columns a
              rank), TP_CDK_STEPS steps against the one-process step at the
              same tolerance; both on K1-K3 on the gathered modes, one
              launch of each a step on each rank; (c) SpIN and SpINx at
              hydrogen.sh's width (L 36, 2055 features, B 512, FD at eps
              0.01) on SGD with a clip, TP_SPIN_ITERS eager steps and one
              eval with its checkpoint, each rank holding 18 of the 36 slots
              of j_avg, against one process: parameters, the gathered
              j_avg, sigma_avg and chol, the ranks bit for bit, each rank's
              j_avg bytes and peak memory, the tp checkpoint loaded in one
              process bit for bit, SpINx's refresh from it against the tp
              run's weights; no K1-K3 launch;
19. export    the serving export (utils/export.py): the E4 wavefunction
              (f32, and the `high` tier, its products tiered_einsum ops)
              and the paper-width CDK x tower (f32, bf16) saved to .pt2
              files, reloaded and evaluated at 3 and 4096 rows against the
              eager modules; the exported and eager calls' ms;
20. dryrun    graft_entry.entry() (the flagship L 36 model on the card) and
              graft_entry.dryrun_multichip(4) (a dp x tp PDE step and a dp
              CDK step on four gloo CPU ranks, in its subprocess).
21. validate  the accuracy entry points (neuralsvd_tpu_torch/scripts/):
              validate_northstar.main at the E4 recipe (its defaults,
              lap_eps -1) for NS_ITERS steps in chunks of NS_CHUNK with
              partial rows every NS_EVAL_EVERY and the full 64-round raw
              and EMA evals (its JSON lines printed): every loss finite,
              no skipped step, one launch of each of K1-K3 a step (the
              wrappers' eager launches of the capture's warm-up and the
              replayed ones in the trace of the chunk at NS_TRACED); the
              eval's sums of the trained EMA parameters on the card
              against a float64 CPU copy on the same draws; a run stopped
              at its first partial row and resumed through NS_CKPT, bit
              for bit with the straight run; the L 36 flagship's levers
              (42 modes, 6 guards, tail LR 3x, the clone rescue, the
              weighted 5-scale mixture) with a forced duplicate in the
              checkpoint that the resumed run's first rescue exiles;
              validate_methods' four methods and validate_fokker_planck's
              1D and 2D runs with their FD spectra, each cut to a few
              thousand steps.  Every path that trains NestedLoRA (the
              north star, the levers' resumed run, validate_methods'
              NestedLoRA, the FP runs) launches each of K1-K3 once a
              step: the wrappers count each capture's warm-up, and one
              replayed block of each path is traced.
22. plots     the figures, drawn by the port without matplotlib (none may be
              imported): the hydrogen figure tool
              (scripts/plot_hydrogen_modes.py) on the north star's NS_CKPT
              checkpoint that phase validate trained through K1-K3 and
              resumed (its model and operator on the card, 16 eval rounds
              of 8192 draws, a 192² grid): the 1200 x 1200 PNG, decoded,
              equal to a re-render of the same figure, and the colour of
              each panel at its centre (where |ψ| >= PSI_SIGN_MIN) and at
              its pixel of largest |ψ| of the sign of ψ there (blue
              positive, red negative); the eval's and the drawing's
              seconds and the PNG encoding's alone; plot_1d_eigfuncs at 4096 points x 16
              modes; and the PNGs the earlier phases' CLI runs wrote beside
              their .npz files (pde_recipes: hydrogen.sh's 36-panel
              1800 x 1800 grid on its 1000² validation grid and its
              spectrum; sketchy_cli: each epoch's ratio histogram, 16.7M
              off-diagonal entries, and the final spectrum with both
              towers' orthogonality), each one's size, bytes and seconds.

Then the {"kernels": [...]} line (numbers at the CDK shape, launches of
the main paths that run K1-K3 (e4 trainer, pde_cli, hydrogen,
oscillator, fp, cdk, pde_tiers, cdk_bf16, kernel_evd, sketchy_cli,
northstar, northstar_levers, methods, fp_validate, and
tp_e4 and tp_cdk, summed over phase tp's two ranks; the dp path takes the
plain losses and launches none, nor do tp_spin and tp_spinx; the
CLI paths' are the eager launches counted by the wrappers plus the
replayed launches counted in the traced block, each also under "paths"),
per-path numbers under "paths", every shape's under "shapes"), the
nvidia-smi line and,
last, {"ok": true, "device": {...}}.  Any failed check raises: the exit
code is then non-zero and the last line is never printed.  Without a GPU it
raises before printing anything.
"""
import contextlib
import copy
import csv
import io
import json
import logging
import os
import shutil
import statistics
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

from neuralsvd_tpu_torch import graft_entry
from neuralsvd_tpu_torch.cli import pde
from neuralsvd_tpu_torch.cli import sketchy
from neuralsvd_tpu_torch.cli.sketchy import get_args, make_trainer, run_training
from neuralsvd_tpu_torch.data.samplers import get_sampler, make_val_grid
from neuralsvd_tpu_torch.data.sketchy import (
    ArrayPairLoader,
    SketchyVGGDataLoader,
    extract_features_main,
    invert_image,
    load_sketchy_features,
    make_vgg_feature_extractor,
    split_classes,
    write_feature_files,
)
from neuralsvd_tpu_torch.eval.knn import knn_monitor, knn_predict
from neuralsvd_tpu_torch.eval.retrieval import average_precisions, precision_at_k, top_k_retrievals
from neuralsvd_tpu_torch.methods.nestedlora import NestedLoRA
from neuralsvd_tpu_torch.methods.nystrom import Nystrom, run_nystrom
from neuralsvd_tpu_torch.methods.spin import PROFILE_RANGES as SPIN_PARTS
from neuralsvd_tpu_torch.methods.spin import SpIN
from neuralsvd_tpu_torch.methods.spectrum import compute_spectrum_evd
from neuralsvd_tpu_torch.models.mlp import make_mlp_eigfuncs, parse_dims, tower_product
from neuralsvd_tpu_torch.models.probe import make_multihead_probe, register_spectrum
from neuralsvd_tpu_torch.models.resnet import make_cifar_resnet, make_resnet, make_wide_resnet
from neuralsvd_tpu_torch.models.two_tower import HeteroNetwork, SiamNetwork
from neuralsvd_tpu_torch.models.wavefunctions import make_wavefunctions
from neuralsvd_tpu_torch.operators.base import KernelOperator
from neuralsvd_tpu_torch.operators.diff_ops import VectorizedLaplacian
from neuralsvd_tpu_torch.operators.problems import get_problem
from neuralsvd_tpu_torch.ops import cuda_build, cuda_gram, forward_laplacian
from neuralsvd_tpu_torch.ops.cuda_gram import (
    nestedlora_cdk_loss_kernels,
    nestedlora_evd_loss_kernels,
)
from neuralsvd_tpu_torch.ops.masks import (
    joint_nesting_masks,
    sequential_nesting_masks,
    step_weights,
)
from neuralsvd_tpu_torch.ops.nestedlora import nestedlora_cdk_loss, nestedlora_evd_loss
from neuralsvd_tpu_torch.scripts import plot_hydrogen_modes, rayleigh
from neuralsvd_tpu_torch.scripts import validate_fokker_planck as vf
from neuralsvd_tpu_torch.scripts import validate_methods as vm
from neuralsvd_tpu_torch.scripts import validate_northstar as vn
from neuralsvd_tpu_torch.training.checkpoint import (
    load_checkpoint,
    load_pretrained,
    load_resumable,
    save_checkpoint,
    save_resumable,
)
from neuralsvd_tpu_torch.training.optimizers import (
    build_optimizer,
    cosine_annealing,
    torch_rmsprop,
)
from neuralsvd_tpu_torch.training.rescue import named_leaves
from neuralsvd_tpu_torch.training.train_operator import (
    GRAPH_WARMUP_STEPS,
    PROFILE_MARGIN_S,
    REFRESH_STREAM,
    ScannedTrainStep,
    block_seed,
    make_scanned_train_step,
    make_train_step,
    train_operator,
)
from neuralsvd_tpu_torch.training.train_state import (
    clone_tree,
    init_train_state,
    load_state_tree,
    state_tree,
)
from neuralsvd_tpu_torch.utils import export, plotting, raster
from neuralsvd_tpu_torch.utils.config import parse_pde_config, run_name
from neuralsvd_tpu_torch.utils.meters import accuracy

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

# the PDE CLI: the E4 flags (bench.py:33-92, scripts/validate_northstar.py),
# of which only the number of steps is cut (800k in the E4 recipe)
PDE_E4_ARGV = ("--potential_type hydrogen --ndim 2 --neigs 16 --parallel true "
               "--apply_boundary false --laplacian_eps -1 --operator_scale 100 "
               "--use_fourier_feature true --fourier_mapping_size 1024 "
               "--fourier_scale 0.1 --fourier_append_radial true "
               "--fourier_append_envelopes 2,0.6667,0.4,0.2857 "
               "--sampling_mode gaussian_mixture --sampling_scales 0.5,2,6,16 "
               "--batch_size 512 --optimizer rmsprop --lr 1e-4 --use_lr_scheduler true "
               "--ema_decay 0.995 --neuralsvd.sequential true --seed 0").split()
PDE_ITERS, PDE_BLOCK, PDE_EVAL, PDE_RESUME_ITERS = 2000, 500, 1000, 3000
# the README quick start (README.md:164-172), cut to PDE_DEFAULT_ITERS steps
PDE_README_ARGV = ("--potential_type hydrogen --ndim 2 --neigs 16 --lim 32 "
                   "--operator_scale 100 --laplacian_eps 0.1 --use_fourier_feature true "
                   "--fourier_mapping_size 256 --fourier_scale 0.1 "
                   "--mlp_hidden_dims 128,128,128 --nonlinearity softplus "
                   "--sampling_mode gaussian --sampling_scale 16 --batch_size 512 "
                   "--optimizer rmsprop --lr 1e-4 --seed 0").split()
PDE_DEFAULT_ITERS, PDE_DEFAULT_BLOCK = 500, 250
PDE_TURN_ITERS = 2 * PDE_BLOCK  # steps of each timed CLI run, no eval
# the CLI's --profile window: one graph block of each run (E4: steps
# 1000-1500 of 2000; README model: 250-500 of 500), traced to count the
# replayed launches (a trace of a whole run would overflow the profiler's
# device buffers: ~500 kernels a step)
PDE_E4_TRACED = (PDE_EVAL, PDE_BLOCK)
PDE_DEFAULT_TRACED = (PDE_DEFAULT_BLOCK, PDE_DEFAULT_BLOCK)
PDE_PROFILE_STEPS = 50  # the profiled replayed block
# graph block vs eager steps from one state: rtol, atol of the largest entry
PDE_STATE_RTOL, PDE_STATE_ATOL = 1e-5, 1e-6

# the paper's two PDE recipes: the args=( ... ) lists of
# scripts/exps/pde/hydrogen.sh and oscillator.sh with the scripts' defaults
# (batch 512, joint nesting) and --loss neuralsvd; only --num_iters,
# --eval_freq, --print_freq, --overwrite and --log_dir are set here (and
# --resume and --profile for the runs that need them)
HYDROGEN_ARGV = ("--optimizer rmsprop --use_lr_scheduler true --ema_decay 0.995 "
                 "--batch_size 512 --lr 1e-4 --momentum 0. --num_iters 500000 "
                 "--laplacian_eps 0.01 --eval_freq 10000 --overwrite true "
                 "--potential_type hydrogen --ndim 2 --lim 50 --val_eps 0.1 --neigs 36 "
                 "--apply_boundary false --apply_exp_mask false "
                 "--mlp_hidden_dims 128,128,128 --parallel true --nonlinearity softplus "
                 "--sampling_mode gaussian_mixture --sampling_scales 0.5,2,6,16,32 "
                 "--fourier_append_radial true "
                 "--fourier_append_envelopes 2.0,0.6667,0.4,0.2857,0.2222,0.1818 "
                 "--operator_scale 100 --rescue true --use_fourier_feature true "
                 "--fourier_mapping_size 1024 --fourier_scale 0.1 --neuralsvd.step 1 "
                 "--neuralsvd.sequential 0 --neuralef.unbiased true "
                 "--neuralef.include_diag false --neuralef.batchnorm_mode unbiased "
                 "--loss neuralsvd").split()
OSCILLATOR_ARGV = ("--optimizer rmsprop --use_lr_scheduler true --ema_decay 0.995 "
                   "--batch_size 512 --lr 1e-4 --num_iters 100000 --laplacian_eps 0.01 "
                   "--eval_freq 100000 --overwrite true --potential_type harmonic_oscillator "
                   "--ndim 2 --lim 5 --val_eps 0.1 --neigs 55 --apply_boundary false "
                   "--apply_exp_mask true --exp_mask_init_scale 10 "
                   "--mlp_hidden_dims 128,128,128 --parallel true --nonlinearity softplus "
                   "--sampling_mode gaussian --sampling_scale 4 --operator_scale 1 "
                   "--operator_shift 16.0 --use_fourier_feature true "
                   "--fourier_mapping_size 256 --fourier_scale 1 --neuralsvd.step 1 "
                   "--neuralsvd.sequential 0 --neuralef.unbiased true "
                   "--neuralef.include_diag false --loss neuralsvd").split()
HYDROGEN_L, OSCILLATOR_L = 36, 55
# hydrogen: a first run of HYD_FIRST steps checkpoints at its eval; slot
# HYD_DUP[0] is copied to slot HYD_DUP[1]; --resume to HYD_ITERS with an
# eval at HYD_EVAL (inside rescue_until 0.7 x HYD_ITERS) rescues it, and
# HYD_ITERS - HYD_EVAL more steps follow.  Blocks of RECIPE_BLOCK steps.
RECIPE_BLOCK = 250
HYD_FIRST, HYD_EVAL, HYD_ITERS, HYD_DUP = 500, 750, 1250, (2, 20)
OSC_ITERS = 750  # one eval, at the end
# the --profile window: one graph block of each run, not its last one
HYD_TRACED = (HYD_EVAL, RECIPE_BLOCK)
OSC_TRACED = (RECIPE_BLOCK, RECIPE_BLOCK)

# NeuralEF on hydrogen.sh: the same list with --loss neuralef (the script
# takes the loss as $1 and already passes the --neuralef.* flags); only
# steps are cut (NEF_ITERS of 500000), in graph blocks of RECIPE_BLOCK with
# one eval at the end
NEF_ITERS = 500
NEF_CPU_ROWS = 64  # the card vs CPU check of loss and grads, in float64
NEF_CPU_RTOL = 1e-4
# the repo's 2D Fokker–Planck recipe (scripts/validate_fokker_planck.py:
# 129-139, 296-313): per-mode 64³ softplus towers on 16 deterministic
# Fourier maps, uniform sampling on [-π, π]² (the uniform sampler reads
# --sampling_scale), the forward engine with return_grad, the top 6 modes
# and one guard (L 7) over a shift of 4, sequential nesting, Adam at 1e-3
# on the cosine schedule, EMA 0.995, B 512; cut to FP_ITERS steps
FP_ARGV = ("--problem fp --ndim 2 --neigs 7 --mlp_hidden_dims 64,64,64 "
           "--nonlinearity softplus --parallel true --use_fourier_feature true "
           "--fourier_deterministic true --fourier_mapping_size 16 --fourier_scale 1 "
           "--apply_boundary false --sampling_mode uniform "
           "--sampling_scale 3.141592653589793 --lim pi --laplacian_eps -1 "
           "--operator_shift 4 --neuralsvd.sequential true --optimizer adam --lr 1e-3 "
           "--use_lr_scheduler true --ema_decay 0.995 --batch_size 512 --seed 0").split()
FP_L, FP_SHIFT, FP_ITERS = 7, 4.0, 1000
FP_TRACED = (RECIPE_BLOCK, RECIPE_BLOCK)
# Nyström (methods/nystrom.py) on the FP domain: an RBF kernel (width 1) on
# NY_TRAIN uniform points of [-π, π]², the top FP_L eigenpairs extended to
# NY_VAL new points, numpy samples with no device (so: the card) against
# the same call on the CPU; eigvals rtol NY_RTOL, eigenfunctions up to sign
# within NY_RTOL of the largest entry (f32 rounding: ~4e-7 against float64)
NY_TRAIN, NY_VAL, NY_RTOL = 2000, 1000, 1e-5

# SpIN and SpINx on hydrogen.sh: the same list with --loss spin|spinx (the
# script takes the loss as $1; --spin.decay stays at its default 0.01);
# only steps and evals are cut (SPIN_ITERS of 500000, an eval every
# SPIN_EVAL, the first inside the rescue's window of 0.7 x SPIN_ITERS), in
# graph blocks of RECIPE_BLOCK
SPIN_ITERS, SPIN_EVAL = 500, 250
SPIN_CPU_ROWS = 64  # the card vs CPU check of one loss_and_grad, float64
SPIN_CPU_RTOL = 1e-4
SPIN_SMALL_L = 4  # compact vs dense j_avg on the card at hydrogen.sh's widths
SPIN_DENSE_RTOL = 1e-4
SPIN_EAGER_PROFILED, SPIN_REPLAYED = 5, 20  # steps traced for a step's parts
TOP_KERNELS = 12  # a profiled replayed block lists its costliest kernels
# the least share of a traced block's replays whose kernels the trace
# holds in full (see _replay_launches)
REPLAY_WHOLE_SHARE = 0.9

# SpIN and SpINx on the exact Laplacian's engines: the E4 flags (L 16, B
# 512, 128³ per-mode softplus towers on 2053 features, the forward engine
# at --laplacian_eps -1 --laplacian_mode forward) with --loss spin|spinx,
# SPIN_EXACT_ITERS steps in graph blocks of RECIPE_BLOCK with one eval at
# the end, then --loss spin on Hutchinson probes (--laplacian_probes
# SPIN_HUTCH_PROBES) for SPIN_HUTCH_ITERS; the checkpoint API on SpIN's
# state (save_resumable after one block from the trained state,
# load_resumable into a fresh template, the next block bit for bit)
SPIN_EXACT_ITERS, SPIN_HUTCH_ITERS, SPIN_HUTCH_PROBES = 2 * RECIPE_BLOCK, RECIPE_BLOCK, 2

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
# the paper script's bf16 towers (scripts/exps/sketchy.sh:18-21): the same
# list with --compute_dtype bf16.  The card's bf16 tower products on
# BF16_ROWS rows are held to float64 products of the same bf16 operands:
# |card - ref| <= BF16_RTOL·|ref| + BF16_ATOL·max|ref| (the output's
# rounding to bf16 is at most half of BF16_RTOL, 2^-8 of the value;
# BF16_ATOL of the largest entry covers the float32 sums of depth 8192)
CDK_BF16_ARGV = CDK_ARGV + ["--compute_dtype", "bf16"]
BF16_ROWS, BF16_RTOL, BF16_ATOL = 256, 2.0 ** -7, 2.0 ** -12
CDK_TURNS = ("f32", "tf32", "bf16", "bf16", "tf32", "f32")  # bare-step timing order
CDK_PROFILED = 5  # eager f32, TF32 and bf16 steps under the profiler

# the Sketchy CLI's own entry point (phase sketchy_cli): scripts/exps/sketchy.sh's
# args=( ... ) list as written (bf16 towers 512-8192-512, L 512, B 4096, SGD
# 0.9, grad clip 1.0, the lr schedule, its 28 truncation dims, 20 saved
# retrievals, AP v1) with two cuts: --neuralsvd.sequential false dropped (the
# flag takes no value, ROADMAP §3) and --num_epochs SKETCHY_EPOCHS; run by
# cli.sketchy.main on feature files at Sketchy Extended scale: SKETCHY_CLASSES
# classes of SKETCHY_SKETCHES sketches and SKETCHY_PHOTOS photos, 512-d
# (the width of make_vgg_feature_extractor's head), made up from SEED with
# _cdk_data's class-centre recipe, split by split_classes(.., SKETCHY_SPLIT)
# into 90 train, 10 valid and 25 test classes
SKETCHY_EPOCHS = 2
SKETCHY_TRUNC = (-512, -448, -384, -320, -256, -192, -128, -64, -32, -16, -8, -4, -2, -1,
                 1, 2, 4, 8, 16, 32, 64, 128, 192, 256, 320, 384, 448, 512)
SKETCHY_ARGV = ["--overwrite", "--network_dims", "8192,512", "--mu", "16",
                "--compute_dtype", "bf16", "--num_epochs", str(SKETCHY_EPOCHS),
                "--warmup_epochs", "0", "--batch_size", "4096", "--optimizer", "sgd",
                "--momentum", "0.9", "--base_lr", "5e-3", "--use_lr_scheduler",
                "--grad_clip", "1.0", "--neigs", "512", "--loss", "neuralsvd",
                "--neuralsvd.step", "1", "--n_retrievals_to_save", "20",
                "--trunc_dims", *map(str, SKETCHY_TRUNC), "--ap_ver", "1"]
SKETCHY_SPLIT, SKETCHY_CLASSES, SKETCHY_DIM = "1_0", 125, 512
SKETCHY_SKETCHES, SKETCHY_PHOTOS = 604, 584  # a class: ~75.5k sketches, ~73k photos
# VGG16 extraction through extract_features_main on made-up 3x224x224 images,
# VGG_PER_CLASS of each kind a class, batch VGG_BATCH; the card against a CPU
# copy on VGG_CPU_ROWS images (TF32 off), of the largest entry
VGG_PER_CLASS, VGG_BATCH, VGG_CPU_ROWS, VGG_RTOL, VGG_TIMED = 2, 64, 8, 1e-4, 10
# the loader's host ms a batch at B 4096 on the train files, native against
# use_native=False in turns; the native pair draw at least LOADER_MIN_RATIO
# times faster (tests/test_native_sampler.py's assertion)
LOADER_TURNS, LOADER_BATCHES, LOADER_MIN_RATIO = ("native", "python", "python", "native"), 10, 5.0
RETRIEVAL_QUERY_BATCH = 2048  # top_k_retrievals' query batch
# phase dp (--mesh dp, parallel/sharding.py): the E4 flags on the plain
# loss (--neuralsvd.use_pallas false) through cli.pde.main on a one-rank
# NCCL group, DP_ITERS steps in graph blocks of DP_BLOCK with one eval at
# the end, its second block traced (DP_TRACED); held to the same flags
# without --mesh (bit for bit expected; else DP_PLAIN_ATOL of the largest
# entry) and to itself as eager steps (PDE_STATE_RTOL/ATOL); then steps/s
# of each block after the first of DP_TURN_ITERS-step runs in the turns
# DP_TURNS (dp on the plain loss, no mesh on the plain loss, no mesh on the
# kernels).  The
# Sketchy script (SKETCHY_ARGV, one epoch, one truncation dim, no saved
# retrievals) through cli.sketchy.main with --mesh dp against the run
# without it on --use_pallas false, at DP_SKETCHY_RTOL/ATOL
# (tests/test_cli_mesh.py:69).  Two gloo ranks on the one card (spawned,
# CUDA tensors, joined within DP_SPAWN_TIMEOUT_S): one eager E4 step at
# dp=2 against the single-process step on the half-consistent union batch,
# and one CDK step at the paper's width in float32 (CDK_ARGV) against the
# single-process step on the same pairs, at DP_LOSS_TOL and DP_PARAM_TOL
# (tests/test_parallel.py:158-209), both with SGD and no clip
# (_dp_step_argv, _dp_cdk_args)
DP_ITERS, DP_BLOCK = 500, 250
DP_TRACED = (DP_BLOCK, DP_BLOCK)
DP_TURNS = ("dp", "plain", "kernels", "kernels", "plain", "dp")
DP_TURN_ITERS = 3 * DP_BLOCK  # a turn's rates: each block after the capturing one
# SpIN at hydrogen.sh's flags (HYDROGEN_ARGV, --loss spin) with --mesh dp
# against no mesh: the flat mean of the method state (the 1.54 GB j_avg)
# every step.  DP_SPIN_ITERS steps in graph blocks of DP_SPIN_BLOCK, no
# eval, in the turns DP_SPIN_TURNS: steps/s of each block after the
# capturing one and the run's peak device memory above what it started
# with; the first dp and no-mesh runs' states held to each other
DP_SPIN_ITERS, DP_SPIN_BLOCK = 200, 100
DP_SPIN_TURNS = ("dp", "plain", "dp")
DP_PLAIN_ATOL = 1e-6
DP_SKETCHY_RTOL, DP_SKETCHY_ATOL = 2e-4, 2e-5
DP_LOSS_TOL, DP_PARAM_TOL = (1e-5, 1e-6), (1e-4, 1e-6)  # (rtol, atol)
DP_SPAWN_TIMEOUT_S = 120
# Tensor parallelism (--mesh tp=2, parallel/sharding.py) on two gloo ranks
# on the one card (spawned, CUDA tensors, joined within TP_SPAWN_TIMEOUT_S;
# NCCL refuses two ranks on one device, and gloo refuses a CUDA graph, so
# eager steps): (a) the E4 flags through cli.pde.main on SGD (their lr),
# TP_E4_ITERS steps with one eval and its checkpoint, against the same run
# without a mesh at TP_TOL on every parameter leaf (tests/test_cli_mesh.py
# :62-63), the checkpoint loaded into a one-process TrainState; then one
# step on Adam and on RMSprop, whose parameters are not held to TP_TOL: their
# first update, lr·g/(|g| + eps) up to a constant, moves an entry whose
# gradient lies inside the two runs' reduction-order rounding (a
# cancellation) by a sizeable share of lr in either direction, where SGD's
# update is linear in g.  Instead every tensor of their optimizer state (the
# first step's moments: the gradient, scaled) is held to TP_TOL with atol a
# share of the leaf's largest entry, and every parameter entry outside
# TP_TOL must be one whose one-process gradient is under TP_FLIP_GRAD of its
# leaf's largest; (b) the paper-width f32 CDK step
# (CDK_ARGV: 512-8192-512 towers, L 512 + the constant, B 4096, 256 mode
# columns a rank), TP_CDK_STEPS steps on the same pairs against the
# one-process step at TP_TOL.  Both on K1-K3: one launch of each a step on
# each rank
TP_E4_ITERS, TP_E4_BLOCK = 200, 100
TP_E4_RUNS = (("sgd", TP_E4_ITERS), ("adam", 1), ("rmsprop", 1))  # SGD's parameters checked
TP_CDK_STEPS = 5
TP_TOL = (2e-4, 2e-5)  # (rtol, atol)
TP_FLIP_GRAD = 2e-5  # the moments' atol share: a larger gradient keeps its sign within it
TP_SPAWN_TIMEOUT_S = 480
# (c) SpIN and SpINx at hydrogen.sh's width (HYDROGEN_ARGV with --loss
# spin|spinx: L 36, 2055 features, per-mode 128³ towers, B 512, FD at eps
# 0.01) on SGD at the script's lr without its schedule and with a grad clip
# of TP_SPIN_CLIP (SGD takes SpIN's first, whitened gradient whole: on the
# CPU at toy width one step moved σ from 0.31 to 1064 and two reduction
# orders parted; the clip reads the whole gradient's norm on both sides),
# TP_SPIN_ITERS eager steps in two blocks (the second one's rate is printed)
# with one eval at the end (its checkpoint, then SpINx's refresh) on a grid
# at --val_eps TP_SPIN_VAL_EPS (10⁴ points, not the script's 10⁶: the eval
# is not what is held here), at --mesh tp=2 against one process: the
# parameters at TP_TOL, the gathered j_avg, sigma_avg and chol at TP_TOL
# with atol a share of each leaf's largest entry (the Jacobian average's
# batch sums run to ~10² at toy width, where 2e-5 is below their float32
# rounding), the ranks bit for bit, each rank's j_avg bytes (half of 36·P·4)
# and peak memory, the tp SpIN checkpoint loaded in one process with equal
# j_avg, and SpINx's weights: one process refreshes from the tp run's
# checkpoint on the same batch in float64, and the tp run's refresh must be
# within TP_WEIGHTS_RTOL of it, or within RECIPE_F64_FACTOR times one
# process's own float32 refresh's distance from it (finite differences at
# eps 0.01 leave two float32 evaluations ~1e-3 apart, and the weights,
# square roots of ratios of squared gradient norms, carry it: at hydrogen.sh
# on the H100 the two float32 refreshes sat 9.1e-3 apart); the two runs'
# weights are printed, not gated (a float32 refresh moves its weights by
# ~2e-4 of themselves under a 1e-7 relative change of the parameters,
# tests/test_torch_tp_spin.py); no K1-K3 launch
TP_SPIN_ITERS, TP_SPIN_VAL_EPS, TP_SPIN_CLIP, TP_WEIGHTS_RTOL = 20, 1.0, 1.0, 1e-4
# the parameters must move more than TP_SPIN_MOVED (2.5 x TP_TOL's atol), so
# that a wrong gradient would show; SGD clipped at 1 moves an entry at most lr
# (1e-4) a step, and SpINx's concentrated gradient moved one by 1.0e-4 in 20
TP_SPIN_MOVED = 5e-5
TP_SPIN_LOSSES = ("spin", "spinx")
# The serving export (utils/export.py): the E4 wavefunction (float32, and at
# --matmul_precision high, each tower product one tiered_einsum operator in
# the program) and the
# paper-width CDK x tower (CDK_ARGV's widths, f32 and bf16), exported with a
# dynamic batch, saved to a .pt2 file and reloaded, at EXPORT_BATCHES rows
# against the eager module: bit for bit, or within EXPORT_RTOL and
# EXPORT_ATOL of the largest entry; CUDA-event ms of both calls
EXPORT_BATCHES = (3, 4096)
EXPORT_RTOL, EXPORT_ATOL = 1e-6, 1e-7
DRYRUN_RANKS = 4  # graft_entry.dryrun_multichip on gloo CPU ranks
# The accuracy entry points (neuralsvd_tpu_torch/scripts/): the north star
# at the E4 recipe (validate_northstar's defaults with lap_eps -1: the
# forward engine, L 16, B 512, 1024 Fourier maps, the 4-scale mixture, the
# radial and envelope features) cut to NS_ITERS steps in chunks of NS_CHUNK
# (not the recipe's 1000: the chunk at iteration NS_TRACED is traced to
# count the replayed launches, and a trace of ~500 kernels a step must stay
# within the profiler's device buffers) with partial rows every NS_EVAL_EVERY and
# the full NS_EVAL_ROUNDS-round raw and EMA evals; the resume check stops a
# run at its first partial row (NS_GATE) and resumes it from NS_CKPT
NS_ITERS, NS_CHUNK, NS_EVAL_EVERY, NS_TRACED = 5000, 500, 2000, 2500
# the eval's sums on the card against a float64 CPU copy on the same draws
NS_CPU_ROUNDS, NS_CPU_RTOL, NS_CPU_ATOL = 2, 1e-4, 1e-6
# the L 36 flagship's levers (scripts/r5_tpu_queue_take3.sh:80-87: 42 modes
# with 6 guards, the rescue, tail LR 3x from mode 25, the weighted 5-scale
# mixture), with a rescue every NS_LEVERS_CHUNK steps up to NS_RESCUE_END of
# NS_LEVERS_ITERS: a first run stops at its partial row at NS_LEVERS_FIRST,
# its checkpoint gets slot NS_LEVERS_DUP[0] copied to NS_LEVERS_DUP[1]
# (params, EMA, moments), and the resumed run's next rescue must exile it;
# the resumed run's chunk at NS_LEVERS_TRACED (after that rescue) is traced
NS_LEVERS_ENV = {"NS_NEIGS": "42", "NS_EVAL_TOP": "36", "NS_RESCUE": "1",
                 "NS_TAIL_LR": "3", "NS_TAIL_LR_START": "25",
                 "NS_MIX": "0.5,2,6,16,32", "NS_MIX_W": "0.3,0.2,0.2,0.15,0.15"}
NS_LEVERS_ITERS, NS_LEVERS_FIRST, NS_LEVERS_CHUNK, NS_LEVERS_END = 4000, 1000, 250, "0.4"
NS_LEVERS_L, NS_LEVERS_DUP, NS_LEVERS_ROUNDS, NS_LEVERS_TRACED = 42, (2, 30), 8, 1500
# validate_methods (four methods on the 1D oscillator) and
# validate_fokker_planck (1D and 2D against their FD spectra), cut to
# VM_STEPS and VF_ITERS steps in blocks of VM_BLOCK and VF_CHUNK (a
# traced block of ~250-410 kernels a step stays within the profiler's
# buffers), NestedLoRA's block at VM_TRACED and the 1D run's at VF_TRACED
# traced; the 1D run trains VF_L modes (its FD shells 1, 2, 2, 2 and a
# guard), the 2D run FP_L
VM_STEPS, VM_BLOCK, VM_TRACED = 2000, 250, 1000
VF_ITERS, VF_CHUNK, VF_TRACED, VF_L = 2000, 250, 500, 8
# the figures: the figure tool on the north star's checkpoint (its JAX
# defaults: 16 eval rounds, a 192² grid), a panel's centre read for the
# sign of ψ where |ψ| >= PSI_SIGN_MIN of the mode's largest (paler is too
# close to RdBu's white); plot_1d_eigfuncs at PLOT_1D_POINTS x PLOT_1D_MODES;
# the phase within PLOTS_MAX_S
PSI_SIGN_MIN, PLOT_1D_POINTS, PLOT_1D_MODES, PLOTS_MAX_S = 0.05, 4096, 16, 30.0
# the online heads (90 train classes), kNN (k 200, T 0.1) and the multi-head
# probe (PROBE_STEPS SGD steps of batch CDK_B) on the trained towers
KNN_K, KNN_T = 200, 0.1
PROBE_TRUNC, PROBE_STEPS, PROBE_LR = (16, -16, 512), 20, 0.1
# the ResNets and the Siamese network: the card against a CPU copy (float32,
# TF32 off, of the largest entry) on ZOO_CPU_ROWS images or SIAM_CPU_ROWS
# rows, then ZOO_STEPS SGD steps after one warm-up step
ZOO_RTOL, ZOO_CPU_ROWS, SIAM_CPU_ROWS, ZOO_STEPS = 1e-4, 4, 256, 5
RESNETS = {  # name: (factory(device, generator), image side, batch, classes)
    "resnet18": (lambda d, g: make_resnet((2, 2, 2, 2), 64, num_outputs=1000, device=d,
                                          generator=g), 224, 64, 1000),
    "cifar_resnet20": (lambda d, g: make_cifar_resnet(20, num_outputs=10, device=d,
                                                      generator=g), 32, 128, 10),
    "wrn_28_2": (lambda d, g: make_wide_resnet(28, 2, num_outputs=10, device=d, generator=g),
                 32, 128, 10),
}
SIAM_MODES = {"plain": {}, "separation": {"separation": True},
              "batch_l2norm": {"batch_l2norm": True}}
SIAM_DIMS, SIAM_B = [8192, 512], 4096

# the PDE CLI's --matmul_precision tiers on the E4 flags: one run a tier of
# PDE_TIER_ITERS steps in graph blocks of RECIPE_BLOCK (the first block
# captures, the second is timed, the third traced), then a second round in
# the reverse order of PDE_TIER_TURN steps for the rates in turns; tower
# outputs against a float64 copy on TIER_ROWS rows
PDE_TIERS = ("highest", "high", "default", "highest@1,high")
PDE_TIER_ITERS, PDE_TIER_TURN, TIER_ROWS = 3 * RECIPE_BLOCK, 2 * RECIPE_BLOCK, 256
PDE_TIER_TRACED = (2 * RECIPE_BLOCK, RECIPE_BLOCK)
# the largest error each tier's tower outputs may have against float64, of
# the largest entry: IEEE and 3xTF32 are float32-grade, one TF32 pass 2^-11
TIER_MAX_ERR = {"highest": 2.0 ** -16, "high": 2.0 ** -16, "default": 2.0 ** -6}
# the bf16 E4 towers on the card against a CPU copy, of the largest entry:
# each of the four products rounds its output to bf16 (2^-9 relative) on
# both sides, in different sums
BF16_CARD_CPU_ATOL = 2.0 ** -5

# the kernel-operator EVD path (phase kernel_evd): an RBF kernel
# exp(-|a - b|^2) on 2D standard-normal samples (the kernel and sampler of
# tests/test_training.py:130-168) at B KEVD_B, L KEVD_L; per-mode 128³
# softplus towers on the raw input and the shared trunk 128³ with weight
# normalization and no biases; NestedLoRA's loss_and_grad_kernel with and
# without split_batch, kernels vs plain on the card; NeuralEF, SpIN and
# SpINx on the card against a CPU copy on KEVD_CPU_ROWS rows in float64;
# then train_operator on a fixed KEVD_B-landmark KernelOperator for
# KEVD_ITERS steps in graph blocks of RECIPE_BLOCK, one eval, the
# --profile window KEVD_TRACED
KEVD_B, KEVD_L, KEVD_HIDDEN = 4096, 16, [128, 128, 128]
KEVD_CPU_ROWS, KEVD_CPU_RTOL = 512, 1e-4
KEVD_ITERS, KEVD_LR = 1000, 1e-3
KEVD_TRACED = (2 * RECIPE_BLOCK, RECIPE_BLOCK)
KEVD_VAL_LIM, KEVD_VAL_EPS = 3.0, 0.05  # the eval grid: 120² points

# full batches (B, L); K1/K3 see the two halves (B/2, L), K2 the whole on
# the EVD path and the two halves (f, g) on the CDK path; on the kernel
# path's split batch ("kernel_split") K1/K3 see (f1, f2) of B rows each
# and K2 the pair (f1, Kf1) of B rows
KERNEL_SHAPES = [("E4", BATCH, NEIGS), ("unaligned", 96, 5), ("wide", 2048, 64),
                 ("edge", 2000, 129), ("cdk", 2 * CDK_B, CDK_L + 1),
                 ("hydrogen", BATCH, HYDROGEN_L), ("oscillator", BATCH, OSCILLATOR_L),
                 ("fp", BATCH, FP_L), ("kernel_evd", KEVD_B, KEVD_L),
                 ("kernel_split", KEVD_B // 2, KEVD_L), ("levers", BATCH, NS_LEVERS_L),
                 ("methods", vm.B, vm.L), ("fp_validate", vf.B, VF_L)]
# the EVD packaging (K1-K3 in the loss's forward and backward) is timed at
# the shapes of the paths that take it
PACKAGING_SHAPES = ("E4", "hydrogen", "oscillator", "fp", "kernel_evd", "kernel_split")
KERNEL_RTOL = 1e-5   # of the plain version on |inputs|: f32 rounding scale
LOSS_RTOL = 1e-5     # kernel vs plain loss on one batch
GRAD_RTOL, GRAD_ATOL = 1e-4, 1e-6  # atol in units of the largest entry
OPERATOR_RTOL = 1e-4  # GPU vs CPU Tf, fs: f32 second derivatives
# a recipe's trained state: the kernel path's gradient excess over the
# tolerance, against float64, may be this many times the plain path's
RECIPE_F64_FACTOR = 2.0
# forward engine vs nested JVPs (tests/test_torch_operators.py): rtol, and
# atol in units of the largest entry of each output
LAP_RTOL, LAP_ATOL = 1e-4, 1e-5
# Hutchinson: mean of HUTCH_DRAWS estimates (HUTCH_PROBES probes each) vs
# the exact Laplacian, within HUTCH_Z standard errors of the mean (a t
# variable of 63 degrees of freedom passes 6 with odds ~1e-7 an entry, so
# ~1e-3 for the 8192 entries) plus LAP_ATOL of the largest entry (f32)
HUTCH_PROBES, HUTCH_DRAWS, HUTCH_Z, HUTCH_STEPS = 2, 64, 6.0, 20

# H100 SXM peaks (NVIDIA data sheet, at a 700 W power limit)
HBM_BYTES_PER_S = 3.35e12
F32_FLOP_PER_S = 67e12

KERNEL_SOURCE = "neuralsvd_tpu_torch/csrc/gram_kernels.cu"
# the kernels of csrc/gram_kernels.cu, as ptxas names them (mangled)
CUDA_KERNELS = ("masked_gram_syrk_kernel", "masked_gram_finish_kernel",
                "sum_partials_kernel", "weighted_dot_kernel",
                "metric_grads_kernel")
# each wrapper's kernel as the profiler names it (K1: its SYRK pass)
GRAM_KERNELS = {"masked_gram_pair": "masked_gram_syrk_kernel",
                "weighted_dot": "weighted_dot_kernel",
                "metric_grads": "metric_grads_kernel"}
# every CUDA kernel each wrapper launches, for its device time in a trace
WRAPPER_KERNELS = {"masked_gram_pair": ("masked_gram_syrk_kernel", "masked_gram_finish_kernel",
                                        "sum_partials_kernel"),
                   "weighted_dot": ("weighted_dot_kernel",),
                   "metric_grads": ("metric_grads_kernel",)}
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
    """(f, Tf, f1, f2, vector mask, matrix mask): f1, f2 the halves of f,
    or on the split kernel path f = f1 and an independent f2, B rows each."""
    dev = DEVICE
    f = torch.randn(B, L, generator=gen, device=dev)
    Tf = torch.randn(B, L, generator=gen, device=dev)
    if label in ("E4", "edge", "fp", "kernel_evd", "kernel_split"):
        vmask, mmask = sequential_nesting_masks(L)
    elif label == "cdk":
        vmask, mmask = joint_nesting_masks(step_weights(L - 1), set_first_mode_const=True)
    else:
        vmask, mmask = joint_nesting_masks(step_weights(L))
    if label == "kernel_split":
        f1, f2 = f, torch.randn(B, L, generator=gen, device=dev)
    else:
        f1, f2 = torch.chunk(f, 2)
    return (f, Tf, f1, f2, torch.as_tensor(vmask, device=dev),
            torch.as_tensor(mmask, device=dev))


def phase_kernels():
    """Every kernel against its plain version; timings at each shape."""
    gen = torch.Generator(device=DEVICE).manual_seed(SEED)
    rows = {k: [] for k in REPLACES}
    packaging = []
    for label, B, L in KERNEL_SHAPES:
        f, Tf, f1, f2, vmask, mmask = _kernel_inputs(label, B, L, gen)
        Bh = f1.shape[0]
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
        if label in PACKAGING_SHAPES:
            packaging.append(_packaging_row(label, f, Tf, f2 if label == "kernel_split" else None,
                                            vmask, mmask, rows))
    emit("kernels", rtol=KERNEL_RTOL, results=rows)
    emit("kernels_packaging", results=packaging)
    return rows, packaging


def _packaging_row(label, f, Tf, f2, vmask, mmask, rows):
    """The EVD packaging's forward and backward (one call each of K1, K2
    and K3) against the plain EVD loss on the same (f, Tf): loss at
    LOSS_RTOL, the gradient of f at the gradient tolerances, and the
    CUDA-event ms of each; its bound is the sum of the three kernels'
    bounds at this shape.  The halves are those of f, or (f, ``f2``) on
    the split kernel path, as ``loss_and_grad_kernel`` passes them."""
    def run(loss_fn):
        a = f.detach().requires_grad_()
        halves = torch.chunk(a, 2) if f2 is None else (a, f2)
        loss = loss_fn(a, Tf, *halves, vmask, mmask)
        return loss, torch.autograd.grad(loss, a)[0]

    (loss_k, grad_k), (loss_p, grad_p) = (run(nestedlora_evd_loss_kernels),
                                          run(nestedlora_evd_loss))
    loss_rel = abs(loss_k.item() - loss_p.item()) / abs(loss_p.item())
    check(loss_rel <= LOSS_RTOL, f"packaging at {label}: loss rel {loss_rel:.3g}")
    grad_excess = _excess(grad_k, grad_p, GRAD_RTOL, GRAD_ATOL)
    check(grad_excess <= 1.0, f"packaging at {label}: grad {grad_excess:.3g}x tolerance")
    parts = [next(r for r in rows[k] if r["shape"] == label) for k in REPLACES]
    return dict(shape=label, B=f.shape[0], L=f.shape[1], loss_rel=loss_rel,
                grad_tol_used=grad_excess,
                ms=time_ms(lambda: run(nestedlora_evd_loss_kernels)),
                plain_ms=time_ms(lambda: run(nestedlora_evd_loss)),
                bound_ms=sum(r["bound_ms"] for r in parts),
                bound_by=[r["bound_by"] for r in parts])


def _e4_setup(device, laplacian_mode="forward", laplacian_probes=0):
    model = make_wavefunctions(
        ndim=NDIM, neigs=NEIGS, mlp_hidden_dims=HIDDEN,
        nonlinearity="softplus", parallel=True, use_fourier_feature=True,
        fourier_mapping_size=FOURIER, fourier_scale=0.1,
        fourier_append_radial=True, fourier_append_envelopes=ENVELOPES,
        apply_boundary=False, seed=SEED, device=device)
    operator, ground_truth, _ = get_problem(
        problem="sch", potential_type="hydrogen", ndim=NDIM, neigs=NEIGS,
        laplacian_eps=-1.0, laplacian_mode=laplacian_mode,
        laplacian_probes=laplacian_probes, operator_scale=OPERATOR_SCALE)
    sampler, importance = get_sampler("gaussian_mixture", BATCH, 1, NDIM,
                                      MIX_SCALES, device=device)
    return model, operator, ground_truth, sampler, importance


def _excess(got, ref, rtol, atol):
    """Largest |got - ref| over (rtol·|ref| + atol·max|ref|)."""
    tol = rtol * ref.abs() + atol * ref.abs().max()
    return ((got - ref).abs() / tol).max().item()


def _check_grads(got, ref):
    worst = 0.0
    for k, r in ref.items():
        excess = _excess(got[k], r, GRAD_RTOL, GRAD_ATOL)
        check(excess <= 1.0, f"kernel vs plain gradient of {k}: {excess:.3g}x tolerance")
        worst = max(worst, excess)
    return worst


def _forward_vs_jvp(model, x, importance):
    """Laplacian, gradient and fs of the forward engine against nested JVPs
    on one batch, under √w conjugation."""
    out = {}
    with torch.no_grad():
        fwd = VectorizedLaplacian(eps=-1.0, exact_mode="forward")(
            model, x, importance, return_grad=True)
        ref = VectorizedLaplacian(eps=-1.0, exact_mode="jvp")(
            model, x, importance, return_grad=True)
    for name, a, b in zip(("lap", "grad", "fs"), fwd, ref):
        out[name] = _excess(a, b, LAP_RTOL, LAP_ATOL)
        check(out[name] <= 1.0, f"forward vs jvp {name}: {out[name]:.3g}x tolerance")
    return out


def _steps_per_s(step, ts, gen, n, warmup):
    """Run n train steps: (steps/s over the last n - warmup, losses).
    Fails on a non-finite loss or a skipped step."""
    losses, skipped = [], []
    for i in range(n):
        if i == warmup:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
        ts, metrics = step(ts, gen)
        losses.append(metrics["loss"])
        skipped.append(metrics["skipped"])
    torch.cuda.synchronize()
    rate = (n - warmup) / (time.perf_counter() - t0)
    losses = torch.stack(losses).cpu().numpy()
    n_skipped = int(torch.stack(skipped).sum().item())
    check(np.isfinite(losses).all(), "non-finite training loss")
    check(n_skipped == 0, f"{n_skipped} skipped steps")
    return rate, losses


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
    lap_excess = _forward_vs_jvp(model, x, importance)

    # GPU vs CPU on a small batch: the same operator on a CPU copy
    cpu_model, cpu_op, _, _, cpu_imp = _e4_setup("cpu")
    cpu_model.load_state_dict(model.state_dict())
    xs = x[:64]
    Tf_g, fs_g = operator(model, xs, importance)
    Tf_c, fs_c = cpu_op(cpu_model, xs.cpu(), cpu_imp)
    op_rel = max(((a.detach().cpu() - b.detach()).abs().max() / b.abs().max()).item()
                 for a, b in ((Tf_g, Tf_c), (fs_g, fs_c)))
    check(op_rel <= OPERATOR_RTOL, f"GPU vs CPU operator: rel {op_rel:.3g}")

    # the main path: TRAIN_STEPS steps through the kernels and the engine
    step = make_train_step(method, operator, optimizer, sampler,
                           importance=importance, ema_decay=EMA_DECAY)
    cuda_gram.reset_launch_counts()
    forward_laplacian.fallback_rule.calls = 0
    steps_per_s, losses = _steps_per_s(step, ts, gen, TRAIN_STEPS, WARMUP_STEPS)
    counts = cuda_gram.launch_counts()
    fallbacks = forward_laplacian.fallback_rule.calls
    check(all(n == TRAIN_STEPS for n in counts.values()),
          f"launch counts {counts} != {TRAIN_STEPS} each")
    check(fallbacks == 0, f"{fallbacks} fallback-rule calls on the E4 path")
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

    # the same number of steps on the nested-JVP Laplacian, for its rate
    _, jvp_op, _, _, _ = _e4_setup(DEVICE, laplacian_mode="jvp")
    jvp_step = make_train_step(method, jvp_op, optimizer, sampler,
                               importance=importance, ema_decay=EMA_DECAY)
    jvp_steps_per_s, _ = _steps_per_s(jvp_step, ts, gen, TRAIN_STEPS, WARMUP_STEPS)
    emit("trainer", L=NEIGS, B=BATCH, hidden=HIDDEN, feature_dim=feature_dim,
         laplacian_mode="forward",
         kernel_vs_plain_loss_rel=loss_rel, kernel_vs_plain_grad_tol_used=grad_excess,
         forward_vs_jvp_tol_used=lap_excess,
         gpu_vs_cpu_operator_rel=op_rel, steps=TRAIN_STEPS,
         first_loss=float(losses[0]), last_loss=float(losses[-1]),
         skipped=0, launches=counts, fallback_calls=fallbacks,
         steps_per_s=steps_per_s, jvp_steps_per_s=jvp_steps_per_s,
         timed_steps=TRAIN_STEPS - WARMUP_STEPS, peak_mem_gib=peak_gib,
         eigvals=eigvals.tolist(), ground_truth=np.asarray(ground_truth).tolist())
    return counts, model, importance, x


def phase_hutchinson(model, importance, x):
    """The Hutchinson Laplacian against the exact one at full width, and a
    short training run on it."""
    exact = VectorizedLaplacian(eps=-1.0, exact_mode="forward")
    hutch = VectorizedLaplacian(eps=-1.0, exact_mode="forward", num_probes=HUTCH_PROBES)
    check(hutch.needs_key and not exact.needs_key, "needs_key")
    gen = torch.Generator(device=DEVICE).manual_seed(SEED + 2)
    with torch.no_grad():
        lap, _, _ = exact(model, x, importance)
        draws = torch.stack([hutch(model, x, importance, generator=gen)[0]
                             for _ in range(HUTCH_DRAWS)])
    mean = draws.mean(0)
    se = draws.std(0) / HUTCH_DRAWS ** 0.5
    z = ((mean - lap).abs() / (se + LAP_ATOL * lap.abs().max())).max().item()
    check(z <= HUTCH_Z, f"Hutchinson mean vs exact: {z:.3g} standard errors")
    check((draws[0] != draws[1]).any().item(), "Hutchinson draws do not vary")
    mean_rel = ((mean - lap).abs().mean() / lap.abs().mean()).item()

    model, operator, _, sampler, importance = _e4_setup(
        DEVICE, laplacian_probes=HUTCH_PROBES)
    check(operator.needs_key, "the probe operator does not ask for probes")
    method = NestedLoRA(model, neigs=NEIGS, sequential=True)
    optimizer = torch_rmsprop(LR, alpha=ALPHA)
    step = make_train_step(method, operator, optimizer, sampler,
                           importance=importance, ema_decay=EMA_DECAY)
    ts = init_train_state(model, optimizer, method)
    rate, losses = _steps_per_s(step, ts, torch.Generator(device=DEVICE).manual_seed(SEED),
                                HUTCH_STEPS, HUTCH_STEPS // 4)
    emit("hutchinson", probes=HUTCH_PROBES, draws=HUTCH_DRAWS, max_z=z,
         z_limit=HUTCH_Z, mean_abs_err_over_mean_abs=mean_rel,
         draw_rel_spread=(draws.std(0).mean() / lap.abs().mean()).item(),
         train_steps=HUTCH_STEPS, first_loss=float(losses[0]),
         last_loss=float(losses[-1]), steps_per_s=rate)


class _Records(logging.Handler):
    """Keeps the port's log records of a run (print rows, health reports,
    the resume line)."""

    def __init__(self):
        super().__init__(logging.INFO)
        self.records = []

    def emit(self, record):
        self.records.append(record)


def _pde_run(argv, log_dir, timings=None, use_graph=True):
    """neuralsvd_tpu_torch.cli.pde.main on ``argv``: (state, eigvals, run
    dir, log records); the text spectrum plots it prints are dropped."""
    cfg = parse_pde_config(argv + ["--log_dir", log_dir, "--device", DEVICE])
    records = _Records()
    port_log = logging.getLogger("neuralsvd_tpu_torch")
    port_log.addHandler(records)
    try:
        with contextlib.redirect_stdout(io.StringIO()):
            ts, eigvals, _ = pde.main(cfg, timings=timings, use_graph=use_graph)
    finally:
        port_log.removeHandler(records)
    return ts, eigvals, os.path.join(log_dir, run_name(cfg)), records.records


def _rows(records):
    return [r.args for r in records if r.msg == "%s" and isinstance(r.args, dict)
            and "iter" in r.args]


def _check_run(label, ts, eigvals, run_dir, records, iters, evals, neigs=NEIGS):
    """Every print row finite and without skips, the evals' ``neigs``
    eigenvalues finite, the files of a run and one health report an eval."""
    rows = _rows(records)
    check(rows and rows[-1]["iter"] == iters, f"{label}: rows {rows}")
    check(all(np.isfinite(r["train_loss"]) for r in rows), f"{label}: non-finite loss")
    check(all("skips" not in r for r in rows), f"{label}: skipped steps {rows}")
    check(int(ts.step) == iters, f"{label}: step {int(ts.step)}")
    check(len(eigvals) == len(evals), f"{label}: {len(eigvals)} evals")
    check(all(np.shape(e) == (neigs,) and np.isfinite(e).all() for e in eigvals),
          f"{label}: eigenvalues {eigvals}")
    names = set(os.listdir(run_dir))
    want = {"stats.npz"} | {f"ckpt_{it}" for it in evals}
    check(want <= names and any(n.endswith(".csv") for n in names),
          f"{label}: files {sorted(names)}")
    health = [r for r in records if "mode health" in r.msg]
    check(len(health) == len(evals), f"{label}: {len(health)} health reports")
    return rows, [r.getMessage().split("\n", 1)[-1] for r in health]


def _profile_argv(traced):
    start, steps = traced
    return ["--profile", "true", "--profile_start", str(start),
            "--profile_steps", str(steps)]


def _trace_records(events):
    """The correlation ids of the cudaGraphLaunch calls and the (name,
    correlation id, µs) of each device record in a chrome trace's events."""
    launches, device = [], []
    for e in events:
        cat, name = str(e.get("cat", "")).lower(), str(e.get("name", ""))
        if cat == "cuda_runtime" and "cudaGraphLaunch" in name:
            launches.append(e["args"]["correlation"])
        elif cat in ("kernel", "gpu_memcpy", "gpu_memset"):
            device.append((name, e.get("args", {}).get("correlation"), e.get("dur", 0.0)))
    return launches, device


def _replay_launches(label, launches, device, steps, per_step=1):
    """Each gram kernel's replayed launches in a trace window of ``steps``
    replays of one captured step: ``launches`` the correlation ids of the
    window's cudaGraphLaunch calls, ``device`` its device records (name,
    correlation id, ...), as ``_trace_records`` gives them.

    CUPTI ties every kernel of a replay to the replay's cudaGraphLaunch by
    their correlation id, so the kernels are counted replay by replay.  The
    tracer loses records (on an H100, up to ~60 in a window, from one replay,
    more the longer the process has traced; once a K1 SYRK pass); a replay
    that lost records holds fewer than the largest replay.  Every replay launches the same
    instantiated graph, so the replays the tracer kept whole show what each
    of them launched.  Checks ``steps`` graph launches, ``per_step`` of each
    gram kernel in every whole replay and no more in any, at least
    REPLAY_WHOLE_SHARE of the replays whole, and no gram kernel outside a
    replay.  Returns ({wrapper: launches}, the trace's numbers)."""
    check(len(set(launches)) == len(launches) == steps,
          f"{label}: {len(launches)} graph launches in the trace window, not {steps}")
    replays = {c: {"records": 0, **{w: 0 for w in GRAM_KERNELS}} for c in launches}
    outside = {w: 0 for w in GRAM_KERNELS}
    for name, correlation, *_ in device:
        replay = replays.get(correlation)
        if replay is not None:
            replay["records"] += 1
        for w, k in GRAM_KERNELS.items():
            if k in name:
                if replay is None:
                    outside[w] += 1
                else:
                    replay[w] += 1
    full = max(r["records"] for r in replays.values())
    whole = [r for r in replays.values() if r["records"] == full]
    check(not any(outside.values()), f"{label}: gram kernels outside a replay {outside}")
    check(len(whole) >= REPLAY_WHOLE_SHARE * steps,
          f"{label}: {len(whole)} of {steps} replays hold all {full} device records")
    check(all(r[w] == per_step for r in whole for w in GRAM_KERNELS)
          and all(r[w] <= per_step for r in replays.values() for w in GRAM_KERNELS),
          f"{label}: gram kernels a replay {[{w: r[w] for w in GRAM_KERNELS} for r in whole][:3]}"
          f" != {per_step} each")
    return ({w: per_step * steps for w in GRAM_KERNELS},
            {"records_a_replay": full, "whole_replays": len(whole),
             "lost_records": sum(full - r["records"] for r in replays.values()),
             "gram_records": {w: sum(r[w] for r in replays.values())
                              for w in GRAM_KERNELS}})


def _launch_rows(label, eager, traced_n, traced, device_us, replay_trace, captures=1):
    """Each gram kernel's row for the kernels line: the wrappers' eager
    launches ``eager`` (the warm-up steps of ``captures`` captures: a
    capture launches nothing and replays do not call the wrappers) plus
    the replayed ones ``traced_n`` of the traced block ``traced`` (start,
    steps; ``_replay_launches``, whose numbers are ``replay_trace``), with
    ``device_us`` a traced step.  Checks one eager launch each a warm-up
    step and one replayed launch each a traced step."""
    check(all(n == captures * GRAPH_WARMUP_STEPS for n in eager.values()),
          f"{label}: eager launches {eager} != {captures} x {GRAPH_WARMUP_STEPS} "
          f"warm-up steps each")
    check(all(n == traced[1] for n in traced_n.values()),
          f"{label}: traced launches {traced_n} != {traced[1]} steps each")
    return {w: {"launches": eager[w] + traced_n[w], "eager": eager[w],
                "traced": traced_n[w], "traced_steps": list(traced),
                "traced_records": replay_trace["gram_records"][w],
                "trace_lost_records": replay_trace["lost_records"],
                "device_us_per_step": device_us[w]}
            for w in GRAM_KERNELS}


def _measured_launches(label, run_dir, traced):
    """Each gram kernel's launches in a CLI run (``_launch_rows``): the
    wrappers' counts since the last reset and the replays in the trace of
    the run's --profile window ``traced`` (start, steps), one graph block,
    K1 by its SYRK pass (``_replay_launches``); and the kernels a traced
    step."""
    eager = cuda_gram.launch_counts()
    with open(os.path.join(run_dir, "profile", "trace.json")) as fh:
        events = json.load(fh)["traceEvents"]
    kernels = [e for e in events if str(e.get("cat", "")).lower() == "kernel"]
    names = [e.get("name", "") for e in kernels]
    check(names, f"{label}: the profile window's trace holds no kernel")
    traced_n, replay_trace = _replay_launches(label, *_trace_records(events), traced[1])
    device_us = {w: sum(e.get("dur", 0.0) for e in kernels
                        if any(k in e.get("name", "") for k in ks)) / traced[1]
                 for w, ks in WRAPPER_KERNELS.items()}
    return (_launch_rows(label, eager, traced_n, traced, device_us, replay_trace),
            len(names) / traced[1])


def _block_rates(timings, kind):
    """Steps/s of each block of ``kind`` after the first (which captures)."""
    return [n / seconds for n, seconds in timings[kind][1:]]


def _block_rate(timings, kind):
    """Steps/s of the last block of ``kind`` (the first graph block also
    captures)."""
    n, seconds = timings[kind][-1]
    return n / seconds


def _pde_setup(ts_tree, steps_per_call, use_graph, laplacian_probes=0):
    """The E4 model, problem and sampler with the CLI's optimizer (RMSprop,
    cosine over PDE_ITERS), a block of ``steps_per_call`` steps and a
    TrainState loaded from ``ts_tree``."""
    model, operator, _, sampler, importance = _e4_setup(
        DEVICE, laplacian_probes=laplacian_probes)
    method = NestedLoRA(model, neigs=NEIGS, sequential=True)
    optimizer = build_optimizer("rmsprop", LR, lr_schedule=cosine_annealing(LR, PDE_ITERS))
    block = make_scanned_train_step(method, operator, optimizer, sampler,
                                    importance=importance, ema_decay=EMA_DECAY,
                                    steps_per_call=steps_per_call, seed=SEED,
                                    use_graph=use_graph)
    ts = init_train_state(model, optimizer, method)
    load_state_tree(ts, ts_tree)
    return ts, block


def _state_excess(got, want, rtol=PDE_STATE_RTOL, atol=PDE_STATE_ATOL):
    """Largest |got - want| over (rtol·|want| + atol·max|want|), leaf by leaf,
    and whether every leaf is equal bit for bit."""
    if isinstance(want, torch.Tensor):
        if not want.is_floating_point():
            return (0.0 if torch.equal(got, want) else float("inf")), torch.equal(got, want)
        return _excess(got, want, rtol, atol), torch.equal(got, want)
    items = (zip(got, want) if isinstance(want, (list, tuple))
             else ((got[k], want[k]) for k in want))
    worst, same = 0.0, True
    for a, b in items:
        e, eq = _state_excess(a, b, rtol, atol)
        worst, same = max(worst, e), same and eq
    return worst, same


def _profiled(fn, steps, per_step=1):
    """``fn()`` (``steps`` replays of a captured train step) under
    torch.profiler, the window opened and closed on an idle device (see
    PROFILE_MARGIN_S): device busy share, device records ("kernels") and
    device ms a step, each gram kernel's launches ("counts", by wrapper,
    ``per_step`` each a replay: ``_replay_launches``, whose numbers are
    "replay_trace") and each wrapper's device µs a step (all its CUDA
    kernels), and the costliest kernels.  It reads the profiler's own
    records: ``key_averages`` and a chrome trace of the north star's
    traced block (~257k kernels) took ~35 s more together on an H100."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        time.sleep(PROFILE_MARGIN_S)
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_s = time.perf_counter() - t0
        time.sleep(PROFILE_MARGIN_S)
    launches, device = [], []
    for e in prof.profiler.kineto_results.events():
        if e.device_type() == torch.autograd.DeviceType.CUDA:
            device.append((e.name(), e.correlation_id(), e.duration_ns() / 1e3))
        elif e.name() == "cudaGraphLaunch":
            launches.append(e.correlation_id())
    check(device, "the profiler recorded no CUDA kernel in a replayed block")
    counts, replay_trace = _replay_launches("replayed block", launches, device, steps, per_step)
    by_name = {}
    for name, _, us in device:
        n, total = by_name.get(name, (0, 0.0))
        by_name[name] = (n + 1, total + us)
    device_us_total = sum(us for _, us in by_name.values())
    top = sorted(by_name.items(), key=lambda kv: kv[1][1], reverse=True)[:TOP_KERNELS]
    return {"steps": steps, "wall_ms_per_step": wall_s / steps * 1e3,
            "device_ms_per_step": device_us_total / steps / 1e3,
            "device_busy_share": device_us_total / 1e6 / wall_s,
            "kernels_per_step": len(device) / steps,
            "counts": counts, "replay_trace": replay_trace,
            "device_us_per_step": {w: sum(us for name, (_, us) in by_name.items()
                                          if any(k in name for k in ks)) / steps
                                   for w, ks in WRAPPER_KERNELS.items()},
            "top_kernels": [{"name": name[:100], "ms_per_step": us / steps / 1e3,
                             "per_step": n / steps} for name, (n, us) in top]}


def _profile_block(block, ts, start, gram_per_step=1):
    """One replayed block under ``_profiled``, with each gram kernel's
    launches a step (checked to be ``gram_per_step`` in every replay)."""
    block(ts, start)  # captures
    n = block.steps_per_call
    prof = _profiled(lambda: block(ts, start + n), n, gram_per_step)
    per_step = {GRAM_KERNELS[w]: c / n for w, c in prof.pop("counts").items()}
    prof.pop("device_us_per_step")
    return {**prof, "gram_kernels_per_step": per_step}


@contextlib.contextmanager
def _traced_block(start):
    """Inside, the first ``ScannedTrainStep`` call of a block at iteration
    ``start`` runs under ``_profiled``; yields the dict that gets its
    result and "start".  A block that captures launches its warm-up steps
    eagerly, so ``_launch_rows`` refuses its counts: trace a replay."""
    traced = {}
    call = ScannedTrainStep.__call__

    def run(self, ts, s, n=None):
        if s != start or traced:
            return call(self, ts, s, n)
        out = []
        traced.update(_profiled(lambda: out.append(call(self, ts, s, n)),
                                self.steps_per_call if n is None else n), start=s)
        return out[0]

    ScannedTrainStep.__call__ = run
    try:
        yield traced
    finally:
        ScannedTrainStep.__call__ = call


def _traced_launches(label, traced, captures=1):
    """``_launch_rows`` of a ``_traced_block`` run, from the wrappers'
    counts since the last reset; fails if no block was traced."""
    check(traced, f"{label}: no block was traced")
    return _launch_rows(label, cuda_gram.launch_counts(), traced["counts"],
                        (traced["start"], traced["steps"]), traced["device_us_per_step"],
                        traced["replay_trace"], captures)


def phase_pde_cli():
    """The PDE entry point at full width, through its normal arguments."""
    e4 = PDE_E4_ARGV + ["--print_freq", str(PDE_BLOCK), "--eval_freq", str(PDE_EVAL)]
    evals = list(range(PDE_EVAL, PDE_ITERS + 1, PDE_EVAL))
    with tempfile.TemporaryDirectory() as tmp:
        # the E4 run: graph blocks, two evals
        timings = {}
        cuda_gram.reset_launch_counts()
        t0 = time.perf_counter()
        ts, eigvals, run_dir, records = _pde_run(
            e4 + ["--num_iters", str(PDE_ITERS)] + _profile_argv(PDE_E4_TRACED),
            os.path.join(tmp, "e4"), timings)
        run_s = time.perf_counter() - t0
        rows, health = _check_run("e4", ts, eigvals, run_dir, records, PDE_ITERS, evals)
        launches, traced_kernels = _measured_launches("e4", run_dir, PDE_E4_TRACED)
        check([n for n, _ in timings.get("block_graph", [])] == [PDE_BLOCK] * (
            PDE_ITERS // PDE_BLOCK) and "block_eager" not in timings,
              f"E4 blocks {timings}")
        tickets = {str(k): v for k, v in cuda_gram.ticket_values().items()}
        check(all(v == 0 for v in tickets.values()), f"K2 tickets {tickets}")
        trained = state_tree(ts)

        # --resume: the run of PDE_RESUME_ITERS finds the last checkpoint
        resume_argv = e4 + ["--num_iters", str(PDE_RESUME_ITERS), "--resume", "true"]
        resume_dir = os.path.join(tmp, "e4", run_name(parse_pde_config(resume_argv)))
        os.makedirs(resume_dir)
        shutil.copy(os.path.join(run_dir, f"ckpt_{PDE_ITERS}"), resume_dir)
        rtimings = {}
        rts, reigvals, _, rrecords = _pde_run(resume_argv, os.path.join(tmp, "e4"),
                                              rtimings)
        resumed = [r.args[1] for r in rrecords if r.msg.startswith("resuming from")]
        check(resumed == [PDE_ITERS], f"resume started at {resumed}")
        _check_run("resume", rts, reigvals, resume_dir, rrecords, PDE_RESUME_ITERS,
                   [PDE_RESUME_ITERS])
        check(len(rtimings.get("block_graph", [])) == (PDE_RESUME_ITERS - PDE_ITERS) // PDE_BLOCK,
              f"resumed blocks {rtimings}")

        # one block as a graph and as eager steps, from the trained state
        gts, graph = _pde_setup(trained, PDE_BLOCK, use_graph=True)
        graph(gts, PDE_ITERS)
        torch.cuda.synchronize()
        check(graph.graph is not None, "the block did not capture")
        tickets_after = {str(k): v for k, v in cuda_gram.ticket_values().items()}
        check(all(v == 0 for v in tickets_after.values()), f"K2 tickets {tickets_after}")
        ets, eager = _pde_setup(trained, PDE_BLOCK, use_graph=False)
        eager(ets, PDE_ITERS)
        excess, bitwise = _state_excess(state_tree(gts), state_tree(ets))
        check(excess <= 1.0, f"graph vs eager block: {excess:.3g}x tolerance")

        # one replayed block under the profiler
        pts, pblock = _pde_setup(trained, PDE_PROFILE_STEPS, use_graph=True)
        prof = _profile_block(pblock, pts, PDE_ITERS)

        # the README quick start's model: shared trunk, box mask, FD Laplacian
        cuda_gram.reset_launch_counts()
        dtimings = {}
        dts, deigvals, drun_dir, drecords = _pde_run(
            PDE_README_ARGV + ["--num_iters", str(PDE_DEFAULT_ITERS), "--print_freq",
                               str(PDE_DEFAULT_BLOCK), "--eval_freq",
                               str(PDE_DEFAULT_ITERS)] + _profile_argv(PDE_DEFAULT_TRACED),
            os.path.join(tmp, "readme"), dtimings)
        _check_run("readme", dts, deigvals, drun_dir, drecords, PDE_DEFAULT_ITERS,
                   [PDE_DEFAULT_ITERS])
        dlaunches, dtraced_kernels = _measured_launches("readme", drun_dir,
                                                        PDE_DEFAULT_TRACED)

        # steps/s through the CLI: eager, graph, graph, eager (no eval)
        rates = {"eager": [], "graph": []}
        for path in ("eager", "graph", "graph", "eager"):
            tt = {}
            _pde_run(PDE_E4_ARGV + ["--num_iters", str(PDE_TURN_ITERS), "--print_freq",
                                    str(PDE_BLOCK), "--eval_freq", str(10 ** 9)],
                     os.path.join(tmp, f"turn{len(rates[path])}{path}"), tt,
                     use_graph=(path == "graph"))
            rates[path].append(_block_rate(tt, f"block_{path}"))
    emit("pde_cli", argv=PDE_E4_ARGV, iters=PDE_ITERS, block=PDE_BLOCK,
         eval_freq=PDE_EVAL, run_s=run_s, launches=launches,
         traced_block_kernels_per_step=traced_kernels, tickets=tickets,
         rows=rows, eigvals=np.asarray(eigvals[-1]).tolist(), health=health,
         eval_s=timings["eval"], block_s=timings.get("block_graph"),
         graph_block_steps_per_s=_block_rate(timings, "block_graph"),
         resume={"started_at": resumed[0], "iters": PDE_RESUME_ITERS,
                 "eigvals": np.asarray(reigvals[-1]).tolist()},
         graph_vs_eager={"steps": PDE_BLOCK, "tol_used": excess, "bit_for_bit": bitwise,
                         "rtol": PDE_STATE_RTOL, "atol_of_max": PDE_STATE_ATOL},
         replayed_block_profile=prof,
         readme_model={"iters": PDE_DEFAULT_ITERS, "launches": dlaunches,
                       "traced_block_kernels_per_step": dtraced_kernels,
                       "eigvals": np.asarray(deigvals[-1]).tolist(),
                       "eval_s": dtimings["eval"],
                       "block_s": dtimings.get("block_graph")},
         cli_steps_per_s_in_turns={"order": ["eager", "graph", "graph", "eager"],
                                   "steps_per_block": PDE_BLOCK, **rates})
    return launches


def _with_flags(argv, **flags):
    """``argv`` with each ``--<flag>`` set to the given value (replaced
    where present, else appended)."""
    argv = list(argv)
    for flag, value in flags.items():
        name = "--" + flag
        if name in argv:
            argv[argv.index(name) + 1] = str(value)
        else:
            argv += [name, str(value)]
    return argv


def _recipe_argv(argv, iters, eval_freq, traced=None, **flags):
    out = _with_flags(argv, num_iters=iters, print_freq=RECIPE_BLOCK,
                      eval_freq=eval_freq, overwrite="true", **flags)
    return out + (_profile_argv(traced) if traced else [])


def _kernel_vs_plain_at_init(argv):
    """The CLI's run parts for ``argv`` (the model as built from --seed), a
    batch, and the kernel loss and grads against the plain path's on it
    at the JAX tolerances."""
    cfg = parse_pde_config(argv + ["--device", DEVICE])
    run = pde.build(cfg)
    plain = NestedLoRA(run.model, neigs=cfg.neigs, step=cfg.loss.neuralsvd.step,
                       sequential=cfg.loss.neuralsvd.sequential, use_pallas=False)
    check(run.method.use_pallas == "auto" and not plain.use_pallas, "loss routes")
    params = dict(run.model.named_parameters())
    x = run.sample(torch.Generator(device=DEVICE).manual_seed(SEED + 3))
    loss_k, grads_k, _, _ = run.method.loss_and_grad(params, {}, x, run.operator,
                                                     run.importance_train)
    loss_p, grads_p, _, _ = plain.loss_and_grad(params, {}, x, run.operator,
                                                run.importance_train)
    loss_rel = abs(loss_k.item() - loss_p.item()) / abs(loss_p.item())
    check(loss_rel <= LOSS_RTOL, f"kernel vs plain loss: rel {loss_rel:.3g}")
    return run, x, {"loss_rel": loss_rel, "grad_tol_used": _check_grads(grads_k, grads_p)}


def _kernel_vs_plain(argv, ts):
    """The recipe's kernel loss and grads against the plain path on one
    batch.  At the CLI's initial parameters (the model as built from
    --seed), at the JAX tolerances, as phase trainer does for E4.  At the
    trained parameters of ``ts`` neither float32 path meets those
    tolerances at every gradient entry (a float32 product of ~1e3 terms
    with cancellation), so there both are held against a float64
    evaluation of the same loss on the same (fs, Tf): the kernel path's
    worst gradient excess over the tolerance may not pass
    max(1, RECIPE_F64_FACTOR x the plain path's)."""
    run, x, init = _kernel_vs_plain_at_init(argv)
    params = dict(run.model.named_parameters())
    out = {"init": init}

    # the trained parameters: both float32 paths against float64
    with torch.no_grad():
        for k, p in params.items():
            p.copy_(ts.params[k])
    Tf, fs = run.operator(run.model, x, run.importance_train)
    fs, Tf = fs.contiguous(), Tf.contiguous()
    model64 = copy.deepcopy(run.model).double()
    params64 = dict(model64.named_parameters())
    fs64 = model64(x.double()).contiguous()
    masks = run.method.masks(DEVICE)
    names = list(params)
    losses, grads = {}, {}
    for path, loss_fn, f, ps, dtype in (
            ("kernel", nestedlora_evd_loss_kernels, fs, params, torch.float32),
            ("plain", nestedlora_evd_loss, fs, params, torch.float32),
            ("float64", nestedlora_evd_loss, fs64, params64, torch.float64)):
        loss = loss_fn(f, Tf.to(dtype), *torch.chunk(f, 2), *(m.to(dtype) for m in masks))
        grads[path] = torch.autograd.grad(loss, [ps[k] for k in names], retain_graph=True)
        losses[path] = loss.item()
    trained = {"loss_rel_kernel": abs(losses["kernel"] / losses["float64"] - 1),
               "loss_rel_plain": abs(losses["plain"] / losses["float64"] - 1), "grads": {}}
    for i, k in enumerate(names):
        ref = grads["float64"][i]
        e_k, e_p = (_excess(grads[path][i].double(), ref, GRAD_RTOL, GRAD_ATOL)
                    for path in ("kernel", "plain"))
        check(e_k <= max(1.0, RECIPE_F64_FACTOR * e_p),
              f"trained {k}: kernel {e_k:.3g}x, plain {e_p:.3g}x the tolerance vs float64")
        trained["grads"][k] = {"kernel_tol_used": e_k, "plain_tol_used": e_p}
    check(trained["loss_rel_kernel"] <= max(LOSS_RTOL, RECIPE_F64_FACTOR
                                            * trained["loss_rel_plain"]),
          f"trained loss vs float64: {trained}")
    out["trained_vs_float64"] = trained
    return run, x, out


def _records_of(records, prefix):
    return [r for r in records if r.msg.startswith(prefix)]


def _duplicate_mode(tree, neigs, src, dst):
    """Copy mode slot ``src`` to ``dst`` in every per-mode tensor (leading
    size ``neigs``) of a state tree's params, EMA and optimizer state."""
    def walk(t):
        if isinstance(t, torch.Tensor):
            if t.ndim and t.shape[0] == neigs:
                t[dst] = t[src]
        elif isinstance(t, dict):
            for v in t.values():
                walk(v)
        elif isinstance(t, (list, tuple)):
            for v in t:
                walk(v)

    for name in ("params", "ema_params", "opt_state"):
        walk(tree[name])


def _hydrogen_recipe(tmp, figures):
    """hydrogen.sh: a run to an eval checkpoint, a forced duplicate, then
    --resume: the next eval flags and rescues it in place and the graph
    blocks go on.  The resumed eval's figures are added to ``figures``."""
    src, dst = HYD_DUP
    first_argv = _recipe_argv(HYDROGEN_ARGV, HYD_FIRST, HYD_FIRST)
    ts, eigvals, first_dir, records = _pde_run(first_argv, os.path.join(tmp, "hyd"))
    _check_run("hydrogen", ts, eigvals, first_dir, records, HYD_FIRST, [HYD_FIRST],
               neigs=HYDROGEN_L)
    tree = load_checkpoint(os.path.join(first_dir, f"ckpt_{HYD_FIRST}"))
    _duplicate_mode(tree, HYDROGEN_L, src, dst)
    resume_argv = _recipe_argv(HYDROGEN_ARGV, HYD_ITERS, HYD_EVAL, HYD_TRACED,
                               resume="true")
    resume_dir = os.path.join(tmp, "hyd", run_name(parse_pde_config(resume_argv)))
    save_checkpoint(os.path.join(resume_dir, f"ckpt_{HYD_FIRST}"), tree)

    timings = {}
    cuda_gram.reset_launch_counts()
    t0 = time.perf_counter()
    with _figure_seconds(pde, ("plot_and_save_spectrum", "plot_2d_eigfuncs")) as drawn:
        ts, eigvals, run_dir, records = _pde_run(resume_argv, os.path.join(tmp, "hyd"),
                                                 timings)
    run_s = time.perf_counter() - t0
    figures += _figure_rows("pde_recipes hydrogen", run_dir, drawn, {
        f"eigfuncs2d_it{HYD_EVAL}.png": _grid_size(HYDROGEN_L),
        f"spectrum_it{HYD_EVAL}.png": (400, 1000)})
    launches, traced_kernels = _measured_launches("hydrogen", run_dir, HYD_TRACED)
    rows, health = _check_run("hydrogen-resumed", ts, eigvals, run_dir, records,
                              HYD_ITERS, [HYD_EVAL], neigs=HYDROGEN_L)
    check(any(f"DUPLICATE: mode {m} ~" in health[0] for m in (src, dst)),
          f"the health report misses the duplicate {src}/{dst}: {health[0]}")
    rescued = _records_of(records, "it%d rescue: exiled")
    check(len(rescued) == 1 and rescued[0].args[:1] == (HYD_EVAL,)
          and rescued[0].args[1] >= 1, f"rescue lines {[r.getMessage() for r in rescued]}")
    detail = _records_of(records, "it%d rescue: tail slots")
    check(len(detail) == 1, "no rescue detail line")
    _, tail, sources, factors = detail[0].args
    captures = _records_of(records, "captured a CUDA graph")
    check(len(captures) == 1, f"{len(captures)} captures in the resumed run")
    check([n for n, _ in timings.get("block_graph", [])]
          == [RECIPE_BLOCK] * ((HYD_ITERS - HYD_FIRST) // RECIPE_BLOCK)
          and "block_eager" not in timings, f"hydrogen blocks {timings}")
    # the state the rescue left (checkpointed right after it): the tail's
    # EMA equals its params, each slot differs from its clone source
    after = load_checkpoint(os.path.join(run_dir, f"ckpt_{HYD_EVAL}"))
    for k, p in after["params"].items():
        check(torch.equal(after["ema_params"][k][tail], p[tail]), f"tail EMA of {k}")
    for t, s in zip(tail, sources):
        check(any(not torch.equal(p[t], p[s]) for p in after["params"].values()),
              f"rescued slot {t} equals its clone source {s}")
    _, _, check_ = _kernel_vs_plain(resume_argv, ts)
    return {"argv": HYDROGEN_ARGV, "first_iters": HYD_FIRST, "duplicated": [src, dst],
            "resumed_to": HYD_ITERS, "eval": HYD_EVAL, "run_s": run_s,
            "health_at_rescue": health[0], "n_spurious": rescued[0].args[1],
            "tail_slots": tail, "clone_sources": sources, "amplitude_factors": factors,
            "graph_captures": len(captures), "rows": rows,
            "eigvals": np.asarray(eigvals[-1]).tolist(), "launches": launches,
            "traced_block_kernels_per_step": traced_kernels,
            "kernel_vs_plain": check_, "eval_s": timings["eval"],
            "block_s": timings.get("block_graph"),
            "graph_block_steps_per_s": _block_rate(timings, "block_graph")}


def _oscillator_recipe(tmp):
    """oscillator.sh: graph blocks and one eval; the learned mask scales
    move off their init; the forward-Laplacian engine runs the exp-masked
    model with no fallback call."""
    argv = _recipe_argv(OSCILLATOR_ARGV, OSC_ITERS, OSC_ITERS, OSC_TRACED)
    timings = {}
    cuda_gram.reset_launch_counts()
    t0 = time.perf_counter()
    ts, eigvals, run_dir, records = _pde_run(argv, os.path.join(tmp, "osc"), timings)
    run_s = time.perf_counter() - t0
    launches, traced_kernels = _measured_launches("oscillator", run_dir, OSC_TRACED)
    rows, health = _check_run("oscillator", ts, eigvals, run_dir, records, OSC_ITERS,
                              [OSC_ITERS], neigs=OSCILLATOR_L)
    check([n for n, _ in timings.get("block_graph", [])]
          == [RECIPE_BLOCK] * (OSC_ITERS // RECIPE_BLOCK) and "block_eager" not in timings,
          f"oscillator blocks {timings}")
    scales = ts.params["mask.scales"].detach()
    check(scales.shape == (OSCILLATOR_L,) and torch.isfinite(scales).all().item()
          and (scales != 10.0).all().item(), f"mask scales {scales}")
    run, x, check_ = _kernel_vs_plain(argv, ts)
    # the exact Laplacian of the exp-masked model by the forward engine
    # (the recipe itself takes finite differences): no fallback call, and
    # nested JVPs agree
    forward_laplacian.fallback_rule.calls = 0
    lap_excess = _forward_vs_jvp(run.model, x, run.importance_train)
    fallbacks = forward_laplacian.fallback_rule.calls
    check(fallbacks == 0, f"{fallbacks} fallback-rule calls on the exp-masked model")
    return {"argv": OSCILLATOR_ARGV, "iters": OSC_ITERS, "run_s": run_s, "rows": rows,
            "eigvals": np.asarray(eigvals[-1]).tolist(), "health": health,
            "mask_scales": [scales.min().item(), scales.max().item()],
            "launches": launches, "traced_block_kernels_per_step": traced_kernels,
            "kernel_vs_plain": check_, "forward_vs_jvp_tol_used": lap_excess,
            "fallback_calls": fallbacks, "eval_s": timings["eval"],
            "block_s": timings.get("block_graph"),
            "graph_block_steps_per_s": _block_rate(timings, "block_graph")}


def phase_pde_recipes(figures):
    """The paper's two PDE recipes through the PDE entry point at full width
    (hydrogen's figures added to ``figures``)."""
    with tempfile.TemporaryDirectory() as tmp:
        hydrogen = _hydrogen_recipe(tmp, figures)
        oscillator = _oscillator_recipe(tmp)
    emit("pde_recipes", block=RECIPE_BLOCK, hydrogen=hydrogen, oscillator=oscillator)
    return {"hydrogen": hydrogen["launches"], "oscillator": oscillator["launches"]}


def _graph_vs_eager(cfg, trained, start):
    """One block of RECIPE_BLOCK steps from the state ``trained`` as a
    replayed graph and as eager steps, same seed, each on the CLI's run
    parts: (excess over PDE_STATE_RTOL/ATOL, bit for bit)."""
    states = []
    for use_graph in (True, False):
        run = pde.build(cfg)
        block = make_scanned_train_step(
            run.method, run.operator, run.optimizer, run.sample,
            importance=run.importance_train, ema_decay=cfg.ema_decay,
            steps_per_call=RECIPE_BLOCK, grad_clip=cfg.grad_clip, seed=cfg.seed,
            use_graph=use_graph)
        ts = init_train_state(run.model, run.optimizer, run.method)
        load_state_tree(ts, trained)
        block(ts, start)
        torch.cuda.synchronize()
        check((block.graph is not None) == use_graph, "graph vs eager: capture")
        states.append(state_tree(ts))
    excess, bitwise = _state_excess(*states)
    check(excess <= 1.0, f"graph vs eager block: {excess:.3g}x tolerance")
    return {"steps": RECIPE_BLOCK, "tol_used": excess, "bit_for_bit": bitwise}


def _neuralef_card_vs_cpu(cfg, ts):
    """NeuralEF's loss, grads and new norm state at the trained state on
    NEF_CPU_ROWS rows, on the card against a CPU copy, model and operator
    in float64 (finite differences at eps 0.01 would leave two float32
    evaluations ~1e-3 apart): rtol NEF_CPU_RTOL, grads also atol 1e-6 of
    the largest entry."""
    out = {}
    for dev in (DEVICE, "cpu"):  # the batch is drawn on the card
        run = pde.build(cfg, dev)
        if dev == DEVICE:
            x = run.sample(torch.Generator(device=DEVICE).manual_seed(SEED + 4))
            x = x[:NEF_CPU_ROWS].double()
        run.model.double()
        params = dict(run.model.named_parameters())
        with torch.no_grad():
            for k, p in params.items():
                p.copy_(ts.params[k])
        state = {k: v.to(dev, torch.float64 if v.is_floating_point() else v.dtype)
                 for k, v in ts.method_state.items()}
        loss, grads, _, new_state = run.method.loss_and_grad(
            params, state, x.to(dev), run.operator, run.importance_train)
        out[dev] = (loss.item(), {k: g.cpu() for k, g in grads.items()},
                    {k: v.cpu() for k, v in new_state.items()})
    (loss_g, grads_g, state_g), (loss_c, grads_c, state_c) = out[DEVICE], out["cpu"]
    loss_rel = abs(loss_g / loss_c - 1)
    check(loss_rel <= NEF_CPU_RTOL, f"NeuralEF card vs CPU loss: rel {loss_rel:.3g}")
    grad_excess = max(_excess(grads_g[k], r, NEF_CPU_RTOL, GRAD_ATOL) for k, r in grads_c.items())
    check(grad_excess <= 1.0, f"NeuralEF card vs CPU grads: {grad_excess:.3g}x tolerance")
    for k, v in state_c.items():
        check(torch.allclose(state_g[k], v, rtol=NEF_CPU_RTOL, atol=0.0),
              f"NeuralEF card vs CPU state {k}")
    return {"rows": NEF_CPU_ROWS, "loss_rel": loss_rel, "grad_tol_used": grad_excess}


def _neuralef_hydrogen(tmp):
    """hydrogen.sh with --loss neuralef: graph blocks, one eval, the norm
    EMA, graph vs eager, card vs CPU."""
    argv = _recipe_argv(_with_flags(HYDROGEN_ARGV, loss="neuralef"), NEF_ITERS, NEF_ITERS)
    cfg = parse_pde_config(argv + ["--device", DEVICE])
    check(cfg.loss.name == "neuralef" and cfg.loss.neuralef.unbiased
          and cfg.loss.neuralef.batchnorm_mode == "unbiased", f"NeuralEF flags {cfg.loss}")
    timings = {}
    cuda_gram.reset_launch_counts()
    t0 = time.perf_counter()
    ts, eigvals, run_dir, records = _pde_run(argv, os.path.join(tmp, "nef"), timings)
    run_s = time.perf_counter() - t0
    counts = cuda_gram.launch_counts()
    check(not any(counts.values()), f"NeuralEF launched gram kernels: {counts}")
    rows, health = _check_run("neuralef", ts, eigvals, run_dir, records, NEF_ITERS,
                              [NEF_ITERS], neigs=HYDROGEN_L)
    check([n for n, _ in timings.get("block_graph", [])]
          == [RECIPE_BLOCK] * (NEF_ITERS // RECIPE_BLOCK) and "block_eager" not in timings,
          f"NeuralEF blocks {timings}")
    captures = _records_of(records, "captured a CUDA graph")
    check(len(captures) == 1, f"{len(captures)} captures in the NeuralEF run")
    state = ts.method_state
    norms = {k: state[k].detach().cpu() for k in ("norm_biased", "norm_unbiased")}
    check(bool(state["initialized"]) and all(
        torch.isfinite(v).all().item() and (v != 1.0).all().item() for v in norms.values()),
          f"NeuralEF norm state {state}")
    trained = state_tree(ts)
    return {"argv": argv, "iters": NEF_ITERS, "run_s": run_s, "rows": rows,
            "eigvals": np.asarray(eigvals[-1]).tolist(), "health": health,
            "gram_kernel_launches": counts,
            "norm_unbiased": [norms["norm_unbiased"].min().item(),
                              norms["norm_unbiased"].max().item()],
            "graph_vs_eager": _graph_vs_eager(cfg, trained, NEF_ITERS),
            "card_vs_cpu": _neuralef_card_vs_cpu(cfg, ts),
            "eval_s": timings["eval"], "block_s": timings.get("block_graph"),
            "graph_block_steps_per_s": _block_rate(timings, "block_graph")}


def _fokker_planck(tmp):
    """The 2D Fokker–Planck recipe: graph blocks, one eval, the kernels
    once a step, no fallback rule, kernel vs plain at the initial
    parameters; λ₀ − shift printed."""
    argv = _recipe_argv(FP_ARGV, FP_ITERS, FP_ITERS, FP_TRACED)
    timings = {}
    cuda_gram.reset_launch_counts()
    forward_laplacian.fallback_rule.calls = 0
    t0 = time.perf_counter()
    ts, eigvals, run_dir, records = _pde_run(argv, os.path.join(tmp, "fp"), timings)
    run_s = time.perf_counter() - t0
    fallbacks = forward_laplacian.fallback_rule.calls
    check(fallbacks == 0, f"{fallbacks} fallback-rule calls on the Fokker–Planck path")
    launches, traced_kernels = _measured_launches("fp", run_dir, FP_TRACED)
    rows, health = _check_run("fp", ts, eigvals, run_dir, records, FP_ITERS, [FP_ITERS],
                              neigs=FP_L)
    check([n for n, _ in timings.get("block_graph", [])]
          == [RECIPE_BLOCK] * (FP_ITERS // RECIPE_BLOCK) and "block_eager" not in timings,
          f"Fokker–Planck blocks {timings}")
    _, _, init = _kernel_vs_plain_at_init(argv)
    learned = np.asarray(eigvals[-1])
    return {"argv": FP_ARGV, "iters": FP_ITERS, "run_s": run_s, "rows": rows,
            "eigvals": learned.tolist(), "learned_minus_shift": (learned - FP_SHIFT).tolist(),
            "lambda0_minus_shift": float(learned.max() - FP_SHIFT), "health": health,
            "launches": launches, "traced_block_kernels_per_step": traced_kernels,
            "kernel_vs_plain_init": init, "fallback_calls": fallbacks,
            "eval_s": timings["eval"], "block_s": timings.get("block_graph"),
            "graph_block_steps_per_s": _block_rate(timings, "block_graph")}


def _rbf(x, y):
    return torch.exp(-0.5 * torch.sum((x[:, None, :] - y[None, :, :]) ** 2, dim=-1))


def _nystrom():
    """Nyström with numpy samples and no device: the samples, the empirical
    kernel and the extension on the card, equal to the CPU run."""
    rng = np.random.default_rng(SEED)
    xs = rng.uniform(-np.pi, np.pi, (NY_TRAIN, 2)).astype(np.float32)
    xval = rng.uniform(-np.pi, np.pi, (NY_VAL, 2)).astype(np.float32)
    check(Nystrom(_rbf, xs[:8], 2).xs.is_cuda, "Nyström left its samples on the host")
    t0 = time.perf_counter()
    ev, ef, evd_s = run_nystrom(_rbf, FP_L, xs, xval)
    run_s = time.perf_counter() - t0
    ev_c, ef_c, _ = run_nystrom(_rbf, FP_L, xs, xval, device="cpu")
    signs = np.sign(np.sum(ef * ef_c, axis=0))
    ev_err = float(np.max(np.abs(ev - ev_c) / np.abs(ev_c)))
    ef_err = float(np.max(np.abs(ef * signs - ef_c)) / np.max(np.abs(ef_c)))
    check(ev_err <= NY_RTOL and ef_err <= NY_RTOL,
          f"Nyström on the card vs the CPU: eigvals {ev_err}, eigenfunctions {ef_err}")
    return {"train": NY_TRAIN, "val": NY_VAL, "neigs": FP_L, "eigvals": ev.tolist(),
            "eigvals_rel_err": ev_err, "eigfuncs_err": ef_err, "run_s": run_s,
            "evd_s": evd_s}


def phase_pde_methods():
    """NeuralEF on hydrogen.sh and the Fokker–Planck recipe through the
    PDE entry point, and Nyström on the FP domain."""
    with tempfile.TemporaryDirectory() as tmp:
        neuralef = _neuralef_hydrogen(tmp)
        fp = _fokker_planck(tmp)
    emit("pde_methods", block=RECIPE_BLOCK, neuralef=neuralef, fokker_planck=fp,
         nystrom=_nystrom())
    return {"fp": fp["launches"]}


def _to(tree, device, dtype):
    """A nest of dicts of tensors on ``device``, floating ones in ``dtype``."""
    if isinstance(tree, dict):
        return {k: _to(v, device, dtype) for k, v in tree.items()}
    return tree.to(device, dtype if tree.is_floating_point() else tree.dtype)


def _spin_card_vs_cpu(cfg, ts):
    """One loss_and_grad of the run's method at the trained state on
    SPIN_CPU_ROWS rows, on the card and on a CPU copy, model, operator and
    state in float64 (finite differences at eps 0.01 leave two float32
    evaluations ~1e-3 apart): loss, grads and the new state at rtol
    SPIN_CPU_RTOL, atol 1e-6 of each tensor's largest entry."""
    out = {}
    for dev in (DEVICE, "cpu"):  # the batch is drawn on the card
        run = pde.build(cfg, dev)
        if dev == DEVICE:
            x = run.sample(torch.Generator(device=DEVICE).manual_seed(SEED + 5))
            x = x[:SPIN_CPU_ROWS].double()
        run.model.double()
        params = dict(run.model.named_parameters())
        with torch.no_grad():
            for k, p in params.items():
                p.copy_(ts.params[k])
        loss, grads, _, state = run.method.loss_and_grad(
            params, _to(ts.method_state, dev, torch.float64), x.to(dev), run.operator,
            run.importance_train)
        out[dev] = (loss.item(), clone_tree(grads, "cpu"), clone_tree(state, "cpu"))
        del run, params, grads, state
    (loss_g, grads_g, state_g), (loss_c, grads_c, state_c) = out[DEVICE], out["cpu"]
    loss_rel = abs(loss_g / loss_c - 1)
    check(loss_rel <= SPIN_CPU_RTOL, f"{cfg.loss.name} card vs CPU loss: rel {loss_rel:.3g}")
    grad_excess, _ = _state_excess(grads_g, grads_c, SPIN_CPU_RTOL, GRAD_ATOL)
    state_excess, _ = _state_excess(state_g, state_c, SPIN_CPU_RTOL, GRAD_ATOL)
    check(grad_excess <= 1.0 and state_excess <= 1.0,
          f"{cfg.loss.name} card vs CPU: grads {grad_excess:.3g}x, state "
          f"{state_excess:.3g}x the tolerance")
    return {"rows": SPIN_CPU_ROWS, "loss_rel": loss_rel, "grad_tol_used": grad_excess,
            "state_tol_used": state_excess}


def _spin_compact_vs_dense(argv):
    """SpIN at hydrogen.sh's widths with L SPIN_SMALL_L on the card: the
    compact j_avg (L passes) against the dense one (L² one-hot passes) over
    two steps on the same batches: grads and the diagonal blocks at rtol
    SPIN_DENSE_RTOL, atol 1e-6 of the largest entry; the blocks off the
    diagonal exactly zero."""
    cfg = parse_pde_config(_with_flags(argv, neigs=SPIN_SMALL_L) + ["--device", DEVICE])
    run = pde.build(cfg)
    compact = run.method
    dense = SpIN(run.model, SPIN_SMALL_L, decay=cfg.loss.spin.decay)
    dense.per_mode = frozenset()
    params = dict(run.model.named_parameters())
    check(compact.per_mode == set(params), f"per-mode leaves {sorted(compact.per_mode)}")
    states = [m.init_state(params) for m in (compact, dense)]
    gen = torch.Generator(device=DEVICE).manual_seed(SEED + 6)
    for _ in range(2):
        x = run.sample(gen)
        grads = [m.loss_and_grad(params, st, x, run.operator, run.importance_train)[1]
                 for m, st in zip((compact, dense), states)]
    torch.cuda.synchronize()
    grad_excess, _ = _state_excess(grads[0], grads[1], SPIN_DENSE_RTOL, GRAD_ATOL)
    off = ~torch.eye(SPIN_SMALL_L, dtype=torch.bool, device=DEVICE)
    diag = {k: torch.diagonal(j, dim1=1, dim2=2).movedim(-1, 1)
            for k, j in states[1]["j_avg"].items()}
    check(not any(j[:, off].any().item() for j in states[1]["j_avg"].values()),
          "dense j_avg: a block off the diagonal is not zero")
    j_excess, _ = _state_excess(states[0]["j_avg"], diag, SPIN_DENSE_RTOL, GRAD_ATOL)
    check(grad_excess <= 1.0 and j_excess <= 1.0,
          f"compact vs dense: grads {grad_excess:.3g}x, j_avg {j_excess:.3g}x the tolerance")
    return {"L": SPIN_SMALL_L, "compact_bytes": compact.state_bytes(params),
            "dense_bytes": dense.state_bytes(params), "grad_tol_used": grad_excess,
            "j_avg_tol_used": j_excess}


def _range_device_ms(trace_path, names, steps):
    """Device ms a step of the kernels, copies and fills launched inside
    each profiler range of ``names`` (by the host time of their launch,
    which finds the backward's kernels too: the autograd engine launches
    them from its own thread while the range's thread waits), and of all
    of them, from a chrome trace of ``steps`` eager steps."""
    with open(trace_path) as fh:
        events = json.load(fh)["traceEvents"]
    launched = {e["args"]["correlation"]: e["ts"] for e in events
                if e.get("cat") == "cuda_runtime" and "correlation" in e.get("args", {})}
    device = [e for e in events if e.get("cat") in ("kernel", "gpu_memcpy", "gpu_memset")]
    ranges = [(e["name"], e["ts"], e["ts"] + e["dur"]) for e in events
              if e.get("cat") in ("user_annotation", "cpu_op") and e.get("name") in names]
    out = dict.fromkeys(names, 0.0)
    for e in device:
        t = launched.get(e.get("args", {}).get("correlation"))
        for name, t0, t1 in ranges:
            if t is not None and t0 <= t <= t1:
                out[name] += e["dur"]
                break
    total = sum(e["dur"] for e in device)
    return {k: v / steps / 1e3 for k, v in out.items()}, total / steps / 1e3


def _spin_step_parts(cfg, trained, start):
    """Where a SpIN step's time goes: the device ms of each of its profiler
    ranges (SPIN_PARTS) a step over SPIN_EAGER_PROFILED eager steps, and a
    replayed block of SPIN_REPLAYED steps under the profiler (device busy
    share, device ms, kernels a step and the costliest kernels), from the
    trained state."""
    from torch.profiler import ProfilerActivity, profile

    run = pde.build(cfg)
    block = make_scanned_train_step(
        run.method, run.operator, run.optimizer, run.sample,
        importance=run.importance_train, ema_decay=cfg.ema_decay,
        steps_per_call=SPIN_REPLAYED, grad_clip=cfg.grad_clip, seed=cfg.seed)
    ts = init_train_state(run.model, run.optimizer, run.method)
    load_state_tree(ts, trained)
    block.begin_block(DEVICE, start)
    block.eager_step(ts)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        time.sleep(PROFILE_MARGIN_S)
        for i in range(SPIN_EAGER_PROFILED):
            block.begin_block(DEVICE, start + 1 + i)  # rewinds the traces
            block.eager_step(ts)
        torch.cuda.synchronize()
        time.sleep(PROFILE_MARGIN_S)
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "trace.json")
        prof.export_chrome_trace(path)
        parts, eager_ms = _range_device_ms(path, SPIN_PARTS, SPIN_EAGER_PROFILED)
    check(all(v > 0 for v in parts.values()), f"SpIN step parts without device time: {parts}")
    return {"eager_device_ms_per_step": parts, "eager_total_device_ms_per_step": eager_ms,
            "replayed": _profile_block(block, ts, start + 1, gram_per_step=0)}


def _spin_hydrogen(tmp, loss):
    """hydrogen.sh with --loss spin|spinx: graph blocks, two evals (the
    rescue's window includes the first), the method state, the checkpoint,
    graph vs eager, card vs CPU; for SpIN also where a step's time goes."""
    argv = _recipe_argv(_with_flags(HYDROGEN_ARGV, loss=loss), SPIN_ITERS, SPIN_EVAL)
    cfg = parse_pde_config(argv + ["--device", DEVICE])
    check(cfg.loss.name == loss and cfg.loss.spin.decay == 0.01 and cfg.rescue
          and cfg.laplacian_eps == 0.01 and cfg.neigs == HYDROGEN_L, f"{loss} flags {cfg}")
    timings = {}
    cuda_gram.reset_launch_counts()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    ts, eigvals, run_dir, records = _pde_run(argv, os.path.join(tmp, loss), timings)
    run_s = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated()
    counts = cuda_gram.launch_counts()
    check(not any(counts.values()), f"{loss} launched gram kernels: {counts}")
    evals = list(range(SPIN_EVAL, SPIN_ITERS + 1, SPIN_EVAL))
    rows, health = _check_run(loss, ts, eigvals, run_dir, records, SPIN_ITERS, evals,
                              neigs=HYDROGEN_L)
    check([n for n, _ in timings.get("block_graph", [])]
          == [RECIPE_BLOCK] * (SPIN_ITERS // RECIPE_BLOCK) and "block_eager" not in timings,
          f"{loss} blocks {timings}")
    captures = _records_of(records, "captured a CUDA graph")
    check(len(captures) == 1, f"{len(captures)} captures in the {loss} run")
    n_params = sum(p.numel() for p in ts.params.values())
    state = ts.method_state
    out = {"argv": argv, "iters": SPIN_ITERS, "evals": evals, "run_s": run_s, "rows": rows,
           "eigvals": np.asarray(eigvals[-1]).tolist(), "health": health,
           "rescues": [r.getMessage() for r in _records_of(records, "it%d rescue: exiled")],
           "gram_kernel_launches": counts, "params": n_params, "peak_mem_bytes": peak,
           "eval_s": timings["eval"], "block_s": timings["block_graph"],
           "graph_block_steps_per_s": _block_rate(timings, "block_graph"),
           "checkpoint_bytes": os.path.getsize(os.path.join(run_dir, f"ckpt_{SPIN_ITERS}")),
           "checkpoint_s": timings["checkpoint"]}
    check(all(torch.isfinite(v).all().item() for v in (state["sigma_avg"], state["chol"])),
          f"{loss} state not finite")
    if loss == "spin":
        j_bytes = sum(j.numel() * j.element_size() for j in state["j_avg"].values())
        check(j_bytes == HYDROGEN_L * n_params * 4, f"j_avg holds {j_bytes} bytes")
        check(all(torch.isfinite(j).all().item() for j in state["j_avg"].values()),
              "j_avg not finite")
        out.update(j_avg_bytes=j_bytes, dense_j_avg_bytes=HYDROGEN_L ** 2 * n_params * 4)
    else:
        w = state["weights"]
        check(torch.isfinite(w).all().item() and not (w == 1).all().item(),
              f"SpINx weights {w}")
        out.update(weights=[w.min().item(), w.max().item()],
                   refresh_s=timings["spinx_refresh"])
    trained = state_tree(ts)
    out["graph_vs_eager"] = _graph_vs_eager(cfg, trained, SPIN_ITERS)
    out["card_vs_cpu"] = _spin_card_vs_cpu(cfg, ts)
    if loss == "spin":
        out["step_parts"] = _spin_step_parts(cfg, trained, SPIN_ITERS)
    return out


def phase_pde_spin():
    """SpIN and SpINx on hydrogen.sh through the PDE entry point, and the
    compact j_avg against the dense one."""
    with tempfile.TemporaryDirectory() as tmp:
        spin = _spin_hydrogen(tmp, "spin")
        spinx = _spin_hydrogen(tmp, "spinx")
    emit("pde_spin", block=RECIPE_BLOCK, spin=spin, spinx=spinx,
         compact_vs_dense=_spin_compact_vs_dense(_with_flags(HYDROGEN_ARGV, loss="spin")))


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

        def fwd_bwd(fn):
            a, b = fx.detach().requires_grad_(), gy.detach().requires_grad_()
            return torch.autograd.grad(fn(True, a, b, vmask, mmask, bw)[0], [a, b])

        # forward + backward, CUDA events, as _packaging_row times the EVD one
        rel["ms"] = time_ms(lambda: fwd_bwd(nestedlora_cdk_loss_kernels))
        rel["plain_ms"] = time_ms(lambda: fwd_bwd(nestedlora_cdk_loss))
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
    return counts, _cdk_quality(rows)


def _cdk_quality(rows):
    last = rows[-1]
    return {k: float(last[k]) for k in ("test_P@K", "test_mAP@all", "valid_P@K",
                                         "valid_mAP@all")}


def _bf16_products_vs_float64(model, x):
    """Each layer of the bf16 x tower on the card against a float64
    product of the same bf16 operands (the card's own bf16 input to that
    layer), with cuBLAS's bf16 reduced-precision reduction on (PyTorch's
    default, what the port runs) and off: the excess over the tolerance,
    the largest error of the largest entry, and the ms of the layer's
    product each way."""
    matmul = torch.backends.cuda.matmul
    default = matmul.allow_bf16_reduced_precision_reduction
    tower = model.x
    out = {}
    for reduced in (default, not default):
        matmul.allow_bf16_reduced_precision_reduction = reduced
        try:
            h = x.to(torch.bfloat16)
            layers = []
            for i, layer in enumerate(tower.layers):
                w, b = layer.w.detach().to(torch.bfloat16), layer.b.detach().to(torch.bfloat16)
                prod = tower_product("bi,io->bo", h, w)
                ref = h.double() @ w.double()
                tol = BF16_RTOL * ref.abs() + BF16_ATOL * ref.abs().max()
                layers.append({"depth": int(w.shape[0]), "width": int(w.shape[1]),
                               "tol_used": ((prod.double() - ref).abs() / tol).max().item(),
                               "max_err": ((prod.double() - ref).abs().max()
                                           / ref.abs().max()).item(),
                               "ms": time_ms(lambda: tower_product("bi,io->bo", h, w),
                                             iters=20, reps=5)})
                h = prod + b
                if i < len(tower.layers) - 1:
                    h = tower.act(h)
        finally:
            matmul.allow_bf16_reduced_precision_reduction = default
        out["reduced_on" if reduced else "reduced_off"] = layers
    worst = max(r["tol_used"] for r in out["reduced_on" if default else "reduced_off"])
    check(worst <= 1.0, f"bf16 tower products vs float64: {worst:.3g}x tolerance")
    return out


def _timed_steps(tr, batches, n, tf32=False):
    """ms a step of ``n`` bare train steps of ``tr`` on device batches;
    ``tf32`` sets cuBLAS's TF32 switch around them (a measurement only)."""
    matmul = torch.backends.cuda.matmul
    old = matmul.allow_tf32
    matmul.allow_tf32 = tf32
    try:
        skips = torch.zeros((), dtype=torch.int32, device=DEVICE)
        params, opt_state = tr.params, tr.opt_state
        losses = []
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for i in range(n):
            x, y = batches[i % len(batches)]
            params, opt_state, _, loss, _, skips = tr.step(params, opt_state, {}, x, y, skips)
            losses.append(loss)
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
    finally:
        matmul.allow_tf32 = old
    check(torch.isfinite(torch.stack(losses)).all().item() and int(skips) == 0,
          "timed CDK steps")
    return seconds / n * 1e3


def _profile_cdk_step(tr, batches, tf32=False):
    """CDK_PROFILED eager steps of ``tr`` (``tf32``: with cuBLAS's TF32
    switch set around them) under the profiler: device ms and
    kernels a step, the busy share, device ms a step by group (cuBLAS
    GEMMs: the tower products; the gram kernels; the rest), and the
    costliest kernels."""
    from torch.profiler import ProfilerActivity, profile

    skips = torch.zeros((), dtype=torch.int32, device=DEVICE)
    params, opt_state = tr.params, tr.opt_state
    matmul = torch.backends.cuda.matmul
    old = matmul.allow_tf32
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        time.sleep(PROFILE_MARGIN_S)
        matmul.allow_tf32 = tf32
        try:
            t0 = time.perf_counter()
            for i in range(CDK_PROFILED):
                x, y = batches[i % len(batches)]
                params, opt_state, _, _, _, skips = tr.step(params, opt_state, {}, x, y, skips)
            torch.cuda.synchronize()
            wall_s = time.perf_counter() - t0
        finally:
            matmul.allow_tf32 = old
        time.sleep(PROFILE_MARGIN_S)
    kernels = [e for e in prof.key_averages()
               if e.device_type == torch.autograd.DeviceType.CUDA]
    check(kernels, "the profiler recorded no CUDA kernel in the bf16 CDK steps")

    def device_us(e):
        return getattr(e, "self_device_time_total", None) or e.self_cuda_time_total

    total = sum(device_us(e) for e in kernels)
    top = sorted(kernels, key=device_us, reverse=True)[:TOP_KERNELS]
    n = CDK_PROFILED

    def group(name):
        if any(k in name for k in CUDA_KERNELS):
            return "gram_kernels"
        return "gemm" if any(k in name for k in ("nvjet", "gemm", "xmma", "cutlass")) \
            else "other"

    groups = {}
    for e in kernels:
        groups[group(e.key)] = groups.get(group(e.key), 0.0) + device_us(e) / n / 1e3
    return {"steps": n, "wall_ms_per_step": wall_s / n * 1e3,
            "device_ms_per_step": total / n / 1e3,
            "device_busy_share": total / 1e6 / wall_s,
            "kernels_per_step": sum(e.count for e in kernels) / n,
            "device_ms_per_step_by_group": groups,
            "top_kernels": [{"name": e.key[:100], "ms_per_step": device_us(e) / n / 1e3,
                             "per_step": e.count / n} for e in top]}


def phase_cdk_bf16(train, test, valid, f32_quality):
    """The Sketchy script as written (--compute_dtype bf16) through
    run_training; its products against float64; the bare step at f32, TF32
    and bf16 in turns; a few profiled steps of each."""
    with tempfile.TemporaryDirectory() as log_dir:
        args = get_args(CDK_BF16_ARGV + ["--num_epochs", str(CDK_EPOCHS),
                                         "--log_dir", log_dir, "--device", DEVICE])
        cuda_gram.reset_launch_counts()
        timings = {}
        t0 = time.perf_counter()
        params, trunc = run_training(args, train, test, valid, input_dim=CDK_DIM,
                                     timings=timings)
        torch.cuda.synchronize()
        run_s = time.perf_counter() - t0
        counts = cuda_gram.launch_counts()
        rows = _csv_rows(log_dir)
        spectrum = np.load(os.path.join(log_dir, "best_stats.npz"))["spectrum"]
    steps = CDK_EPOCHS * train.max_steps
    check(len(rows) == CDK_EPOCHS, f"bf16: {len(rows)} log rows")
    check(all(np.isfinite(float(r["loss"])) for r in rows), "non-finite bf16 CDK loss")
    check(int(rows[-1]["skips"]) == 0, f"{rows[-1]['skips']} skipped bf16 CDK steps")
    check(all(n == steps for n in counts.values()),
          f"bf16 CDK launch counts {counts} != {steps} each")
    check(all(p.dtype == torch.float32 for p in params.values()), "bf16 master weights")
    check(spectrum.shape == (CDK_L + 1,) and np.isfinite(spectrum).all(), "bf16 spectrum")

    f32_tr = make_trainer(_cdk_args(""), CDK_DIM, CDK_STEPS)
    bf16_tr = make_trainer(get_args(CDK_BF16_ARGV + ["--device", DEVICE]), CDK_DIM, CDK_STEPS)
    batches = [tuple(torch.as_tensor(a, device=DEVICE) for a in b[:2])
               for _, b in zip(range(4), train)]
    products = _bf16_products_vs_float64(bf16_tr.model, batches[0][0][:BF16_ROWS])
    trainers = {"f32": f32_tr, "tf32": f32_tr, "bf16": bf16_tr}
    for name in ("f32", "bf16"):
        _timed_steps(trainers[name], batches, CDK_WARMUP)
    ms = {name: [] for name in trainers}
    for name in CDK_TURNS:
        ms[name].append(_timed_steps(trainers[name], batches, CDK_TIMED, tf32=(name == "tf32")))
    prof = {name: _profile_cdk_step(trainers[name], batches, tf32=(name == "tf32"))
            for name in ("f32", "tf32", "bf16")}
    # what the JAX-order bf16 leaky ReLU (where(x >= 0, x, s·x), three
    # passes) costs against one F.leaky_relu pass with the same slope
    towers = (bf16_tr.model.x, bf16_tr.model.y)
    acts = [t.act for t in towers]
    slope = torch.tensor(0.2, dtype=torch.bfloat16).item()
    for t in towers:
        t.act = lambda v: torch.nn.functional.leaky_relu(v, negative_slope=slope)
    try:
        prof["bf16_with_F.leaky_relu"] = _profile_cdk_step(bf16_tr, batches)
    finally:
        for t, a in zip(towers, acts):
            t.act = a
    check(not torch.backends.cuda.matmul.allow_tf32, "TF32 left on after the timing")
    emit("cdk_bf16", argv=CDK_BF16_ARGV, epochs=CDK_EPOCHS, steps=steps, launches=counts,
         run_s=run_s, run_parts_s=timings, driver_steps_per_s=train.max_steps / timings["steps"][-1],
         per_epoch=[{k: float(v) for k, v in r.items()} for r in rows],
         quality={"bf16": _cdk_quality(rows), "f32": f32_quality},
         trunc=trunc, spectrum_head=spectrum[:8].tolist(),
         products_vs_float64={"rows": BF16_ROWS, "rtol": BF16_RTOL, "atol_of_max": BF16_ATOL,
                              **products},
         step_ms_in_turns={"order": list(CDK_TURNS), "steps": CDK_TIMED, **ms},
         steps_per_s={k: [1e3 / v for v in vs] for k, vs in ms.items()},
         step_profiles=prof)
    return counts


def _tier_model(cfg, params):
    """The CLI's model for ``cfg`` (its tier) with ``params``, and a float64
    copy of it (no tier applies in float64)."""
    model = pde.build(cfg).model
    with torch.no_grad():
        for k, p in model.named_parameters():
            p.copy_(params[k])
    return model, copy.deepcopy(model).double()


def _tier_errors(prec, model, model64, x):
    """The tower outputs' largest error against float64, of the largest
    entry, checked against its tier's TIER_MAX_ERR; for a split spec the
    head's and the tail's."""
    with torch.no_grad():
        out, ref = model(x).double(), model64(x.double())
    parts = {"all": (slice(None), prec)}
    if "@" in prec:
        head, rest = prec.split("@")
        k, tail = rest.split(",")
        parts = {"head": (slice(None, int(k)), head), "tail": (slice(int(k), None), tail)}
    errors = {}
    for name, (sl, tier) in parts.items():
        errors[name] = ((out[:, sl] - ref[:, sl]).abs().max() / ref[:, sl].abs().max()).item()
        check(errors[name] <= TIER_MAX_ERR[tier],
              f"{prec} {name}: tower error {errors[name]:.3g} > {TIER_MAX_ERR[tier]}")
    return errors


def _loss_inside_a_tiered_run(cfg, params, fixed, ref_loss):
    """The plain EVD loss on fixed float32 inputs computed in hooks inside
    one loss_and_grad of the tiered model (after the towers' forward, and
    in their backward): each value against ``ref_loss`` bit for bit."""
    run = pde.build(cfg)
    with torch.no_grad():
        for k, p in run.model.named_parameters():
            p.copy_(params[k])
    seen = []

    def loss_now(*_):
        seen.append(nestedlora_evd_loss(*fixed).item())

    def forward_hook(module, args, out):
        loss_now()
        if isinstance(out, torch.Tensor) and out.requires_grad:
            out.register_hook(lambda g: loss_now())

    handle = run.model.base.register_forward_hook(forward_hook)
    try:
        x = run.sample(torch.Generator(device=DEVICE).manual_seed(SEED + 5))
        loss, _, _, _ = run.method.loss_and_grad(dict(run.model.named_parameters()), {}, x,
                                                 run.operator, run.importance_train)
        torch.cuda.synchronize()
    finally:
        handle.remove()
    check(len(seen) >= 2 and torch.isfinite(loss).item(), f"hooks fired {len(seen)}")
    check(all(v == ref_loss for v in seen),
          f"EVD loss inside a tiered run {seen} != {ref_loss} outside")
    return len(seen)


def _bf16_e4_towers():
    """The E4 ParallelMLP in bf16 (compute_dtype) on the card against a CPU
    copy on TIER_ROWS rows, and its forward-engine Laplacian there."""
    kw = dict(ndim=NDIM, neigs=NEIGS, mlp_hidden_dims=HIDDEN, nonlinearity="softplus",
              parallel=True, use_fourier_feature=True, fourier_mapping_size=FOURIER,
              fourier_scale=0.1, fourier_append_radial=True,
              fourier_append_envelopes=ENVELOPES, apply_boundary=False, seed=SEED,
              compute_dtype=torch.bfloat16)
    card = make_wavefunctions(**kw, device=DEVICE)
    cpu = make_wavefunctions(**kw, device="cpu")
    sampler, _ = get_sampler("gaussian_mixture", TIER_ROWS, 1, NDIM, MIX_SCALES, device=DEVICE)
    x = sampler(torch.Generator(device=DEVICE).manual_seed(SEED + 6))
    with torch.no_grad():
        got, want = card(x), cpu(x.cpu())
    rel = ((got.cpu() - want).abs().max() / want.abs().max()).item()
    check(got.dtype == torch.float32 and rel <= BF16_CARD_CPU_ATOL,
          f"bf16 towers card vs CPU: {rel:.3g} of the largest entry")
    forward_laplacian.fallback_rule.calls = 0
    with torch.no_grad():
        lap, _, fs = forward_laplacian.forward_laplacian(card, x)
    fallbacks = forward_laplacian.fallback_rule.calls
    check(fallbacks == 0 and torch.isfinite(lap).all().item() and torch.isfinite(fs).all().item(),
          f"bf16 forward-engine Laplacian: {fallbacks} fallbacks, finite "
          f"{torch.isfinite(lap).all().item()}")
    return {"card_vs_cpu": rel, "atol_of_max": BF16_CARD_CPU_ATOL, "rows": TIER_ROWS,
            "laplacian_finite": True, "fallback_calls": fallbacks}


def phase_pde_tiers():
    """The PDE CLI's --matmul_precision tiers on the E4 flags."""
    gen = torch.Generator(device=DEVICE).manual_seed(SEED + 4)
    vmask, mmask = sequential_nesting_masks(NEIGS)
    fixed = (torch.randn(BATCH, NEIGS, generator=gen, device=DEVICE),
             torch.randn(BATCH, NEIGS, generator=gen, device=DEVICE))
    fixed = fixed + tuple(torch.chunk(fixed[0], 2)) + (
        torch.as_tensor(vmask, device=DEVICE), torch.as_tensor(mmask, device=DEVICE))
    ref_loss = nestedlora_evd_loss(*fixed).item()
    results, launches = {}, {}
    rates = {t: [] for t in PDE_TIERS}
    with tempfile.TemporaryDirectory() as tmp:
        for prec in PDE_TIERS:
            check(torch.get_float32_matmul_precision() == "highest", f"before {prec}")
            argv = _with_flags(PDE_E4_ARGV, matmul_precision=prec, num_iters=PDE_TIER_ITERS,
                               print_freq=RECIPE_BLOCK, eval_freq=PDE_TIER_ITERS)
            cuda_gram.reset_launch_counts()
            forward_laplacian.fallback_rule.calls = 0
            timings = {}
            ts, eigvals, run_dir, records = _pde_run(argv + _profile_argv(PDE_TIER_TRACED),
                                                     os.path.join(tmp, prec), timings)
            fallbacks = forward_laplacian.fallback_rule.calls
            check(fallbacks == 0, f"{prec}: {fallbacks} fallback-rule calls")
            check(torch.get_float32_matmul_precision() == "highest", f"after {prec}")
            _check_run(prec, ts, eigvals, run_dir, records, PDE_TIER_ITERS, [PDE_TIER_ITERS],
                       neigs=NEIGS)
            launches[prec], _ = _measured_launches(prec, run_dir, PDE_TIER_TRACED)
            n, seconds = timings["block_graph"][1]
            rates[prec].append(n / seconds)
            cfg = parse_pde_config(argv + ["--device", DEVICE])
            model, model64 = _tier_model(cfg, ts.params)
            sampler, _ = get_sampler("gaussian_mixture", TIER_ROWS, 1, NDIM, MIX_SCALES,
                                     device=DEVICE)
            x = sampler(torch.Generator(device=DEVICE).manual_seed(SEED + 7))
            errors = _tier_errors(prec, model, model64, x)
            hooks = _loss_inside_a_tiered_run(cfg, ts.params, fixed, ref_loss)
            results[prec] = {"tower_err_vs_float64": errors, "fallback_calls": fallbacks,
                             "eigvals": np.asarray(eigvals[-1]).tolist(),
                             "loss_hooks_bit_for_bit": hooks,
                             "precision_after": torch.get_float32_matmul_precision()}
        for prec in reversed(PDE_TIERS):  # the second round, for the rates in turns
            timings = {}
            _pde_run(_with_flags(PDE_E4_ARGV, matmul_precision=prec, num_iters=PDE_TIER_TURN,
                                 print_freq=RECIPE_BLOCK, eval_freq=10 ** 9),
                     os.path.join(tmp, "turn-" + prec), timings)
            rates[prec].append(_block_rate(timings, "block_graph"))
            check(torch.get_float32_matmul_precision() == "highest", f"after {prec} turn")
    bf16 = _bf16_e4_towers()
    emit("pde_tiers", argv=PDE_E4_ARGV, tiers=list(PDE_TIERS), iters=PDE_TIER_ITERS,
         block=RECIPE_BLOCK, results=results, launches=launches,
         graph_block_steps_per_s_in_turns={"order": list(PDE_TIERS) + list(reversed(PDE_TIERS)),
                                           **rates},
         tier_max_err=TIER_MAX_ERR, evd_loss_outside=ref_loss, bf16_e4_towers=bf16)
    return {k: {"launches": sum(launches[t][k]["launches"] for t in PDE_TIERS),
                "per_tier": {t: launches[t][k]["launches"] for t in PDE_TIERS}}
            for k in GRAM_KERNELS}


def _spin_resumable(cfg, trained, start, tmp):
    """SpIN's checkpoint API on the card: from ``trained``, one graph block,
    save_resumable, one more block (the straight run); load_resumable into
    a fresh template on the card and that same block: the two states equal
    bit for bit.  The bytes and seconds of the save and the load."""
    def parts():
        run = pde.build(cfg)
        block = make_scanned_train_step(
            run.method, run.operator, run.optimizer, run.sample,
            importance=run.importance_train, ema_decay=cfg.ema_decay,
            steps_per_call=RECIPE_BLOCK, grad_clip=cfg.grad_clip, seed=cfg.seed)
        return block, init_train_state(run.model, run.optimizer, run.method)

    block, ts = parts()
    load_state_tree(ts, trained)
    block(ts, start)
    path = os.path.join(tmp, "resumable.pt")
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    save_resumable(path, ts, chunk=1)
    save_s = time.perf_counter() - t0
    block(ts, start + RECIPE_BLOCK)
    straight = state_tree(ts)
    del block, ts
    block, fresh = parts()
    t0 = time.perf_counter()
    loaded, chunk = load_resumable(path, fresh)
    torch.cuda.synchronize()
    load_s = time.perf_counter() - t0
    check(loaded is fresh and chunk == 1 and fresh.step.is_cuda, "load_resumable")
    block(fresh, start + RECIPE_BLOCK)
    _, bitwise = _state_excess(state_tree(fresh), straight)
    check(bitwise, "a block after load_resumable differs from the straight run")
    return {"bytes": os.path.getsize(path), "save_s": save_s, "load_s": load_s,
            "bit_for_bit": bitwise}


def _spin_pretrained(cfg, ts, run_dir, iters):
    """load_pretrained of the run's ckpt_<iters> EMA parameters into a
    fresh model: its eval outputs on a val batch equal the run's own (EMA
    params and method state) bit for bit; the bytes and seconds."""
    run = pde.build(cfg)
    params = dict(run.model.named_parameters())
    path = os.path.join(run_dir, f"ckpt_{iters}")
    t0 = time.perf_counter()
    loaded = load_pretrained(path, params, keys=("ema_params",))
    torch.cuda.synchronize()
    load_s = time.perf_counter() - t0
    x = torch.as_tensor(next(iter(run.val_batches())), device=DEVICE)
    with torch.no_grad():
        for k, p in params.items():
            p.copy_(loaded[k])
        got = run.method.eval_apply(params, ts.method_state, x)
        want = run.method.eval_apply(ts.ema_params, ts.method_state, x)
    check(torch.equal(got, want), "load_pretrained's model differs from the run's")
    return {"bytes": os.path.getsize(path), "load_s": load_s, "rows": x.shape[0],
            "bit_for_bit": True}


def _spin_exact_run(tmp, label, loss, iters, **flags):
    """The E4 flags with --loss ``loss`` on the exact Laplacian's engines:
    graph blocks, one eval, one capture, no fallback call, no gram kernel,
    graph vs eager; on the exact engine (no probes) the card against a CPU
    copy in float64."""
    argv = _recipe_argv(_with_flags(PDE_E4_ARGV, loss=loss, laplacian_mode="forward", **flags),
                        iters, iters)
    cfg = parse_pde_config(argv + ["--device", DEVICE])
    check(cfg.loss.name == loss and cfg.laplacian_eps <= 0 and cfg.laplacian_mode == "forward"
          and cfg.neigs == NEIGS and cfg.batch_size == BATCH, f"{loss} flags {cfg}")
    timings = {}
    cuda_gram.reset_launch_counts()
    forward_laplacian.fallback_rule.calls = 0
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    ts, eigvals, run_dir, records = _pde_run(argv, os.path.join(tmp, label), timings)
    run_s = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated()
    fallbacks = forward_laplacian.fallback_rule.calls
    check(fallbacks == 0, f"{loss}: {fallbacks} fallback-rule calls")
    counts = cuda_gram.launch_counts()
    check(not any(counts.values()), f"{loss} launched gram kernels: {counts}")
    rows, health = _check_run(label, ts, eigvals, run_dir, records, iters, [iters],
                              neigs=NEIGS)
    check([n for n, _ in timings.get("block_graph", [])] == [RECIPE_BLOCK] * (iters // RECIPE_BLOCK)
          and "block_eager" not in timings, f"{loss} blocks {timings}")
    captures = _records_of(records, "captured a CUDA graph")
    check(len(captures) == 1, f"{len(captures)} captures in the {loss} run")
    state = ts.method_state
    check(all(torch.isfinite(v).all().item() for v in (state["sigma_avg"], state["chol"])),
          f"{loss} state not finite")
    out = {"argv": argv, "iters": iters, "run_s": run_s, "rows": rows, "health": health,
           "eigvals": np.asarray(eigvals[-1]).tolist(), "fallback_calls": fallbacks,
           "gram_kernel_launches": counts, "captures": len(captures),
           "params": sum(p.numel() for p in ts.params.values()), "peak_mem_bytes": peak,
           "eval_s": timings["eval"], "block_s": timings["block_graph"],
           "graph_block_steps_per_s": _block_rate(timings, "block_graph")}
    if loss == "spin":
        j_bytes = sum(j.numel() * j.element_size() for j in state["j_avg"].values())
        check(j_bytes == NEIGS * out["params"] * 4, f"j_avg holds {j_bytes} bytes")
        check(all(torch.isfinite(j).all().item() for j in state["j_avg"].values()),
              "j_avg not finite")
        out["j_avg_bytes"] = j_bytes
    trained = state_tree(ts)
    out["graph_vs_eager"] = _graph_vs_eager(cfg, trained, iters)
    if not flags:
        out["card_vs_cpu"] = _spin_card_vs_cpu(cfg, ts)
    return cfg, ts, trained, run_dir, out


def phase_pde_spin_exact():
    """SpIN and SpINx on the E4 flags with the forward-Laplacian engine in
    grad mode, SpIN on Hutchinson probes, and the checkpoint API."""
    with tempfile.TemporaryDirectory() as tmp:
        cfg, ts, trained, run_dir, spin = _spin_exact_run(tmp, "spin", "spin", SPIN_EXACT_ITERS)
        spin["resumable"] = _spin_resumable(cfg, trained, SPIN_EXACT_ITERS, tmp)
        spin["pretrained"] = _spin_pretrained(cfg, ts, run_dir, SPIN_EXACT_ITERS)
        del ts, trained
        spinx = _spin_exact_run(tmp, "spinx", "spinx", SPIN_EXACT_ITERS)[-1]
        hutch = _spin_exact_run(tmp, "hutchinson", "spin", SPIN_HUTCH_ITERS,
                                laplacian_probes=SPIN_HUTCH_PROBES)[-1]
    emit("pde_spin_exact", block=RECIPE_BLOCK, spin=spin, spinx=spinx, spin_hutchinson=hutch)


def _unit_rbf(a, b):
    """exp(-|a - b|^2), the kernel of tests/test_training.py:130-168."""
    return torch.exp(-torch.sum((a[:, None, :] - b[None, :, :]) ** 2, dim=-1))


def _kevd_models(device):
    """The kernel path's two models on ``device``: per-mode 128³ softplus
    towers on the raw 2D input, and the shared trunk 128³ with weight
    normalization and no biases."""
    towers = make_wavefunctions(ndim=2, neigs=KEVD_L, mlp_hidden_dims=KEVD_HIDDEN,
                                nonlinearity="softplus", parallel=True,
                                use_fourier_feature=False, apply_boundary=False,
                                seed=SEED, device=device)
    trunk = make_mlp_eigfuncs(2, KEVD_L, KEVD_HIDDEN, "softplus", bias=False,
                              weight_normalization=True,
                              generator=torch.Generator().manual_seed(SEED)).to(device)
    return {"towers": towers, "wn_trunk": trunk}


def _kernel_op(landmarks):
    return KernelOperator(_unit_rbf, landmarks)


def _kevd_nestedlora(models, x):
    """NestedLoRA's loss_and_grad_kernel on the card, with and without
    split_batch, on each model: one launch of K1, K2 and K3 a call, and
    the kernels against the plain path at LOSS_RTOL / the gradient
    tolerances."""
    out = {}
    for mname, model in models.items():
        params = dict(model.named_parameters())
        for split in (False, True):
            res = {}
            for label, use_pallas in (("kernels", "auto"), ("plain", False)):
                method = NestedLoRA(model, KEVD_L, sequential=True, use_pallas=use_pallas)
                cuda_gram.reset_launch_counts()
                loss, grads, aux, _ = method.loss_and_grad_kernel(params, {}, x, _kernel_op,
                                                                  split_batch=split)
                torch.cuda.synchronize()
                res[label] = (loss.item(), grads, cuda_gram.launch_counts(), aux["f"].shape)
            (lk, gk, ck, shape), (lp, gp, cp, _) = res["kernels"], res["plain"]
            check(all(v == 1 for v in ck.values()) and not any(cp.values()),
                  f"kernel path {mname} split={split}: launches {ck}, plain {cp}")
            loss_rel = abs(lk - lp) / abs(lp)
            check(loss_rel <= LOSS_RTOL, f"kernel path {mname} split={split}: loss {loss_rel:.3g}")
            out[f"{mname}/{'split' if split else 'whole'}"] = {
                "loss": lk, "loss_rel": loss_rel, "grad_tol_used": _check_grads(gk, gp),
                "launches": ck, "f_rows": shape[0]}
    return out


def _kevd_card_vs_cpu(models, x):
    """NeuralEF, SpIN and SpINx's loss_and_grad_kernel, with and without
    split_batch, on each model: the card against a CPU copy on
    KEVD_CPU_ROWS rows, model and state in float64 (the Cholesky
    whitening amplifies float32 rounding): loss, grads and the new state at
    rtol KEVD_CPU_RTOL; atol 1e-6 of each state tensor's largest entry,
    and of the largest gradient entry over all parameters (under NeuralEF's
    batch norm the output is invariant to the last layer's gains, so their
    gradient is rounding noise around zero, which no scale of its own
    bounds)."""
    from neuralsvd_tpu_torch.methods.factories import get_evd_method

    xs = x[:KEVD_CPU_ROWS].double()
    out = {}
    for mname, model in models.items():
        for name in ("neuralef", "spin", "spinx"):
            for split in (False, True):
                res = {}
                for dev in (DEVICE, "cpu"):
                    m = copy.deepcopy(model).to(dev).double()
                    params = dict(m.named_parameters())
                    method = get_evd_method(name, m, KEVD_L)
                    loss, grads, _, state = method.loss_and_grad_kernel(
                        params, method.init_state(params), xs.to(dev), _kernel_op,
                        split_batch=split)
                    res[dev] = (loss.item(), clone_tree(grads, "cpu"), clone_tree(state, "cpu"))
                (lg, gg, sg), (lc, gc, sc) = res[DEVICE], res["cpu"]
                loss_rel = abs(lg / lc - 1)
                scale = max(g.abs().max().item() for g in gc.values())
                grad_excess = max(
                    ((gg[k] - g).abs() / (KEVD_CPU_RTOL * g.abs() + GRAD_ATOL * scale)).max().item()
                    for k, g in gc.items())
                state_excess, _ = _state_excess(sg, sc, KEVD_CPU_RTOL, GRAD_ATOL)
                key = f"{mname}/{name}/{'split' if split else 'whole'}"
                check(loss_rel <= KEVD_CPU_RTOL and grad_excess <= 1.0 and state_excess <= 1.0,
                      f"{key} card vs CPU: loss {loss_rel:.3g}, grads {grad_excess:.3g}x, "
                      f"state {state_excess:.3g}x the tolerance")
                out[key] = {"loss": lg, "loss_rel": loss_rel, "grad_tol_used": grad_excess,
                            "state_tol_used": state_excess}
    return out


def _kevd_train(tmp):
    """train_operator on a fixed KEVD_B-landmark KernelOperator with
    NestedLoRA and the towers: KEVD_ITERS steps in graph blocks, one eval;
    every loss finite, no skipped step, positive eigenvalues (the kernel is
    PSD); K1-K3 launches measured (eager warm-up and a traced block)."""
    rng = np.random.default_rng(SEED)
    landmarks = rng.normal(size=(KEVD_B, 2)).astype(np.float32)
    model = _kevd_models(DEVICE)["towers"]
    method = NestedLoRA(model, KEVD_L, sequential=True)
    sample, _ = get_sampler("gaussian", KEVD_B, 1, 2, 1.0, device=DEVICE)
    optimizer = build_optimizer("rmsprop", KEVD_LR)
    _, val_batches, _ = make_val_grid(2, KEVD_VAL_LIM, KEVD_VAL_EPS, KEVD_B)
    run_dir = os.path.join(tmp, "kernel_evd")
    rows, timings, records = [], {}, _Records()

    class Writer:
        def writerow(self, r):
            rows.append(r)

    cuda_gram.reset_launch_counts()
    logging.basicConfig(level=logging.INFO)  # as cli.pde.main sets it
    port_log = logging.getLogger("neuralsvd_tpu_torch")
    port_log.addHandler(records)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    try:
        ts, all_eigvals, _ = train_operator(
            method, _kernel_op(landmarks), sample, optimizer, model, KEVD_ITERS,
            val_batches=val_batches, ema_decay=EMA_DECAY, eval_freq=KEVD_ITERS,
            print_freq=RECIPE_BLOCK, log_writer=Writer(), seed=SEED, timings=timings,
            profile_dir=os.path.join(run_dir, "profile"), profile_start=KEVD_TRACED[0],
            profile_steps=KEVD_TRACED[1])
    finally:
        port_log.removeHandler(records)
    run_s = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated()
    losses = [r["train_loss"] for r in rows]
    check(len(losses) == KEVD_ITERS // RECIPE_BLOCK and np.isfinite(losses).all(),
          f"kernel_evd losses {losses}")
    check(not any("skips" in r.args for r in records.records
                  if r.msg == "%s" and isinstance(r.args, dict)), "kernel_evd skipped steps")
    check(int(ts.step) == KEVD_ITERS and len(all_eigvals) == 1, "kernel_evd steps and evals")
    eigvals = np.asarray(all_eigvals[-1])
    check(np.isfinite(eigvals).all() and (eigvals > 0).all(),
          f"kernel_evd eigenvalues {eigvals} (the RBF kernel is PSD)")
    check([n for n, _ in timings.get("block_graph", [])]
          == [RECIPE_BLOCK] * (KEVD_ITERS // RECIPE_BLOCK), f"kernel_evd blocks {timings}")
    captures = _records_of(records.records, "captured a CUDA graph")
    check(len(captures) == 1, f"{len(captures)} captures in the kernel_evd run")
    launches, traced_kernels = _measured_launches("kernel_evd", run_dir, KEVD_TRACED)
    return launches, {
        "iters": KEVD_ITERS, "landmarks": KEVD_B, "run_s": run_s, "losses": losses,
        "eigvals": eigvals.tolist(), "eval_s": timings["eval"],
        "block_s": timings["block_graph"], "peak_mem_bytes": peak,
        "graph_block_steps_per_s": _block_rate(timings, "block_graph"),
        "launches": launches, "traced_block_kernels_per_step": traced_kernels}


def phase_kernel_evd():
    """The kernel-operator EVD path: every method's loss_and_grad_kernel on
    the card, and the driver on a fixed-landmark kernel operator."""
    models = _kevd_models(DEVICE)
    x = torch.randn(KEVD_B, 2, generator=torch.Generator(device=DEVICE).manual_seed(SEED + 8),
                    device=DEVICE)
    nestedlora = _kevd_nestedlora(models, x)
    card_vs_cpu = _kevd_card_vs_cpu(models, x)
    with tempfile.TemporaryDirectory() as tmp:
        launches, train = _kevd_train(tmp)
    emit("kernel_evd", B=KEVD_B, L=KEVD_L, nestedlora=nestedlora, card_vs_cpu=card_vs_cpu,
         train=train)
    return launches


class _Images:
    """ImageFolder protocol (.classes, .samples, [i] -> (image, class
    index)) over made-up 3x224x224 images in [0, 1), VGG_PER_CLASS a class,
    drawn from a seeded CPU generator; sketches go through invert_image."""

    def __init__(self, kind, classes, seed):
        self.classes = list(classes)
        self.samples = [(f"/{kind}/{c}/{j}.png", ci)
                        for ci, c in enumerate(self.classes) for j in range(VGG_PER_CLASS)]
        self.data = torch.rand(len(self.samples), 3, 224, 224,
                               generator=torch.Generator().manual_seed(seed))
        if kind == "sketch":
            self.data = invert_image(self.data)

    def __getitem__(self, i):
        return self.data[i], self.samples[i][1]


def _rel(got, want):
    """max |got - want| over max |want|, on the CPU in float32."""
    want = want.detach().float().cpu()
    return ((got.detach().float().cpu() - want).abs().max() / want.abs().max()).item()


def _vgg_extraction(root, names):
    """Both VGG16 towers (random weights) on the card through
    extract_features_main: the card against a CPU copy, images/s, and the
    npz files read back by the loader."""
    check(not torch.backends.cudnn.allow_tf32 and not torch.backends.cuda.matmul.allow_tf32,
          "TF32 must be off for the VGG16 card vs CPU check")
    kinds = ("sketch", "photo")
    towers = {k: make_vgg_feature_extractor(device=DEVICE,
                                            generator=torch.Generator().manual_seed(SEED + i))
              for i, k in enumerate(kinds)}
    data = {k: _Images(k, names, SEED + 10 + i) for i, k in enumerate(kinds)}
    x = data["sketch"].data[:VGG_CPU_ROWS]
    with torch.no_grad():
        card = towers["sketch"](x.to(DEVICE))
        cpu = copy.deepcopy(towers["sketch"]).cpu()(x)
    card_vs_cpu = _rel(card, cpu)
    check(card.shape == (VGG_CPU_ROWS, SKETCHY_DIM) and card_vs_cpu <= VGG_RTOL,
          f"VGG16 card vs CPU: {card_vs_cpu:.3g} of the largest entry > {VGG_RTOL}")
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out_dir = extract_features_main(root, split=SKETCHY_SPLIT, batch_size=VGG_BATCH,
                                    device=DEVICE, dataset_factory=lambda: (data, towers))
    extract_s = time.perf_counter() - t0
    images = sum(len(d.samples) for d in data.values())
    batch = data["photo"].data[:VGG_BATCH].to(DEVICE)
    with torch.no_grad():
        forward_ms = time_ms(lambda: towers["photo"](batch), iters=VGG_TIMED, reps=3)
    subsets = split_classes(names, SKETCHY_SPLIT)
    rows = {}
    for phase in ("train", "test", "valid"):
        for kind in kinds:
            feats, classes, _, _ = load_sketchy_features(root, SKETCHY_SPLIT, phase, kind)
            rows[f"{phase}_{kind}"] = len(feats)
            check(feats.shape == (len(subsets[phase]) * VGG_PER_CLASS, SKETCHY_DIM)
                  and np.isfinite(feats).all()
                  and set(classes.tolist()) == set(subsets[phase].tolist()),
                  f"extracted {phase}_{kind}: {feats.shape}")
    xb, yb, cls = next(iter(SketchyVGGDataLoader(VGG_BATCH, root_path=root, split=SKETCHY_SPLIT)))
    check(xb.shape == yb.shape == (VGG_BATCH, SKETCHY_DIM), "a loader batch of extracted features")
    return {"out_dir": os.path.relpath(out_dir, root), "images": images, "rows": rows,
            "card_vs_cpu_rel": card_vs_cpu, "rtol": VGG_RTOL, "extract_s": extract_s,
            "extract_images_per_s": images / extract_s, "forward_batch": VGG_BATCH,
            "forward_ms": forward_ms, "forward_images_per_s": VGG_BATCH / forward_ms * 1e3}


def _sketchy_features(root, names):
    """Feature files of the loader's layout at Sketchy Extended scale, made
    up from SEED: class centres (3·N(0, 1)) plus unit noise, 512-d."""
    rng = np.random.default_rng(SEED)
    centres = {k: 3 * rng.standard_normal((len(names), SKETCHY_DIM), dtype=np.float32)
               for k in ("sketch", "photo")}
    per_class = {"sketch": SKETCHY_SKETCHES, "photo": SKETCHY_PHOTOS}
    subsets = split_classes(names, SKETCHY_SPLIT)
    for phase in ("train", "test", "valid"):
        for kind, n in per_class.items():
            cls = np.repeat(subsets[phase], n)
            feats = centres[kind][np.searchsorted(names, cls)]
            feats += rng.standard_normal(feats.shape, dtype=np.float32)
            write_feature_files(root, SKETCHY_SPLIT, phase, kind, feats, cls)
    return subsets


def _loader_ms(root):
    """Host ms a batch of the train loader at B CDK_B, native draws against
    use_native=False in turns: the whole batch (pairs and both gathers) and
    the pair draw alone."""
    loaders = {kind: SketchyVGGDataLoader(CDK_B, root_path=root, split=SKETCHY_SPLIT, seed=SEED,
                                          use_native=(kind == "native"))
               for kind in ("native", "python")}
    batch_ms = {k: [] for k in loaders}
    pairs_ms = {k: [] for k in loaders}
    for kind in LOADER_TURNS:
        it = iter(loaders[kind])
        t0 = time.perf_counter()
        for _ in range(LOADER_BATCHES):
            next(it)
        batch_ms[kind].append((time.perf_counter() - t0) / LOADER_BATCHES * 1e3)
        t0 = time.perf_counter()
        for _ in range(LOADER_BATCHES):
            loaders[kind]._pick_random_pairs()
        pairs_ms[kind].append((time.perf_counter() - t0) / LOADER_BATCHES * 1e3)
    ratio = {"pairs": min(pairs_ms["python"]) / max(pairs_ms["native"]),
             "batch": min(batch_ms["python"]) / max(batch_ms["native"])}
    check(ratio["pairs"] >= LOADER_MIN_RATIO,
          f"native pair draw only {ratio['pairs']:.2f}x the Python loop's speed")
    return {"order": list(LOADER_TURNS), "batches_a_turn": LOADER_BATCHES, "batch_ms": batch_ms,
            "pairs_ms": pairs_ms, "python_over_native_worst": ratio}


def _embed(model, side, feats, batch=CDK_B):
    with torch.no_grad():
        return torch.cat([model.apply_single(torch.as_tensor(feats[i:i + batch], device=DEVICE),
                                             side)
                          for i in range(0, len(feats), batch)]).cpu().numpy()


def _retrieval_split(model, test):
    """The test retrieval on the run's embeddings, timed in parts: the
    public top_k_retrievals (device scores and top-k, index copy), the
    same loop with a sync between its device work and its copy, and the
    numpy metrics (relevances, precision_at_k, average_precisions v1), at
    K 100 (the script's) and the whole gallery (--return_map_all)."""
    zx = _embed(model, "x", test.sketch_features)
    zy = _embed(model, "y", test.photo_features)
    xcls, ycls = np.asarray(test.sketch_classes), np.asarray(test.photo_classes)
    counts = {c: n for c, n in zip(*np.unique(xcls, return_counts=True))}
    n_items = np.asarray([counts[c] for c in xcls])
    out = {"queries": len(zx), "gallery": len(zy)}
    for label, K in (("K100", 100), ("all", len(zy))):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        idx = top_k_retrievals(zx, zy, K, device=DEVICE)
        public_s = time.perf_counter() - t0
        gallery = torch.as_tensor(zy, device=DEVICE)
        device_s = copy_s = 0.0
        for i in range(0, len(zx), RETRIEVAL_QUERY_BATCH):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            q = torch.as_tensor(zx[i:i + RETRIEVAL_QUERY_BATCH], device=DEVICE)
            top = torch.topk(q @ gallery.T, K, dim=1).indices
            torch.cuda.synchronize()
            t1 = time.perf_counter()
            top.cpu().numpy()
            copy_s += time.perf_counter() - t1
            device_s += t1 - t0
        t0 = time.perf_counter()
        rel = ycls[idx] == xcls[:, None]
        p_at_k = precision_at_k(rel)
        aps = average_precisions(rel, n_items, ver=1)
        numpy_s = time.perf_counter() - t0
        out[label] = {"top_k_retrievals_s": public_s, "device_scores_topk_s": device_s,
                      "index_copy_s": copy_s, "numpy_metrics_s": numpy_s,
                      "P@K": float(p_at_k.mean()), "mAP": float(aps.mean())}
    return out


def _trained_towers(args, params, num_classes):
    """A float32 copy of the run's towers (``args``' widths) with online
    heads for ``num_classes`` (seeded), on the card."""
    model = HeteroNetwork(SKETCHY_DIM, parse_dims(args.network_dims), args.activation,
                          mu=args.mu, num_classes=num_classes,
                          generator=torch.Generator().manual_seed(SEED)).to(DEVICE)
    with torch.no_grad():
        for name, p in model.named_parameters():
            if not name.startswith("head_"):
                p.copy_(params[name])
    return model


def _heads(model, train):
    """One classify=True call on the card against a CPU copy; a classifier
    loss gives the towers a zero gradient and the heads a nonzero one."""
    names = sorted(set(train.sketch_classes.tolist()))
    labels = np.searchsorted(names, train.sketch_classes)
    x = torch.as_tensor(train.sketch_features[:64], device=DEVICE)
    y = torch.as_tensor(labels[:64], device=DEVICE)
    cpu = copy.deepcopy(model).cpu()
    out = {}
    for side in ("x", "y"):
        emb, logits = model.apply_single(x, side, classify=True)
        with torch.no_grad():
            cemb, clogits = cpu.apply_single(x.cpu(), side, classify=True)
        out[side] = {"emb_rel": _rel(emb, cemb), "logits_rel": _rel(logits, clogits)}
        check(max(out[side].values()) <= CDK_TOWER_RTOL, f"heads card vs CPU: {out[side]}")
        loss = torch.nn.functional.cross_entropy(logits, y)
        params = dict(model.named_parameters())
        grads = dict(zip(params, torch.autograd.grad(loss, list(params.values()),
                                                     allow_unused=True)))
        tower = [k for k in params if not k.startswith("head_")]
        check(all(grads[k] is None or not grads[k].any() for k in tower),
              "a classifier loss reached the towers")
        check(all(grads[k] is not None and grads[k].abs().max() > 0
                  for k in params if k.startswith(f"head_{side}.")), f"head_{side} gradient")
        out[side]["loss"] = loss.item()
    return out


def _knn(model, train, test):
    """kNN (KNN_K, KNN_T) of test-sketch embeddings (x tower) against a
    photo bank (y tower): the train photos (the classes are disjoint, so
    every prediction is a train class and the accuracy is 0) and the test
    photos (chance 1/25)."""
    names = sorted(set(train.sketch_classes.tolist()) | set(test.sketch_classes.tolist()))
    q = _embed(model, "x", test.sketch_features)
    q_labels = np.searchsorted(names, test.sketch_classes)
    out = {}
    for bank_name, loader in (("train_photos", train), ("test_photos", test)):
        bank = _embed(model, "y", loader.photo_features)
        bank_labels = np.searchsorted(names, loader.photo_classes)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        acc = knn_monitor(lambda v: v, bank, bank_labels, q, q_labels, len(names),
                          k=KNN_K, temperature=KNN_T, device=DEVICE)
        out[bank_name] = {"bank": len(bank), "accuracy": acc, "s": time.perf_counter() - t0}
    preds = knn_predict(q[:512], _embed(model, "y", train.photo_features),
                        np.searchsorted(names, train.photo_classes), len(names),
                        k=KNN_K, temperature=KNN_T, device=DEVICE)
    train_ids = set(np.searchsorted(names, train.photo_classes).tolist())
    check(set(preds.tolist()) <= train_ids and out["train_photos"]["accuracy"] == 0.0,
          "kNN on the train-photo bank predicted a class outside the bank")
    check(out["test_photos"]["accuracy"] > 0, "kNN on the test-photo bank")
    out["queries"], out["k"], out["temperature"] = len(q), KNN_K, KNN_T
    out["test_chance"] = 1 / len(set(test.sketch_classes.tolist()))
    return out


def _probe(model, train, spectrum):
    """The multi-head probe over the frozen x tower (rep: its 8192-wide
    hidden layer; emb: its embedding), PROBE_TRUNC, spectrum-sorted;
    PROBE_STEPS SGD steps: losses finite, towers unchanged."""
    tower = model.x

    def embed(v):
        return tower.act(tower.layers[0](v)), model.apply_single(v, "x")

    names = sorted(set(train.sketch_classes.tolist()))
    labels = torch.as_tensor(np.searchsorted(names, train.sketch_classes), device=DEVICE)
    feats = torch.as_tensor(train.sketch_features, device=DEVICE)
    probe = make_multihead_probe(embed, tower.layers[0].w.shape[1], tower.layers[-1].w.shape[1],
                                 len(names), trunc_dims=PROBE_TRUNC,
                                 sort=True, generator=torch.Generator().manual_seed(SEED)).to(DEVICE)
    record = register_spectrum(spectrum)
    before = {k: p.detach().clone() for k, p in model.named_parameters()}
    opt = torch.optim.SGD(probe.parameters(), lr=PROBE_LR, momentum=0.9)
    gen = torch.Generator(device=DEVICE).manual_seed(SEED + 20)
    losses = []
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(PROBE_STEPS):
        idx = torch.randint(0, len(feats), (CDK_B,), generator=gen, device=DEVICE)
        logits = probe(feats[idx], spectrum_record=record)
        loss = sum(torch.nn.functional.cross_entropy(v, labels[idx]) for v in logits.values())
        opt.zero_grad()
        loss.backward()
        opt.step()
        losses.append(loss.detach())
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    losses = torch.stack(losses).cpu()
    check(torch.isfinite(losses).all().item(), "non-finite probe loss")
    check(all(torch.equal(p, before[k]) for k, p in model.named_parameters()),
          "the probe moved the frozen towers")
    with torch.no_grad():
        idx = torch.arange(CDK_B, device=DEVICE)
        top1 = {k: accuracy(v, labels[idx])[0]
                for k, v in probe(feats[idx], spectrum_record=record).items()}
    return {"heads": list(probe.heads), "steps": PROBE_STEPS, "loss_first": losses[0].item(),
            "loss_last": losses[-1].item(), "steps_per_s": PROBE_STEPS / seconds,
            "train_top1_percent": top1}


def _zoo_resnet(name):
    """A ResNet on the card against a CPU copy (train mode: output and
    running statistics after the step; eval mode), then ZOO_STEPS SGD
    steps on random images and labels: images/s."""
    make, side, batch, classes = RESNETS[name]
    cpu = make("cpu", torch.Generator().manual_seed(SEED))
    card = copy.deepcopy(cpu).to(DEVICE)
    x = torch.rand(ZOO_CPU_ROWS, 3, side, side, generator=torch.Generator().manual_seed(SEED + 1))
    rel = {}
    for mode in ("train", "eval"):
        cpu.train(mode == "train")
        card.train(mode == "train")
        with torch.no_grad():
            rel[mode] = _rel(card(x.to(DEVICE)), cpu(x))
    card_buffers = dict(card.named_buffers())
    rel["running_stats"] = max(_rel(card_buffers[k], b) for k, b in cpu.named_buffers())
    check(max(rel.values()) <= ZOO_RTOL, f"{name} card vs CPU: {rel}")
    card.train()
    opt = torch.optim.SGD(card.parameters(), lr=0.01, momentum=0.9)
    gen = torch.Generator(device=DEVICE).manual_seed(SEED + 2)
    xb = torch.rand(batch, 3, side, side, generator=gen, device=DEVICE)
    yb = torch.randint(0, classes, (batch,), generator=gen, device=DEVICE)
    losses = []

    def step():
        loss = torch.nn.functional.cross_entropy(card(xb), yb)
        opt.zero_grad()
        loss.backward()
        opt.step()
        losses.append(loss.detach())

    step()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(ZOO_STEPS):
        step()
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    check(torch.isfinite(torch.stack(losses)).all().item(), f"{name}: non-finite loss")
    return {"side": side, "batch": batch, "card_vs_cpu_rel": rel,
            "params": sum(p.numel() for p in card.parameters()),
            "images_per_s": ZOO_STEPS * batch / seconds}


def _zoo_siam(mode):
    """SiamNetwork (backbone 512-8192-512) on the card against a CPU copy:
    two train-mode two-view calls (outputs, then the l2norm buffer), one
    eval call; then ZOO_STEPS SGD steps at SIAM_B rows: rows/s."""
    kw = SIAM_MODES[mode]
    cpu = SiamNetwork(SKETCHY_DIM, SIAM_DIMS, mu=16.0, generator=torch.Generator().manual_seed(SEED),
                      **kw)
    card = copy.deepcopy(cpu).to(DEVICE)
    g = torch.Generator().manual_seed(SEED + 3)
    z1, z2 = (torch.randn(SIAM_CPU_ROWS, SKETCHY_DIM, generator=g) for _ in range(2))
    rel = {}
    for call, (a, b) in enumerate(((z1, z2), (z2, z1))):
        with torch.no_grad():
            got, want = card(a.to(DEVICE), b.to(DEVICE)), cpu(a, b)
        rel[f"train_call{call}"] = max(_rel(g_, w) for g_, w in zip(got, want))
    rel["l2norm"] = _rel(card.l2norm, cpu.l2norm)
    check(bool(card.initialized) == bool(cpu.initialized) == bool(kw), f"siam {mode} initialized")
    cpu.eval()
    card.eval()
    with torch.no_grad():
        rel["eval"] = max(_rel(g_, w) for g_, w in zip(card(z1.to(DEVICE)), cpu(z1)))
    check(max(rel.values()) <= ZOO_RTOL, f"siam {mode} card vs CPU: {rel}")
    card.train()
    opt = torch.optim.SGD(card.parameters(), lr=0.01, momentum=0.9)
    gen = torch.Generator(device=DEVICE).manual_seed(SEED + 4)
    xb = torch.randn(SIAM_B, SKETCHY_DIM, generator=gen, device=DEVICE)
    losses = []

    def step():
        _, e1, _, e2 = card(xb, xb + 0.1 * torch.randn(xb.shape, generator=gen, device=DEVICE))
        loss = -torch.nn.functional.cosine_similarity(e1, e2, dim=1).mean()
        opt.zero_grad()
        loss.backward()
        opt.step()
        losses.append(loss.detach())

    step()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(ZOO_STEPS):
        step()
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    check(torch.isfinite(torch.stack(losses)).all().item(), f"siam {mode}: non-finite loss")
    return {"card_vs_cpu_rel": rel, "batch": SIAM_B, "rows_per_s": ZOO_STEPS * SIAM_B / seconds}


def phase_sketchy_cli(tmp, figures):
    """The Sketchy CLI's own entry point on feature files at Sketchy
    Extended scale, the VGG16 extraction that writes such files, the
    loader's native draws against the Python loop, the retrieval split,
    the online heads, kNN, the probe, the ResNets and the Siamese network.
    The feature files stay in the ``root`` folder of ``tmp`` (phase dp
    reads them); the run's figures are added to ``figures``."""
    names = [f"c{i:03d}" for i in range(SKETCHY_CLASSES)]
    vgg = _vgg_extraction(os.path.join(tmp, "vgg"), names)
    root, log_dir = os.path.join(tmp, "root"), os.path.join(tmp, "log")
    t0 = time.perf_counter()
    subsets = _sketchy_features(root, names)
    files_s = time.perf_counter() - t0
    args = get_args(SKETCHY_ARGV + ["--root_dir", root, "--sketchy_split", SKETCHY_SPLIT,
                                    "--log_dir", log_dir, "--seed", str(SEED),
                                    "--device", DEVICE])
    cuda_gram.reset_launch_counts()
    timings = {}
    t0 = time.perf_counter()
    with _figure_seconds(sketchy, ("plot_hist_ratios",)) as drawn:
        params, trunc = sketchy.main(args, timings=timings)
    torch.cuda.synchronize()
    run_s = time.perf_counter() - t0
    counts = cuda_gram.launch_counts()
    figures += _figure_rows("sketchy_cli", log_dir, drawn, {
        **{f"ratios_e{e}.png": (400, 600) for e in range(SKETCHY_EPOCHS)},
        "spectrum_final.png": (400, 1500)})
    rows = _csv_rows(log_dir)
    files = sorted(os.listdir(log_dir))
    spectrum = np.load(os.path.join(log_dir, "best_stats.npz"))["spectrum"]
    loader = {phase: SketchyVGGDataLoader(CDK_B, root_path=root, split=SKETCHY_SPLIT,
                                          train_or_test=phase, use_native=False)
              for phase in ("train", "test")}
    train, test = loader["train"], loader["test"]
    steps = SKETCHY_EPOCHS * train.max_steps
    check(len(train) == len(subsets["train"]) * SKETCHY_SKETCHES, "train sketches")
    check(len(rows) == SKETCHY_EPOCHS, f"{len(rows)} log rows")
    check(all(np.isfinite(float(r["loss"])) for r in rows), "non-finite Sketchy loss")
    check(int(rows[-1]["skips"]) == 0, f"{rows[-1]['skips']} skipped Sketchy steps")
    check(all(n == steps for n in counts.values()),
          f"Sketchy CLI launch counts {counts} != {steps} each")
    check({"best", "ckpt", "best_stats.npz", "retrievals_best.npz"} <= set(files),
          f"Sketchy CLI files {files}")
    check(set(trunc) == set(SKETCHY_TRUNC), f"truncation sweep {sorted(trunc)}")
    loader_ms = _loader_ms(root)
    model = _trained_towers(args, params, len(subsets["train"]))
    retrieval = _retrieval_split(model, test)
    heads = _heads(model, train)
    knn = _knn(model, train, test)
    probe = _probe(model, train, spectrum)
    zoo = {name: _zoo_resnet(name) for name in RESNETS}
    zoo.update({f"siam_{mode}": _zoo_siam(mode) for mode in SIAM_MODES})
    emit("sketchy_cli", argv=SKETCHY_ARGV, split=SKETCHY_SPLIT,
         classes={k: len(v) for k, v in subsets.items()},
         rows={"train_sketches": len(train), "test_sketches": len(test)},
         feature_files_s=files_s, vgg=vgg, epochs=SKETCHY_EPOCHS, steps=steps,
         launches=counts, run_s=run_s, run_parts_s=timings,
         run_other_s=run_s - sum(map(sum, timings.values())),
         driver_steps_per_s=train.max_steps / timings["steps"][-1],
         per_epoch=[{k: float(v) for k, v in r.items()} for r in rows],
         test_p_at_100=float(rows[-1]["test_P@K"]),
         test_chance=1 / len(subsets["test"]), trunc=trunc, loader_ms=loader_ms,
         retrieval=retrieval, heads=heads, knn=knn, probe=probe, zoo=zoo)
    return counts


def _abs_excess(got, ref, rtol, atol):
    """Largest |got - ref| over (rtol·|ref| + atol), the JAX tests' form."""
    return ((got - ref).abs() / (rtol * ref.abs() + atol)).max().item()


def _nccl_per_step(run_dir, traced):
    """In the trace of a run's --profile window ``traced`` (start, steps):
    the NCCL kernels and device copies a step ({name: count/step}; NCCL
    reduces a one-rank group in place with neither) and the kernels a
    step."""
    with open(os.path.join(run_dir, "profile", "trace.json")) as fh:
        events = json.load(fh)["traceEvents"]
    out, kernels = {}, 0
    for e in events:
        name, cat = str(e.get("name", "")), str(e.get("cat", "")).lower()
        kernels += cat == "kernel"
        if (cat == "kernel" and "nccl" in name.lower()) or cat == "gpu_memcpy":
            out[name] = out.get(name, 0) + 1 / traced[1]
    return out, kernels / traced[1]


def _dp_argv(variant):
    """The E4 flags of phase dp's runs: ``dp`` on the plain loss with
    --mesh dp, ``plain`` the plain loss without it, ``kernels`` K1-K3."""
    argv = PDE_E4_ARGV + ["--print_freq", str(DP_BLOCK), "--num_iters", str(DP_ITERS)]
    if variant != "kernels":
        argv += ["--neuralsvd.use_pallas", "false"]
    return argv + (["--mesh", "dp"] if variant == "dp" else [])


def _dp_e4(tmp):
    """The E4 CLI on a one-rank NCCL group against no mesh, and as eager
    steps; steps/s in turns."""
    e4 = ["--eval_freq", str(DP_ITERS)]
    cuda_gram.reset_launch_counts()
    timings = {}
    dts, deigvals, ddir, drecords = _pde_run(
        _dp_argv("dp") + e4 + _profile_argv(DP_TRACED), os.path.join(tmp, "dp"), timings)
    _check_run("dp", dts, deigvals, ddir, drecords, DP_ITERS, [DP_ITERS], neigs=NEIGS)
    graph_launches = cuda_gram.launch_counts()
    captures = _records_of(drecords, "captured a CUDA graph")
    check(len(captures) == 1 and [n for n, _ in timings.get("block_graph", [])]
          == [DP_BLOCK] * (DP_ITERS // DP_BLOCK), f"dp blocks {timings}, {len(captures)} captures")
    nccl, traced_kernels = _nccl_per_step(ddir, DP_TRACED)
    pts, peigvals, _, _ = _pde_run(_dp_argv("plain") + e4, os.path.join(tmp, "plain"))
    plain_excess, plain_bitwise = _state_excess(state_tree(dts), state_tree(pts), rtol=0.0,
                                                atol=DP_PLAIN_ATOL)
    check(plain_excess <= 1.0, f"dp vs no mesh: {plain_excess:.3g}x tolerance")
    cuda_gram.reset_launch_counts()
    ets, _, _, _ = _pde_run(_dp_argv("dp") + e4, os.path.join(tmp, "eager"), use_graph=False)
    eager_launches = cuda_gram.launch_counts()
    check(all(n == 0 for n in {**graph_launches, **eager_launches}.values()),
          f"gram kernels launched on the dp path: {graph_launches}, {eager_launches}")
    eager_excess, eager_bitwise = _state_excess(state_tree(dts), state_tree(ets))
    check(eager_excess <= 1.0, f"dp graph vs eager: {eager_excess:.3g}x tolerance")
    rates = {v: [] for v in dict.fromkeys(DP_TURNS)}
    for variant in DP_TURNS:
        tt = {}
        _pde_run(_with_flags(_dp_argv(variant), num_iters=DP_TURN_ITERS, eval_freq=10 ** 9),
                 os.path.join(tmp, f"turn{len(rates[variant])}{variant}"), tt)
        rates[variant].append(_block_rates(tt, "block_graph"))
    return {"argv": _dp_argv("dp"), "iters": DP_ITERS, "block": DP_BLOCK,
            "launches": {"graph_run": graph_launches, "eager_run": eager_launches},
            "eigvals": np.asarray(deigvals[-1]).tolist(),
            "eigvals_no_mesh": np.asarray(peigvals[-1]).tolist(),
            "vs_no_mesh": {"bit_for_bit": plain_bitwise, "tol_used": plain_excess,
                           "atol_of_max": DP_PLAIN_ATOL},
            "graph_vs_eager": {"bit_for_bit": eager_bitwise, "tol_used": eager_excess,
                               "rtol": PDE_STATE_RTOL, "atol_of_max": PDE_STATE_ATOL},
            "traced_nccl_and_copies_per_step": nccl,
            "traced_block_kernels_per_step": traced_kernels,
            "graph_block_steps_per_s_in_turns": {"order": list(DP_TURNS),
                                                 "iters": DP_TURN_ITERS, **rates}}


def _dp_spin(tmp):
    """SpIN at hydrogen.sh's flags on the one-rank NCCL group against no
    mesh: steps/s and peak device memory in turns, the states held to each
    other."""
    argv = _with_flags(HYDROGEN_ARGV, loss="spin", num_iters=DP_SPIN_ITERS,
                       print_freq=DP_SPIN_BLOCK, eval_freq=10 ** 9)
    out = {v: {"steps_per_s": [], "peak_mem_above_start_bytes": []}
           for v in dict.fromkeys(DP_SPIN_TURNS)}
    states = {}
    for i, variant in enumerate(DP_SPIN_TURNS):
        timings = {}
        torch.cuda.synchronize()
        start = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        ts, _, _, _ = _pde_run(argv + (["--mesh", "dp"] if variant == "dp" else []),
                               os.path.join(tmp, f"spin{i}{variant}"), timings)
        torch.cuda.synchronize()
        out[variant]["peak_mem_above_start_bytes"].append(
            torch.cuda.max_memory_allocated() - start)
        out[variant]["steps_per_s"].append(_block_rates(timings, "block_graph"))
        if variant not in states:
            states[variant] = state_tree(ts)
        del ts
    excess, bitwise = _state_excess(states["dp"], states["plain"], rtol=0.0,
                                    atol=DP_PLAIN_ATOL)
    check(excess <= 1.0, f"SpIN dp vs no mesh: {excess:.3g}x tolerance")
    return {"argv": argv, "iters": DP_SPIN_ITERS, "block": DP_SPIN_BLOCK,
            "order": list(DP_SPIN_TURNS), **out,
            "vs_no_mesh": {"bit_for_bit": bitwise, "tol_used": excess}}


def _dp_sketchy(tmp, root):
    """The Sketchy script, one epoch, with --mesh dp against the run
    without it on the plain loss."""
    i, j = SKETCHY_ARGV.index("--trunc_dims"), SKETCHY_ARGV.index("--ap_ver")
    argv = _with_flags(SKETCHY_ARGV[:i] + ["--trunc_dims", "512"] + SKETCHY_ARGV[j:],
                       num_epochs=1, n_retrievals_to_save=0)
    argv += ["--root_dir", root, "--sketchy_split", SKETCHY_SPLIT, "--seed", str(SEED),
             "--device", DEVICE]
    out, params = {}, {}
    for variant, extra in (("dp", ["--mesh", "dp"]), ("plain", ["--use_pallas", "false"])):
        log_dir = os.path.join(tmp, f"sketchy_{variant}")
        cuda_gram.reset_launch_counts()
        t0 = time.perf_counter()
        params[variant], _ = sketchy.main(get_args(argv + extra + ["--log_dir", log_dir]))
        torch.cuda.synchronize()
        rows = _csv_rows(log_dir)
        check(len(rows) == 1 and np.isfinite(float(rows[0]["loss"]))
              and int(rows[0]["skips"]) == 0, f"Sketchy {variant}: {rows}")
        out[variant] = {"run_s": time.perf_counter() - t0, "loss": float(rows[0]["loss"]),
                        "test_p_at_100": float(rows[0]["test_P@K"]),
                        "launches": cuda_gram.launch_counts()}
    check(all(n == 0 for n in out["dp"]["launches"].values()),
          f"gram kernels launched on the dp path: {out['dp']['launches']}")
    worst = max(_abs_excess(params["dp"][k].detach(), p.detach(), DP_SKETCHY_RTOL,
                            DP_SKETCHY_ATOL) for k, p in params["plain"].items())
    check(worst <= 1.0, f"Sketchy dp vs no mesh: {worst:.3g}x tolerance")
    bitwise = all(torch.equal(params["dp"][k], p) for k, p in params["plain"].items())
    return {"argv": argv, **out, "tol_used": worst, "bit_for_bit": bitwise,
            "rtol": DP_SKETCHY_RTOL, "atol": DP_SKETCHY_ATOL}


def _dp_step_inputs(tmp):
    """The E4 batch of phase dp's gloo step (two local batches of B/2 rows
    from the sampler) and the CDK pairs (B 4096 of CDK_DIM, class-correlated,
    from SEED), written to ``tmp``; with the single-process steps' results."""
    cfg = parse_pde_config(_dp_step_argv() + ["--device", DEVICE, "--log_dir", tmp])
    run = pde.build(cfg)
    x = run.sample(torch.Generator(DEVICE).manual_seed(SEED))
    half = BATCH // 2
    locals_ = [x[:half], x[half:]]
    q = half // 2
    union = torch.cat([locals_[0][:q], locals_[1][:q], locals_[0][q:], locals_[1][q:]])
    step = make_train_step(run.method, run.operator, run.optimizer, lambda g: union,
                           importance=run.importance_train, ema_decay=cfg.ema_decay)
    ts = init_train_state(run.model, run.optimizer, run.method)
    _, metrics = step(ts, None)
    e4 = {"loss": metrics["loss"].item(), "params": clone_tree(ts.params, "cpu")}
    rng = np.random.default_rng(SEED)
    cls = np.arange(CDK_B) % CDK_CLASSES
    cx, cy = (3 * rng.standard_normal((CDK_CLASSES, CDK_DIM), dtype=np.float32)
              for _ in range(2))
    cdk_x = cx[cls] + rng.standard_normal((CDK_B, CDK_DIM), dtype=np.float32)
    cdk_y = cy[cls] + rng.standard_normal((CDK_B, CDK_DIM), dtype=np.float32)
    np.savez(os.path.join(tmp, "inputs.npz"), x0=locals_[0].cpu().numpy(),
             x1=locals_[1].cpu().numpy(), cdk_x=cdk_x, cdk_y=cdk_y)
    tr = make_trainer(_dp_cdk_args(tmp), CDK_DIM, CDK_STEPS)
    skips = torch.zeros((), dtype=torch.int32, device=DEVICE)
    params, _, _, loss, _, _ = tr.step(tr.params, tr.opt_state, {},
                                       torch.as_tensor(cdk_x, device=DEVICE),
                                       torch.as_tensor(cdk_y, device=DEVICE), skips)
    cdk = {"loss": loss.item(), "params": clone_tree(params, "cpu")}
    return e4, cdk


def _dp_step_argv():
    """The E4 flags of the gloo step, on the plain loss, with SGD in place
    of RMSprop: RMSprop's first update is lr·g/(√((1-ρ)g²) + ε), ±lr/√(1-ρ)
    for every entry above ε, so an entry whose gradient sits inside the
    two summation orders' rounding (~1e-7 of the largest entry) would take
    a full-size step of either sign; SGD's update is linear in g."""
    return _with_flags(_dp_argv("plain"), optimizer="sgd")


def _dp_cdk_args(tmp, mesh=None):
    """The CDK flags of the gloo step, on the plain loss, with no grad clip:
    SGD's first update is linear in the gradient, so a gradient averaged
    over the ranks where it must be summed shows, where a clip that bites
    would scale either to the same norm."""
    return get_args(CDK_ARGV + ["--num_epochs", str(CDK_EPOCHS), "--use_pallas", "false",
                                "--grad_clip", "0", "--log_dir", tmp, "--device", DEVICE]
                    + (["--mesh", mesh] if mesh else []))


def _dp_gloo_rank(rank, port, tmp):
    """One of phase dp's two gloo ranks on the card (a spawned process):
    the group through make_mesh's torchrun path with backend gloo, its
    refusal of a CUDA graph, one E4 step and one CDK step on this rank's
    rows; results to ``tmp``/rank<r>.pt, a traceback to rank<r>.err."""
    from neuralsvd_tpu_torch.parallel import mesh as dp_mesh, sharding

    os.environ.update(MASTER_ADDR="localhost", MASTER_PORT=str(port), RANK=str(rank),
                      WORLD_SIZE="2")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")
    try:
        mesh = dp_mesh.make_mesh("dp=2", device=DEVICE, backend="gloo")
        group = dp_mesh.dp_group(mesh)
        try:
            dp_mesh.require_capturable(group, "cuda")
            refused = None
        except ValueError as e:
            refused = str(e)
        z = np.load(os.path.join(tmp, "inputs.npz"))
        cfg = parse_pde_config(_dp_step_argv() + ["--mesh", "dp=2", "--device", DEVICE,
                                                  "--log_dir", tmp])
        run = pde.build(cfg, axis_name=group)
        x = torch.as_tensor(z[f"x{rank}"], device=DEVICE)
        step = sharding.make_mesh_train_step(run.method, run.operator, run.optimizer,
                                             lambda g: x, mesh,
                                             importance=run.importance_train,
                                             ema_decay=cfg.ema_decay)
        ts = init_train_state(run.model, run.optimizer, run.method)
        _, metrics = step(ts, None)
        tr = make_trainer(_dp_cdk_args(tmp, "dp=2"), CDK_DIM, CDK_STEPS)
        rows = slice(rank * CDK_B // 2, (rank + 1) * CDK_B // 2)
        skips = torch.zeros((), dtype=torch.int32, device=DEVICE)
        params, _, _, loss, aux, skips = tr.step(
            tr.params, tr.opt_state, {}, torch.as_tensor(z["cdk_x"][rows], device=DEVICE),
            torch.as_tensor(z["cdk_y"][rows], device=DEVICE), skips)
        torch.save({"refused": refused, "backend": torch.distributed.get_backend(group),
                    "e4": {"loss": metrics["loss"].item(), "params": clone_tree(ts.params, "cpu")},
                    "cdk": {"loss": loss.item(), "params": clone_tree(params, "cpu"),
                            "f_rows": aux["f"].shape[0], "skips": int(skips)}},
                   os.path.join(tmp, f"rank{rank}.pt"))
    except BaseException:
        import traceback

        with open(os.path.join(tmp, f"rank{rank}.err"), "w") as fh:
            fh.write(traceback.format_exc())
        raise
    finally:
        if torch.distributed.is_initialized():
            torch.distributed.destroy_process_group()


def _spawn_two(target, tmp, prefix, timeout):
    """Run ``target(rank, port, tmp)`` in two spawned processes (a free
    localhost port for their group), each writing a traceback to
    ``tmp``/<prefix><rank>.err on failure; joined within ``timeout``
    seconds, then killed.  Fails the check unless both exit cleanly;
    returns the seconds the two took."""
    import multiprocessing
    import socket

    with socket.socket() as sock:
        sock.bind(("localhost", 0))
        port = sock.getsockname()[1]
    ctx = multiprocessing.get_context("spawn")
    t0 = time.perf_counter()
    procs = [ctx.Process(target=target, args=(r, port, tmp)) for r in range(2)]
    for p in procs:
        p.start()
    deadline = time.monotonic() + timeout
    for p in procs:
        p.join(max(0.0, deadline - time.monotonic()))
    hung = [r for r, p in enumerate(procs) if p.is_alive()]
    for p in procs:
        if p.is_alive():
            p.kill()
            p.join(10)
    errors = [open(os.path.join(tmp, f"{prefix}{r}.err")).read() for r in range(2)
              if os.path.exists(os.path.join(tmp, f"{prefix}{r}.err"))]
    check(not hung and not errors and all(p.exitcode == 0 for p in procs),
          f"{target.__name__}: hung {hung}, exit codes {[p.exitcode for p in procs]}: {errors}")
    return time.perf_counter() - t0


def _dp_gloo(tmp):
    """Two gloo ranks on the one card, spawned, against the single-process
    E4 and CDK steps."""
    e4, cdk = _dp_step_inputs(tmp)
    torch.cuda.empty_cache()
    out = {"spawn_s": _spawn_two(_dp_gloo_rank, tmp, "rank", DP_SPAWN_TIMEOUT_S)}
    for r in range(2):
        got = torch.load(os.path.join(tmp, f"rank{r}.pt"), weights_only=False)
        check(got["backend"] == "gloo" and got["refused"] and "gloo" in got["refused"],
              f"rank {r}: backend {got['backend']}, graph refusal {got['refused']!r}")
        check(got["cdk"]["f_rows"] == CDK_B and got["cdk"]["skips"] == 0,
              f"rank {r}: CDK aux rows {got['cdk']['f_rows']}, skips {got['cdk']['skips']}")
        for name, ref in (("e4", e4), ("cdk", cdk)):
            loss_excess = abs(got[name]["loss"] - ref["loss"]) / (
                DP_LOSS_TOL[0] * abs(ref["loss"]) + DP_LOSS_TOL[1])
            param_excess = {k: _abs_excess(got[name]["params"][k], p, *DP_PARAM_TOL)
                            for k, p in ref["params"].items()}
            worst = max(param_excess, key=param_excess.get)
            check(loss_excess <= 1.0 and param_excess[worst] <= 1.0,
                  f"gloo rank {r} {name} vs one process: loss {loss_excess:.3g}x, "
                  f"params {param_excess[worst]:.3g}x tolerance ({worst})")
            out.setdefault(name, {})[f"rank{r}"] = {
                "loss": got[name]["loss"], "loss_tol_used": loss_excess,
                "params_tol_used": param_excess[worst]}
    out["e4"]["single_loss"], out["cdk"]["single_loss"] = e4["loss"], cdk["loss"]
    out["graph_refusal"] = got["refused"]
    return out


def phase_dp(root):
    """Data parallelism (--mesh dp) on the card: the E4 CLI, the Sketchy
    script and SpIN on a one-rank NCCL group, two gloo ranks on the one
    card."""
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as tmp:
        e4 = _dp_e4(tmp)
        sk = _dp_sketchy(tmp, root)
        spin = _dp_spin(tmp)
        torch.distributed.destroy_process_group()  # the one-rank NCCL group
        gloo = _dp_gloo(tmp)
    emit("dp", e4=e4, sketchy=sk, spin=spin, gloo=gloo, phase_s=time.perf_counter() - t0)


def _tp_e4_argv(optimizer, iters, mesh=None):
    """The E4 flags of a phase tp run (K1-K3 by default) on ``optimizer``
    for ``iters`` steps with one eval, with ``mesh``."""
    return _with_flags(PDE_E4_ARGV, num_iters=iters, eval_freq=iters,
                       print_freq=min(iters, TP_E4_BLOCK),
                       optimizer=optimizer) + (["--mesh", mesh] if mesh else [])


def _tp_e4_runs(tmp, mesh=None):
    """The phase tp E4 runs (TP_E4_RUNS): each one's whole parameters
    (CPU), last eigenvalues, run directory, K1-K3 launches and eager
    steps/s."""
    out = {}
    for optimizer, iters in TP_E4_RUNS:
        cuda_gram.reset_launch_counts()
        timings = {}
        ts, eigvals, run_dir, _ = _pde_run(
            _tp_e4_argv(optimizer, iters, mesh),
            os.path.join(tmp, f"tp_{mesh or 'single'}_{optimizer}"), timings, use_graph=False)
        out[optimizer] = {"params": clone_tree(ts.params, "cpu"),
                          "opt_state": {k: v.detach().cpu() for k, v in named_leaves(ts.opt_state)},
                          "iters": iters,
                          "eigvals": np.asarray(eigvals[-1]).tolist(), "run_dir": run_dir,
                          "launches": cuda_gram.launch_counts(),
                          "steps_per_s": _block_rates(timings, "block_eager")}
        del ts
    return out


def _tp_adaptive_check(label, ref, got):
    """An adaptive optimizer's one step at tp against one process: every
    tensor of the optimizer state (the gradient's moments) within TP_TOL,
    atol scaled by the leaf's largest |entry|; and every parameter entry
    outside TP_TOL one whose one-process gradient (read from the second
    moment ``nu``) is under TP_FLIP_GRAD of its leaf's largest, where the
    update's sign follows the rounding.  Returns both readings."""
    moments = {k: _abs_excess(got["opt_state"][k].double(), m.double(), TP_TOL[0],
                              TP_TOL[1] * max(m.abs().max().item(), 1e-30))
               for k, m in ref["opt_state"].items()}
    worst = max(moments, key=moments.get)
    check(set(got["opt_state"]) == set(ref["opt_state"]) and moments[worst] <= 1.0,
          f"{label}: optimizer state {moments[worst]:.3g}x tolerance ({worst})")
    flip, misses = 0.0, 0
    for k, p in ref["params"].items():
        miss = (got["params"][k] - p).abs() > TP_TOL[0] * p.abs() + TP_TOL[1]
        if miss.any():
            nu = next(v for n, v in ref["opt_state"].items() if f".{n}".endswith(f".nu.{k}"))
            grad = nu.double().sqrt()
            flip = max(flip, (grad[miss].max() / grad.max()).item())
            misses += int(miss.sum())
    check(flip <= TP_FLIP_GRAD, f"{label}: a parameter outside the tolerance has "
                                f"{flip:.3g} of its leaf's largest gradient")
    return {"moments_tol_used": moments[worst], "worst_moment": worst,
            "misses": misses, "grad_at_misses": flip}


def _tp_cdk_args(tmp, mesh=None):
    """The paper-width f32 CDK flags (CDK_ARGV, its grad clip included) of
    phase tp's step, with ``mesh``."""
    return get_args(CDK_ARGV + ["--num_epochs", str(CDK_EPOCHS), "--log_dir", tmp,
                                "--device", DEVICE] + (["--mesh", mesh] if mesh else []))


def _tp_references(tmp):
    """The one-process E4 runs and CDK steps of phase tp, the initial E4
    parameters, and the CDK pairs written to ``tmp``/tp_inputs.npz."""
    e4 = _tp_e4_runs(tmp)
    cfg = parse_pde_config(_tp_e4_argv(*TP_E4_RUNS[0]) + ["--device", DEVICE])
    init = {k: p.detach().cpu().clone() for k, p in pde.build(cfg).model.named_parameters()}
    rng = np.random.default_rng(SEED + 17)
    cls = np.arange(CDK_B) % CDK_CLASSES
    cx, cy = (3 * rng.standard_normal((CDK_CLASSES, CDK_DIM), dtype=np.float32)
              for _ in range(2))
    x = cx[cls] + rng.standard_normal((CDK_B, CDK_DIM), dtype=np.float32)
    y = cy[cls] + rng.standard_normal((CDK_B, CDK_DIM), dtype=np.float32)
    np.savez(os.path.join(tmp, "tp_inputs.npz"), x=x, y=y)
    cuda_gram.reset_launch_counts()
    cdk = _tp_cdk_steps(_tp_cdk_args(tmp), x, y)
    cdk["launches"] = cuda_gram.launch_counts()
    torch.cuda.empty_cache()
    spin = _tp_spin_runs(tmp)
    cfg = parse_pde_config(_tp_spin_argv("spin") + ["--device", DEVICE])
    spin["init"] = {k: p.detach().cpu().clone()
                    for k, p in pde.build(cfg).model.named_parameters()}
    return e4, init, cdk, spin


def _tp_spin_argv(loss, mesh=None):
    """hydrogen.sh's flags of a phase tp SpIN or SpINx run (TP_SPIN_*)."""
    return _with_flags(HYDROGEN_ARGV, loss=loss, optimizer="sgd", use_lr_scheduler="false",
                       grad_clip=TP_SPIN_CLIP, num_iters=TP_SPIN_ITERS,
                       eval_freq=TP_SPIN_ITERS, print_freq=TP_SPIN_ITERS // 2,
                       val_eps=TP_SPIN_VAL_EPS) + (["--mesh", mesh] if mesh else [])


def _same_on_every_rank(tree) -> bool:
    """Whether every rank's tensors of ``tree`` equal rank 0's bit for bit
    (rank 0's broadcast over the default group)."""
    leaves = [t for _, t in named_leaves(tree) if t.is_floating_point()]
    flat = torch.cat([t.detach().reshape(-1) for t in leaves])
    ref = flat.clone()
    torch.distributed.broadcast(ref, 0)
    differ = torch.tensor([float(not torch.equal(flat, ref))], device=flat.device)
    torch.distributed.all_reduce(differ)
    return differ.item() == 0


def _tp_spin_runs(tmp, mesh=None):
    """The phase tp SpIN and SpINx runs (TP_SPIN_*), eager, with ``mesh``:
    each one's whole parameters and method state (CPU; under a mesh on rank
    0 only, the ranks checked bit for bit), last eigenvalues, run directory,
    K1-K3 launches, the method state's bytes on this rank, peak memory and
    eager steps/s."""
    out = {}
    for loss in TP_SPIN_LOSSES:
        cuda_gram.reset_launch_counts()
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        timings = {}
        ts, eigvals, run_dir, records = _pde_run(
            _tp_spin_argv(loss, mesh), os.path.join(tmp, f"tp_{mesh or 'single'}_{loss}"),
            timings, use_graph=False)
        torch.cuda.synchronize()
        rows = _rows(records)
        check(rows and all(np.isfinite(r["train_loss"]) and "skips" not in r for r in rows),
              f"tp {loss} ({mesh}): rows {rows}")
        res = {"eigvals": np.asarray(eigvals[-1]).tolist(), "run_dir": run_dir,
               "launches": cuda_gram.launch_counts(),
               "state_bytes": next(r.args for r in records
                                   if r.msg.startswith("method state bytes")),
               "peak_bytes": torch.cuda.max_memory_allocated(),
               "steps_per_s": _block_rates(timings, "block_eager")}
        if mesh:
            res["same_as_rank0"] = _same_on_every_rank(
                {"params": ts.params, "method_state": ts.method_state})
        if not mesh or torch.distributed.get_rank() == 0:
            res.update(params=clone_tree(ts.params, "cpu"),
                       method_state=clone_tree(ts.method_state, "cpu"))
        out[loss] = res
        del ts
        torch.cuda.empty_cache()
    return out


def _tp_cdk_steps(args, x, y):
    """TP_CDK_STEPS CDK steps of ``make_trainer(args)`` on the pairs: the
    whole parameters (gathered under tp), the shapes held, the last loss,
    the skips and the steps' seconds."""
    tr = make_trainer(args, CDK_DIM, CDK_STEPS)
    x, y = torch.as_tensor(x, device=DEVICE), torch.as_tensor(y, device=DEVICE)
    params, opt_state = tr.params, tr.opt_state
    skips = torch.zeros((), dtype=torch.int32, device=DEVICE)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(TP_CDK_STEPS):
        params, opt_state, _, loss, _, skips = tr.step(params, opt_state, {}, x, y, skips)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    whole = params if tr.shards is None else tr.shards.gather_tree(params)
    return {"params": clone_tree(whole, "cpu"), "loss": loss.item(), "skips": int(skips),
            "held": {k: list(p.shape) for k, p in params.items()}, "steps_s": seconds}


def _tp_gloo_rank(rank, port, tmp):
    """One of phase tp's two gloo ranks on the card (a spawned process):
    the E4 run, the CDK steps and the SpIN and SpINx runs at --mesh tp=2;
    results to ``tmp``/tp_rank<r>.pt, a traceback to tp_rank<r>.err."""
    from neuralsvd_tpu_torch.parallel import mesh as tp_mesh

    os.environ.update(MASTER_ADDR="localhost", MASTER_PORT=str(port), RANK=str(rank),
                      WORLD_SIZE="2")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        tp_mesh.init_process_group(DEVICE, backend="gloo")  # the CLIs reuse it
        out = {"e4": _tp_e4_runs(tmp, "tp=2")}
        z = np.load(os.path.join(tmp, "tp_inputs.npz"))
        cuda_gram.reset_launch_counts()
        out["cdk"] = _tp_cdk_steps(_tp_cdk_args(tmp, "tp=2"), z["x"], z["y"])
        out["cdk"]["launches"] = cuda_gram.launch_counts()
        torch.cuda.empty_cache()
        out["spin"] = _tp_spin_runs(tmp, "tp=2")
        out["backend"] = torch.distributed.get_backend()
        torch.save(out, os.path.join(tmp, f"tp_rank{rank}.pt"))
    except BaseException:
        import traceback

        with open(os.path.join(tmp, f"tp_rank{rank}.err"), "w") as fh:
            fh.write(traceback.format_exc())
        raise
    finally:
        if torch.distributed.is_initialized():
            torch.distributed.destroy_process_group()


def _tp_checkpoint_in_one_process(run_dir, params):
    """The tp run's last checkpoint loaded into a one-process TrainState of
    the E4 flags (every shape whole): whether its parameters equal the
    run's bit for bit, and the file's bytes."""
    path = os.path.join(run_dir, f"ckpt_{TP_E4_ITERS}")
    cfg = parse_pde_config(_tp_e4_argv(*TP_E4_RUNS[0]) + ["--device", DEVICE])
    run = pde.build(cfg)
    template = init_train_state(run.model, run.optimizer, run.method)
    load_state_tree(template, load_checkpoint(path))
    same = all(torch.equal(template.params[k].cpu(), p) for k, p in params.items())
    return same, os.path.getsize(path)


def _tp_spin_in_one_process(loss, run_dir, whole):
    """The tp run's last checkpoint in a one-process TrainState of its
    flags: whether its parameters and method state equal the run's
    (``whole``, gathered) bit for bit; for SpINx the weights one process
    refreshes from it on the refresh's batch (train_operator's
    REFRESH_STREAM at the last step) in float32 and in float64, and the tp
    run's refreshed weights held to the float64 ones (see TP_SPIN_*)."""
    cfg = parse_pde_config(_tp_spin_argv(loss) + ["--device", DEVICE])
    run = pde.build(cfg)
    template = init_train_state(run.model, run.optimizer, run.method)
    path = os.path.join(run_dir, f"ckpt_{TP_SPIN_ITERS}")
    t0 = time.perf_counter()
    load_state_tree(template, load_checkpoint(path))
    out = {"bytes": os.path.getsize(path), "load_s": time.perf_counter() - t0}
    state = clone_tree(template.method_state, "cpu")
    if loss == "spinx":  # the checkpoint is written before the eval's refresh
        state["weights"] = whole["method_state"]["weights"]
    out["equal"] = (all(torch.equal(template.params[k].cpu(), p) for k, p in
                        whole["params"].items())
                    and all(torch.equal(a, b) for (_, a), (_, b) in
                            zip(named_leaves(state), named_leaves(whole["method_state"]))))
    check(out["equal"], f"tp {loss}: the checkpoint in one process differs from the run")
    if loss == "spinx":
        refreshed = {}
        for dtype in (torch.float32, torch.float64):
            run.model.to(dtype)  # template.params are its parameters
            state = _to(template.method_state, DEVICE, dtype)
            x = run.sample(torch.Generator(device=DEVICE).manual_seed(
                block_seed(cfg.seed, TP_SPIN_ITERS, REFRESH_STREAM)))
            run.method.refresh_weights(template.params, state,
                                       x.reshape(x.shape[0], -1).to(dtype), run.operator,
                                       run.importance_train)
            refreshed[dtype] = state["weights"].double().cpu()
        f64 = refreshed[torch.float64]
        tp_err = _abs_excess(whole["method_state"]["weights"].double(), f64,
                             TP_WEIGHTS_RTOL, 0.0)
        single_err = _abs_excess(refreshed[torch.float32], f64, TP_WEIGHTS_RTOL, 0.0)
        out.update(weights_f64=f64.tolist(), tp_vs_f64_rtol_used=tp_err,
                   one_process_f32_vs_f64_rtol_used=single_err)
        check(tp_err <= max(1.0, RECIPE_F64_FACTOR * single_err),
              f"tp spinx: the tp run's refresh {tp_err:.3g}x rtol {TP_WEIGHTS_RTOL} of the "
              f"float64 refresh, one process's float32 {single_err:.3g}x")
    del template
    torch.cuda.empty_cache()
    return out


def _tp_spin_checks(ref, got):
    """Phase tp's SpIN and SpINx runs at tp=2 against one process
    (TP_SPIN_*); returns the readings and each path's launches."""
    out, launches = {}, {}
    for loss in TP_SPIN_LOSSES:
        r, ranks = ref[loss], [g["spin"][loss] for g in got]
        g0 = ranks[0]
        res = {"single": {k: v for k, v in r.items() if k not in ("params", "method_state")}}
        excess = {f"param {k}": _abs_excess(g0["params"][k], p, *TP_TOL)
                  for k, p in r["params"].items()}
        want = dict(named_leaves(r["method_state"]))
        for k, v in named_leaves(g0["method_state"]):
            if k != "weights":
                excess[f"state {k}"] = _abs_excess(
                    v, want[k], TP_TOL[0], TP_TOL[1] * want[k].abs().max().item())
        worst = max(excess, key=excess.get)
        check(excess[worst] <= 1.0, f"tp {loss} vs one process: {excess[worst]:.3g}x "
                                    f"tolerance ({worst})")
        res.update(tol_used=excess[worst], worst_leaf=worst,
                   moved=max((p - ref["init"][k]).abs().max().item()
                             for k, p in r["params"].items()))
        check(res["moved"] > TP_SPIN_MOVED, f"tp {loss}: the parameters moved {res['moved']:.3g}")
        if loss == "spinx":  # information: two runs' refreshes (not gated, see TP_SPIN_*)
            res["weights_run_vs_run_rtol_used"] = _abs_excess(
                g0["method_state"]["weights"], r["method_state"]["weights"], 1e-4, 0.0)
        for i, g in enumerate(ranks):
            check(g["same_as_rank0"], f"tp {loss}: rank {i} differs from rank 0")
            check(not any(g["launches"].values()) and not any(r["launches"].values()),
                  f"tp {loss}: K1-K3 launched {g['launches']}, one process {r['launches']}")
            if loss == "spin":
                check(2 * g["state_bytes"]["j_avg"] == r["state_bytes"]["j_avg"],
                      f"tp spin rank {i}: j_avg {g['state_bytes']} against one process's "
                      f"{r['state_bytes']}")
            res[f"rank{i}"] = {k: v for k, v in g.items() if k not in ("params", "method_state")}
        launches[f"tp_{loss}"] = {k: sum(g["launches"][k] for g in ranks) for k in g0["launches"]}
        res["checkpoint"] = _tp_spin_in_one_process(loss, g0["run_dir"], g0)
        out[loss] = res
    return out, launches


def phase_tp(tmp):
    """Tensor parallelism on the card: two gloo ranks at --mesh tp=2, the
    E4 CLI run, the paper-width CDK step and SpIN and SpINx at hydrogen.sh's
    width against one process; returns each kernel's launches on the two
    ranks, by path."""
    t0 = time.perf_counter()
    e4, init, cdk, spin = _tp_references(tmp)
    spawn_s = _spawn_two(_tp_gloo_rank, tmp, "tp_rank", TP_SPAWN_TIMEOUT_S)
    got = [torch.load(os.path.join(tmp, f"tp_rank{r}.pt"), weights_only=False)
           for r in range(2)]
    out = {"spawn_s": spawn_s, "backend": got[0]["backend"], "tol": TP_TOL}
    launches = {}
    checked = TP_E4_RUNS[0][0]
    cases = [("e4", opt, e4[opt], [g["e4"][opt] for g in got], steps)
             for opt, steps in TP_E4_RUNS] + [("cdk", None, cdk, [g["cdk"] for g in got],
                                               TP_CDK_STEPS)]
    for name, opt, ref, ranks, steps in cases:
        label = name if opt is None else f"{name} {opt}"
        check(all(n == steps for n in ref["launches"].values()) and ref["launches"],
              f"tp {label} one process: launches {ref['launches']} for {steps} steps")
        res = {"single": {k: v for k, v in ref.items() if k not in ("params", "opt_state")}}
        for r, g in enumerate(ranks):
            excess = {k: _abs_excess(g["params"][k], p, *TP_TOL) for k, p in ref["params"].items()}
            worst = max(excess, key=excess.get)
            if opt in (None, checked):
                check(excess[worst] <= 1.0, f"tp rank {r} {label} vs one process: "
                                            f"{excess[worst]:.3g}x tolerance ({worst})")
                adaptive = {}
            else:
                adaptive = _tp_adaptive_check(f"tp rank {r} {label}", ref, g)
            check(all(torch.equal(g["params"][k], ranks[0]["params"][k])
                      for k in ref["params"]), f"tp {label}: rank {r} differs from rank 0")
            check(set(g["launches"]) == set(ref["launches"])
                  and all(n == steps for n in g["launches"].values()),
                  f"tp rank {r} {label}: launches {g['launches']} for {steps} steps")
            for k, n in g["launches"].items():
                launches.setdefault(f"tp_{name}", {}).setdefault(k, 0)
                launches[f"tp_{name}"][k] += n
            res[f"rank{r}"] = {k: v for k, v in g.items() if k not in ("params", "opt_state")}
            res[f"rank{r}"].update(tol_used=excess[worst], worst_leaf=worst, **adaptive)
        if opt == checked:
            res["moved"] = max((p - init[k]).abs().max().item() for k, p in ref["params"].items())
            check(res["moved"] > 10 * TP_TOL[1], f"tp e4: the parameters moved {res['moved']:.3g}")
        out[label.replace(" ", "_")] = res
    held, width = got[0]["cdk"]["held"], parse_dims(_tp_cdk_args(tmp).network_dims)
    check(held["x.layers.1.w"] == [width[0], width[1] // 2]
          and held["y.layers.1.b"] == [width[1] // 2]
          and held["x.layers.0.w"] == [CDK_DIM, width[0]], f"tp CDK shares held: {held}")
    check(all(g["cdk"]["skips"] == 0 for g in got), "tp CDK: a skipped step")
    same, nbytes = _tp_checkpoint_in_one_process(got[0]["e4"][checked]["run_dir"],
                                                 got[0]["e4"][checked]["params"])
    check(same, "tp checkpoint loaded in one process differs from the run's parameters")
    out["checkpoint"] = {"loads_in_one_process": same, "bytes": nbytes}
    out["spin"], spin_launches = _tp_spin_checks(spin, got)
    launches.update(spin_launches)
    emit("tp", **out, launches=launches, phase_s=time.perf_counter() - t0)
    return launches


def _export_case(tmp, label, apply_fn, params, input_dim):
    """One serving export on the card: saved to ``tmp``/<label>.pt2 and
    reloaded; at EXPORT_BATCHES rows against the eager ``apply_fn``, bit
    for bit or within EXPORT_RTOL/EXPORT_ATOL of the largest entry; the
    exported and eager calls' CUDA-event ms."""
    path = os.path.join(tmp, f"{label}.pt2")
    t0 = time.perf_counter()
    export.save_evaluator(path, apply_fn, params, input_dim)
    out = {"export_s": time.perf_counter() - t0, "bytes": os.path.getsize(path)}
    t0 = time.perf_counter()
    fn = export.load_evaluator_file(path)
    out["load_s"] = time.perf_counter() - t0
    out["tiered_ops"] = sum("tiered_einsum" in str(n.target) for n in fn.graph.nodes)
    gen = torch.Generator(device=DEVICE).manual_seed(SEED)
    for rows in EXPORT_BATCHES:
        x = torch.randn((rows, input_dim), generator=gen, device=DEVICE)
        with torch.no_grad():
            got, want = fn(x), apply_fn(params, x)
        check(got.shape == want.shape, f"export {label}: shape {got.shape} != {want.shape}")
        excess = _excess(got.double(), want.double(), EXPORT_RTOL, EXPORT_ATOL)
        check(excess <= 1.0, f"export {label} at {rows} rows: {excess:.3g}x tolerance")
        with torch.no_grad():
            out[f"rows{rows}"] = {
                "bit_for_bit": torch.equal(got, want), "tol_used": excess,
                "ms": time_ms(lambda: fn(x), iters=20, reps=5),
                "eager_ms": time_ms(lambda: apply_fn(params, x), iters=20, reps=5)}
    return out


def phase_export(tmp):
    """The serving export (utils/export.py) on the card: the E4
    wavefunction (float32 and the 'high' tier) and the paper-width CDK x
    tower (f32, bf16), reloaded from their files against the eager
    modules."""
    from torch.func import functional_call

    t0 = time.perf_counter()
    out = {"tol": [EXPORT_RTOL, EXPORT_ATOL], "batches": list(EXPORT_BATCHES)}
    for label, flags in (("e4", []), ("e4_high", ["--matmul_precision", "high"])):
        cfg = parse_pde_config(PDE_E4_ARGV + flags + ["--device", DEVICE])
        model = pde.build(cfg).model
        params = {k: p.detach() for k, p in model.named_parameters()}
        out[label] = _export_case(tmp, label, lambda p, x, m=model: functional_call(m, p, (x,)),
                                  params, NDIM)
    check(out["e4"]["tiered_ops"] == 0 and out["e4_high"]["tiered_ops"] == len(HIDDEN) + 1,
          f"export: tiered products {out['e4']['tiered_ops']}, {out['e4_high']['tiered_ops']}")
    args = _tp_cdk_args(tmp)
    for label, dtype in (("cdk_f32", None), ("cdk_bf16", "bf16")):
        net = HeteroNetwork(CDK_DIM, parse_dims(args.network_dims), args.activation, mu=args.mu,
                            generator=torch.Generator().manual_seed(SEED),
                            compute_dtype=dtype).to(DEVICE)
        params = {k: p.detach() for k, p in net.named_parameters()}
        out[label] = _export_case(
            tmp, label, lambda p, x, m=net: functional_call(m, p, (x, x))[0], params, CDK_DIM)
    emit("export", **out, phase_s=time.perf_counter() - t0)


def phase_dryrun():
    """graft_entry: the flagship model's entry on the card, and
    dryrun_multichip on DRYRUN_RANKS gloo CPU ranks in its subprocess."""
    t0 = time.perf_counter()
    fn, args = graft_entry.entry()
    with torch.no_grad():
        out = fn(*args)
    check(out.shape == (512, 36) and bool(torch.isfinite(out).all()),
          f"entry: {tuple(out.shape)}")
    t1 = time.perf_counter()
    graft_entry.dryrun_multichip(DRYRUN_RANKS)
    emit("dryrun", entry_shape=list(out.shape), ranks=DRYRUN_RANKS,
         dryrun_s=time.perf_counter() - t1, phase_s=time.perf_counter() - t0)


def _ns_env(**extra):
    """The north star's environment: the E4 recipe (the script's defaults)
    with NS_CHUNK and the partial rows of this phase, plus ``extra``."""
    env = {"NS_CHUNK": str(NS_CHUNK), "NS_EVAL_EVERY": str(NS_EVAL_EVERY)}
    env.update({k: str(v) for k, v in extra.items()})
    return env


def _northstar(num_iters, env, traced_start=None):
    """validate_northstar.main at lap_eps -1 on ``env``: (record, info,
    the JSON lines it printed, the traced block's ``_profiled`` numbers or
    None).  The block at iteration ``traced_start`` runs under the
    profiler (``_traced_block``)."""
    out = io.StringIO()
    with _traced_block(traced_start) as traced, contextlib.redirect_stdout(out):
        record, info = vn.main(num_iters, -1.0, device=DEVICE, env=env)
    lines = [ln for ln in out.getvalue().splitlines() if ln.startswith("{")]
    check(json.loads(lines[-1]) == json.loads(json.dumps(record)),
          "the north star's last JSON line is not its record")
    check(info["skipped"] == 0 and info["nonfinite_losses"] == 0,
          f"north star: {info['skipped']} skipped steps, "
          f"{info['nonfinite_losses']} non-finite losses")
    check(np.isfinite(record["value"]) and record["num_iters"] > 0,
          f"north star record {record}")
    return record, info, lines, (traced or None)


def _northstar_sums_vs_cpu(ts):
    """The eval's (cov, quad) of the trained EMA parameters on the card
    against a float64 CPU copy on the same NS_CPU_ROUNDS draws."""
    cfg = vn.read_config(_ns_env())
    card = vn.build_model(cfg, -1.0, DEVICE)
    cpu = vn.build_model(cfg, -1.0, "cpu")
    cpu.model.double()
    card_method, cpu_method = vn.build_method(cfg, card.model), vn.build_method(cfg, cpu.model)
    sampler, _ = vn.make_sampling(cfg, vn.EVAL_BATCH, DEVICE)
    params64 = {k: v.detach().double().cpu() for k, v in ts.ema_params.items()}
    got, want = [0.0, 0.0], [0.0, 0.0]
    t0 = time.perf_counter()
    for r in range(NS_CPU_ROUNDS):
        x = sampler(rayleigh.round_generator(vn.EVAL_SEED, r, DEVICE))
        sums = rayleigh.sums(card.operator, rayleigh.eval_fn(card_method, ts.ema_params, {}),
                             card.importance, x)
        ref = rayleigh.sums(cpu.operator, rayleigh.eval_fn(cpu_method, params64, {}),
                            cpu.importance, x.double().cpu())
        for i in range(2):
            got[i] = got[i] + sums[i].double().cpu()
            want[i] = want[i] + ref[i]
    excess = {name: _excess(g, w, NS_CPU_RTOL, NS_CPU_ATOL)
              for name, g, w in zip(("cov", "quad"), got, want)}
    check(all(v <= 1.0 for v in excess.values()),
          f"north-star eval sums card vs float64 CPU: excess {excess}")
    return {"rounds": NS_CPU_ROUNDS, "rows": NS_CPU_ROUNDS * vn.EVAL_BATCH,
            "rtol": NS_CPU_RTOL, "atol": NS_CPU_ATOL, "excess": excess,
            "max_abs_err": {name: float(torch.max(torch.abs(g - w)))
                            for name, g, w in zip(("cov", "quad"), got, want)},
            "seconds": time.perf_counter() - t0}


def _northstar_resume(tmp, straight_ts):
    """A run stopped at its first partial row and resumed through NS_CKPT
    ends bit for bit where the straight run ended."""
    ckpt = os.path.join(tmp, "northstar.ckpt")
    env = _ns_env(NS_EVAL_ROUNDS=2, NS_CKPT=ckpt)
    first, _, _, _ = _northstar(NS_ITERS, dict(env, NS_GATE="1e9"))
    check(first["num_iters"] == NS_EVAL_EVERY and os.path.exists(ckpt),
          f"the stopped run: {first['num_iters']} iters")
    resumed, info, _, _ = _northstar(NS_ITERS, env)
    check(resumed["resumed_at_iter"] == NS_EVAL_EVERY and resumed["num_iters"] == NS_ITERS,
          f"the resumed run: {resumed}")
    ts = info["ts"]
    same = {name: _state_excess(getattr(ts, name), getattr(straight_ts, name))[1]
            for name in ("params", "ema_params", "opt_state")}
    same["step"] = int(ts.step) == int(straight_ts.step) == NS_ITERS
    check(all(same.values()), f"resumed vs straight north star, bit for bit: {same}")
    return {"stopped_at": first["num_iters"], "resumed_at": resumed["resumed_at_iter"],
            "bit_for_bit": same, "resumed_steps_per_s": resumed["train_steps_per_sec"]}


def _northstar_levers(tmp):
    """The L 36 flagship's levers: guards, the tail-LR chain and the clone
    rescue under the graph; a forced duplicate exiled by the resumed run's
    first rescue."""
    src, dst = NS_LEVERS_DUP
    ckpt = os.path.join(tmp, "levers.ckpt")
    env = dict(NS_LEVERS_ENV, NS_CHUNK=str(NS_LEVERS_CHUNK),
               NS_RESCUE_EVERY=str(NS_LEVERS_CHUNK), NS_RESCUE_END=NS_LEVERS_END,
               NS_EVAL_EVERY=str(NS_LEVERS_FIRST), NS_EVAL_ROUNDS=str(NS_LEVERS_ROUNDS),
               NS_CKPT=ckpt)
    t0 = time.perf_counter()
    first, first_info, _, _ = _northstar(NS_LEVERS_ITERS, dict(env, NS_GATE="1e9"))
    check(first["num_iters"] == NS_LEVERS_FIRST, f"levers first run: {first}")
    saved = load_checkpoint(ckpt)
    _duplicate_mode(saved["ts"], NS_LEVERS_L, src, dst)
    save_checkpoint(ckpt, saved)
    cuda_gram.reset_launch_counts()
    record, info, lines, traced = _northstar(NS_LEVERS_ITERS, env, NS_LEVERS_TRACED)
    launches = _traced_launches("levers", traced)
    rescues = info["rescues"]
    first_rescue = NS_LEVERS_FIRST + NS_LEVERS_CHUNK
    check(rescues and rescues[0][0] == first_rescue and rescues[0][1] >= 1,
          f"the resumed run's rescues {rescues}: the duplicate {src}/{dst} not exiled "
          f"at {first_rescue}")
    ts = info["ts"]
    check(all(torch.isfinite(p).all() for p in ts.params.values()), "levers: parameters")
    return {"env": env, "iters": NS_LEVERS_ITERS, "first_run_rescues": first_info["rescues"],
            "duplicated": [src, dst], "resumed_run_rescues": rescues,
            "record": record, "traced_block": traced, "launches": launches,
            "seconds": time.perf_counter() - t0}


def _methods():
    """validate_methods.run for each method at VM_STEPS steps in blocks of
    VM_BLOCK, NestedLoRA's block at VM_TRACED traced: (rows, NestedLoRA's
    launches)."""
    rows = {}
    for name, lr in vm.METHODS:
        stats = {}
        cuda_gram.reset_launch_counts()
        with _traced_block(VM_TRACED if name == "neuralsvd" else None) as traced:
            ray, gts, rel = vm.run(name, VM_STEPS, lr, device=DEVICE, stats=stats,
                                   block=VM_BLOCK)
        check(stats["skipped"] == 0 and stats["nonfinite_losses"] == 0
              and np.isfinite(ray).all(), f"validate_methods {name}: {stats} {ray}")
        rows[name] = {"learned": ray.tolist(), "analytic": gts.tolist(),
                      "max_rel_err": float(rel.max()),
                      "steps_per_s": VM_STEPS / stats["train_s"],
                      "eager_launches": cuda_gram.launch_counts()}
        if name == "neuralsvd":
            launches = _traced_launches("validate_methods neuralsvd", traced)
            rows[name]["traced_block"] = traced
    check(not any(any(rows[m]["eager_launches"].values())
                  for m in ("neuralef", "spinx", "spin")),
          f"validate_methods launches {[r['eager_launches'] for r in rows.values()]}")
    return rows, launches


def _fp_validate(tmp):
    """validate_fokker_planck.main, 1D and 2D at VF_ITERS steps in blocks
    of VF_CHUNK, the 1D run's block at VF_TRACED traced: (record, the
    launches of both runs)."""
    cuda_gram.reset_launch_counts()
    with _traced_block(VF_TRACED) as traced, contextlib.redirect_stdout(io.StringIO()):
        fp = vf.main(VF_ITERS, VF_ITERS, 0, device=DEVICE, chunk=VF_CHUNK,
                     env={"NS_FP_OUT": os.path.join(tmp, "fp")})
    check(np.isfinite(fp["value"]) and set(fp["detail"]) == {"fp1d", "fp2d"},
          f"validate_fokker_planck: {fp}")
    return fp, traced, _traced_launches("validate_fokker_planck", traced, captures=2)


@contextlib.contextmanager
def _figure_seconds(cli, writers):
    """{PNG name: seconds} of each figure written inside the block: the
    whole call of each writer ``writers`` of the module ``cli`` (the
    field's ranges or the histograms, drawing, encoding, the .npz beside
    it), else ``raster.Figure.write_png`` alone (layout, drawing,
    encoding)."""
    seconds = {}

    def timed(fn, name_of):
        def call(*args, **kwargs):
            t0 = time.perf_counter()
            out = fn(*args, **kwargs)
            seconds[name_of(args, out)] = time.perf_counter() - t0
            return out
        return call

    png = lambda path: os.path.splitext(os.path.basename(path))[0] + ".png"
    saved = {name: getattr(cli, name) for name in writers}
    write = raster.Figure.write_png
    raster.Figure.write_png = timed(write, lambda args, out: png(out))
    for name, fn in saved.items():
        setattr(cli, name, timed(fn, lambda args, out: png(out)))
    try:
        yield seconds
    finally:
        raster.Figure.write_png = write
        for name, fn in saved.items():
            setattr(cli, name, fn)


def _grid_size(modes):
    """(H, W) of plot_2d_eigfuncs' grid of ``modes`` panels: 300 pixels a
    panel (2 inches at dpi 150), ceil(sqrt(modes)) columns."""
    cols = int(np.ceil(np.sqrt(modes)))
    return 300 * -(-modes // cols), 300 * cols


def _figure_rows(label, run_dir, seconds, sizes):
    """Each PNG of ``sizes`` ({name: (H, W)}) in ``run_dir``: decoded at
    its size, the ``.npz`` of its arrays beside it; its bytes and the
    seconds it took to draw."""
    rows = []
    for name, size in sizes.items():
        path = os.path.join(run_dir, name)
        check(os.path.exists(path), f"{label}: no {name} in {sorted(os.listdir(run_dir))}")
        check(os.path.exists(path[:-len(".png")] + ".npz"), f"{label}: no .npz beside {name}")
        with open(path, "rb") as fh:
            shape = raster.decode_png(fh.read()).shape
        check(shape == (*size, 3), f"{label}: {name} is {shape}, not {size}")
        rows.append({"run": label, "name": name, "height_width": list(size),
                     "bytes": os.path.getsize(path), "seconds": seconds.get(name)})
    return rows


def _panel_signs(info, grid, top):
    """The figure tool's PNG decoded, whether it equals the figure
    re-rendered from what the tool returned, and for each panel the ψ and
    the colour (blue over red: positive; None where |ψ| < PSI_SIGN_MIN) at
    its centre pixel and at its pixel of largest |ψ|, ψ read at the grid
    point under the pixel's centre."""
    with open(info["path"], "rb") as fh:
        decoded = raster.decode_png(fh.read())
    fig = plotting.eigfuncs_2d_figure(info["psi"], top, info["titles"], True, info["suptitle"])
    same = np.array_equal(fig.render().pixels, decoded)
    panels = []
    for k, ax in enumerate(fig.axes[:top]):
        x0, y0, x1, y1 = ax.plot_box()
        ix0, iy0 = int(round(x0)), int(round(y0))
        w, h = int(round(x1)) - ix0, int(round(y1)) - iy0
        rows = ((np.arange(h) + 0.5) * grid / h).astype(int)
        cols = ((np.arange(w) + 0.5) * grid / w).astype(int)
        psi = info["psi"][rows[:, None] * grid + cols[None, :], k]
        read = {}
        for where, (py, px) in (("centre", (h // 2, w // 2)),
                                ("extreme", np.unravel_index(np.argmax(np.abs(psi)), psi.shape))):
            red, _, blue = (int(v) for v in decoded[iy0 + py, ix0 + px])
            value = float(psi[py, px])
            read[where] = (value, (blue > red) if abs(value) >= PSI_SIGN_MIN else None)
        panels.append(read)
    return decoded, same, panels


def phase_plots(tmp, figures):
    """The figures without matplotlib (module docstring): the figure tool on
    the north star's checkpoint in ``tmp``, plot_1d_eigfuncs, and the
    earlier phases' ``figures``."""
    t0 = time.perf_counter()
    check("matplotlib" not in sys.modules, "matplotlib is imported")
    ckpt = os.path.join(tmp, "northstar.ckpt")
    env = _ns_env(NS_EVAL_ROUNDS=2, NS_CKPT=ckpt)  # the resumed north star's
    cfg = vn.read_config(env)
    with contextlib.redirect_stdout(io.StringIO()):
        info = plot_hydrogen_modes.main(ckpt, os.path.join(tmp, "figures"), device=DEVICE,
                                        env=env)
    grid = plot_hydrogen_modes.GRID
    decoded, same, panels = _panel_signs(info, grid, cfg.eval_top)
    check(decoded.shape == (*_grid_size(cfg.eval_top), 3), f"figure tool PNG {decoded.shape}")
    check(same, "the figure tool's PNG is not its figure re-rendered")
    check(np.isfinite(info["psi"]).all() and np.isfinite(info["quotients"]).all(),
          "figure tool: non-finite ψ or quotients")
    read = [r for p in panels for r in p.values() if r[1] is not None]
    check(all(p["extreme"][1] is not None for p in panels)
          and all(pos == (psi > 0) for psi, pos in read),
          f"figure tool: panel colours against the sign of ψ {panels}")
    t1 = time.perf_counter()
    encoded = raster.encode_png(decoded)
    encode_s = time.perf_counter() - t1

    x = np.linspace(-5.0, 5.0, PLOT_1D_POINTS).reshape(-1, 1)
    modes = np.cos(x * np.arange(1, PLOT_1D_MODES + 1) / 2) * np.exp(-x ** 2 / 10)
    t1 = time.perf_counter()
    plotting.plot_1d_eigfuncs(x, modes, os.path.join(tmp, "figures"), tag="plots")
    oned_s = time.perf_counter() - t1
    figures = figures + _figure_rows("plot_1d_eigfuncs", os.path.join(tmp, "figures"),
                                     {"eigfuncs_plots.png": oned_s},
                                     {"eigfuncs_plots.png": (500, 800)})
    check("matplotlib" not in sys.modules, "matplotlib is imported")
    phase_s = time.perf_counter() - t0
    check(phase_s <= PLOTS_MAX_S, f"phase plots took {phase_s:.1f} s > {PLOTS_MAX_S}")
    emit("plots", tool={"ckpt_chunk": info["chunk"], "eval_top": cfg.eval_top, "grid": grid,
                        "lim": info["lim"], "eval_rounds": plot_hydrogen_modes.EVAL_ROUNDS,
                        "height_width": list(decoded.shape[:2]),
                        "bytes": os.path.getsize(info["path"]),
                        "quotients": info["quotients"][info["order"]].tolist(),
                        "titles": info["titles"], "panel_signs": panels,
                        "eval_s": info["eval_s"], "draw_s": info["plot_s"],
                        "encode_s": encode_s, "encoded_bytes": len(encoded)},
         figures=figures, matplotlib_imported=False, phase_s=phase_s)


def phase_validate(tmp):
    """The repo's accuracy entry points on the card (module docstring):
    each path's launches.  The north star's NS_CKPT checkpoint stays in
    ``tmp`` (phase plots reads it)."""
    t0 = time.perf_counter()
    cuda_gram.reset_launch_counts()
    record, info, lines, traced = _northstar(NS_ITERS, _ns_env(), NS_TRACED)
    launches = _traced_launches("north star", traced)
    for line in lines:
        print(line, flush=True)
    check([r["partial_at_iter"] for r in info["partial"]]
          == list(range(NS_EVAL_EVERY, NS_ITERS, NS_EVAL_EVERY)),
          f"partial rows {info['partial']}")
    t1 = time.perf_counter()
    sums = _northstar_sums_vs_cpu(info["ts"])
    resume = _northstar_resume(tmp, info["ts"])
    t2 = time.perf_counter()
    levers = _northstar_levers(tmp)
    t3 = time.perf_counter()
    methods, methods_launches = _methods()
    t4 = time.perf_counter()
    fp, fp_traced, fp_launches = _fp_validate(tmp)
    t5 = time.perf_counter()
    emit("validate", northstar={"iters": NS_ITERS, "chunk": NS_CHUNK, "record": record,
                                "steps_per_s": record["train_steps_per_sec"],
                                "traced_block": traced, "launches": launches,
                                "seconds": t1 - t0},
         eval_sums_vs_cpu=sums, resume=resume, resume_s=t2 - t1, levers=levers,
         levers_s=t3 - t2, methods={"steps": VM_STEPS, "block": VM_BLOCK, "runs": methods,
                                    "launches": methods_launches, "seconds": t4 - t3},
         fokker_planck={"iters": VF_ITERS, "chunk": VF_CHUNK, "record": fp,
                        "traced_block": fp_traced, "launches": fp_launches,
                        "seconds": t5 - t4},
         phase_s=time.perf_counter() - t0)
    return {"northstar": launches, "northstar_levers": levers["launches"],
            "methods": methods_launches, "fp_validate": fp_launches}


def main():
    # full f32 products: TF32 keeps ~3 digits and would break the tolerances
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    name, smi = phase_device()
    phase_build()
    rows, _ = phase_kernels()
    e4_counts, model, importance, x = phase_trainer()
    pde_launches = phase_pde_cli()
    figures = []  # the CLI runs' PNGs, read in phase plots
    recipe_launches = phase_pde_recipes(figures)
    method_launches = phase_pde_methods()
    phase_pde_spin()
    phase_pde_spin_exact()
    tier_launches = phase_pde_tiers()
    kernel_evd_launches = phase_kernel_evd()
    measured = {"pde_cli": pde_launches, **recipe_launches, **method_launches,
                "pde_tiers": tier_launches, "kernel_evd": kernel_evd_launches}
    counts = {"e4": e4_counts,
              **{path: {k: v["launches"] for k, v in m.items()} for path, m in measured.items()}}
    phase_hutchinson(model, importance, x)
    train, test, valid = _cdk_data()
    phase_cdk_loss(train)
    counts["cdk"], f32_quality = phase_cdk_train(train, test, valid)
    counts["cdk_bf16"] = phase_cdk_bf16(train, test, valid, f32_quality)
    with tempfile.TemporaryDirectory() as tmp:
        counts["sketchy_cli"] = phase_sketchy_cli(tmp, figures)
        phase_dp(os.path.join(tmp, "root"))
        counts.update(phase_tp(tmp))
        phase_export(tmp)
    phase_dryrun()
    with tempfile.TemporaryDirectory() as tmp:
        validate = phase_validate(tmp)
        phase_plots(tmp, figures)
    measured.update(validate)
    counts.update({path: {k: v["launches"] for k, v in m.items()}
                   for path, m in validate.items()})
    kernels = []
    for kname, results in rows.items():
        at = {r["shape"]: r for r in results}
        paths = {path: {"launches": counts[path][kname],
                        **{k: at[shape][k] for k in ("B", "L", "max_abs_err", "ms",
                                                      "plain_ms", "bound_ms",
                                                      "bound_by", "library_ms")}}
                 for path, shape in (("e4", "E4"), ("pde_cli", "E4"), ("cdk", "cdk"),
                                     ("hydrogen", "hydrogen"), ("oscillator", "oscillator"),
                                     ("fp", "fp"), ("pde_tiers", "E4"), ("cdk_bf16", "cdk"),
                                     ("kernel_evd", "kernel_evd"), ("sketchy_cli", "cdk"),
                                     ("tp_e4", "E4"), ("tp_cdk", "cdk"),
                                     ("tp_spin", "hydrogen"), ("tp_spinx", "hydrogen"),
                                     ("northstar", "E4"), ("northstar_levers", "levers"),
                                     ("methods", "methods"), ("fp_validate", "fp_validate"))}
        for path, m in measured.items():
            paths[path].update(m[kname])
        cdk = paths["cdk"]
        kernels.append({
            "name": kname, "route": "cuda", "source": KERNEL_SOURCE,
            "replaces": REPLACES[kname],
            "launches": sum(p["launches"] for p in paths.values()),
            "max_abs_err": cdk["max_abs_err"], "ms": cdk["ms"],
            "plain_ms": cdk["plain_ms"], "bound_ms": cdk["bound_ms"],
            "bound_by": cdk["bound_by"], "library_ms": cdk["library_ms"],
            "paths": paths, "shapes": results})
    print(json.dumps({"kernels": kernels}), flush=True)
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": name,
                                             "count": torch.cuda.device_count()}}),
          flush=True)


if __name__ == "__main__":
    main()
