"""PDE config: dataclasses and the namespaced per-method flags.

Port of ``neuralsvd_tpu/utils/config.py:45-233``: ``PDEConfig``, the
``--neuralsvd.*`` / ``--neuralef.*`` / ``--spin.*`` flags collected into a
nested ``loss`` config, ``parse_pde_config``, ``loss_descriptor`` and
``run_name``.  Every flag parses to the JAX package's value and
``run_name`` gives its string, with one repair: ``--lim pi`` means π here,
where the JAX parser declares ``lim`` a float and so exits on "pi" before
its own ``cfg.lim == "pi"`` branch can run.  One flag is the port's own:
``--device`` (default: the GPU).
"""
from __future__ import annotations

import argparse
import math
from dataclasses import dataclass, field, fields
from typing import Optional


@dataclass
class NeuralSVDOpts:
    step: int = 1
    sequential: bool = False
    set_first_mode_const: bool = True
    use_pallas: str = "auto"  # auto | true | false


@dataclass
class NeuralEFOpts:
    batchnorm_mode: str = "unbiased"  # biased | unbiased | none
    unbiased: bool = False
    include_diag: bool = False


@dataclass
class SpINOpts:
    decay: float = 0.01


@dataclass
class LossConfig:
    name: str = "neuralsvd"
    neuralsvd: NeuralSVDOpts = field(default_factory=NeuralSVDOpts)
    neuralef: NeuralEFOpts = field(default_factory=NeuralEFOpts)
    spin: SpINOpts = field(default_factory=SpINOpts)


@dataclass
class PDEConfig:
    # base
    seed: int = 42
    log_dir: str = "./log"
    overwrite: bool = False
    resume: bool = False  # restart from the latest ckpt_<it> in the run's dir
    print_freq: int = 1000
    eval_freq: int = 50000
    print_local_energies: bool = False
    # optimization
    num_iters: int = 100000
    optimizer: str = "rmsprop"
    batch_size: int = 128
    lr: float = 1e-4
    rmsprop_decay: float = 0.999
    momentum: float = 0.0
    adam_eps: float = 1e-7
    use_lr_scheduler: bool = False
    ema_decay: float = 0.99
    grad_clip: float = 0.0
    tail_lr_boost: float = 1.0  # per-mode LR on modes >= tail_lr_start
    tail_lr_start: int = 0
    spike_reject_factor: float = 0.0  # >0: reject gnorm > k x its EMA
    # problem
    problem: str = "sch"          # sch | fp
    ndim: int = 2
    lim: float = 16.0
    potential_type: str = "hydrogen"
    mol_name: Optional[str] = None
    charge: float = 1.0
    hydrogen_mol_ion_R: float = 1.0
    laplacian_eps: float = 0.1
    laplacian_mode: str = "forward"  # exact Laplacian: forward | jvp
    laplacian_probes: int = 0  # > 0: Hutchinson probes in training
    hard_mul_const: float = 1.0
    operator_scale: float = 1.0
    operator_shift: float = 0.0
    scale_operator: float = 1.0
    # model
    neigs: int = 16
    mlp_hidden_dims: str = "128,128,128"
    nonlinearity: str = "softplus"
    parallel: bool = False
    weight_normalization: bool = False
    use_fourier_feature: bool = False
    fourier_mapping_size: int = 256
    fourier_scale: float = 1.0
    fourier_deterministic: bool = False
    fourier_append_raw: bool = False
    fourier_append_radial: bool = False
    fourier_append_envelopes: str = ""
    apply_boundary: bool = True
    boundary_mode: str = "dir_box_sqrt"
    apply_exp_mask: bool = False
    exp_mask_init_scale: float = 1000.0
    matmul_precision: str = ""
    # sampling / validation
    sampling_mode: str = "gaussian"  # gaussian | laplacian | uniform | gaussian_mixture
    sampling_scale: float = 16.0
    sampling_scales: str = ""  # comma list for gaussian_mixture
    sampling_weights: str = ""
    val_eps: float = 0.1
    val_mc_size: int = 8192
    # parallelism
    mesh: str = ""
    # misc
    sort: bool = False
    post_align: bool = False
    rescue: bool = False
    rescue_until: float = 0.7
    # profiling (a torch.profiler trace of a step window)
    profile: bool = False
    profile_start: int = 100
    profile_steps: int = 20
    # the port's own
    device: Optional[str] = None
    loss: LossConfig = field(default_factory=LossConfig)


def _strtobool(v) -> bool:
    if isinstance(v, bool):
        return v
    return str(v).lower() in ("1", "true", "yes", "y", "t")


def _lim(v) -> float:
    return math.pi if str(v).lower() == "pi" else float(v)


def _add_dataclass_args(parser: argparse.ArgumentParser, dc, prefix=""):
    for f in fields(dc):
        if f.name == "loss":
            continue
        name = f"--{prefix}{f.name}"
        default = getattr(dc, f.name)
        if f.name == "lim" and not prefix:
            parser.add_argument(name, type=_lim, default=default)
        elif f.type in ("bool", bool) or isinstance(default, bool):
            parser.add_argument(name, type=_strtobool, default=default)
        elif isinstance(default, int):
            parser.add_argument(name, type=int, default=default)
        elif isinstance(default, float):
            parser.add_argument(name, type=float, default=default)
        else:
            parser.add_argument(name, type=str, default=default)


def parse_pde_config(argv=None) -> PDEConfig:
    cfg = PDEConfig()
    parser = argparse.ArgumentParser("neuralsvd_tpu_torch PDE solver")
    _add_dataclass_args(parser, cfg)
    parser.add_argument("--loss", type=str, default="neuralsvd",
                        dest="loss_name",
                        choices=["neuralsvd", "nestedlora", "neuralef",
                                 "spin", "spinx"])
    for group_name, group in (("neuralsvd", NeuralSVDOpts()),
                              ("neuralef", NeuralEFOpts()),
                              ("spin", SpINOpts())):
        _add_dataclass_args(parser, group, prefix=f"{group_name}.")
    ns = parser.parse_args(argv)
    for f in fields(cfg):
        if f.name != "loss":
            setattr(cfg, f.name, getattr(ns, f.name))
    cfg.loss = LossConfig(
        name=ns.loss_name,
        neuralsvd=NeuralSVDOpts(**{f.name: getattr(ns, f"neuralsvd.{f.name}")
                                   for f in fields(NeuralSVDOpts)}),
        neuralef=NeuralEFOpts(**{f.name: getattr(ns, f"neuralef.{f.name}")
                                 for f in fields(NeuralEFOpts)}),
        spin=SpINOpts(**{f.name: getattr(ns, f"spin.{f.name}")
                         for f in fields(SpINOpts)}),
    )
    return cfg


def loss_descriptor(cfg: PDEConfig) -> str:
    """Run-name fragment encoding the method config."""
    name = cfg.loss.name
    if name in ("neuralsvd", "nestedlora"):
        o = cfg.loss.neuralsvd
        return (f"{name}{'_seq' if o.sequential else '_jnt'}"
                f"{'_sort' if cfg.sort else ''}"
                f"{f'_step{o.step}' if (o.step > 1 and not o.sequential) else ''}")
    if name == "neuralef":
        o = cfg.loss.neuralef
        base = "muEG" if o.unbiased else "alphaEG"
        return f"{base}_diag{int(o.include_diag)}bn{o.batchnorm_mode}"
    if name in ("spin", "spinx"):
        return f"{name}_decay{cfg.loss.spin.decay}"
    return name


def run_name(cfg: PDEConfig) -> str:
    """Log-dir name encoding the salient hparams."""
    problem = (f"sch_{cfg.potential_type}_ndim{cfg.ndim}"
               if cfg.problem == "sch" else f"fp_ndim{cfg.ndim}")
    return (
        f"{problem}_ss{cfg.operator_scale},{cfg.operator_shift}/"
        f"{loss_descriptor(cfg)}_neigs{cfg.neigs}_{cfg.nonlinearity}"
        f"_p{int(cfg.parallel)}_bdd{int(cfg.apply_boundary)}"
        f"_lap{cfg.laplacian_eps}"
        f"{('_hutch' + str(cfg.laplacian_probes)) if cfg.laplacian_probes else ''}"
        f"_fourier{int(cfg.use_fourier_feature)}"
        f"_{cfg.sampling_mode},scale{cfg.sampling_scales or cfg.sampling_scale}"
        f"{('_mesh' + cfg.mesh) if cfg.mesh else ''}"
        f"_bs{cfg.batch_size}_niters{cfg.num_iters}"
        f"_{cfg.optimizer}_lr{cfg.lr}_ema{cfg.ema_decay}_seed{cfg.seed}"
    )
