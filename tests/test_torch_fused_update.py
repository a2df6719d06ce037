"""The train steps' fused CUDA update (ops/cuda_update.py, csrc/update_kernels.cu).

On the CPU: which chains ``build_optimizer`` marks for the fused pass;
that a CPU step, and a step whose chain is not marked, takes the plain
route; and the kernels' own source, compiled with the host C++ compiler
against ``tests/torch_cuda_emulator.h`` (as test_torch_kernel_emulation.py
runs K1-K3), driven through the real E4 and CDK train steps in place of
the card and held to the plain route from the same state: bit for bit
where no clip acts (the kernels round each operation on its own, in the
plain route's order), within 1e-6 of each leaf where one does (‖g‖ is
summed in another order) and for RMSprop (PyTorch's CPU sqrt is not
correctly rounded; on the card it is).  The cases: a NaN gradient entry (skipped: p,
ν or m and the schedule count kept, the skip count up, the EMA moved), a
NaN loss (E4's rule), finite entries whose ‖g‖² overflows (the CDK's scale
is 0 and the step is taken; E4 skips), misaligned gradient views, a list
of more than 32 tensors, and blocks run in reverse order; and that the
CDK step writes its state in place on either route.

On the card (marked ``cuda``, skipped without a GPU; no JAX here either):
the fused route against the plain route on the card at E4's and the CDK's
parameter shapes, a captured E4 block against the same steps run eagerly,
and the counters::

    python -m pytest tests/test_torch_fused_update.py -m cuda -q
"""
import ctypes
import re
import shutil
import subprocess
from pathlib import Path

import numpy as np
import pytest
import torch

from neuralsvd_tpu_torch.ops import cuda_build, cuda_update
from neuralsvd_tpu_torch.training import cdk_step, optimizers, train_operator
from neuralsvd_tpu_torch.training.optimizers import (
    build_optimizer,
    chain,
    cosine_annealing,
    fused_rule,
    per_mode_lr,
    torch_rmsprop,
    warmup_cosine_schedule,
)
from neuralsvd_tpu_torch.training.rescue import tree_permute_modes
from neuralsvd_tpu_torch.training.train_state import TrainState, clone_tree, state_pointers
from neuralsvd_tpu_torch.utils import tracing

TESTS = Path(__file__).resolve().parent
LEAF_RTOL = 1e-6  # where a clip acts: ‖g‖ summed in another order
E4_SHAPES = {"base.ws.0": (16, 128, 2053), "base.ws.1": (16, 128, 128),
             "base.ws.2": (16, 128, 128), "base.ws.3": (16, 1, 128),
             "base.bs.0": (16, 128, 1), "base.bs.1": (16, 128, 1),
             "base.bs.2": (16, 128, 1), "base.bs.3": (16, 1, 1)}
CDK_SHAPES = {f"{t}.layers.{i}.{k}": s for t in "xy"
              for i, (w, b) in enumerate([((512, 8192), (8192,)), ((8192, 512), (512,))])
              for k, s in (("w", w), ("b", b))}
# small shapes for the emulator: whole 4096-element blocks (16-byte path),
# a ragged last block whose size is not a multiple of 4, one element
SMALL_SHAPES = {"w0": (3, 2053), "w1": (2, 4096), "b0": (16, 1, 1), "b1": (1,)}
SCHEDULE = dict(base_lr=1e-2, warmup_lr=0.0, final_lr=0.0, warmup_steps=0, total_steps=50)


# ---------------------------------------------------------------------------
# which chains are fused
# ---------------------------------------------------------------------------

class _Shards:
    """Stands for a tp mesh's ModeShards: build_optimizer and fused_rule
    only test it for None, and with no group and no sharded parameter the
    plain route's reductions over it are the one-process ones."""
    group = None
    pre_gather = ()
    axes = {}


def _chain_with_per_mode_lr():
    return chain(build_optimizer("rmsprop", 1e-3), per_mode_lr(np.ones(2), 2))


FUSABLE = {
    "rmsprop": (lambda: build_optimizer("rmsprop", 1e-3, rmsprop_decay=0.99), "rmsprop", 0.99),
    "rmsprop-schedule": (lambda: build_optimizer("rmsprop", 1e-3,
                                                 lr_schedule=cosine_annealing(1e-3, 10)),
                         "rmsprop", 0.999),
    "sgd-momentum": (lambda: build_optimizer("sgd", 1e-3, momentum=0.9), "trace", 0.9),
    "sgd-momentum-schedule": (lambda: build_optimizer(
        "sgd", 1e-3, momentum=0.8, lr_schedule=cosine_annealing(1e-3, 10)), "trace", 0.8),
    "rmsprop-momentum": (lambda: build_optimizer("rmsprop", 1e-3, momentum=0.9), None, None),
    "sgd": (lambda: build_optimizer("sgd", 1e-3), None, None),
    "sgd-weight-decay": (lambda: build_optimizer("sgd", 1e-3, momentum=0.9, weight_decay=1e-4),
                         None, None),
    "adam": (lambda: build_optimizer("adam", 1e-3), None, None),
    "adamw": (lambda: build_optimizer("adamw", 1e-3, weight_decay=1e-4), None, None),
    "lars": (lambda: build_optimizer("lars", 1e-3, momentum=0.9), None, None),
    "reject-spikes": (lambda: build_optimizer("rmsprop", 1e-3, spike_reject_factor=25.0),
                      None, None),
    "per-mode-lr": (_chain_with_per_mode_lr, None, None),
    # marked: the step, which knows its mesh, keeps a tp mesh on the plain route
    "tp-mesh": (lambda: build_optimizer("sgd", 1e-3, momentum=0.9, shards=_Shards()),
                "trace", 0.9),
}
# the chains a step keeps on the plain route
UNMARKED = [c for c, (_, kind, _) in FUSABLE.items() if kind is None] + ["tp-mesh"]


@pytest.mark.parametrize("case", list(FUSABLE))
def test_build_optimizer_marks_the_fused_chains(case):
    """RMSprop without momentum and momentum SGD without weight decay, at a
    constant lr or on a schedule, are marked, also when built for a tp
    mesh; every other chain is not.  A mark finds ν or m and the
    schedule's count in the chain's state."""
    make, kind, decay = FUSABLE[case]
    opt = make()
    if kind is None:
        assert opt.fused is None
        return
    rule = opt.fused
    assert (rule.kind, rule.decay) == (kind, decay)
    assert rule.eps == (1e-10 if kind == "rmsprop" else 0.0)
    params = {"a": torch.ones(2, 3), "b": torch.ones(2)}
    state = opt.init(params)
    moments = rule.moments(state)
    assert set(moments) == set(params)
    assert all(torch.equal(m, torch.zeros_like(params[k])) for k, m in moments.items())
    count = rule.count(state)
    if callable(rule.lr):
        assert count.dtype == torch.int32 and count.shape == ()
    else:
        assert count is None and rule.lr == 1e-3


def test_fused_rule_takes_cuda_float32_tensors_only(monkeypatch):
    """The route is the fused one only for a marked chain off a tp mesh on
    CUDA tensors: on the CPU it is always the plain one.  The fused pass
    itself refuses parameters that are not contiguous float32
    (``test_fused_pass_refuses_tensors_it_cannot_take``)."""
    opt = build_optimizer("rmsprop", 1e-3)
    params = {"a": torch.ones(3)}
    assert fused_rule(opt, params) is None
    monkeypatch.setattr(optimizers, "_on_card", lambda params: True)
    assert fused_rule(opt, params) is opt.fused
    assert fused_rule(opt, params, shards=_Shards()) is None
    assert fused_rule(build_optimizer("adam", 1e-3), params) is None
    assert fused_rule(torch_rmsprop(1e-3), params) is None


@pytest.mark.parametrize("case", ["float64", "strided"])
def test_fused_pass_refuses_tensors_it_cannot_take(case):
    """``apply_update`` raises on parameters that are not contiguous
    float32, before it looks for a card: it reroutes nothing."""
    p = torch.zeros((4, 6), dtype=torch.float64 if case == "float64" else torch.float32)
    if case == "strided":
        p = p.t()
    g = torch.zeros(p.shape, dtype=torch.float32)
    with pytest.raises(ValueError, match="contiguous float32"):
        cuda_update.apply_update(None, [g], [p], [torch.zeros_like(g)], rule="trace",
                                 decay=0.9, lr=1e-3)


# ---------------------------------------------------------------------------
# steps driven by preset gradients
# ---------------------------------------------------------------------------

class _GradMethod:
    """A method whose ``loss_and_grad`` hands out preset (loss, grads),
    one pair a call (neither route alters them)."""

    def __init__(self, script):
        self.script = list(script)
        self.calls = 0

    def loss_and_grad(self, params, method_state, *inputs):
        loss, grads = self.script[self.calls]
        self.calls += 1
        return loss, dict(grads), {}, method_state


def _tensors(shapes, rng, device, scale=1.0):
    return {k: torch.as_tensor(scale * rng.standard_normal(s, dtype=np.float32), device=device)
            for k, s in shapes.items()}


def _script(shapes, rng, device, steps):
    """(loss, gradients) of ``steps`` steps: an entry of the first gradient
    NaN at step 1 and the loss NaN at step 2, where there are such steps."""
    out = []
    for i in range(steps):
        grads = _tensors(shapes, rng, device, 1e-2)
        if i == 1:
            next(iter(grads.values())).view(-1)[7] = float("nan")
        out.append((torch.tensor(float("nan") if i == 2 else 1.0, device=device), grads))
    return out


def _e4_state(shapes, optimizer, rng, device):
    params = _tensors(shapes, rng, device)
    return TrainState(step=torch.zeros((), dtype=torch.int64, device=device), params=params,
                      opt_state=optimizer.init(params),
                      ema_params={k: p.clone() for k, p in params.items()}, method_state={})


def _e4_copy(start, optimizer):
    """A fresh TrainState at the initial state ``start`` (a ``clone_tree``
    of one made by ``_e4_state``)."""
    params = clone_tree(start["params"])
    return TrainState(step=start["step"].clone(), params=params, opt_state=optimizer.init(params),
                      ema_params=clone_tree(start["ema_params"]), method_state={})


def _run_e4(ts, optimizer, script, grad_clip, device, shards=None):
    """The E4 train step (``make_train_step``) over ``script``: the state
    and the (loss, gnorm, skipped) of each step."""
    step = train_operator.make_train_step(
        _GradMethod(script), lambda *a, **k: None, optimizer,
        lambda gen: torch.zeros((4, 2), device=device), ema_decay=0.995, grad_clip=grad_clip,
        shards=shards)
    metrics = []
    for _ in script:
        _, m = step(ts, None)
        metrics.append((m["gnorm"].clone(), bool(m["skipped"])))
    return clone_tree(ts.__dict__), metrics


def _run_cdk(params, opt_state, optimizer, script, grad_clip):
    """The CDK train step (``make_cdk_train_step``) over ``script``:
    (params, opt_state, skipped steps)."""
    step = cdk_step.make_cdk_train_step(_GradMethod(script), optimizer, grad_clip)
    device = next(iter(params.values())).device
    skips = torch.zeros((), dtype=torch.int32, device=device)
    x = torch.zeros((4, 2), device=device)
    for _ in script:
        params, opt_state, _, _, _, skips = step(params, opt_state, {}, x, x, skips)
    return params, opt_state, int(skips)


def _cdk_tree(params, opt_state):
    return clone_tree({"params": params, "opt_state": opt_state})


def _plain(optimizer):
    """The same chain without its fused mark: the plain route on any device."""
    return optimizer._replace(fused=None)


def _assert_trees(got, want, rtol=0.0):
    """Equal bit for bit (rtol 0), or each leaf within rtol of its largest
    entry."""
    if isinstance(want, torch.Tensor):
        if rtol == 0.0 or not want.is_floating_point():
            assert torch.equal(got, want), (got, want)
        else:
            err = (got.double() - want.double()).abs().max().item()
            assert err <= rtol * want.double().abs().max().item(), err
    elif isinstance(want, dict):
        assert set(got) == set(want)
        for k in want:
            _assert_trees(got[k], want[k], rtol)
    elif isinstance(want, (list, tuple)):
        assert len(got) == len(want)
        for a, b in zip(got, want):
            _assert_trees(a, b, rtol)
    else:
        assert got == want


def test_cpu_step_takes_the_plain_route():
    """A CPU step of a marked chain counts ``update.plain`` and launches no
    kernel."""
    rng = np.random.default_rng(0)
    opt = build_optimizer("rmsprop", 1e-3, lr_schedule=cosine_annealing(1e-3, 10))
    before = tracing.counts()
    launches = cuda_update.launch_counts()
    _run_e4(_e4_state(SMALL_SHAPES, opt, rng, "cpu"), opt, _script(SMALL_SHAPES, rng, "cpu", 2),
            0.0, "cpu")
    after = tracing.counts()
    assert after.get("update.plain", 0) - before.get("update.plain", 0) == 2
    assert after.get("update.fused", 0) == before.get("update.fused", 0)
    assert cuda_update.launch_counts() == launches


# ---------------------------------------------------------------------------
# the kernels' source on the CPU (emulated card)
# ---------------------------------------------------------------------------

def _emulated_source() -> str:
    src = (cuda_build.CSRC / "update_kernels.cu").read_text()
    src = src.replace("#include <cuda_runtime.h>", '#include "torch_cuda_emulator.h"')

    def launch(m):
        grid, threads = (part.strip() for part in m.group(2).split(",")[:2])
        return f"emu_launch(dim3({grid}), {threads}, [&] {{ {m.group(1)}({m.group(3)}); }});"

    src, n = re.subn(r"(\w+(?:<\d+>)?)<<<(.*?)>>>\((.*?)\);", launch, src, flags=re.S)
    assert n == 5, f"{n} launches"
    return src


@pytest.fixture(scope="module")
def emulated_lib(tmp_path_factory):
    cxx = shutil.which("g++") or shutil.which("c++")
    if cxx is None:
        pytest.skip("needs a host C++ compiler")
    out = tmp_path_factory.mktemp("emulated_update")
    (out / "update_kernels_emulated.cpp").write_text(_emulated_source())
    lib = out / "libupdate_emulated.so"
    proc = subprocess.run(
        [cxx, "-std=c++20", "-O1", "-ffp-contract=off", "-shared", "-fPIC", "-pthread", "-w",
         "-I", str(TESTS), "-o", str(lib), str(out / "update_kernels_emulated.cpp")],
        capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]
    dll = ctypes.CDLL(str(lib))
    for name, argtypes in cuda_build._UPDATE_SIGNATURES.items():
        getattr(dll, name).argtypes = argtypes
        getattr(dll, name).restype = ctypes.c_int
    return dll


@pytest.fixture
def emulated(emulated_lib, monkeypatch):
    """The steps take the fused route on CPU tensors, its launches run by
    the emulated library; yields the ticket counter (it must stay 0)."""
    ticket = torch.zeros((1,), dtype=torch.int32)

    def launch(name, *args):
        assert getattr(emulated_lib, name)(*args) == 0, name

    monkeypatch.setattr(cuda_update, "_launch", launch)
    monkeypatch.setattr(cuda_update, "_card_stream", lambda tensors, name: None)
    monkeypatch.setattr(cuda_update, "_ticket", lambda device, stream: ticket)
    monkeypatch.setattr(torch.cuda, "is_current_stream_capturing", lambda: False)
    monkeypatch.setattr(optimizers, "_on_card", lambda params: True)
    yield ticket
    ctypes.c_int.in_dll(emulated_lib, "emu_reverse").value = 0
    assert int(ticket) == 0


@pytest.mark.parametrize("case", UNMARKED)
def test_unmarked_chain_takes_the_plain_route_on_any_device(emulated, case):
    """A chain ``build_optimizer`` does not mark, and a marked one in a
    step on a tp mesh, counts ``update.plain`` and launches no kernel,
    even where the device would take the fused route (the emulated card)."""
    opt = FUSABLE[case][0]()
    shards = _Shards() if case == "tp-mesh" else None
    shapes = {"w": (2, 3), "v": (2,)}  # per_mode_lr's chain leads with 2 modes
    rng = np.random.default_rng(9)
    before, launches = tracing.counts().get("update.plain", 0), cuda_update.launch_counts()
    _run_e4(_e4_state(shapes, opt, rng, "cpu"), opt, _script(shapes, rng, "cpu", 1), 0.0, "cpu",
            shards)
    assert tracing.counts()["update.plain"] - before == 1
    assert cuda_update.launch_counts() == launches


E4_CASES = {  # name: (schedule, grad_clip, reverse block order)
    "no-clip": (True, 0.0, False),
    "constant-lr": (False, 0.0, True),
    "clip-active": (True, 1e-3, True),
}


@pytest.mark.parametrize("case", list(E4_CASES))
def test_emulated_e4_step_matches_plain_route(emulated_lib, emulated, case):
    """Four E4 steps (the NaN entry and the NaN loss skipped: p, ν and the
    count kept, the EMA moved) through the kernels' source against the
    plain route from the same state: every leaf within 1e-6 (PyTorch's CPU
    sqrt is not correctly rounded, unlike the card's, where the card test
    asks for equal bits); ‖g‖ within 1e-6, the skips equal; ``update.fused``
    counted and each wrapper one launch a step."""
    schedule, grad_clip, reverse = E4_CASES[case]
    ctypes.c_int.in_dll(emulated_lib, "emu_reverse").value = int(reverse)
    lr = cosine_annealing(1e-2, 20) if schedule else None
    opt = build_optimizer("rmsprop", 1e-2, rmsprop_decay=0.9, lr_schedule=lr)
    rng = np.random.default_rng(1)
    ts = _e4_state(SMALL_SHAPES, opt, rng, "cpu")
    start = clone_tree(ts.__dict__)
    script = _script(SMALL_SHAPES, rng, "cpu", 4)
    before, launches = tracing.counts().get("update.fused", 0), cuda_update.launch_counts()
    got, got_m = _run_e4(ts, opt, script, grad_clip, "cpu")
    assert tracing.counts()["update.fused"] - before == 4
    assert {k: n - launches[k] for k, n in cuda_update.launch_counts().items()} == \
        {"grad_status": 4, "apply_update": 4}
    want, want_m = _run_e4(_e4_copy(start, opt), _plain(opt), script, grad_clip, "cpu")
    _assert_trees(got, want, LEAF_RTOL)
    assert [s for _, s in got_m] == [s for _, s in want_m] == [False, True, True, False]
    for (a, _), (b, _) in zip(got_m, want_m):
        if torch.isfinite(b):
            assert abs(a.item() - b.item()) <= LEAF_RTOL * b.item()
    assert not torch.equal(got["ema_params"]["w0"], start["ema_params"]["w0"])


def test_emulated_e4_overflow_skips(emulated):
    """Finite entries whose ‖g‖² overflows float32: E4's rule skips the
    step (‖g‖ is inf), as a NaN entry does."""
    opt = build_optimizer("rmsprop", 1e-2, lr_schedule=cosine_annealing(1e-2, 20))
    rng = np.random.default_rng(2)
    ts = _e4_state(SMALL_SHAPES, opt, rng, "cpu")
    start = clone_tree(ts.__dict__)
    loss, grads = _script(SMALL_SHAPES, rng, "cpu", 1)[0]
    grads = {k: g * 1e25 for k, g in grads.items()}
    got, metrics = _run_e4(ts, opt, [(loss, grads)], 0.0, "cpu")
    assert metrics[0][1] and torch.isinf(metrics[0][0])
    _assert_trees(got["params"], start["params"])
    _assert_trees(got["opt_state"], clone_tree(opt.init(start["params"])))


CDK_CASES = {  # name: (schedule, grad_clip, misaligned gradient views)
    "clip-active": (True, 1e-3, False),
    "clip-inactive": (True, 1e6, False),
    "no-clip-constant-lr": (False, 0.0, True),
    "clip-active-misaligned": (True, 1e-3, True),
}


def _cdk_setup(opt, shapes, seed):
    rng = np.random.default_rng(seed)
    params = _tensors(shapes, rng, "cpu")
    return rng, params, opt.init(params)


def _misaligned(script):
    """Each step's gradients as views one float into one flat buffer."""
    out = []
    for loss, grads in script:
        flat = torch.empty(1 + sum(g.numel() for g in grads.values()))
        views, at = {}, 1
        for k, g in grads.items():
            views[k] = flat[at:at + g.numel()].view(g.shape)
            views[k].copy_(g)
            at += g.numel()
        out.append((loss, views))
    return out


@pytest.mark.parametrize("case", list(CDK_CASES))
def test_emulated_cdk_step_matches_plain_route(emulated, case):
    """Three CDK steps (momentum SGD; the NaN entry skipped: p, m and the
    count kept, the skip count up) through the kernels' source against
    the plain route: bit for bit where no clip acts, within 1e-6 where one
    does; 16-byte and 4-byte paths alike."""
    schedule, grad_clip, misaligned = CDK_CASES[case]
    opt = build_optimizer("sgd", 1e-2, momentum=0.9,
                          lr_schedule=warmup_cosine_schedule(**SCHEDULE) if schedule else None)
    rng, params, state = _cdk_setup(opt, SMALL_SHAPES, 3)
    script = _script(SMALL_SHAPES, rng, "cpu", 3)
    if misaligned:
        script = _misaligned(script)
    p0 = clone_tree(params)
    *got, skips = _run_cdk(params, state, opt, script, grad_clip)
    *want, want_skips = _run_cdk(p0, opt.init(p0), _plain(opt), script, grad_clip)
    assert skips == want_skips == 1
    got, want = _cdk_tree(*got), _cdk_tree(*want)
    _assert_trees(got, want, LEAF_RTOL if grad_clip == 1e-3 else 0.0)
    if schedule:
        assert int(got["opt_state"][1]["count"]) == 2


def test_emulated_cdk_overflow_takes_a_zero_step(emulated):
    """Finite entries whose ‖g‖² overflows float32: the CDK's clip scale is
    0 and the step is taken with a zero gradient (m ← βm, the count up),
    as the plain route on the card does; the same as a plain step on zero
    gradients, bit for bit."""
    opt = build_optimizer("sgd", 1e-2, momentum=0.9,
                          lr_schedule=warmup_cosine_schedule(**SCHEDULE))
    rng, params, state = _cdk_setup(opt, SMALL_SHAPES, 4)
    first = _script(SMALL_SHAPES, rng, "cpu", 1)  # a step that makes m nonzero
    loss, grads = _script(SMALL_SHAPES, rng, "cpu", 1)[0]
    huge = [(loss, {k: g * 1e25 for k, g in grads.items()})]
    zero = [(loss, {k: torch.zeros_like(g) for k, g in grads.items()})]
    p0 = clone_tree(params)
    params, state, _ = _run_cdk(params, state, opt, first, 1.0)
    after_first = clone_tree(params)
    *got, skips = _run_cdk(params, state, opt, huge, 1.0)
    p0, s0, _ = _run_cdk(p0, opt.init(p0), _plain(opt), first, 1.0)
    *want, want_skips = _run_cdk(p0, s0, _plain(opt), zero, 1.0)
    assert skips == want_skips == 0
    got, want = _cdk_tree(*got), _cdk_tree(*want)
    assert int(got["opt_state"][1]["count"]) == 2
    _assert_trees(got, want, LEAF_RTOL)
    assert not torch.equal(got["params"]["w0"], after_first["w0"])


@pytest.mark.parametrize("route", ["fused", "plain"])
def test_cdk_step_writes_opt_state_in_place(emulated, route):
    """Either route of the CDK step writes the parameters and the optimizer
    state into the tensors passed in and returns those objects: a step
    taken moves them, a skipped one (a NaN entry) leaves them as they were."""
    opt = build_optimizer("sgd", 1e-2, momentum=0.9,
                          lr_schedule=warmup_cosine_schedule(**SCHEDULE))
    opt = opt if route == "fused" else _plain(opt)
    rng, params, state = _cdk_setup(opt, SMALL_SHAPES, 11)
    leaves = [state[0][k] for k in SMALL_SHAPES] + [state[1]["count"]]
    before = tracing.counts().get(f"update.{route}", 0)
    step = cdk_step.make_cdk_train_step(_GradMethod(_script(SMALL_SHAPES, rng, "cpu", 2)), opt,
                                        1.0)
    skips = torch.zeros((), dtype=torch.int32)
    x = torch.zeros((4, 2))
    for i in range(2):
        kept = clone_tree({"params": params, "opt_state": state})
        got_params, got_state, _, _, _, skips = step(params, state, {}, x, x, skips)
        assert got_params is params and got_state is state
        assert all(a is b for a, b in zip([state[0][k] for k in SMALL_SHAPES]
                                          + [state[1]["count"]], leaves))
        if i == 0:
            assert int(state[1]["count"]) == 1 and bool(state[0]["w0"].ne(0).any())
        else:
            _assert_trees(clone_tree({"params": params, "opt_state": state}), kept)
    assert int(skips) == 1
    assert tracing.counts()[f"update.{route}"] - before == 2


def test_emulated_long_list_takes_a_launch_per_32_tensors(emulated):
    """33 tensors: two launches of each pass, whose norm partials and
    ticket span both; the state within 1e-6 of the plain route's."""
    shapes = {f"t{i}": (8 + 37 * i,) for i in range(33)}
    opt = build_optimizer("rmsprop", 1e-2, lr_schedule=cosine_annealing(1e-2, 20))
    rng = np.random.default_rng(5)
    ts = _e4_state(shapes, opt, rng, "cpu")
    start = clone_tree(ts.__dict__)
    script = _script(shapes, rng, "cpu", 1)
    launches = cuda_update.launch_counts()
    got, got_m = _run_e4(ts, opt, script, 0.0, "cpu")
    assert {k: n - launches[k] for k, n in cuda_update.launch_counts().items()} == \
        {"grad_status": 2, "apply_update": 2}
    want, want_m = _run_e4(_e4_copy(start, opt), _plain(opt), script, 0.0, "cpu")
    _assert_trees(got, want, LEAF_RTOL)
    assert [s for _, s in got_m] == [s for _, s in want_m] == [False]


def _permute_modes(ts, perm):
    """What a mode rescue does between blocks: every per-mode tensor of the
    parameters, their EMA and the moments rewritten in place."""
    for tree in (ts.params, ts.ema_params, ts.opt_state):
        tree_permute_modes(tree, perm)


def test_emulated_steps_read_a_rescue_written_in_place(emulated):
    """Two steps, the modes permuted in place as ``training/rescue.py``
    does between blocks, two more steps: the fused route reads the
    rescued state (no tensor replaced) and matches the plain route doing
    the same, within 1e-6."""
    shapes = {"base.ws.0": (4, 8, 129), "base.bs.0": (4, 8, 1)}
    opt = build_optimizer("rmsprop", 1e-2, lr_schedule=cosine_annealing(1e-2, 20))
    rng = np.random.default_rng(10)
    start = clone_tree(_e4_state(shapes, opt, rng, "cpu").__dict__)
    script = _script(shapes, rng, "cpu", 4)

    def run(optimizer):
        ts = _e4_copy(start, opt)
        ptrs = state_pointers(ts)
        step = train_operator.make_train_step(_GradMethod(script), None, optimizer,
                                              lambda gen: torch.zeros((4, 2)), ema_decay=0.995)
        for i in range(len(script)):
            if i == 2:
                _permute_modes(ts, [2, 0, 3, 1])
            step(ts, None)
        assert state_pointers(ts) == ptrs
        return clone_tree(ts.__dict__)

    _assert_trees(run(opt), run(_plain(opt)), LEAF_RTOL)


# ---------------------------------------------------------------------------
# on the card
# ---------------------------------------------------------------------------

@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("grad_clip", [0.0, 1e-3], ids=["no-clip", "clip-active"])
def test_fused_e4_step_matches_plain_route_on_card(cuda_device, grad_clip):
    """E4's parameter shapes (4.7M in 8 tensors), RMSprop on the cosine with
    the EMA: three steps (the second with a NaN entry, skipped) fused and
    plain from the same state, on the card: bit for bit without a clip,
    within 1e-6 a leaf with one; the route counted and each wrapper one
    launch a step."""
    opt = build_optimizer("rmsprop", 1e-4, lr_schedule=cosine_annealing(1e-4, 800000))
    rng = np.random.default_rng(6)
    ts = _e4_state(E4_SHAPES, opt, rng, cuda_device)
    start = clone_tree(ts.__dict__)
    script = _script(E4_SHAPES, rng, cuda_device, 4)
    before, launches = tracing.counts().get("update.fused", 0), cuda_update.launch_counts()
    got, got_m = _run_e4(ts, opt, script, grad_clip, cuda_device)
    torch.cuda.synchronize()
    assert tracing.counts()["update.fused"] - before == 4
    assert {k: n - launches[k] for k, n in cuda_update.launch_counts().items()} == \
        {"grad_status": 4, "apply_update": 4}
    want, want_m = _run_e4(_e4_copy(start, opt), _plain(opt), script, grad_clip, cuda_device)
    _assert_trees(got, want, LEAF_RTOL if grad_clip else 0.0)
    assert [s for _, s in got_m] == [s for _, s in want_m] == [False, True, True, False]
    assert int(got["opt_state"][1]["count"]) == 2 and int(got["step"]) == 4


@pytest.mark.cuda
@pytest.mark.parametrize("grad_clip", [1e6, 1.0], ids=["clip-inactive", "clip-active"])
def test_fused_cdk_step_matches_plain_route_on_card(cuda_device, grad_clip):
    """The CDK's parameter shapes (16.8M in 8 tensors), momentum SGD on the
    cosine: three steps (the NaN entry skipped, the skip count up), then
    a step of finite entries whose ‖g‖² overflows (scale 0: m ← βm, the
    step taken), fused and plain from the same state on the card."""
    opt = build_optimizer("sgd", 5e-3, momentum=0.9,
                          lr_schedule=warmup_cosine_schedule(5e-3, 0.0, 0.0, 0, 130))
    rng = np.random.default_rng(7)
    params = _tensors(CDK_SHAPES, rng, cuda_device)
    p0 = clone_tree(params)
    script = _script(CDK_SHAPES, rng, cuda_device, 3)
    loss, grads = _script(CDK_SHAPES, rng, cuda_device, 1)[0]
    script.append((loss, {k: g * 1e25 for k, g in grads.items()}))
    before = tracing.counts().get("update.fused", 0)
    *got, skips = _run_cdk(params, opt.init(params), opt, script, grad_clip)
    assert tracing.counts()["update.fused"] - before == 4
    *want, want_skips = _run_cdk(p0, opt.init(p0), _plain(opt), script, grad_clip)
    assert skips == want_skips == 1
    got, want = _cdk_tree(*got), _cdk_tree(*want)
    assert int(got["opt_state"][1]["count"]) == 3
    _assert_trees(got, want, LEAF_RTOL if grad_clip == 1.0 else 0.0)


class _SampleMethod:
    """Gradients that follow the sampled batch: base · mean(x) (so a
    captured step's replays draw new ones, as eager steps do)."""

    def __init__(self, base):
        self.base = base

    def loss_and_grad(self, params, method_state, x, *rest):
        c = x.mean()
        return c, {k: b * c for k, b in self.base.items()}, {}, method_state


@pytest.mark.cuda
def test_fused_e4_block_replays_match_eager_steps(cuda_device):
    """Two blocks of replays of the captured fused E4 step at E4's shapes,
    the modes permuted in place between them (as a rescue rewrites the
    state the graph reads), against the same steps run eagerly from the
    same state: the whole state bit for bit; the capture and the replays
    launch nothing through the wrappers (the warm-up's steps alone are
    counted)."""
    opt = build_optimizer("rmsprop", 1e-4, lr_schedule=cosine_annealing(1e-4, 800000))
    rng = np.random.default_rng(8)
    base = _tensors(E4_SHAPES, rng, cuda_device, 1e-2)
    ts = _e4_state(E4_SHAPES, opt, rng, cuda_device)
    start = clone_tree(ts.__dict__)

    def block(use_graph):
        step = train_operator.make_train_step(
            _SampleMethod(base), lambda *a, **k: None, opt,
            lambda gen: torch.randn((512, 2), generator=gen, device=cuda_device),
            ema_decay=0.995)
        return train_operator.ScannedTrainStep(step, 10, seed=3, use_graph=use_graph)

    launches = cuda_update.launch_counts()
    perm = list(range(1, 16)) + [0]
    graph = block(True)
    graph(ts, 0)
    _permute_modes(ts, perm)
    graph(ts, 10)
    torch.cuda.synchronize()
    assert graph.graph is not None
    assert {k: n - launches[k] for k, n in cuda_update.launch_counts().items()} == \
        {"grad_status": train_operator.GRAPH_WARMUP_STEPS,
         "apply_update": train_operator.GRAPH_WARMUP_STEPS}
    ts_e = _e4_copy(start, opt)
    eager = block(False)
    eager(ts_e, 0)
    _permute_modes(ts_e, perm)
    eager(ts_e, 10)
    _assert_trees(clone_tree(ts.__dict__), clone_tree(ts_e.__dict__))
    assert int(ts.step) == 20 and int(ts.opt_state[1]["count"]) == 20
