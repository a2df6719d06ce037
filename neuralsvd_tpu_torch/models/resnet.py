"""ResNet family for image-based eigenfunction and SSL experiments.

Port of ``neuralsvd_tpu/models/resnet.py``: ``make_resnet`` (torchvision
-style BasicBlock ResNet-18/34, optional CIFAR stem), ``make_cifar_resnet``
(ResNet-20/32/44/56), ``make_wide_resnet`` and ``make_linear_probe``.  The
shipped entry points do not call them; they complete the model zoo.

NCHW inside, as PyTorch lays images out (the JAX package is NHWC; a JAX
input goes over as ``x.transpose(0, 3, 1, 2)``).  Parameters follow the
JAX tree: ``stem.w``, ``bn_stem.scale``, ``bn_stem.bias``,
``blocks.<i>.conv1.w``, ``blocks.<i>.bn1.*``, ``blocks.<i>.down.w``,
``blocks.<i>.bn_down.*``, ``head.w`` (in, out), ``head.b``; the conv
weights (out, in, kh, kw) where JAX holds (kh, kw, in, out).  The
BatchNorm running statistics are buffers (``bn_*.mean``, ``bn_*.var``),
updated in place by a forward in train mode.

Two places where the torch idiom would compute another function:
- JAX's "SAME" padding puts the odd pixel after: a 3x3 stride-2 conv on an
  even input pads 0 before and 1 after, the 7x7/2 stem 2 and 3, and the
  stem's 3x3/2 max pool pads with -inf in the same way.  ``padding=k//2``
  and ``MaxPool2d(padding=1)`` give the same shapes and other values, so
  the pads are computed (``same_pads``) and applied explicitly.
- JAX's BatchNorm (``resnet.py:41-52``) normalizes by the batch's biased
  variance and keeps ``0.9·old + 0.1·batch`` of the *biased* variance;
  ``nn.BatchNorm2d`` keeps the unbiased one.  ``BatchNorm`` here
  normalizes with ``F.batch_norm`` and updates its buffers itself.

Init (the JAX init's distributions, drawn from ``generator``): conv
weights N(0, 2/fan_in), BatchNorm scale 1 and bias 0, the head's weight
U(±√(1/fan_in)) and bias 0.
"""
from __future__ import annotations

import math
from typing import Optional, Sequence

import torch
import torch.nn.functional as F
from torch import nn

from neuralsvd_tpu_torch.device import resolve_device


def same_pads(size: int, k: int, stride: int):
    """(before, after) of JAX's "SAME" padding along one axis of ``size``."""
    out = -(-size // stride)
    total = max((out - 1) * stride + k - size, 0)
    return total // 2, total - total // 2


def _pad_same(x: torch.Tensor, k: int, stride: int, value: float = 0.0):
    """``x`` (N, C, H, W) padded as "SAME" needs, or ``(x, (ph, pw))`` with
    symmetric pads left to the op."""
    ph = same_pads(x.shape[2], k, stride)
    pw = same_pads(x.shape[3], k, stride)
    if ph[0] == ph[1] and pw[0] == pw[1]:
        return x, (ph[0], pw[0])
    return F.pad(x, (pw[0], pw[1], ph[0], ph[1]), value=value), (0, 0)


class Conv(nn.Module):
    """Bias-free k x k convolution with "SAME" padding."""

    def __init__(self, k: int, cin: int, cout: int, stride: int = 1,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.k, self.stride = k, stride
        std = math.sqrt(2.0 / (k * k * cin))
        self.w = nn.Parameter(torch.randn(cout, cin, k, k, generator=generator) * std)

    def forward(self, x):
        x, pad = _pad_same(x, self.k, self.stride)
        return F.conv2d(x, self.w, stride=self.stride, padding=pad)


class BatchNorm(nn.Module):
    """JAX's BatchNorm: batch statistics in train mode (the running mean and
    biased variance updated in place, momentum 0.9), the running ones in
    eval mode."""

    def __init__(self, c: int, momentum: float = 0.9, eps: float = 1e-5):
        super().__init__()
        self.momentum, self.eps = momentum, eps
        self.scale = nn.Parameter(torch.ones(c))
        self.bias = nn.Parameter(torch.zeros(c))
        self.register_buffer("mean", torch.zeros(c))
        self.register_buffer("var", torch.ones(c))

    def forward(self, x):
        if not self.training:
            return F.batch_norm(x, self.mean, self.var, self.scale, self.bias,
                                training=False, eps=self.eps)
        with torch.no_grad():
            var, mean = torch.var_mean(x, dim=(0, 2, 3), correction=0)
            self.mean.mul_(self.momentum).add_(mean, alpha=1 - self.momentum)
            self.var.mul_(self.momentum).add_(var, alpha=1 - self.momentum)
        return F.batch_norm(x, None, None, self.scale, self.bias, training=True,
                            eps=self.eps)


class BasicBlock(nn.Module):
    def __init__(self, cin: int, cout: int, stride: int,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.conv1 = Conv(3, cin, cout, stride, generator)
        self.conv2 = Conv(3, cout, cout, 1, generator)
        self.bn1, self.bn2 = BatchNorm(cout), BatchNorm(cout)
        if stride != 1 or cin != cout:
            self.down = Conv(1, cin, cout, stride, generator)
            self.bn_down = BatchNorm(cout)
        else:
            self.down = None

    def forward(self, x):
        out = F.relu(self.bn1(self.conv1(x)))
        out = self.bn2(self.conv2(out))
        sc = x if self.down is None else self.bn_down(self.down(x))
        return F.relu(out + sc)


class Head(nn.Module):
    """Linear layer with (in, out) weights: U(±√(1/in)) and zero bias."""

    def __init__(self, in_dim: int, out_dim: int,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        bound = math.sqrt(1.0 / in_dim)
        self.w = nn.Parameter(torch.rand(in_dim, out_dim, generator=generator)
                              * (2 * bound) - bound)
        self.b = nn.Parameter(torch.zeros(out_dim))

    def forward(self, feats):
        return feats @ self.w + self.b


class ResNet(nn.Module):
    """Stem (conv, BatchNorm, ReLU, and for the ImageNet stem a 3x3/2 max
    pool), BasicBlocks (``widths`` per stage, the first block of every
    stage after the first at stride 2), global average pool, optional
    head.  ``forward(x)`` (N, C, H, W) -> (N, widths[-1] or num_outputs)."""

    def __init__(self, depth_blocks: Sequence[int], widths: Sequence[int],
                 stem_width: int, stem_k: int, stem_stride: int, max_pool: bool,
                 num_outputs: int = 0, in_channels: int = 3,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.stem = Conv(stem_k, in_channels, stem_width, stem_stride, generator)
        self.bn_stem = BatchNorm(stem_width)
        self.max_pool = max_pool
        blocks, cin = [], stem_width
        for stage, (n, cout) in enumerate(zip(depth_blocks, widths)):
            for b in range(n):
                blocks.append(BasicBlock(cin, cout, 2 if (b == 0 and stage > 0) else 1,
                                         generator))
                cin = cout
        self.blocks = nn.ModuleList(blocks)
        self.head = Head(cin, num_outputs, generator) if num_outputs else None

    def forward(self, x):
        out = F.relu(self.bn_stem(self.stem(x)))
        if self.max_pool:
            out, pad = _pad_same(out, 3, 2, value=-math.inf)
            out = F.max_pool2d(out, 3, 2, padding=pad)
        for block in self.blocks:
            out = block(out)
        feats = out.mean(dim=(2, 3))
        return feats if self.head is None else self.head(feats)


def _on(model: nn.Module, device) -> nn.Module:
    return model.to(resolve_device(device))


def make_resnet(depth_blocks: Sequence[int] = (2, 2, 2, 2), width: int = 64,
                num_outputs: int = 0, cifar_stem: bool = False,
                in_channels: int = 3, device=None,
                generator: Optional[torch.Generator] = None) -> ResNet:
    """torchvision-style ResNet on ``device`` (default: the GPU):
    (2, 2, 2, 2) is ResNet-18, (3, 4, 6, 3) ResNet-34; ``cifar_stem``: a
    3x3 stride-1 stem without the max pool; ``num_outputs=0``: pooled
    features."""
    widths = [width * 2 ** i for i in range(len(depth_blocks))]
    return _on(ResNet(depth_blocks, widths, width, 3 if cifar_stem else 7,
                      1 if cifar_stem else 2, not cifar_stem, num_outputs,
                      in_channels, generator), device)


def make_cifar_resnet(depth: int = 20, num_outputs: int = 0, width: int = 16,
                      device=None, generator: Optional[torch.Generator] = None) -> ResNet:
    """CIFAR ResNet-20/32/44/56: three stages of (depth - 2)/6 blocks."""
    if (depth - 2) % 6:
        raise ValueError(f"depth {depth} is not 6n+2")
    n = (depth - 2) // 6
    return _on(ResNet((n, n, n), [width, 2 * width, 4 * width], width, 3, 1, False,
                      num_outputs, 3, generator), device)


def make_wide_resnet(depth: int = 28, widen: int = 2, num_outputs: int = 0,
                     device=None, generator: Optional[torch.Generator] = None) -> ResNet:
    """WideResNet-depth-widen: the CIFAR topology with stage widths
    16·widen, 32·widen, 64·widen after a 16-wide stem."""
    if (depth - 4) % 6:
        raise ValueError(f"depth {depth} is not 6n+4")
    n = (depth - 4) // 6
    return _on(ResNet((n, n, n), [16 * widen, 32 * widen, 64 * widen], 16, 3, 1, False,
                      num_outputs, 3, generator), device)


class LinearProbe(Head):
    """A linear classifier on detached features."""

    def forward(self, feats):
        return super().forward(feats.detach())


def make_linear_probe(input_dim: int, num_classes: int, device=None,
                      generator: Optional[torch.Generator] = None) -> LinearProbe:
    return _on(LinearProbe(input_dim, num_classes, generator), device)
