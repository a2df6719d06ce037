"""Nyström method: the classical kernel EVD baseline.

Port of ``neuralsvd_tpu/methods/nystrom.py``.  The empirical kernel on a
training sample is eigendecomposed on the host in numpy, as in the JAX
package; the empirical kernel and the out-of-sample extension
f(x_new) = k(x_new, X)·V / λ / √n run on tensors on ``device`` (``None``:
the GPU, ``device.resolve_device``), where the training sample and the new
points are moved.  ``kernel(a, b)`` takes two tensors of rows and returns
their (len(a), len(b)) kernel matrix.  The eigenpairs take the kernel's
dtype in the extension, as JAX's float32 arrays meet its kernel.
"""
from __future__ import annotations

import math
import time
from typing import Callable, Optional

import numpy as np
import torch

from neuralsvd_tpu_torch.device import resolve_device


class Nystrom:
    def __init__(self, kernel: Optional[Callable], xs, dim: int,
                 emp_kernel=None, device=None):
        self.kernel = kernel
        self.xs = torch.as_tensor(xs, device=resolve_device(device))
        self.dim = dim
        self.eigvals, self.eigvecs, self.training_time = self.evd(
            self.xs, kernel, dim, emp_kernel)

    def __call__(self, xnew) -> torch.Tensor:
        K = self.kernel(torch.as_tensor(xnew, device=self.xs.device), self.xs)  # (B, n)
        return (K @ self.eigvecs.to(K.dtype) / self.eigvals.to(K.dtype)
                / math.sqrt(self.xs.shape[0]))

    @staticmethod
    def evd(xs: torch.Tensor, kernel, dim: int, emp_kernel=None):
        """(top-``dim`` eigvals / n, their eigenvectors, seconds), as
        tensors on ``xs``'s device, of its dtype where it is floating (else
        the default dtype)."""
        start = time.time()
        if emp_kernel is None:
            if kernel is None:
                raise ValueError("need kernel or emp_kernel")
            with torch.no_grad():
                emp_kernel = kernel(xs, xs)
        if isinstance(emp_kernel, torch.Tensor):
            emp_kernel = emp_kernel.detach().cpu().numpy()
        eigvals, eigvecs = np.linalg.eigh(np.asarray(emp_kernel))
        eigvals = eigvals[::-1][:dim] / xs.shape[0]
        eigvecs = eigvecs[:, ::-1][:, :dim]
        dtype = xs.dtype if xs.is_floating_point() else torch.get_default_dtype()
        return (torch.as_tensor(eigvals.copy(), dtype=dtype, device=xs.device),
                torch.as_tensor(eigvecs.copy(), dtype=dtype, device=xs.device),
                time.time() - start)


def run_nystrom(kernel, neigs: int, train_data, val_data,
                log_dir: Optional[str] = None, emp_kernel=None, device=None):
    """(eigvals, eigfuncs on ``val_data``, EVD seconds) as numpy arrays,
    computed on ``device``; with ``log_dir`` also written to
    ``eigvals.npz`` there."""
    nystrom = Nystrom(kernel, train_data, neigs, emp_kernel, device)
    eigvals = nystrom.eigvals.cpu().numpy()
    with torch.no_grad():
        eigfuncs = nystrom(val_data).cpu().numpy()
    if log_dir is not None:
        np.savez(f"{log_dir}/eigvals.npz", eigvals=eigvals, eigfuncs=eigfuncs)
    return eigvals, eigfuncs, nystrom.training_time
