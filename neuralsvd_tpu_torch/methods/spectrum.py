"""Post-hoc spectrum estimation from validation batches.

Port of ``neuralsvd_tpu/methods/spectrum.py:50-148``
(``compute_spectrum_evd``): accumulate cov = E[φφᵀ] and quad = E[φ(Tφ)ᵀ]
over a dataloader with train→val importance reweighting, then take the
Rayleigh quotients; and of ``:152-193`` (``compute_spectrum_svd``): the
singular values and orthogonality of a two-tower (CDK) model from its two
marginal grams.  The accumulation runs on the device without autograd;
the (L, L) results go to numpy.  Not ported yet (ROADMAP queue 1, item 9):
``post_align`` and the numpy diagnostics (``mode_health``,
``grouped_rayleigh``, ``spectrum_report``).
"""
from __future__ import annotations

from typing import Callable, Optional

import numpy as np
import torch

from neuralsvd_tpu_torch.device import resolve_device


def _accumulate_evd(f, operator, x, importance_train, importance_val,
                    set_first_mode_const: bool):
    sqrt_ws_train = torch.sqrt(importance_train(x)) if importance_train else 1.0
    sqrt_ws_val = torch.sqrt(importance_val(x)) if importance_val else 1.0
    sqrt_ws = sqrt_ws_train / sqrt_ws_val
    Tphi, phi = operator(f, x, importance_train)  # no generator: exact Laplacian
    eigfuncs = sqrt_ws_train * phi
    phi = sqrt_ws * phi
    Tphi = sqrt_ws * Tphi
    if set_first_mode_const:
        ones = torch.ones((phi.shape[0], 1), dtype=phi.dtype, device=phi.device)
        phi = torch.cat([ones, phi], dim=1)
        Tphi = torch.cat([ones, Tphi], dim=1)
    # non-finite rows are isolated points where the exact Laplacian of a
    # cusped feature diverges: zero them (measure zero, unbiased)
    phi = torch.nan_to_num(phi, nan=0.0, posinf=0.0, neginf=0.0)
    Tphi = torch.nan_to_num(Tphi, nan=0.0, posinf=0.0, neginf=0.0)
    if getattr(operator, "singular_at_origin", False):
        at_origin = torch.all(
            torch.isclose(x, torch.zeros((), dtype=x.dtype, device=x.device)),
            dim=1, keepdim=True)
        Tphi = torch.where(at_origin, torch.zeros_like(Tphi), Tphi)
    cov = torch.einsum("bl,bm->lm", phi, phi)
    quad = torch.einsum("bl,bm->lm", phi, Tphi)
    return cov, quad, eigfuncs


def compute_spectrum_evd(
    f,
    dataloader,
    operator,
    importance_train: Optional[Callable] = None,
    importance_val: Optional[Callable] = None,
    set_first_mode_const: bool = False,
    post_align: bool = False,
    normalize: bool = False,
    sort: bool = False,
    device=None,
):
    """Returns dict with eigfuncs, cov, quad, eigvals (Rayleigh), norms.

    ``f`` is a callable x -> (B, L) or a tuple ``(eval_apply, params,
    state)``.  ``dataloader`` yields x batches (numpy arrays or tensors),
    moved to ``device`` (default: the GPU).
    """
    if post_align:
        raise NotImplementedError(
            "post_align is not ported yet (ROADMAP queue 1, item 9)")
    dev = resolve_device(device)
    if isinstance(f, tuple):
        eval_apply, params, state = f
        f = lambda x: eval_apply(params, state, x)  # noqa: E731
    n = 0
    cov = quad = 0.0
    eigfuncs = []
    with torch.no_grad():
        for x in dataloader:
            x = torch.as_tensor(x, dtype=torch.float32, device=dev)
            c, q, ef = _accumulate_evd(f, operator, x, importance_train,
                                       importance_val, set_first_mode_const)
            cov = cov + c
            quad = quad + q
            eigfuncs.append(ef.cpu().numpy())
            n += x.shape[0]
    cov = (cov / n).cpu().numpy()
    quad = (quad / n).cpu().numpy()
    outputs = {"eigfuncs": np.concatenate(eigfuncs, axis=0), "cov": cov,
               "quad": quad}
    # eigfuncs hold the L learned modes only; with set_first_mode_const the
    # matrices hold the constant mode first (L + 1).  The JAX package
    # normalises and sorts eigfuncs by all L + 1 modes and raises there
    # (ROADMAP §3); here eigfuncs take the non-constant modes' norms and order.
    first = 1 if set_first_mode_const else 0
    with np.errstate(divide="ignore", invalid="ignore"):
        outputs["eigvals"] = eigvals = np.diag(quad) / np.diag(cov)
        outputs["norms"] = norms = np.diag(cov)
        if normalize:
            sn = np.sqrt(np.maximum(norms, 1e-300))[:, None]
            outputs["cov"] = cov / (sn @ sn.T)
            outputs["eigfuncs"] = outputs["eigfuncs"] / sn[first:].T
    if sort:
        idx = np.argsort(eigvals)[::-1]
        outputs["eigvals"] = outputs["eigvals"][idx]
        outputs["eigfuncs"] = outputs["eigfuncs"][:, np.argsort(eigvals[first:])[::-1]]
        outputs["cov"] = outputs["cov"][np.ix_(idx, idx)]
        outputs["quad"] = outputs["quad"][np.ix_(idx, idx)]
        outputs["norms"] = outputs["norms"][idx]
    return outputs


def compute_spectrum_svd(apply_fn, dataloader, sort: bool = False,
                         set_first_mode_const: bool = False, device=None):
    """(spectrum, orthogonality_x, orthogonality_y) of a two-tower model.

    ``apply_fn(x, y) -> (f, g)``; ``dataloader`` yields (x, y[, cls])
    batches (numpy or tensors), moved to ``device`` (default: the GPU).
    spectrum_l = √(E[f_l²]·E[g_l²]); orthogonality is each gram
    normalised by its diagonal.
    """
    dev = resolve_device(device)
    n = 0
    mx = my = 0.0
    with torch.no_grad():
        for batch in dataloader:
            x = torch.as_tensor(batch[0], dtype=torch.float32, device=dev)
            y = torch.as_tensor(batch[1], dtype=torch.float32, device=dev)
            fx, gy = apply_fn(x, y)
            if set_first_mode_const:
                ones = torch.ones((fx.shape[0], 1), dtype=fx.dtype, device=dev)
                fx = torch.cat([ones, fx], dim=1)
                gy = torch.cat([ones, gy], dim=1)
            mx = mx + torch.einsum("bl,bm->lm", fx, fx)
            my = my + torch.einsum("bl,bm->lm", gy, gy)
            n += x.shape[0]
    mx = mx.cpu().numpy() / n
    my = my.cpu().numpy() / n
    dx = np.diag(mx)[:, None]
    dy = np.diag(my)[:, None]
    spectrum = np.sqrt(dx * dy).ravel()
    orth_x = mx / np.sqrt(dx @ dx.T)
    orth_y = my / np.sqrt(dy @ dy.T)
    if sort:
        idx = np.argsort(spectrum)[::-1]
        spectrum = spectrum[idx]
        orth_x = orth_x[np.ix_(idx, idx)]
        orth_y = orth_y[np.ix_(idx, idx)]
    return spectrum, orth_x, orth_y
