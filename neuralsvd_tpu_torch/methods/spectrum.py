"""Post-hoc spectrum estimation from validation batches.

Port of ``neuralsvd_tpu/methods/spectrum.py:50-148``
(``compute_spectrum_evd``): accumulate cov = E[φφᵀ] and quad = E[φ(Tφ)ᵀ]
over a dataloader with train→val importance reweighting, then take the
Rayleigh quotients; of ``:152-193`` (``compute_spectrum_svd``): the
singular values and orthogonality of a two-tower (CDK) model from its two
marginal grams; and a numpy copy of ``:196-380``, the diagnostics on the
(L, L) accumulators: ``mode_health``, ``format_mode_health``,
``grouped_rayleigh``, ``post_alignment`` (``post_align``) and
``spectrum_report``.  The accumulation runs on the device without
autograd; the (L, L) results go to numpy.
"""
from __future__ import annotations

from typing import Callable, Optional

import numpy as np
import torch
from scipy.linalg import eigh

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
    if post_align:
        (outputs["eigfuncs_aligned"], outputs["eigvals_aligned"],
         outputs["cov_aligned"]) = post_alignment(
            outputs["eigfuncs"], outputs["cov"], outputs["quad"])
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


def mode_health(cov, quad, corr_thresh: float = 0.5,
                dead_rel: float = 1e-3):
    """Dead/duplicate-mode diagnosis from the (L, L) accumulators.

    A collapsed run parks near-zero-amplitude modes on already-occupied
    eigendirections — loss-free under norm-invariant Rayleigh objectives
    (observed at hydrogen L=36, BASELINE.md) — and the signals are already
    in the accumulators: a duplicate has |corr| ≈ 1 with the mode it
    copies, a dead mode has cov-diag ≈ 0.  Greedy scan by norm descending:
    a mode whose |corr| with any already-kept mode exceeds ``corr_thresh``
    is a duplicate of it (the higher-norm copy is the one kept); a mode
    whose norm is below ``dead_rel`` × median norm is dead.

    Returns a dict with ``healthy`` (bool L), ``duplicate_of`` (int L, −1
    for healthy), ``dead`` (bool L), ``rayleigh``, ``norms``, ``corr``.
    """
    cov = np.asarray(cov, dtype=np.float64)
    quad = np.asarray(quad, dtype=np.float64)
    raw_norms = np.diag(cov).copy()
    # a zero/NaN norm must read as DEAD, not poison every comparison into
    # False (NaN < x is False — the exact blindness this module exists to
    # remove)
    norms = np.nan_to_num(raw_norms, nan=0.0, posinf=0.0, neginf=0.0)
    rayleigh = np.nan_to_num(np.diag(quad) / np.maximum(norms, 1e-300))
    denom = np.sqrt(np.maximum(np.outer(norms, norms), 1e-300))
    corr = np.nan_to_num(cov / denom)
    L = cov.shape[0]
    dead = ((norms <= dead_rel * max(float(np.median(norms)), 0.0))
            | ~np.isfinite(raw_norms))
    duplicate_of = np.full(L, -1, dtype=np.int64)
    kept: list = []
    for i in np.argsort(norms)[::-1]:
        dup = next((j for j in kept if abs(corr[i, j]) > corr_thresh), None)
        if dup is None:
            kept.append(int(i))
        else:
            duplicate_of[i] = dup
    healthy = (duplicate_of < 0) & ~dead
    return {"healthy": healthy, "duplicate_of": duplicate_of, "dead": dead,
            "rayleigh": rayleigh, "norms": norms, "corr": corr}


def format_mode_health(health) -> str:
    """Human-readable dead/duplicate report ('' when all modes healthy)."""
    lines = []
    dup = health["duplicate_of"]
    for i in np.nonzero(dup >= 0)[0]:
        j = dup[i]
        lines.append(f"DUPLICATE: mode {i} ~ mode {j} "
                     f"(corr {health['corr'][i, j]:+.3f}, "
                     f"norms {health['norms'][i]:.3g}/{health['norms'][j]:.3g})")
    for i in np.nonzero(health["dead"] & (dup < 0))[0]:
        lines.append(f"DEAD: mode {i} (norm {health['norms'][i]:.3g})")
    if lines:
        n_bad = int((~health["healthy"]).sum())
        lines.append(f"{n_bad}/{len(dup)} modes dead or duplicate")
    return "\n".join(lines)


def grouped_rayleigh(quad_diag, cov_diag, group_sizes, cov=None,
                     corr_thresh: float = 0.5):
    """Degeneracy-aware Rayleigh estimates — collapse-aware.

    Within a degenerate eigenspace the learned modes converge to an
    arbitrary rotation of the true eigenfunctions, so individual Rayleigh
    quotients spread around the common eigenvalue; the pooled group
    estimate tr(quad_G)/tr(cov_G) is invariant to that rotation (trace of
    the group block).  Modes are ordered by their individual quotients and
    grouped by the problem's known degeneracy structure
    (operators/ground_truths.py get_degeneracy).

    With ``cov`` (the full (L, L) accumulator) given, pooling REFUSES any
    group containing a dead/duplicate mode (mode_health) and reports raw
    per-mode quotients for it instead: a collapsed run must not have its
    spurious modes laundered into a real group's trace (round-2 L=36
    lesson — the positional bucketing mis-filed corr-0.99 duplicates and
    under-reported the failure, VERDICT r2).

    Args: diagonals of the quad/cov accumulators (L,), group sizes summing
    to <= L.  Returns per-mode pooled estimates (L,), sorted descending.
    """
    quad_diag = np.asarray(quad_diag, dtype=np.float64)
    cov_diag = np.asarray(cov_diag, dtype=np.float64)
    rayleigh = quad_diag / cov_diag
    bad = np.zeros(len(rayleigh), dtype=bool)
    if cov is not None:
        quad_full = np.diag(quad_diag)
        health = mode_health(cov, quad_full, corr_thresh=corr_thresh)
        bad = ~health["healthy"]
    order = np.argsort(rayleigh)[::-1]
    out = np.array(rayleigh, dtype=np.float64)
    start = 0
    for gsize in group_sizes:
        idx = order[start:start + int(gsize)]
        if not bad[idx].any():
            out[idx] = quad_diag[idx].sum() / cov_diag[idx].sum()
        start += int(gsize)
    return np.sort(out)[::-1]


def post_alignment(eigfuncs, cov, quad, cond_limit: float = 1e10):
    """Post-hoc orthogonalization: whiten by cov, diagonalize quad.

    Reference: methods/spectrum.py:161-169.

    When cov is near-singular (duplicate/dead modes make it rank
    -deficient) the whitening amplifies noise unboundedly — the round-2
    L=36 logs show aligned eigvals reaching −2.5e9.  Guard: if
    cond(cov) > ``cond_limit`` a warning is emitted and the whitening
    eigenvalues are floored at max(eigval)/cond_limit, so the output is
    bounded and explicitly flagged instead of silently garbage.
    """
    import warnings

    eigvals_cov, eigvecs_cov = eigh(cov)
    emax = float(eigvals_cov.max())
    cond = emax / max(float(eigvals_cov.min()), 1e-300)
    if cond > cond_limit:
        warnings.warn(
            f"post_alignment: cov is near-singular (cond {cond:.3g} > "
            f"{cond_limit:.1g}) — dead/duplicate modes likely (see "
            "mode_health); whitening eigenvalues floored, aligned "
            "eigenvalues beyond the healthy subspace are meaningless",
            RuntimeWarning, stacklevel=2)
        eigvals_cov = np.maximum(eigvals_cov, emax / cond_limit)
    whitening = eigvecs_cov @ np.diag(1 / np.sqrt(eigvals_cov)) @ eigvecs_cov.T
    eigvals, V = eigh(whitening @ quad @ whitening)
    eigvals = np.sqrt(np.abs(eigvals[::-1]))
    V = V[:, ::-1]
    eigfuncs = eigfuncs @ (V.T @ whitening).T
    orthogonality = np.eye(quad.shape[0])
    return eigfuncs, eigvals, orthogonality


def spectrum_report(cov, quad, gt_sorted, group_sizes, top: int = 0,
                    corr_thresh: float = 0.5):
    """Complete collapse-, degeneracy-, and guard-aware spectrum eval.

    The one code path behind the hydrogen validation harness and the CLI
    eval summaries: given the (L, L) accumulators and the analytic
    spectrum, computes per-mode Rayleigh quotients, degeneracy-pooled
    estimates (grouped_rayleigh — refuses to pool spurious modes), and
    whitened-aligned eigenvalues, each with relative errors vs
    ``gt_sorted``, plus the dead/duplicate-mode diagnosis (mode_health).

    ``top``: report only the ``top`` best modes by Rayleigh quotient (0 =
    all L).  The remaining modes are *guards* — extra trained modes that
    absorb the slow convergence at the subspace truncation edge
    (subspace-iteration practice; the L=36 n=5 shell sits at the edge
    and dominates the error without them).  Guards still appear in the
    health diagnosis and in ``guards`` (their Rayleigh quotients), but
    not in the accuracy metrics.  ``group_sizes`` must sum to ``top``.

    Returns a dict: rayleigh, rel, grouped, rel_grouped, aligned,
    rel_aligned, max_off_corr, health, n_spurious, guards, report (the
    formatted health string, '' when clean).
    """
    cov = np.asarray(cov, dtype=np.float64)
    quad = np.asarray(quad, dtype=np.float64)
    L = cov.shape[0]
    top = int(top) if top else L
    gt_sorted = np.asarray(gt_sorted, dtype=np.float64)[:top]
    assert int(np.sum(group_sizes)) == top, (group_sizes, top)

    ray_full = np.diag(quad) / np.diag(cov)
    covn = cov / np.sqrt(np.outer(np.diag(cov), np.diag(cov)))
    max_off = float(np.nan_to_num(np.abs(covn - np.eye(L)), nan=1.0).max())
    health = mode_health(cov, quad, corr_thresh=corr_thresh)

    # Top-k selection must be collapse-aware (ADVICE r3): a dead mode's 0/0
    # Rayleigh is NaN, which raw argsort places last ascending — i.e. FIRST
    # after the reversal — exiling a healthy mode to the guards.  Rank
    # healthy modes first (by sanitized Rayleigh, descending); unhealthy
    # modes are eligible only if fewer than ``top`` healthy modes exist.
    ray_sane = np.nan_to_num(ray_full, nan=-np.inf,
                             posinf=-np.inf, neginf=-np.inf)
    order = np.lexsort((-ray_sane, ~health["healthy"]))
    sel = order[:top]
    sel = sel[np.argsort(-ray_sane[sel])]  # NaN/spurious last within top-k
    rayleigh = ray_full[sel]
    rel = np.abs(rayleigh - gt_sorted) / np.abs(gt_sorted)

    grouped = grouped_rayleigh(np.diag(quad)[sel], np.diag(cov)[sel],
                               group_sizes, cov=cov[np.ix_(sel, sel)],
                               corr_thresh=corr_thresh)
    rel_grouped = np.abs(grouped - gt_sorted) / np.abs(gt_sorted)

    # whitened alignment over ALL modes (basis-free), report the top
    w_eigvals, w_vecs = eigh(cov)
    wh = (w_vecs @ np.diag(1 / np.sqrt(np.maximum(w_eigvals, 1e-12)))
          @ w_vecs.T)
    aligned = np.sort(eigh(wh @ ((quad + quad.T) / 2) @ wh)[0])[::-1][:top]
    rel_aligned = np.abs(aligned - gt_sorted) / np.abs(gt_sorted)

    return {
        "rayleigh": rayleigh, "rel": rel,
        "grouped": grouped, "rel_grouped": rel_grouped,
        "aligned": aligned, "rel_aligned": rel_aligned,
        "max_off_corr": max_off, "health": health,
        "n_spurious": int((~health["healthy"]).sum()),
        "guards": ray_full[order[top:]],
        "report": format_mode_health(health),
    }
