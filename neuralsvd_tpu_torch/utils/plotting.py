"""The arrays behind the PDE CLI's plots, written as ``.npz``.

Port of ``neuralsvd_tpu/utils/plotting.py``: ``term_plot_spectrum`` (the
text spectrum plot for the log), and in place of each PNG the arrays it
would plot, since the card's machine has no matplotlib:

- ``plot_and_save_spectrum`` -> ``spectrum_<tag>.npz``: each spectrum
  series, |orthogonality| and the ground truth;
- ``plot_1d_eigfuncs`` -> ``eigfuncs_<tag>.npz``: x sorted and the first
  ``max_modes`` eigenfunctions in that order, strided to at most
  ``MAX_1D_POINTS`` points;
- ``plot_2d_eigfuncs`` -> ``eigfuncs2d_<tag>.npz``: the first
  ``max_modes`` eigenfunctions as images strided to at most
  ``MAX_2D_SIDE`` points a side.

The eigenfunction files are float32 and of bounded size, as the JAX
package's one 150-dpi PNG an eval is: at hydrogen.sh's 1000 x 1000 grid
and L 36 an eval writes 36 x 250 x 250 values (9 MB), not the full grid
(144 MB, 7.2 GB over a run's 50 evals).
"""
from __future__ import annotations

import os
from typing import Optional

import numpy as np

MAX_2D_SIDE = 256
MAX_1D_POINTS = 4096


def _stride(n: int, most: int) -> int:
    """The smallest stride that leaves at most ``most`` of ``n`` points."""
    return -(-n // most)


def term_plot_spectrum(spectrum: dict, width: int = 72, height: int = 14):
    """ASCII spectrum plot for terminal logs."""
    lines = []
    for key, vals in spectrum.items():
        if vals is None:
            continue
        vals = np.asarray(vals, dtype=float)
        finite = vals[np.isfinite(vals)]
        if finite.size == 0:
            lines.append(f"{key}: all {len(vals)} values non-finite")
            continue
        lo, hi = float(finite.min()), float(finite.max())
        span = (hi - lo) or 1.0
        cols = np.linspace(0, len(vals) - 1, min(width, len(vals))).astype(int)
        # non-finite entries clip to the plot edges
        rows = np.clip(
            np.nan_to_num((vals[cols] - lo) / span * (height - 1),
                          nan=0.0, posinf=height - 1, neginf=0.0),
            0, height - 1).round().astype(int)
        grid = [[" "] * len(cols) for _ in range(height)]
        for c, r in enumerate(rows):
            grid[height - 1 - r][c] = "*"
        lines.append(f"{key} (sum={vals.sum():.2f}) range=[{lo:.3g},{hi:.3g}]")
        lines.extend("".join(row) for row in grid)
    return "\n".join(lines)


def plot_and_save_spectrum(spectrum: dict, orthogonality,
                           log_dir: Optional[str] = None, tag: str = "",
                           termplot: bool = True, ground_truth_spectrum=None):
    """Print the text plot; write ``spectrum_<tag>.npz`` under ``log_dir``."""
    if termplot:
        print(term_plot_spectrum(spectrum))
    if not log_dir:
        return None
    arrays = {f"spectrum_{k}": np.asarray(v) for k, v in spectrum.items()
              if v is not None}
    arrays["orthogonality"] = np.abs(np.asarray(orthogonality))
    if ground_truth_spectrum is not None:
        arrays["ground_truth"] = np.asarray(ground_truth_spectrum)
    os.makedirs(log_dir, exist_ok=True)
    path = os.path.join(log_dir, f"spectrum_{tag}.npz")
    np.savez(path, **arrays)
    return path


def plot_1d_eigfuncs(x, eigfuncs, log_dir: str, tag: str = "",
                     max_modes: int = 16):
    """Write ``eigfuncs_<tag>.npz``: x sorted, eigenfunctions in its order,
    every k-th point where there are more than ``MAX_1D_POINTS``."""
    L = min(eigfuncs.shape[1], max_modes)
    order = np.argsort(np.asarray(x).ravel())
    order = order[::_stride(len(order), MAX_1D_POINTS)]
    os.makedirs(log_dir, exist_ok=True)
    path = os.path.join(log_dir, f"eigfuncs_{tag}.npz")
    np.savez(path, x=np.asarray(x).ravel()[order].astype(np.float32),
             eigfuncs=np.asarray(eigfuncs)[order, :L].astype(np.float32))
    return path


def plot_2d_eigfuncs(eigfuncs, log_dir: str, tag: str = "",
                     max_modes: int = 36):
    """Write ``eigfuncs2d_<tag>.npz``: (L, s, s) float32 images of the first
    ``max_modes`` eigenfunctions on the square validation grid, every k-th
    grid point along each axis so that s <= ``MAX_2D_SIDE``."""
    eigfuncs = np.asarray(eigfuncs)
    side = int(round(np.sqrt(eigfuncs.shape[0])))
    L = min(eigfuncs.shape[1], max_modes)
    k = _stride(side, MAX_2D_SIDE)
    images = eigfuncs[:side * side, :L].T.reshape(L, side, side)[:, ::k, ::k]
    images = images.astype(np.float32)
    os.makedirs(log_dir, exist_ok=True)
    path = os.path.join(log_dir, f"eigfuncs2d_{tag}.npz")
    np.savez(path, images=images)
    return path
