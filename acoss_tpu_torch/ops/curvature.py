"""Gaussian-derivative curvature vectors of a curve (numpy copy of
`acoss_tpu.ops.curvature`).

Parity target: the reference's `CurvatureTools.py:11-66`
(used by StrucLaplacian at order 3, sigma 2, `StrucLaplacian.py:140`).
Host-side numpy/scipy: these run once per song on tiny (n, 10) curves.
"""

from __future__ import annotations

import numpy as np
from scipy.ndimage import gaussian_filter1d as gf1d


def get_curv_vectors(X: np.ndarray, max_order: int, sigma: float,
                     loop: bool = False) -> list[np.ndarray]:
    """Smoothed curvature/torsion vectors up to `max_order`
    (`CurvatureTools.py:11-30`): [smoothed, velocity, curvature, ...],
    higher orders Gram-Schmidt-projected against lower ones and normalized
    by |velocity|^order."""
    mode = "wrap" if loop else "nearest"
    XSmooth = gf1d(X, sigma, axis=0, order=0, mode=mode)
    Vel = gf1d(X, sigma, axis=0, order=1, mode=mode)
    VelNorm = np.sqrt(np.sum(Vel ** 2, 1))
    VelNorm[VelNorm == 0] = 1
    Curvs = [XSmooth, Vel]
    for order in range(2, max_order + 1):
        Tors = gf1d(X, sigma, axis=0, order=order, mode=mode)
        for j in range(1, order):
            denom = np.sum(Curvs[j] ** 2, 1)
            denom[denom == 0] = 1
            coef = np.sum(Tors * Curvs[j], 1) / denom
            Tors = Tors - Curvs[j] * coef[:, None]
        Tors = Tors / (VelNorm[:, None] ** order)
        Curvs.append(Tors)
    return Curvs


def get_zero_crossings(curvs: list[np.ndarray]) -> list[np.ndarray]:
    """Zero crossings of each curvature component via adjacent-dot sign
    (`CurvatureTools.py:34-41`)."""
    crossings = []
    for C in curvs:
        dots = np.sum(C[:-1] * C[1:], 1)
        crossings.append(np.arange(len(dots))[dots < 0])
    return crossings


def get_scale_space_images(X: np.ndarray, max_order: int,
                           sigmas: np.ndarray) -> list[np.ndarray]:
    """Binary zero-crossing scale-space images (`CurvatureTools.py:44-56`)."""
    images = [np.zeros((len(sigmas), X.shape[0])) for _ in range(max_order)]
    for s, sigma in enumerate(sigmas):
        curvs = get_curv_vectors(X, max_order, sigma)
        crossings = get_zero_crossings(curvs[1:])
        for i in range(max_order):
            if len(crossings[i]) > 0:
                images[i][s, crossings[i]] = 1.0
    return images


def get_multires_curvature_images(X: np.ndarray, max_order: int,
                                  sigmas: np.ndarray) -> list[np.ndarray]:
    """Curvature-magnitude scale-space images (`CurvatureTools.py:58-66`)."""
    images = [np.zeros((len(sigmas), X.shape[0])) for _ in range(max_order)]
    for s, sigma in enumerate(sigmas):
        curvs = get_curv_vectors(X, max_order, sigma)
        for i in range(max_order):
            images[i][s, :] = np.sqrt(np.sum(curvs[i + 1] ** 2, 1))
    return images
