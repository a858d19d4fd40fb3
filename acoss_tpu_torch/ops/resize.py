"""Anti-aliased image resize (port of `acoss_tpu.ops.resize`, the
skimage.transform.resize(anti_aliasing=True) stand-in).

Gaussian pre-smoothing (sigma = (1/scale - 1) / 2 per axis, skimage's
default) followed by bilinear sampling. The blur is the JAX package's
index-order sum of shifted, weighted slices, not a convolution: cuDNN
would run an fp32 convolution in TF32 by default. The kernel taps, the
reflect-padding indices and the sample coordinates are the same numpy
arrays as the JAX package's.
"""

from __future__ import annotations

import numpy as np
import torch


def _gauss_kernel1d(sigma: float) -> np.ndarray:
    if sigma <= 0:
        return np.ones(1, dtype=np.float32)
    radius = max(1, int(np.ceil(3 * sigma)))
    x = np.arange(-radius, radius + 1)
    k = np.exp(-0.5 * (x / sigma) ** 2)
    return (k / k.sum()).astype(np.float32)


def _blur_axis(x: torch.Tensor, kernel: np.ndarray, axis: int) -> torch.Tensor:
    if kernel.size == 1:
        return x
    r = kernel.size // 2
    n = x.shape[axis]
    x = torch.movedim(x, axis, -1)
    # numpy's 'reflect' padding (no edge repeat), as jnp.pad(mode="reflect")
    idx = torch.from_numpy(np.pad(np.arange(n), r, mode="reflect"))
    xp = x[..., idx.to(x.device)]
    k = torch.from_numpy(kernel).to(x.device)
    out = xp[..., 0:n] * k[0]
    for i in range(1, kernel.size):
        out = out + xp[..., i:i + n] * k[i]
    return torch.movedim(out, -1, axis)


def _lin_coords(n_out: int, n_in: int):
    """skimage/scipy zoom-style sample coordinates (edge-aligned)."""
    scale = n_in / n_out
    x = (np.arange(n_out) + 0.5) * scale - 0.5
    x = np.clip(x, 0, n_in - 1)
    lo = np.floor(x).astype(np.int64)
    hi = np.minimum(lo + 1, n_in - 1)
    w = (x - lo).astype(np.float32)
    return lo, hi, w


def _interp_axis(x: torch.Tensor, n_out: int, axis: int) -> torch.Tensor:
    n_in = x.shape[axis]
    lo, hi, w = _lin_coords(n_out, n_in)
    dev = x.device
    xlo = torch.index_select(x, axis, torch.from_numpy(lo).to(dev))
    xhi = torch.index_select(x, axis, torch.from_numpy(hi).to(dev))
    shape = [1] * x.ndim
    shape[axis] = n_out
    wj = torch.from_numpy(w).to(dev).reshape(shape)
    return xlo * (1.0 - wj) + xhi * wj


def resize(img: torch.Tensor, out_shape: tuple[int, int],
           anti_aliasing: bool = True) -> torch.Tensor:
    """Resize the last two axes of `img` to `out_shape` with optional
    Gaussian anti-aliasing on downscale."""
    h_in, w_in = img.shape[-2], img.shape[-1]
    h_out, w_out = out_shape
    if anti_aliasing:
        sh = max(0.0, (h_in / h_out - 1) / 2)
        sw = max(0.0, (w_in / w_out - 1) / 2)
        img = _blur_axis(img, _gauss_kernel1d(sh), -2)
        img = _blur_axis(img, _gauss_kernel1d(sw), -1)
    img = _interp_axis(img, h_out, -2)
    img = _interp_axis(img, w_out, -1)
    return img
