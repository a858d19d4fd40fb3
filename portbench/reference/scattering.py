"""2D wavelet scattering in plain PyTorch: a frozen copy of `Scattering2D`
of `acoss_tpu_torch.ops.scattering` (the kymatio stand-in of the
reference), so that the benchmark's reference does not move with the
program.

2D: a Mallat scattering network with kymatio-compatible output geometry: on
an (M, N) input with J scales and L orientations it gives
1 + J L + L^2 J (J - 1) / 2 channels at (M / 2^J, N / 2^J), e.g. J=2, L=8
on 64 x 64 -> (81, 16, 16). The Morlet filter banks are built by the same
numpy code as the JAX package's, so both packages hold the same filter
numbers; the FFTs run in complex64 (`torch.fft`), and agree with XLA's to
float32 rounding.
"""

from __future__ import annotations

import numpy as np
import torch


def _gabor_2d(M, N, sigma, theta, xi, slant=0.5):
    """Periodized 2D Gabor in the spatial domain (complex)."""
    R = np.array([[np.cos(theta), -np.sin(theta)],
                  [np.sin(theta), np.cos(theta)]])
    D = np.array([[1.0, 0.0], [0.0, slant ** 2]])
    curv = R @ D @ R.T / (2 * sigma ** 2)
    gab = np.zeros((M, N), dtype=np.complex128)
    for ex in (-2, -1, 0, 1):
        for ey in (-2, -1, 0, 1):
            xx, yy = np.mgrid[
                ex * M:M + ex * M, ey * N:N + ey * N]
            arg = -(curv[0, 0] * xx ** 2
                    + (curv[0, 1] + curv[1, 0]) * xx * yy
                    + curv[1, 1] * yy ** 2) \
                + 1j * (xx * xi * np.cos(theta) + yy * xi * np.sin(theta))
            gab += np.exp(arg)
    gab /= 2 * np.pi * sigma ** 2 / slant
    return gab


def _morlet_2d(M, N, sigma, theta, xi, slant=0.5):
    """Zero-mean Morlet: gabor minus a scaled gaussian."""
    wv = _gabor_2d(M, N, sigma, theta, xi, slant)
    wv_mod = _gabor_2d(M, N, sigma, theta, 0.0, slant)
    K = np.sum(wv) / np.sum(wv_mod)
    return wv - K * wv_mod


def _filter_bank_2d(M, N, J, L):
    """Fourier-domain psi_{j, theta} and phi_J filters at full resolution."""
    psis = []
    for j in range(J):
        for th in range(L):
            theta = (th + 0.5) * np.pi / L
            sigma = 0.8 * 2 ** j
            xi = 3.0 / 4.0 * np.pi / 2 ** j
            psi = _morlet_2d(M, N, sigma, theta, xi)
            psis.append(np.real(np.fft.fft2(psi)))
    sigma_phi = 0.8 * 2 ** J
    phi = _gabor_2d(M, N, sigma_phi, 0.0, 0.0)
    phi_f = np.real(np.fft.fft2(phi))
    return (np.stack(psis).astype(np.float32).reshape(J, L, M, N),
            phi_f.astype(np.float32))


def _fold2(Xf, k: int):
    """Fourier fold: (..., M, N) -> (..., M/k, N/k) alias-block sum, for
    numpy arrays and tensors alike.

    `ifft2(fold2(Xf, k)) / k^2 == ifft2(Xf)[..., ::k, ::k]` exactly (the
    DFT decimation identity), so a smoothed-and-subsampled output can be
    computed with the inverse FFT at the SMALL size."""
    if k == 1:
        return Xf
    shape = tuple(Xf.shape)
    M, N = shape[-2], shape[-1]
    X = Xf.reshape(shape[:-2] + (k, M // k, k, N // k))
    return X.sum(axis=(-4, -2)) if isinstance(X, np.ndarray) \
        else X.sum(dim=(-4, -2))


class Scattering2D:
    """2D scattering transform; output (1 + JL + L^2 J(J-1)/2, M/2^J, N/2^J).

    Call the instance on an (..., M, N) float tensor; the filters follow
    the input's device (one copy per device, made on first use).

    `subsample`: run the multiscale pipeline at reduced resolutions the
    way kymatio does -- U1 at scale j1 is decimated to M/2^j1 (an exact
    fold-decimation, see `_fold2`) and the second order convolves with
    sum-periodized filters at that resolution. Default (None) switches it
    on at min(shape) >= 256, so the 64 x 64 block-SSM scattering keeps the
    full-resolution pipeline."""

    def __init__(self, shape: tuple[int, int], J: int = 2, L: int = 8,
                 subsample: bool | None = None):
        self.shape = shape
        self.J = J
        self.L = L
        M, N = shape
        if subsample is None:
            subsample = min(M, N) >= 256
        self.subsample = bool(subsample and M % (1 << J) == 0
                              and N % (1 << J) == 0)
        psi, phi = _filter_bank_2d(M, N, J, L)
        # host copies: psi (J, L, M, N), phi (M, N), both Fourier; the
        # sum-periodized filters of each working resolution of the
        # subsample pipeline are folded once here
        filters = {"psi": psi, "phi": phi}
        if self.subsample:
            for j1 in range(J):
                s = 1 << j1
                if s > 1:
                    filters[("phi", s)] = _fold2(phi, s)
                    for j2 in range(j1 + 1, J):
                        filters[("psi", j2, s)] = _fold2(psi[j2], s)
            for j2 in range(1, J):       # pool resolutions for S2
                s = 1 << j2
                filters.setdefault(("phi", s), _fold2(phi, s))
        self._host = {k: torch.from_numpy(np.ascontiguousarray(v))
                      for k, v in filters.items()}
        self._on: dict = {}

    def filters(self, device: torch.device) -> dict:
        device = torch.device(device)
        if device not in self._on:
            self._on[device] = {k: v.to(device)
                                for k, v in self._host.items()}
        return self._on[device]

    def _pool_spec(self, f: dict, xf: torch.Tensor, j: int) -> torch.Tensor:
        """Spectrum of a real signal at resolution M/2^j -> phi smoothing
        + exact fold-decimation to the output resolution M/2^J (the
        inverse FFT runs at the output size)."""
        k = 1 << (self.J - j)
        phi = f["phi"] if j == 0 else f[("phi", 1 << j)]
        prod = xf * phi
        Mj, Nj = prod.shape[-2], prod.shape[-1]
        if Mj % k == 0 and Nj % k == 0:
            return torch.fft.ifft2(_fold2(prod, k)).real / float(k * k)
        # shapes not divisible by 2^J: identical smoothing, subsampled by
        # slicing at full resolution
        return torch.fft.ifft2(prod).real[..., ::k, ::k]

    def _scatter(self, x: torch.Tensor) -> torch.Tensor:
        J, L = self.J, self.L
        f = self.filters(x.device)
        psi = f["psi"]
        xf = torch.fft.fft2(x)
        outs = [self._pool_spec(f, xf, 0)[..., None, :, :]]          # S0
        S2s = []
        if not self.subsample:
            # full-resolution pipeline (pools still fold-decimate)
            U1 = torch.fft.ifft2(xf[..., None, None, :, :] * psi).abs()
            U1f = torch.fft.fft2(U1)                     # (..., J, L, M, N)
            S1 = self._pool_spec(f, U1f, 0)
            outs.append(S1.reshape(S1.shape[:-4] + (J * L,)
                                   + S1.shape[-2:]))
            for j1 in range(J):
                u1f = U1f[..., j1, :, :, :]
                for j2 in range(j1 + 1, J):
                    U2 = torch.fft.ifft2(u1f[..., None, :, :]
                                         * psi[j2]).abs()
                    S2 = self._pool_spec(f, torch.fft.fft2(U2), 0)
                    S2s.append(S2.reshape(S2.shape[:-4] + (L * L,)
                                          + S2.shape[-2:]))
        else:
            S1s, U1fs = [], []
            for j1 in range(J):
                s = 1 << j1
                prod = xf[..., None, :, :] * psi[j1]     # (..., L, M, N)
                U1 = torch.fft.ifft2(_fold2(prod, s)).abs() / float(s * s)
                u1f = torch.fft.fft2(U1)                 # res M/s
                U1fs.append(u1f)
                S1s.append(self._pool_spec(f, u1f, j1))
            outs.append(torch.cat(S1s, dim=-3))
            for j1 in range(J):
                u1f, s = U1fs[j1], 1 << j1
                for j2 in range(j1 + 1, J):
                    kk = 1 << (j2 - j1)
                    psi2 = psi[j2] if s == 1 else f[("psi", j2, s)]
                    prod = u1f[..., None, :, :] * psi2
                    U2 = torch.fft.ifft2(_fold2(prod, kk)).abs() \
                        / float(kk * kk)
                    S2 = self._pool_spec(f, torch.fft.fft2(U2), j2)
                    S2s.append(S2.reshape(S2.shape[:-4] + (L * L,)
                                          + S2.shape[-2:]))
        if S2s:
            outs.append(torch.cat(S2s, dim=-3))
        return torch.cat(outs, dim=-3)

    def __call__(self, x) -> torch.Tensor:
        return self._scatter(torch.as_tensor(x, dtype=torch.float32))
