"""The port's resize, 2D scattering and block-SSM scattering descriptors
against the JAX package on the CPU (`acoss_tpu.ops.resize`,
`.scattering`, `.ssm_features`)."""

from tests import _torch_threads  # noqa: F401  (caps thread pools)

import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from acoss_tpu.ops import crp as jax_crp
from acoss_tpu.ops import scattering as jax_scattering
from acoss_tpu.ops import ssm_features as jax_ssm
from acoss_tpu.ops.resize import resize as jax_resize
from acoss_tpu_torch.ops import crp, resize, scattering, ssm_features


@pytest.mark.parametrize("M,N,J,L", [(64, 64, 2, 8), (32, 48, 3, 4)])
def test_filter_banks_are_the_same_arrays(M, N, J, L):
    """The filters are the state the port carries over: the same numpy
    code, so the same numbers, including the folded (sum-periodized)
    filters of the subsample pipeline."""
    for got, want in zip(scattering._filter_bank_2d(M, N, J, L),
                         jax_scattering._filter_bank_2d(M, N, J, L)):
        assert got.dtype == want.dtype == np.float32
        np.testing.assert_array_equal(got, want)
    psi, phi = jax_scattering._filter_bank_2d(256, 256, 3, 2)
    sc = scattering.Scattering2D((256, 256), J=3, L=2)
    assert sc.subsample
    f = sc.filters("cpu")
    np.testing.assert_array_equal(f[("phi", 4)].numpy(),
                                  jax_scattering._fold2(phi, 4))
    np.testing.assert_array_equal(f[("psi", 2, 2)].numpy(),
                                  jax_scattering._fold2(psi[2], 2))


@pytest.mark.parametrize("shape,out", [((70, 70), (64, 64)),
                                       ((700, 300), (64, 64)),
                                       ((40, 50), (64, 32))])
def test_resize_matches_jax(shape, out):
    """Blur (reflect-padded, index-order weighted sum) + bilinear sampling;
    the taps and indices are the same numpy arrays, and the float32 adds
    run in the same order, so only the last ulps may differ."""
    rng = np.random.default_rng(sum(shape))
    img = rng.random((3,) + shape).astype(np.float32)
    want = np.asarray(jax_resize(jnp.asarray(img), out))
    got = resize.resize(torch.from_numpy(img), out).numpy()
    assert got.shape == want.shape == (3,) + out
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-7)


@pytest.mark.parametrize("shape,J,L,subsample", [
    ((64, 64), 2, 8, None),          # Serra09's block SSMs: full resolution
    ((256, 256), 3, 2, None),        # auto: the subsample pipeline
    ((64, 64), 3, 4, True),
    ((30, 45), 2, 4, None),          # shapes not divisible by 2^J
])
def test_scattering2d_matches_jax(shape, J, L, subsample):
    """Both pipelines through torch.fft in complex64: FFTs of another
    library round differently, so coefficients agree to float32 rounding
    relative to the largest coefficient."""
    rng = np.random.default_rng(J * 10 + L)
    x = rng.random((2,) + shape).astype(np.float32)
    jsc = jax_scattering.Scattering2D(shape, J=J, L=L, subsample=subsample)
    tsc = scattering.Scattering2D(shape, J=J, L=L, subsample=subsample)
    assert tsc.subsample == jsc.subsample
    want = np.asarray(jsc(x))
    got = tsc(torch.from_numpy(x)).numpy()
    assert got.shape == want.shape and got.dtype == np.float32
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=2e-6 * np.abs(want).max())


def test_scattering2d_matches_direct_space_oracle():
    """The golden fixture of `tests/test_golden_fixtures.py`: an
    independent float64 direct-space oracle (no FFT), at that test's
    tolerance."""
    z = np.load(os.path.join(os.path.dirname(__file__), "fixtures",
                             "scattering2d_16x16_J2_L4.npz"))
    sc = scattering.Scattering2D((16, 16), J=int(z["J"]), L=int(z["L"]))
    got = sc(torch.from_numpy(z["x"].astype(np.float32))).numpy()
    want = z["expected"]
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, atol=1e-4 * np.abs(want).max(),
                               rtol=2e-4)


def test_get_ssm_matches_jax_with_exact_zero_duplicates():
    """Repeat-padded rows (bitwise-equal) are exactly 0 apart, as in the
    JAX package; other distances agree to fp32 rounding."""
    rng = np.random.default_rng(3)
    X = rng.standard_normal((40, 300)).astype(np.float32) * 5 + 2
    X[30:] = X[29]
    want = np.asarray(jax_crp.get_ssm(jnp.asarray(X)))
    got = crp.get_ssm(torch.from_numpy(X)).numpy()
    assert (got[29:, 29:] == 0).all() and (np.diag(got) == 0).all()
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-3)
    # batched over leading dims
    Xb = np.stack([X, X[::-1].copy()])
    gotb = crp.get_ssm(torch.from_numpy(Xb)).numpy()
    np.testing.assert_array_equal(gotb[0], got)


def _mfccs(seed, lengths, d=13):
    rng = np.random.default_rng(seed)
    return [(rng.standard_normal((n, d)) * 3
             + np.linspace(0, 5, n)[:, None]).astype(np.float32)
            for n in lengths]


def test_ssm_scatter_sequence_and_length_match_match_jax():
    (mfcc,) = _mfccs(0, [130])
    kw = dict(downsample_fac=4, m=18)
    want = jax_ssm.get_ssm_scatter_sequence(mfcc, **kw)
    got = ssm_features.get_ssm_scatter_sequence(mfcc, device="cpu", **kw)
    assert got.shape == want.shape == (15, ssm_features.scatter_dim(64))
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=2e-5 * np.abs(want).max())
    short = ssm_features.get_ssm_scatter_sequence(mfcc[:50], device="cpu",
                                                  **kw)
    assert short.shape == (0, ssm_features.scatter_dim(64))
    for M in (0, 10, 15, 20):
        np.testing.assert_array_equal(
            ssm_features.length_match(got, M, got.shape[1]),
            jax_ssm.length_match(got, M, got.shape[1]))


def test_build_ssms_device_matches_jax():
    """The (N, pad_to, sdim) corpus: songs with more blocks than rows
    (cut), fewer (the last row repeated up to M), one block exactly, and
    one shorter than a block (all zero). Values agree to float32
    rounding; the zero rows and repeated rows are exact."""
    mfccs = _mfccs(1, [200, 110, 72, 60, 150])
    Ms = [20, 16, 5, 7, 40]
    kw = dict(pad_to=32, downsample_fac=4, m=18)
    want = np.asarray(jax_ssm.build_ssms_device(mfccs, Ms, chunk=8,
                                                l_bucket=256, **kw))
    got = ssm_features.build_ssms_device(mfccs, Ms, chunk=8, device="cpu",
                                         **kw)
    assert isinstance(got, torch.Tensor)
    got = got.numpy()
    assert got.shape == want.shape == (5, 32, ssm_features.scatter_dim(64))
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=2e-5 * np.abs(want).max())
    assert (got[3] == 0).all() and (got[0, 20:] == 0).all()
    assert (got[1, 10:16] == got[1, 9]).all() and (got[1, 16:] == 0).all()
