"""The port's 1D scattering and ANFScattering against the JAX package on
the CPU: the Morlet filter banks (the same numpy code), `Scattering1D`,
the host song prep, the chunked device scattering with its per-chunk
segment median, the Euclidean-distance `full_scores`, `benchmark()` and
the CLI, on the JAX package's e2e corpus at its settings (J=5, T=2^10,
Q=4)."""

from tests import _torch_threads  # noqa: F401  (caps thread pools)

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from acoss_tpu.benchmarking.algorithms import ANFScattering as JaxANF
from acoss_tpu.benchmarking.algorithms import anf_scattering as jax_anf
from acoss_tpu.benchmarking.harness import benchmark as jax_benchmark
from acoss_tpu.data import make_synthetic_dataset
from acoss_tpu.ops import scattering as jax_scattering
from acoss_tpu_torch import cli
from acoss_tpu_torch.benchmarking.algorithms import ALL_ALGORITHMS, \
    ANFScattering
from acoss_tpu_torch.benchmarking.algorithms import anf_scattering
from acoss_tpu_torch.benchmarking.harness import benchmark, run_pairwise
from acoss_tpu_torch.data import FeatureSet
from acoss_tpu_torch.ops import scattering

KW = dict(J=5, T=2 ** 10, Q=4)


@pytest.fixture(scope="module")
def corpus():
    return make_synthetic_dataset(n_cliques=8, clique_size=2,
                                  n_distractors=4, seed=1)


def _port_fs(fs):
    return FeatureSet(fs.features, fs.lengths, fs.labels, fs.track_ids)


@pytest.mark.parametrize("T,J,Q", [(1024, 5, 4), (16384, 6, 8), (64, 2, 1)])
def test_filter_bank_1d_same_arrays(T, J, Q):
    got = scattering._filter_bank_1d(T, J, Q)
    want = jax_scattering._filter_bank_1d(T, J, Q)
    for g, w in zip(got, want):
        assert g.dtype == w.dtype
        np.testing.assert_array_equal(g, w)
    np.testing.assert_array_equal(scattering._morlet_1d(T, 1.1, 0.2),
                                  jax_scattering._morlet_1d(T, 1.1, 0.2))


@pytest.mark.parametrize("T,J,Q", [(1024, 5, 4), (16384, 6, 8), (64, 5, 4),
                                   (64, 2, 1)])
def test_scattering1d_matches_jax(T, J, Q):
    """complex64 FFTs of two libraries: the Scattering2D tolerance, 2e-6
    of the largest coefficient. (64, 2, 1) has no second-order pair."""
    x = np.random.default_rng(T + J).standard_normal((3, T)) \
        .astype(np.float32)
    want = np.asarray(jax_scattering.Scattering1D(J, T, Q)(x))
    sc = scattering.Scattering1D(J, T, Q)
    got = sc(torch.from_numpy(x)).numpy()
    assert got.shape == want.shape == (3, sc.n_coeffs, T // 2 ** J)
    assert got.dtype == np.float32
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=2e-6 * np.abs(want).max())


def test_song_prep_bit_equal(corpus):
    for name in ("novfn", "snovfn"):
        for i in (0, 7):
            x = corpus.feature(name)[i, :corpus.length(name)[i], 0]
            for g, w in zip(ANFScattering(**KW)._song_prep(x),
                            JaxANF(**KW)._song_prep(x)):
                assert g.dtype == w.dtype == np.float32
                np.testing.assert_array_equal(g, w)


def test_segment_median_is_numpys():
    """The per-chunk segment median on the device: numpy's median of 16
    values (the mean of the two middle ones) exactly."""
    SC = torch.from_numpy(np.random.default_rng(1).random(
        (3, anf_scattering.DOWNSAMPLE_FAC, 5, 4)).astype(np.float32))
    got = anf_scattering._median_segments(SC).numpy()
    want = np.median(SC.numpy().reshape(3, 16, -1), axis=1)
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("chunk", [anf_scattering.SCATTER_CHUNK, 7])
def test_descriptors_match_jax(corpus, chunk, monkeypatch):
    """Descriptors from the device scattering, in one chunk and in chunks
    of 7 songs (the last short), within the scattering's own tolerance:
    2e-6 of each descriptor's largest coefficient."""
    monkeypatch.setattr(anf_scattering, "SCATTER_CHUNK", chunk)
    got = ANFScattering(**KW).extract_descriptors(_port_fs(corpus),
                                                  device="cpu")
    want = JaxANF(**KW).extract_descriptors(corpus)
    assert sorted(got) == sorted(want) == sorted(JaxANF.SIMILARITY_TYPES)
    for k in want:
        assert got[k].dtype == want[k].dtype == np.float32
        assert got[k].shape == want[k].shape, k
        for g, w in zip(got[k], want[k]):
            np.testing.assert_allclose(g, w, rtol=0,
                                       atol=2e-6 * np.abs(w).max(),
                                       err_msg=k)


def test_full_scores_match_jax(corpus):
    """Euclidean distances from one fp32 Gram on the same (JAX-made)
    descriptors, off the diagonal (a song against itself is the Gram's
    cancellation floor, which the harness zeroes): rtol 1e-5, with an
    absolute floor of 1e-5 of the channel's largest distance. The Gram
    formula's error in d^2 scales with the squared norms, not with d^2,
    so near pairs of unit-norm shingles (d ~ 0.1) differ by ~5e-6 between
    two matmuls."""
    desc = JaxANF(**KW).extract_descriptors(corpus)
    n = corpus.n_songs
    off = ~np.eye(n, dtype=bool)
    got = ANFScattering(**KW).full_scores(
        {k: torch.from_numpy(v) for k, v in desc.items()})
    assert list(got) == list(JaxANF.SIMILARITY_TYPES)
    D = run_pairwise(ANFScattering(**KW), desc, n, device="cpu")
    for k in JaxANF.SIMILARITY_TYPES:
        want = np.array(jax_anf._gram_dist(jnp.asarray(desc[k])))
        tol = dict(rtol=1e-5, atol=1e-5 * want.max(), err_msg=k)
        np.testing.assert_allclose(got[k].numpy()[off], want[off], **tol)
        np.testing.assert_allclose(D[k][off], want[off], **tol)
        assert (np.diag(D[k]) == 0).all() and (want[off] > 0).all()


def test_benchmark_matches_jax(corpus, tmp_path):
    assert ALL_ALGORITHMS["ANFScattering"] is ANFScattering
    got = benchmark(ANFScattering(**KW), _port_fs(corpus), device="cpu",
                    results_csv=str(tmp_path / "p.csv"))
    want = jax_benchmark(JaxANF(**KW), corpus,
                         results_csv=str(tmp_path / "j.csv"))
    assert list(got) == list(JaxANF.SIMILARITY_TYPES)
    assert {k: dataclasses.asdict(v) for k, v in got.items()} == \
        {k: dataclasses.asdict(v) for k, v in want.items()}
    assert (tmp_path / "p.csv").read_text() == \
        (tmp_path / "j.csv").read_text()
    assert got["anfrnn"].map > 0.15


def test_cli_anf_scattering_on_cpu(tmp_path, monkeypatch, capsys):
    """ANFScattering takes no `chroma_type`: the CLI must not pass it (it
    did, and the constructor raised TypeError). Default J=6, T=2^14,
    Q=8 on 8 songs."""
    fs = make_synthetic_dataset(n_cliques=4, clique_size=2, seed=2)
    fs.save(str(tmp_path / "synth.npz"))
    monkeypatch.chdir(tmp_path)
    rc = cli.main(["benchmark", "-a", "ANFScattering", "-d", "synth.npz",
                   "-s", "anf", "--device", "cpu", "--no-checkpoint"])
    assert rc == 0
    assert "results appended to results_anf.csv" in capsys.readouterr().out
    rows = (tmp_path / "results_anf.csv").read_text().splitlines()
    assert [r.split(",")[0] for r in rows[1:]] == [
        f"ANFScattering_{k}" for k in ANFScattering.SIMILARITY_TYPES]
    assert all(0 < float(r.split(",")[4]) <= 1 for r in rows[1:])
