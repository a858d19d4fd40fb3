"""The port's EarlyFusion end to end against the JAX package on the CPU:
the cosine and blocked-OTI CSMs, the descriptors, the tile under both of
the JAX package's aligner paths (the XLA scan and the Pallas kernel in
interpret mode), the late fusion, `benchmark(EarlyFusion)` and the CLI.

The corpus is small (8 songs, the scaled configuration of the JAX
package's own EarlyFusion test: 8-beat blocks of 16 MFCC and 12 chroma
frames) but not vacuous: every song has at least 30 blocks."""

from tests import _torch_threads  # noqa: F401  (caps thread pools)

import dataclasses

import jax
import numpy as np
import pytest
import torch

from acoss_tpu.benchmarking.algorithms import EarlyFusion as JaxEarlyFusion
from acoss_tpu.benchmarking.harness import benchmark as jax_benchmark
from acoss_tpu.data import make_synthetic_dataset
from acoss_tpu.ops import alignment as jax_alignment
from acoss_tpu.ops import crp as jax_crp
from acoss_tpu_torch import cli
from acoss_tpu_torch.benchmarking.algorithms import (ALL_ALGORITHMS,
                                                     EarlyFusion)
from acoss_tpu_torch.benchmarking.harness import benchmark
from acoss_tpu_torch.convert import descriptors_from_numpy
from acoss_tpu_torch.data import FeatureSet
from acoss_tpu_torch.data import \
    make_synthetic_dataset as port_synthetic_dataset
from acoss_tpu_torch.ops import crp

KW = dict(blocksize=8, mfccs_per_block=16, chromas_per_block=12, late_K=8,
          late_niters=5)
SIM_TYPES = ("mfccs", "ssms", "chromas", "early")


@pytest.fixture(scope="module")
def corpus():
    fs = make_synthetic_dataset(n_cliques=4, clique_size=2, seed=3)
    desc = {k: np.asarray(v)
            for k, v in JaxEarlyFusion(**KW).extract_descriptors(fs).items()}
    return fs, desc


def _port_fs(fs):
    return FeatureSet(fs.features, fs.lengths, fs.labels, fs.track_ids)


def _blocks(seed, shape, zero_rows=()):
    x = np.random.default_rng(seed).random(shape).astype(np.float32)
    for r in zero_rows:
        x[..., r, :] = 0.0                 # a zero-norm row
    return x


def test_csm_cosine_matches_jax():
    X, Y = _blocks(0, (2, 30, 48), (3,)), _blocks(1, (2, 25, 48), (0, 7))
    for b in range(2):
        want = np.asarray(jax_crp.get_csm_cosine(X[b], Y[b]))
        got = crp.get_csm_cosine(torch.from_numpy(X[b]),
                                 torch.from_numpy(Y[b])).numpy()
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)
        # a zero row of X is at cosine distance 1 from every row
        assert np.all(got[3] == 1.0) or b == 1
    # batched: both pairs in one call
    got = crp.get_csm_cosine(torch.from_numpy(X), torch.from_numpy(Y))
    np.testing.assert_allclose(
        got[1].numpy(), np.asarray(jax_crp.get_csm_cosine(X[1], Y[1])),
        rtol=0, atol=1e-6)


def test_csm_blocked_oti_matches_jax():
    """Per pair and over a (3, 2) tile of pairs: the OTI of the global
    chroma vectors rolls every 12-bin group of X's rows."""
    X, Y = _blocks(2, (3, 20, 36)), _blocks(3, (2, 22, 36))
    C1, C2 = _blocks(4, (3, 12)), _blocks(5, (2, 12))
    got = crp.get_csm_blocked_oti(
        torch.from_numpy(X)[:, None], torch.from_numpy(Y)[None],
        torch.from_numpy(C1)[:, None], torch.from_numpy(C2)[None]).numpy()
    assert got.shape == (3, 2, 20, 22)
    otis = set()
    for i in range(3):
        for j in range(2):
            want = np.asarray(jax_crp.get_csm_blocked_oti(
                X[i], Y[j], C1[i], C2[j], jax_crp.get_csm_cosine))
            np.testing.assert_allclose(got[i, j], want, rtol=0, atol=1e-6)
            single = crp.get_csm_blocked_oti(
                *(torch.from_numpy(a) for a in (X[i], Y[j], C1[i], C2[j])))
            np.testing.assert_allclose(single.numpy(), want, rtol=0,
                                       atol=1e-6)
            otis.add(int(jax_crp.get_oti(C1[i], C2[j])))
    assert len(otis) > 1                   # the rolls differ from pair to pair


def test_descriptors_match_jax(corpus):
    fs, want = corpus
    got = EarlyFusion(**KW).extract_descriptors(_port_fs(fs), device="cpu")
    assert sorted(got) == sorted(want)
    for k in want:
        assert got[k].dtype == want[k].dtype
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    assert int(want["length"].min()) >= 30          # not vacuous


@pytest.mark.parametrize("impl", ["xla", "pallas_interpret"])
def test_tile_matches_jax(corpus, impl):
    """The port's batched tile (per pair in the JAX package) gives the JAX
    tile's scores under both of its aligner paths. The CSMs come from
    other matmuls (fp32 rounding), the CRPs and SW scores are held within
    the Pallas SW kernel's own bound, atol 1e-4 (equal on this corpus)."""
    fs, desc = corpus
    rows, cols = slice(0, 4), slice(4, 8)
    prev = jax_alignment.set_alignment_impl(impl)
    try:
        want = JaxEarlyFusion(**KW).tile_scores(
            jax.device_put({k: v[rows] for k, v in desc.items()}),
            jax.device_put({k: v[cols] for k, v in desc.items()}))
        want = {k: np.asarray(v) for k, v in want.items()}
    finally:
        jax_alignment.set_alignment_impl(prev)
    d = descriptors_from_numpy(desc, "cpu")
    row = {k: v[rows] for k, v in d.items()}
    col = {k: v[cols] for k, v in d.items()}
    for plain in (False, True):
        got = EarlyFusion(**KW).tile_scores(row, col, plain=plain)
        assert tuple(got) == SIM_TYPES
        for k in SIM_TYPES:
            assert got[k].shape == (4, 4)
            np.testing.assert_allclose(got[k].numpy(), want[k], rtol=0,
                                       atol=1e-4, err_msg=f"{k} {plain}")
    assert all(want[k].min() > 0 for k in SIM_TYPES)


def test_post_process_matches_jax():
    """Late fusion (SNF, the reference's sequential order) of the same
    score matrices: the SNF affinities and diffusion sum in another order
    than XLA, so within rtol 1e-5."""
    rng = np.random.default_rng(6)
    n = 12
    Ds = {}
    for k in SIM_TYPES:
        D = rng.random((n, n)).astype(np.float32) * 30
        Ds[k] = np.tril(D, -1) + np.tril(D, -1).T
    desc = {"length": np.full(n, 40, np.int32)}
    got = EarlyFusion(**KW).post_process(Ds, desc, device="cpu")
    want = JaxEarlyFusion(**KW).post_process(Ds, desc)
    assert list(got) == list(want) == list(SIM_TYPES) + ["late",
                                                         "early+late"]
    for k in want:
        assert got[k].dtype == np.float32 and got[k].shape == (n, n)
        np.testing.assert_allclose(got[k], want[k], rtol=1e-5, atol=1e-7,
                                   err_msg=k)
    assert not np.allclose(got["late"], got["early+late"])


def test_benchmark_matches_jax(corpus, tmp_path):
    fs, _ = corpus
    times = {}
    got = benchmark(EarlyFusion(**KW), _port_fs(fs),
                    results_csv=str(tmp_path / "p.csv"), device="cpu",
                    times=times)
    want = jax_benchmark(JaxEarlyFusion(**KW), fs,
                         results_csv=str(tmp_path / "j.csv"))
    assert list(got) == list(SIM_TYPES) + ["late", "early+late"]
    assert {k: dataclasses.asdict(v) for k, v in got.items()} == \
        {k: dataclasses.asdict(v) for k, v in want.items()}
    assert (tmp_path / "p.csv").read_text() == \
        (tmp_path / "j.csv").read_text()
    assert got["chromas"].map > 0.9 and got["late"].map > 0.9
    assert sorted(times) == ["eval", "extract", "sweep"]


def test_cli_early_fusion_on_cpu(tmp_path, monkeypatch, capsys):
    """The CLI with EarlyFusion's defaults (20-beat blocks) on 30 s
    states: ~70 blocks a song."""
    assert ALL_ALGORITHMS["EarlyFusion"] is EarlyFusion
    fs = port_synthetic_dataset(n_cliques=4, clique_size=2, n_states=12,
                                seed=1, base_duration=30.0)
    assert int(fs.length("onsets").min()) - 20 >= 30
    fs.save(str(tmp_path / "synth.npz"))
    monkeypatch.chdir(tmp_path)
    rc = cli.main(["benchmark", "-a", "EarlyFusion", "-d", "synth.npz", "-s",
                   "ef", "--device", "cpu", "--no-checkpoint"])
    assert rc == 0
    assert "results appended to results_ef.csv" in capsys.readouterr().out
    rows = (tmp_path / "results_ef.csv").read_text().splitlines()
    assert [r.split(",")[0] for r in rows[1:]] == [
        f"EarlyFusion_{k}" for k in SIM_TYPES + ("late", "early+late")]
    assert all(0 < float(r.split(",")[4]) <= 1 for r in rows[1:])   # MAP
