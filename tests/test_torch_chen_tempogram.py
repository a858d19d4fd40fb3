"""The port's ChenFusion and TGAlg (the non-mutual row-kNN families that
end in qmax / dmax) and the tempogram they read, against the JAX package
on the CPU, on the JAX package's e2e corpus at its settings
(downsample_fac=4; ChenFusion late_K=10, late_niters=5; TGAlg
win_length=96): `stack_memory`, the descriptors, the tile under both of
the JAX package's aligner paths (XLA and the Pallas kernels in interpret
mode), the late SNF, `benchmark()` and the CLI."""

from tests import _torch_threads  # noqa: F401  (caps thread pools)

import dataclasses

import jax
import numpy as np
import pytest
import torch

from acoss_tpu.benchmarking.algorithms import ChenFusion as JaxChenFusion
from acoss_tpu.benchmarking.algorithms import TGAlg as JaxTGAlg
from acoss_tpu.benchmarking.harness import benchmark as jax_benchmark
from acoss_tpu.data import make_synthetic_dataset
from acoss_tpu.features import rhythm as jax_rhythm
from acoss_tpu.ops import alignment as jax_alignment
from acoss_tpu.ops import segment as jax_segment
from acoss_tpu_torch import cli
from acoss_tpu_torch.benchmarking.algorithms import (ALL_ALGORITHMS,
                                                     ChenFusion, TGAlg)
from acoss_tpu_torch.benchmarking.harness import benchmark
from acoss_tpu_torch.convert import descriptors_from_numpy
from acoss_tpu_torch.data import FeatureSet
from acoss_tpu_torch.features import rhythm
from acoss_tpu_torch.ops import segment

CHEN_KW = dict(downsample_fac=4, late_K=10, late_niters=5)
TG_KW = dict(downsample_fac=4, win_length=96)


@pytest.fixture(scope="module")
def corpus():
    return make_synthetic_dataset(n_cliques=8, clique_size=2,
                                  n_distractors=4, seed=1)


def _port_fs(fs):
    return FeatureSet(fs.features, fs.lengths, fs.labels, fs.track_ids)


def _jax_tile(algo, desc, rows, cols, impl):
    prev = jax_alignment.set_alignment_impl(impl)
    try:
        out = algo.tile_scores(
            jax.device_put({k: v[rows] for k, v in desc.items()}),
            jax.device_put({k: v[cols] for k, v in desc.items()}))
        return {k: np.asarray(v) for k, v in out.items()}
    finally:
        jax_alignment.set_alignment_impl(prev)


def _assert_same_stats(got, want):
    assert list(got) == list(want)
    assert {k: dataclasses.asdict(v) for k, v in got.items()} == \
        {k: dataclasses.asdict(v) for k, v in want.items()}


@pytest.mark.parametrize("n_steps,delay", [(1, 9), (3, 2), (4, 40)])
def test_stack_memory_bit_equal(n_steps, delay):
    X = np.random.default_rng(n_steps).random((37, 12)).astype(np.float32)
    got = segment.stack_memory(X, n_steps, delay)
    want = jax_segment.stack_memory(X, n_steps, delay)
    assert got.dtype == want.dtype and got.shape == (37, 12 * n_steps)
    np.testing.assert_array_equal(got, want)


def test_chen_fusion_descriptors_bit_equal(corpus):
    for kw in (CHEN_KW, dict(CHEN_KW, stack_n_steps=None, tau=2)):
        got = ChenFusion(**kw).extract_descriptors(_port_fs(corpus),
                                                   device="cpu")
        want = JaxChenFusion(**kw).extract_descriptors(corpus)
        assert sorted(got) == sorted(want) == ["gchroma", "length",
                                               "stacked"]
        for k in want:
            assert got[k].dtype == want[k].dtype, k
            np.testing.assert_array_equal(got[k], want[k], err_msg=k)


@pytest.mark.parametrize("impl", ["xla", "pallas_interpret"])
def test_chen_fusion_tile_bit_equal(corpus, impl):
    """The batched tile on the JAX package's descriptors gives its raw
    qmax / dmax exactly (binary CRPs, small-integer scores), through the
    `*_best` aligners and their plain versions. Two songs are cut to 5
    and 3 frames: round(kappa * 5) == 0 neighbours, an all-zero CRP that
    scores 0."""
    desc = JaxChenFusion(**CHEN_KW).extract_descriptors(corpus)
    desc["length"] = desc["length"].copy()
    desc["length"][[9, 14]] = [5, 3]
    rows, cols = slice(0, 8), slice(8, 16)
    want = _jax_tile(JaxChenFusion(**CHEN_KW), desc, rows, cols, impl)
    d = descriptors_from_numpy(desc, "cpu")
    row = {k: v[rows] for k, v in d.items()}
    col = {k: v[cols] for k, v in d.items()}
    B, _, _ = ChenFusion(**CHEN_KW).tile_crps(row, col)
    assert B.dtype == torch.uint8 and int(B[:, [1, 6]].sum()) == 0
    for plain in (False, True):
        got = ChenFusion(**CHEN_KW).tile_scores(row, col, plain=plain)
        assert list(got) == ["qmax", "dmax"]
        for k in want:
            np.testing.assert_array_equal(got[k].numpy(), want[k],
                                          err_msg=f"{k} {plain}")
    assert (want["qmax"][:, [1, 6]] == 0).all()
    assert (np.delete(want["qmax"], [1, 6], axis=1) > 1).all()


def test_chen_fusion_post_process_matches_jax():
    """normalize_by_length (host numpy, bit-equal), then late SNF of the
    two normalized matrices: rtol 1e-4, as the SNF tests state."""
    rng = np.random.default_rng(7)
    n = 14
    Ds = {}
    for k in ("qmax", "dmax"):
        D = rng.random((n, n)).astype(np.float32) * 40 + 1
        Ds[k] = np.tril(D, -1) + np.tril(D, -1).T
    desc = {"length": rng.integers(30, 90, n).astype(np.int32)}
    got = ChenFusion(**CHEN_KW).post_process(Ds, desc, device="cpu")
    want = JaxChenFusion(**CHEN_KW).post_process(Ds, desc)
    assert list(got) == list(want) == ["qmax", "dmax", "Late"]
    for k in ("qmax", "dmax"):
        np.testing.assert_array_equal(got[k], want[k])
    assert got["Late"].dtype == np.float32
    np.testing.assert_allclose(got["Late"], want["Late"], rtol=1e-4,
                               atol=1e-7)


def test_chen_fusion_benchmark_matches_jax(corpus, tmp_path):
    assert ALL_ALGORITHMS["ChenFusion"] is ChenFusion
    got = benchmark(ChenFusion(**CHEN_KW), _port_fs(corpus), device="cpu",
                    results_csv=str(tmp_path / "p.csv"))
    want = jax_benchmark(JaxChenFusion(**CHEN_KW), corpus,
                         results_csv=str(tmp_path / "j.csv"))
    _assert_same_stats(got, want)
    assert (tmp_path / "p.csv").read_text() == \
        (tmp_path / "j.csv").read_text()
    assert all(got[k].map > 0.5 for k in ("qmax", "dmax", "Late"))


def _envelopes():
    rng = np.random.default_rng(8)
    envs = [rng.random(n).astype(np.float32) for n in (300, 411, 97, 50,
                                                        1000, 1)]
    envs[3][:] = 0.0                                # a silent envelope
    bounds = [np.arange(0, e.size, 4) for e in envs]
    bounds[2] = np.array([5, 30, 31, 96, 200])      # ragged, past the end
    return envs, bounds


def test_tempogram_matches_jax_and_ignores_padding():
    """rtol 1e-5 of each song's largest value (FFTs of two libraries), and
    the output does not depend on how the songs are batched (padded):
    equal to float32 rounding, 1e-6 of the song's largest value (the FFT
    library groups the rows of a batch differently for different batch
    sizes, a few ulps)."""
    envs, bounds = _envelopes()
    want = jax_rhythm.tempogram_aggregated_batch(envs, bounds, 96)
    got = rhythm.tempogram_aggregated_batch(envs, bounds, 96, device="cpu")
    for g, w in zip(got, want):
        assert g.shape == w.shape and g.dtype == w.dtype == np.float64
        np.testing.assert_allclose(g, w, rtol=0,
                                   atol=1e-5 * max(np.abs(w).max(), 1e-30))
    alone = [rhythm.tempogram_aggregated_batch([e], [b], 96, device="cpu")[0]
             for e, b in zip(envs, bounds)]
    two = rhythm.tempogram_aggregated_batch(envs, bounds, 96, device="cpu",
                                            batch_size=2)
    for g, a, t in zip(got, alone, two):
        tol = 1e-6 * max(np.abs(g).max(), 1e-30)
        np.testing.assert_allclose(a, g, rtol=0, atol=tol)
        np.testing.assert_allclose(t, g, rtol=0, atol=tol)


def test_tgalg_descriptors_match_jax(corpus):
    got = TGAlg(**TG_KW).extract_descriptors(_port_fs(corpus), device="cpu")
    want = JaxTGAlg(**TG_KW).extract_descriptors(corpus)
    assert sorted(got) == sorted(want)
    for k in want:
        assert got[k].dtype == want[k].dtype and got[k].shape == \
            want[k].shape, k
    for k in ("rnn_len", "sflux_len"):
        np.testing.assert_array_equal(got[k], want[k])
    for k in ("rnn", "sflux"):
        for g, w in zip(got[k], want[k]):
            np.testing.assert_allclose(g, w, rtol=0,
                                       atol=1e-5 * np.abs(w).max())


@pytest.mark.parametrize("impl", ["xla", "pallas_interpret"])
def test_tgalg_tile_bit_equal(corpus, impl):
    """The tile on the JAX package's descriptors: both channels' CRPs in
    one qmax and one dmax call, divided by (M + N), exactly the JAX
    package's scores. A song cut to 5 rows has round(kappa * 5) == 0
    neighbours a row as the column song (an all-zero CRP, score 0), and
    a 5-row CRP with some neighbours a row as the row song."""
    desc = JaxTGAlg(**TG_KW).extract_descriptors(corpus)
    desc["rnn_len"] = desc["rnn_len"].copy()
    desc["rnn_len"][10] = 5
    rows, cols = slice(8, 16), slice(4, 12)
    want = _jax_tile(JaxTGAlg(**TG_KW), desc, rows, cols, impl)
    d = descriptors_from_numpy(desc, "cpu")
    row = {k: v[rows] for k, v in d.items()}
    col = {k: v[cols] for k, v in d.items()}
    for plain in (False, True):
        got = TGAlg(**TG_KW).tile_scores(row, col, plain=plain)
        assert list(got) == list(TGAlg.SIMILARITY_TYPES)
        for k in want:
            np.testing.assert_array_equal(got[k].numpy(), want[k],
                                          err_msg=f"{k} {plain}")
    assert (want["tempogram_rnn_qmax"][:, 6] == 0).all()
    assert (np.delete(want["tempogram_rnn_qmax"][2], 6) > 0).all()
    assert (want["tempogram_sflux_qmax"] > 0).all()


def test_tgalg_benchmark_matches_jax(corpus, tmp_path):
    assert ALL_ALGORITHMS["TGAlg"] is TGAlg
    got = benchmark(TGAlg(**TG_KW), _port_fs(corpus), device="cpu",
                    results_csv=str(tmp_path / "p.csv"))
    want = jax_benchmark(JaxTGAlg(**TG_KW), corpus,
                         results_csv=str(tmp_path / "j.csv"))
    _assert_same_stats(got, want)
    assert (tmp_path / "p.csv").read_text() == \
        (tmp_path / "j.csv").read_text()
    assert got["tempogram_sflux_qmax"].map > 0.15


def test_cli_tgalg_on_cpu(corpus, tmp_path, monkeypatch, capsys):
    """TGAlg takes no `chroma_type`: the CLI must not pass it (it did,
    and the constructor raised TypeError)."""
    corpus.save(str(tmp_path / "synth.npz"))
    monkeypatch.chdir(tmp_path)
    rc = cli.main(["benchmark", "-a", "TGAlg", "-d", "synth.npz", "-s",
                   "tg", "-c", "hpcp", "--device", "cpu", "--cachedir",
                   "ck"])
    assert rc == 0
    assert "results appended to results_tg.csv" in capsys.readouterr().out
    rows = (tmp_path / "results_tg.csv").read_text().splitlines()
    assert [r.split(",")[0] for r in rows[1:]] == [
        f"TGAlg_{k}" for k in TGAlg.SIMILARITY_TYPES]
    assert all(0 < float(r.split(",")[4]) <= 1 for r in rows[1:])
    assert (tmp_path / "ck" / "TGAlg_tg_ckpt.npz").exists()
