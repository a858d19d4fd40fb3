"""The port's structural families StrucFTM2D, StrucShingles and
StrucScattering, and the stages they share with StrucLaplacian, against
the JAX package on the CPU: stacked distances, the batched fused W (and
the port's own per-song path), the 2D-FFT shingles and their top-k, the
sparse Gram's compact form, device path and dispatch, the traced-length
resize, `benchmark()` and the CLI. Sizes follow `tests/test_struct.py`
(its 14-song corpus, wins_per_block=5, K=5, niters=5, PAD_LEN=128,
final_size=64, J=3, L=4, tempogram_win=96)."""

from tests import _torch_threads  # noqa: F401  (caps thread pools)

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from acoss_tpu.benchmarking.algorithms import StrucFTM2D as JaxStrucFTM2D
from acoss_tpu.benchmarking.algorithms import \
    StrucScattering as JaxStrucScattering
from acoss_tpu.benchmarking.algorithms import \
    StrucShingles as JaxStrucShingles
from acoss_tpu.benchmarking.algorithms import struct_common as jax_common
from acoss_tpu.benchmarking.harness import benchmark as jax_benchmark
from acoss_tpu.data import make_synthetic_dataset
from acoss_tpu.ops import crp as jax_crp
from acoss_tpu.ops import sparse_gram as jax_sparse_gram
from acoss_tpu.ops import structure as jax_structure
from acoss_tpu_torch import cli
from acoss_tpu_torch.benchmarking import harness
from acoss_tpu_torch.benchmarking.algorithms import (ALL_ALGORITHMS,
                                                     StrucFTM2D,
                                                     StrucScattering,
                                                     StrucShingles,
                                                     struct_common)
from acoss_tpu_torch.benchmarking.evaluation import (eval_statistics,
                                                     write_results_csv)
from acoss_tpu_torch.benchmarking.harness import benchmark, run_pairwise
from acoss_tpu_torch.data import FeatureSet
from acoss_tpu_torch.ops import crp, sparse_gram, structure

FUSE = dict(wins_per_block=5, K=5, niters=5, tempogram_win=96)
FAMILIES = {
    "StrucFTM2D": (StrucFTM2D, JaxStrucFTM2D, dict(FUSE, PAD_LEN=128)),
    "StrucShingles": (StrucShingles, JaxStrucShingles,
                      dict(FUSE, PAD_LEN=128)),
    "StrucScattering": (StrucScattering, JaxStrucScattering,
                        dict(FUSE, final_size=64, J=3, L=4)),
}


@pytest.fixture(scope="module")
def corpus():
    return make_synthetic_dataset(n_cliques=6, clique_size=2,
                                  n_distractors=2, seed=5)


def _port_fs(fs):
    return FeatureSet(fs.features, fs.lengths, fs.labels, fs.track_ids)


def _t(a):
    return torch.from_numpy(np.array(a))


@pytest.mark.parametrize("n,d,w", [(37, 13, 5), (64, 12, 20), (5, 3, 1)])
def test_stacked_distances_match_jax(n, d, w):
    """The window-sum stacked distances against the JAX package's, on the
    same front-padded features: the bounds of `test_struct.py`'s own
    check against the materialized embedding (atol 2e-5 Euclidean, 2e-6
    cosine). A batch of two gives each song's answer."""
    rng = np.random.default_rng(n + d + w)
    z = np.zeros((2, n + w - 1, d), np.float32)
    z[:, w - 1:] = rng.normal(size=(2, n, d))
    for ours, theirs, atol in (
            (structure.stacked_euclidean, jax_structure.stacked_euclidean,
             2e-5),
            (structure.stacked_cosine, jax_structure.stacked_cosine, 2e-6)):
        got = ours(_t(z), w).numpy()
        assert got.shape == (2, n, n)
        for b in range(2):
            want = np.asarray(theirs(jnp.asarray(z[b]), w))
            np.testing.assert_allclose(got[b], want, rtol=0, atol=atol)


def test_sliding_window_matches_jax():
    x = np.random.default_rng(0).normal(size=(11, 3)).astype(np.float32)
    for win in (1, 4):
        np.testing.assert_array_equal(
            crp.sliding_window(_t(x), win).numpy(),
            np.asarray(jax_crp.sliding_window(jnp.asarray(x), win)))
        np.testing.assert_array_equal(
            crp.sliding_window_padded(_t(x), win).numpy(),
            np.asarray(jax_crp.sliding_window_padded(jnp.asarray(x), win)))
    batch = np.stack([x, 2 * x])
    np.testing.assert_array_equal(crp.sliding_window(_t(batch), 4)[1],
                                  crp.sliding_window(_t(2 * x), 4))


def _chunk_inputs(rng, lengths, npad, win, dims=(13, 12, 24)):
    feats = []
    for d in dims:
        a = np.zeros((len(lengths), npad + win - 1, d), np.float32)
        for b, n in enumerate(lengths):
            a[b, win - 1:win - 1 + n] = rng.random((n, d))
        feats.append(a)
    return feats


def _assert_w_close(got, want):
    """fp32 tolerance, or, where a near-tie kNN rank flips a neighbour of
    the SNF truncation, the JAX package's own bound for its batched vs
    per-song W (`test_struct.py:49-65`): mean abs < 1e-4, max < 5% of
    max |W|."""
    assert got.shape == want.shape
    err = np.abs(got - want)
    assert err.mean() < 1e-4
    assert err.max() < 0.05 * max(np.abs(want).max(), 1e-9)


def test_fused_w_batch_matches_jax():
    """One chunk of four songs (one shorter than 2K + 1) through the
    batched fusion of both packages, from the same padded features."""
    rng = np.random.default_rng(3)
    lengths = np.array([60, 45, 9, 64], np.int32)
    Ks = np.array([struct_common.autotune_k(5, int(n)) for n in lengths],
                  np.int32)
    kinds = ("euclidean", "cosine", "euclidean")
    feats = _chunk_inputs(rng, lengths, 64, 5)
    got = structure.fused_w_batch([_t(f) for f in feats], lengths, Ks,
                                  kinds, 5, niters=5, k_static_max=5)
    want = np.asarray(jax_structure.fused_w_batch(
        tuple(jnp.asarray(f) for f in feats), jnp.asarray(lengths),
        jnp.asarray(Ks), kinds, 5, niters=5, k_static_max=5))
    assert got.dtype == torch.float32
    for b, n in enumerate(lengths):
        _assert_w_close(got[b, :n, :n].numpy(), want[b, :n, :n])
        # the padding: zero but for get_P's 0.5 on the diagonal
        pad = got[b].clone()
        pad[:n, :n] = 0
        assert torch.equal(pad, torch.diag(torch.diagonal(pad)))


def test_structural_fused_w_all_matches_jax_and_per_song(corpus):
    fs = _port_fs(corpus)
    got = struct_common.structural_fused_w_all(fs, **FUSE, batch_size=4,
                                               device="cpu")
    want = jax_common.structural_fused_w_all(corpus, **FUSE, batch_size=4)
    for i in range(corpus.n_songs):
        (Wg, ong, ng), (Wj, onj, nj) = got[i], want[i]
        assert ng == nj and Wg.dtype == np.float32
        np.testing.assert_array_equal(ong, onj)
        _assert_w_close(Wg, Wj)
    for i in (0, 5, 13):
        Wp, onp = struct_common.structural_fused_w(fs, i, **FUSE,
                                                   device="cpu")
        np.testing.assert_array_equal(onp, got[i][1])
        _assert_w_close(Wp, got[i][0])


def test_consume_gets_the_device_chunk(corpus):
    """`consume` gets every chunk's W as a tensor with the fixed batch
    width (a short chunk repeats its first song) and the songs it holds;
    only the real songs' outputs are kept, in song order."""
    seen = []

    def consume(W, lengths, onsets, songs):
        assert isinstance(W, torch.Tensor) and W.shape[0] == len(songs) == 4
        seen.append(list(songs))
        return [int(s) for s in songs]

    out = struct_common.structural_fused_w_all(
        _port_fs(corpus), **FUSE, batch_size=4, consume=consume,
        device="cpu")
    assert out == list(range(corpus.n_songs))
    assert sorted(s for c in seen for s in set(c)) == list(
        range(corpus.n_songs))


def _random_w(rng, lengths, npad):
    W = np.zeros((len(lengths), npad, npad), np.float32)
    for b, n in enumerate(lengths):
        W[b, :n, :n] = rng.random((n, n), dtype=np.float32)
        W[b, n:, n:] = 0.5          # dirty padding, as the fused W's
    return W


@pytest.mark.parametrize("do_fft", [True, False])
def test_shingle_topk_matches_jax(do_fft):
    """The kept sets may differ only at cutoff ties within 1e-5 (torch.fft
    rounds unlike XLA's FFT, and `topk` orders ties unlike `lax.top_k`);
    the values agree to 1e-5."""
    rng = np.random.default_rng(2)
    P, n_keep = 64, 320
    lengths = np.array([40, 55, 64, 70], np.int32)     # 70 > pad_len
    W = _random_w(rng, lengths, 80)
    gi, gv = structure.shingle_topk_batch(_t(W), lengths, P, n_keep, do_fft)
    wi, wv = (np.asarray(a) for a in jax_structure.shingle_topk_batch(
        jnp.asarray(W), jnp.asarray(lengths), P, n_keep, do_fft))
    assert gi.dtype == torch.int32 and gv.dtype == torch.float32
    assert gi.shape == wi.shape == (4, n_keep + structure.TIE_SLACK)
    gi, gv = gi.numpy(), gv.numpy()
    for b in range(4):
        got = dict(zip(gi[b][gi[b] >= 0].tolist(), gv[b][gi[b] >= 0]))
        want = dict(zip(wi[b][wi[b] >= 0].tolist(), wv[b][wi[b] >= 0]))
        assert len(got) >= n_keep and len(want) >= n_keep
        cutoff = np.sort(wv[b][wi[b] >= 0])[::-1][n_keep - 1]
        for j in set(got) ^ set(want):
            assert abs(got.get(j, want.get(j)) - cutoff) < 1e-5
        assert max(abs(got[j] - want[j]) for j in set(got) & set(want)) \
            < 1e-5


def test_shingle_topk_matches_host_top_shingle():
    """The batched shingle equals the per-song host pipeline (pad, fft,
    `sparse_top_shingle`) up to cutoff ties, as `test_struct.py` holds
    the JAX package's."""
    rng = np.random.default_rng(4)
    P, n_keep = 64, 320
    lengths = np.array([33, 64], np.int32)
    W = _random_w(rng, lengths, 64)
    gi, gv = (t.numpy() for t in structure.shingle_topk_batch(
        _t(W), lengths, P, n_keep, True))
    for b, n in enumerate(lengths):
        canvas = np.zeros((P, P), np.float32)
        canvas[:n, :n] = W[b, :n, :n]
        flat = np.abs(np.fft.fft2(canvas)).astype(np.float32).ravel()
        ix, v = struct_common.sparse_top_shingle(flat, n_keep)
        ref = dict(zip(ix.tolist(), v))
        got = dict(zip(gi[b][gi[b] >= 0].tolist(), gv[b][gi[b] >= 0]))
        cutoff = np.sort(v)[::-1][n_keep - 1]
        for j in set(ref) ^ set(got):
            assert abs(ref.get(j, got.get(j)) - cutoff) < 1e-5
        assert max(abs(ref[j] - got[j]) for j in set(ref) & set(got)) < 1e-5


@pytest.mark.parametrize("cls", [StrucFTM2D, StrucShingles])
def test_song_shingle_matches_chunk_stage(corpus, cls):
    """The per-song path (`_song_shingle`: the per-song fused W, the host
    canvas and `sparse_top_shingle`) against the chunk stage on the same
    W: kept sets equal up to cutoff ties within 1e-5, values within 1e-5
    (a float64 norm against a float32 one)."""
    algo = cls(**FUSE, PAD_LEN=128)
    fs = _port_fs(corpus)
    for i in (0, 9):
        ix, v = algo._song_shingle(fs, i, device="cpu")
        W, _ = struct_common.structural_fused_w(fs, i, **FUSE,
                                                fuse_features=("mfcc", "hpcp"),
                                                device="cpu")
        n = W.shape[0]
        (gi, gv), = algo.chunk_shingles(_t(W[None]), [n])
        g, w = dict(zip(gi.tolist(), gv)), dict(zip(ix.tolist(), v))
        cutoff = np.sort(v)[::-1][5 * 128 - 1]
        for j in set(g) ^ set(w):
            assert abs(g.get(j, w.get(j)) - cutoff) < 1e-5
        assert max(abs(g[j] - w[j]) for j in set(g) & set(w)) < 1e-5


def test_sparse_top_shingle_bit_equal():
    flat = np.random.default_rng(5).random(5000).astype(np.float32)
    flat[::7] = flat[3]                                 # ties
    for n_keep in (10, 700, 6000):
        for g, w in zip(struct_common.sparse_top_shingle(flat, n_keep),
                        jax_common.sparse_top_shingle(flat, n_keep)):
            assert g.dtype == w.dtype
            np.testing.assert_array_equal(g, w)


def test_autotune_k_equal():
    for K, n in ((-1, 2), (-1, 100), (-1, 5000), (10, 3)):
        assert struct_common.autotune_k(K, n) == jax_common.autotune_k(K, n)


def _random_shingles(rng, n, dim, nnz_lo, nnz_hi, shared_frac=0.7):
    """`tests/test_sparse_gram.py`'s generator: ragged shingles on a
    concentrated shared support plus a per-row random remainder."""
    shared = rng.choice(dim, size=max(nnz_hi, 8), replace=False)
    idx_list, val_list = [], []
    for _ in range(n):
        k = int(rng.integers(nnz_lo, nnz_hi + 1))
        k_sh = int(k * shared_frac)
        ix = np.unique(np.concatenate([
            rng.choice(shared, size=k_sh, replace=False),
            rng.choice(dim, size=k - k_sh, replace=False)]))
        idx_list.append(ix.astype(np.int64))
        val_list.append(rng.random(ix.size, dtype=np.float32) + 0.1)
    return idx_list, val_list


def test_compact_shingles_bit_equal():
    rng = np.random.default_rng(0)
    idx, val = _random_shingles(rng, 9, 3000, 5, 40)
    for g, w in zip(sparse_gram.compact_shingles(idx, val),
                    jax_sparse_gram.compact_shingles(idx, val)):
        assert np.asarray(g).dtype == np.asarray(w).dtype
        np.testing.assert_array_equal(g, w)


@pytest.mark.parametrize("n,dim,block", [(5, 200, 2048), (23, 4000, 2048),
                                         (37, 1000, 16)])
def test_sparse_gram_device_path_matches_host(n, dim, block):
    """The union Gram (forced, on the CPU tensor path) against the scipy
    path of both packages, rtol 1e-5; block 16 tiles 37 rows into three
    row blocks with a padded tail."""
    rng = np.random.default_rng(n)
    idx, val = _random_shingles(rng, n, dim, 10, 40)
    want = jax_sparse_gram.host_gram_scores(idx, val, dim)
    np.testing.assert_array_equal(
        sparse_gram.host_gram_scores(idx, val, dim), want)
    got = sparse_gram.sparse_gram_scores(idx, val, dim, force_device=True,
                                         max_row_block=block, device="cpu")
    assert got.dtype == np.float32 and got.shape == (n, n)
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=1e-5)


def test_sparse_gram_dispatch():
    """The JAX package's dispatch: a wide union or a small corpus takes
    the host path (identical to it); forced, the device path."""
    rng = np.random.default_rng(2)
    idx, val = _random_shingles(rng, 6, 5000, 10, 30, shared_frac=0.0)
    want = sparse_gram.host_gram_scores(idx, val, 5000)
    np.testing.assert_array_equal(sparse_gram.sparse_gram_scores(
        idx, val, 5000, union_max=4, host_max_n=0, device="cpu"), want)
    np.testing.assert_array_equal(sparse_gram.sparse_gram_scores(
        idx, val, 5000, device="cpu"), want)
    assert sparse_gram.sparse_gram_scores([], [], 10).shape == (0, 0)


def test_struc_full_scores_device_vs_host():
    rng = np.random.default_rng(3)
    algo = StrucShingles()
    algo.HOST_MAX_N = 0          # the device path at this tiny n
    dim = algo.PAD_LEN ** 2
    idx, val = _random_shingles(rng, 9, dim, 50, 120)
    desc = {"idx": idx, "val": val, "dim": dim}
    want = JaxStrucShingles().full_scores_host(desc)["main"]
    np.testing.assert_array_equal(algo.full_scores_host(desc)["main"], want)
    got = algo.full_scores(desc, device="cpu")["main"]
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=1e-5)


def test_run_pairwise_passes_ragged_leaves_through():
    """`run_pairwise` hands `full_scores` the non-array leaves (per-song
    lists, an int) untouched and the array leaves as fp32 tensors on the
    device (an int8 leaf with its scale companion dequantized), then
    zeroes the diagonal."""
    rng = np.random.default_rng(1)
    idx, val = _random_shingles(rng, 5, 300, 5, 20)
    seen = {}

    class Probe(StrucShingles):
        def full_scores(self, desc, device="cuda"):
            seen.update(desc)
            return super().full_scores(desc, device=device)

    q = np.array([[1, -2], [3, 4], [0, 0], [5, 6], [7, 8]], np.int8)
    desc = {"idx": idx, "val": val, "dim": 300, "extra": q,
            "extra@qscale": np.full(5, 0.5, np.float32)}
    D = run_pairwise(Probe(), desc, 5, device="cpu")["main"]
    assert seen["idx"] is idx and seen["val"] is val and seen["dim"] == 300
    assert seen["extra"].dtype == torch.float32
    np.testing.assert_array_equal(seen["extra"].numpy(), q * 0.5)
    assert "extra@qscale" not in seen
    want = sparse_gram.host_gram_scores(idx, val, 300)
    np.fill_diagonal(want, 0.0)
    np.testing.assert_array_equal(D, want)


def test_resize_dynamic_batch_matches_jax():
    """Per-song lengths (blur radius from the batch's worst case, sigma
    per song, reflection at the true edge) against the JAX package's,
    within 1e-6 of the largest value; and against the port's static
    `resize` of the cropped block."""
    from acoss_tpu_torch.ops.resize import resize

    rng = np.random.default_rng(6)
    lengths = np.array([150, 64, 97, 1], np.int32)
    W = _random_w(rng, lengths, 160)
    for out in (64, 32):
        got = structure.resize_dynamic_batch(_t(W), lengths, out).numpy()
        want = np.asarray(jax_structure.resize_dynamic_batch(
            jnp.asarray(W), jnp.asarray(lengths), out))
        assert got.shape == (4, out, out)
        np.testing.assert_allclose(got, want, rtol=0,
                                   atol=1e-6 * np.abs(want).max())
    n = 150
    got = structure.resize_dynamic_batch(_t(W[:1]), lengths[:1], 64,
                                         max_in=n).numpy()[0]
    ref = resize(_t(W[0, :n, :n]), (64, 64)).numpy()
    np.testing.assert_allclose(got, ref, rtol=0, atol=1e-5)


@pytest.mark.parametrize("family", list(FAMILIES))
def test_chunk_stage_on_jax_w_matches_jax(corpus, family, monkeypatch):
    """The stage after the fusion, on the JAX package's own fused W
    chunks (recorded while it extracts, padding songs included): the
    scattering descriptors within 2e-6 of the largest coefficient
    (`test_torch_scattering.py`'s bound for two libraries' complex64
    FFTs); the shingles with kept sets that differ only at cutoff ties
    within 1e-5, and values within 1e-5. The whole pipeline, fusion
    included, is held by `test_benchmark_matches_jax`."""
    import acoss_tpu.benchmarking.algorithms.struc_ftm2d as jax_ftm
    import acoss_tpu.benchmarking.algorithms.struc_scattering as jax_sc

    cls, jcls, kw = FAMILIES[family]
    chunks = []

    def recording(*args, consume, **kwargs):
        def rec(W, lengths, onsets):
            out = consume(W, lengths, onsets)
            chunks.append((np.asarray(W), np.asarray(lengths), out))
            return out
        return jax_common.structural_fused_w_all(*args, consume=rec,
                                                 **kwargs)

    monkeypatch.setattr(jax_sc if cls is StrucScattering else jax_ftm,
                        "structural_fused_w_all", recording)
    jcls(**kw).extract_descriptors(corpus)
    assert sum(len(W) for W, _, _ in chunks) >= corpus.n_songs
    algo = cls(**kw)
    for W, lengths, want in chunks:
        if family == "StrucScattering":
            got = algo.chunk_descriptors(_t(W), lengths)
            for g, w in zip(got, want, strict=True):
                assert g.dtype == np.float32 and g.shape == w.shape
                np.testing.assert_allclose(g, w, rtol=0,
                                           atol=2e-6 * np.abs(w).max())
            continue
        for (gi, gv), (wi, wv) in zip(algo.chunk_shingles(_t(W), lengths),
                                      want, strict=True):
            assert gi.dtype == np.int64 and gv.dtype == np.float32
            assert np.all(np.diff(gi) > 0)
            g, w = dict(zip(gi.tolist(), gv)), dict(zip(wi.tolist(), wv))
            cutoff = np.sort(wv)[::-1][5 * 128 - 1]
            for j in set(g) ^ set(w):
                assert abs(g.get(j, w.get(j)) - cutoff) < 1e-5
            assert max(abs(g[j] - w[j]) for j in set(g) & set(w)) < 1e-5


@pytest.mark.parametrize("family", list(FAMILIES))
def test_descriptors_shape_and_dtype(corpus, family):
    """The port's own descriptors: the JAX package's keys, dtypes and
    shapes (the values differ from its by the fused W's tolerance)."""
    cls, jcls, kw = FAMILIES[family]
    got = cls(**kw).extract_descriptors(_port_fs(corpus), device="cpu")
    want = jcls(**kw).extract_descriptors(corpus)
    assert sorted(got) == sorted(want)
    if family == "StrucScattering":
        assert got["shingle"].dtype == np.float32
        assert got["shingle"].shape == want["shingle"].shape
        return
    assert got["dim"] == want["dim"] == 128 * 128
    assert len(got["idx"]) == len(got["val"]) == corpus.n_songs
    for gi, gv in zip(got["idx"], got["val"]):
        assert gi.dtype == np.int64 and gv.dtype == np.float32
        assert gi.size == gv.size >= 5 * 128 and np.all(np.diff(gi) > 0)


@pytest.mark.parametrize("family", list(FAMILIES))
def test_benchmark_matches_jax(corpus, family, tmp_path):
    """MR, MRR, MDR, MAP and Top-K equal to the JAX package's, and the same
    CSV rows."""
    cls, jcls, kw = FAMILIES[family]
    times = {}
    got = benchmark(cls(**kw), _port_fs(corpus), device="cpu", times=times,
                    results_csv=str(tmp_path / "p.csv"))
    want = jax_benchmark(jcls(**kw), corpus,
                         results_csv=str(tmp_path / "j.csv"))
    assert {k: dataclasses.asdict(v) for k, v in got.items()} == \
        {k: dataclasses.asdict(v) for k, v in want.items()}
    assert (tmp_path / "p.csv").read_text() == \
        (tmp_path / "j.csv").read_text()
    assert got["main"].map > 0.9
    assert sorted(times) == ["eval", "extract", "sweep"]


@pytest.mark.parametrize("name", ["StrucFTM2D", "StrucShingles",
                                  "StrucScattering", "StrucLaplacian",
                                  "StructureLaplacian"])
def test_cli_struc_on_cpu(corpus, tmp_path, monkeypatch, capsys, name):
    """Every Struc class runs from the CLI on the CPU (at class defaults:
    PAD_LEN 2000, a 512^2 scattering, 50 k-means restarts), by NAME or by
    class name. StrucLaplacian's NAME, StructureLaplacian, names the class
    whose whole run is the StrucLaplacian case's, so the alias case stubs
    `benchmark` and checks what the CLI hands it and writes."""
    cls = ALL_ALGORITHMS.get(name) or next(
        c for c in ALL_ALGORITHMS.values() if c.__name__ == name)
    assert cls.__name__ == name or cls.NAME == name
    fs = corpus.subset(np.arange(2))
    fs.save(str(tmp_path / "synth.npz"))
    monkeypatch.chdir(tmp_path)
    if cls.__name__ != name:
        calls = []

        def stub(algo, feats, *, results_csv, device, **kw):
            assert type(algo) is cls and device == "cpu"
            assert list(feats.labels) == list(fs.labels)
            calls.append(results_csv)
            stats = {}
            for k in cls.SIMILARITY_TYPES:
                stats[k] = eval_statistics(np.eye(2), feats.labels)
                write_results_csv(results_csv, algo.NAME, k, stats[k])
            return stats

        monkeypatch.setattr(harness, "benchmark", stub)
    rc = cli.main(["benchmark", "-a", name, "-d", "synth.npz", "-s", "st",
                   "--device", "cpu", "--no-checkpoint"])
    assert rc == 0
    assert "results appended to results_st.csv" in capsys.readouterr().out
    rows = (tmp_path / "results_st.csv").read_text().splitlines()
    assert [r.split(",")[0] for r in rows[1:]] == [
        f"{cls.NAME}_{k}" for k in cls.SIMILARITY_TYPES]
    assert all(0 <= float(r.split(",")[4]) <= 1 for r in rows[1:])
    if cls.__name__ != name:
        assert calls == ["results_st.csv"]


def test_registry_holds_all_twelve_classes():
    from acoss_tpu.benchmarking.algorithms import \
        ALL_ALGORITHMS as JAX_ALGORITHMS

    assert sorted(ALL_ALGORITHMS) == sorted(JAX_ALGORITHMS)
    for name, cls in ALL_ALGORITHMS.items():
        assert cls.__name__ == JAX_ALGORITHMS[name].__name__
