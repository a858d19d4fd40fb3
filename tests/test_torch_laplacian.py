"""The port's StrucLaplacian and its stages against the JAX package on the
CPU: the Laplacian eigenvectors, the time median filter, the masked
k-means, the profile stage (eigenvectors -> k-means -> meet matrix ->
SVD), the pair tile (bit for bit on the JAX package's descriptors), the
host copies (curvature, meet matrix, sequential clustering) and
`benchmark()` on `tests/test_struct.py`'s 14-song corpus (K=5, niters=5,
neigs=6, m=6, tempogram_win=96).

The k-means draws differ by design: the JAX package draws with
`jax.random`, the port from per-(seed, song, k) `torch.Generator`s. So
the stages are held where they are deterministic, and the end-to-end MAP
within a bound set from the JAX package's own spread over k-means keys.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from acoss_tpu.benchmarking.algorithms import \
    StrucLaplacian as JaxStrucLaplacian
from acoss_tpu.benchmarking.algorithms import struc_laplacian as jax_sl
from acoss_tpu.benchmarking.harness import benchmark as jax_benchmark
from acoss_tpu.benchmarking.harness import run_pairwise as jax_run_pairwise
from acoss_tpu.data import make_synthetic_dataset
from acoss_tpu.ops import laplacian as jax_laplacian
from acoss_tpu.ops import structure as jax_structure
from acoss_tpu_torch.benchmarking.algorithms import StrucLaplacian
from acoss_tpu_torch.benchmarking.algorithms import struc_laplacian as port_sl
from acoss_tpu_torch.benchmarking.harness import benchmark, run_pairwise
from acoss_tpu_torch.convert import descriptors_from_numpy
from acoss_tpu_torch.data import FeatureSet
from acoss_tpu_torch.ops import laplacian, structure

KW = dict(wins_per_block=5, K=5, niters=5, neigs=6, m=6, tempogram_win=96)


@pytest.fixture(scope="module")
def corpus():
    return make_synthetic_dataset(n_cliques=6, clique_size=2,
                                  n_distractors=2, seed=5)


def _port_fs(fs):
    return FeatureSet(fs.features, fs.lengths, fs.labels, fs.track_ids)


def _t(a):
    return torch.from_numpy(np.array(a))


def _separated_w(rng, n):
    """A symmetric positive affinity whose Laplacians have well-separated
    eigenvalues (a random dense W)."""
    A = rng.random((n, n)).astype(np.float32)
    return (A + A.T) / 2


def _same_up_to_sign(got, want, atol):
    s = np.sign(np.sum(got * want, axis=0))
    s[s == 0] = 1
    np.testing.assert_allclose(got * s, want, rtol=0, atol=atol)


@pytest.mark.parametrize("name", ["unweighted_laplacian_eigs",
                                  "symmetric_laplacian_eigs",
                                  "random_walk_laplacian_eigs"])
def test_laplacian_eigs_match_jax_up_to_sign(name):
    rng = np.random.default_rng(0)
    W = _separated_w(rng, 24)
    want = np.asarray(getattr(jax_laplacian, name)(jnp.asarray(W)))
    got = getattr(laplacian, name)(_t(W))
    assert got.dtype == torch.float32
    _same_up_to_sign(got.numpy(), want, 1e-4)
    # a batch gives each matrix's eigenvectors
    both = getattr(laplacian, name)(_t(np.stack([W, 2 * W]))).numpy()
    _same_up_to_sign(both[0], got.numpy(), 1e-5)


def test_padded_eigs_match_jax_and_ignore_padding():
    """The leading eigenvectors of each padded W's valid block, equal up
    to each column's sign to the JAX package's (atol 1e-4), zero on the
    padded rows whatever the padding holds."""
    rng = np.random.default_rng(1)
    npad, lengths = 32, np.array([32, 20, 27], np.int64)
    W = np.stack([_separated_w(rng, npad) for _ in lengths])
    for b, n in enumerate(lengths):
        W[b, n:, :] = 0.5
        W[b, :, n:] = 0.5
    got = structure.rw_laplacian_eigs_padded(_t(W), _t(lengths)).numpy()
    for b, n in enumerate(lengths):
        want = np.asarray(jax_structure.rw_laplacian_eigs_padded(
            jnp.asarray(W[b]), int(n)))
        _same_up_to_sign(got[b, :, :n], want[:, :n], 1e-4)
        assert not got[b, n:, :n].any()
        ref = laplacian.random_walk_laplacian_eigs(_t(W[b, :n, :n])).numpy()
        _same_up_to_sign(got[b, :n, :n], ref, 1e-4)


def test_median_filter_time_bit_equal():
    rng = np.random.default_rng(2)
    x = rng.normal(size=(3, 40, 5)).astype(np.float32)
    lengths = np.array([40, 23, 1], np.int64)
    got = structure._median_filter_time(_t(x), _t(lengths), 9).numpy()
    for b, n in enumerate(lengths):
        want = np.asarray(jax_structure._median_filter_time(
            jnp.asarray(x[b]), int(n), 9))
        np.testing.assert_array_equal(got[b], want)


def _planted(rng, k, npad, n):
    truth = rng.integers(0, k, size=n)
    centers = rng.normal(size=(k, 3)) * 20
    x = np.zeros((npad, 3), np.float32)
    x[:n] = centers[truth] + 0.1 * rng.normal(size=(n, 3))
    x[n:] = 1e3                          # masked rows far from every centre
    return x, truth


def test_kmeans_recovers_planted_clusters_like_jax():
    """Well-separated clusters: the port's masked k-means gives the
    planted partition, the JAX package's (`test_struct.py:129-148`) the
    same one, up to label permutation; masked rows move no centre."""
    rng = np.random.default_rng(1)
    k, npad, n = 4, 96, 80
    xs, truths = zip(*(_planted(rng, k, npad, n) for _ in range(3)))
    mask = np.arange(npad) < n
    u = structure.kmeans_uniforms(0, [0, 1, 2], k, 10)
    got = structure._kmeans_labels(_t(np.stack(xs)),
                                   _t(np.stack([mask] * 3)), k, u, 25)
    assert got.shape == (3, npad)
    for b in range(3):
        want = np.asarray(jax_structure._kmeans_labels(
            xs[b], mask, k, jax.random.PRNGKey(b), n_init=10, iters=25))
        lab = got[b, :n].numpy()
        for c in range(k):
            assert len(set(lab[truths[b] == c].tolist())) == 1
            assert len(set(want[:n][truths[b] == c].tolist())) == 1
        assert len(set(lab.tolist())) == k


def test_kmeans_uniforms_per_song():
    """A song's draws depend on (seed, song, k) only: not on its chunk,
    and another seed, song or k draws others."""
    a = structure.kmeans_uniforms(0, [3, 7], 4, 5)
    assert a.shape == (2, 5, 4) and a.dtype == torch.float64
    assert torch.equal(structure.kmeans_uniforms(0, [7], 4, 5)[0], a[1])
    for other in (structure.kmeans_uniforms(1, [3], 4, 5)[0],
                  structure.kmeans_uniforms(0, [4], 4, 5)[0],
                  structure.kmeans_uniforms(0, [3], 5, 5)[0, :, :4]):
        assert not torch.equal(other, a[0])


def test_draw_never_picks_a_zero_weight():
    p = torch.tensor([[0.0, 2.0, 0.0, 1.0, 0.0], [0.0] * 5])
    for u in (0.0, 0.5, 0.6667, 1 - 2 ** -53):
        i = structure._draw(p, torch.tensor([u, u], dtype=torch.float64))
        assert int(i[0]) in (1, 3)
        assert 0 <= int(i[1]) < 5       # a zero row draws by u alone
    assert int(structure._draw(p[:1], torch.tensor([0.7],
                                                   dtype=torch.float64))) == 3


def _block_chunk(sizes_list, npad):
    """Songs whose W is three blocks of consecutive beats, blocks A and B
    closer to each other than to C: every k-means restart at k = 2 gives
    {A + B, C} and at k = 3 {A, B, C}. Beats every 0.5 s from 1 s."""
    B = len(sizes_list)
    W = np.zeros((B, npad, npad), np.float32)
    times = np.full((B, npad), 1e18, np.float32)
    lengths = np.zeros(B, np.int32)
    for b, sizes in enumerate(sizes_list):
        lab = np.repeat(np.arange(3), sizes)
        n = lab.size
        aff = np.array([[1.0, 0.05, 1e-4], [0.05, 1.0, 1e-4],
                        [1e-4, 1e-4, 1.0]], np.float32)
        W[b, :n, :n] = aff[lab[:, None], lab[None, :]]
        W[b, n:, n:] = 0.5                                 # dirty padding
        times[b, :n] = 1.0 + 0.5 * np.arange(n)
        lengths[b] = n
    return W, lengths, times


def test_laplacian_profile_batch_matches_jax():
    """On block-structured W (deterministic clusterings), the SVD curves'
    velocity profiles agree with the JAX package's to atol 1e-4, and the
    meet grids have the same size; songs are batched by the port, vmapped
    by the JAX package."""
    W, lengths, times = _block_chunk([(20, 13, 17), (9, 25, 11),
                                      (30, 8, 14)], 64)
    neigs, meet_pad = 3, 192
    X, nmeet = structure.laplacian_profile_batch(_t(W), lengths, times,
                                                 neigs, meet_pad)
    Xj, nj = jax_structure.laplacian_profile_batch(
        jnp.asarray(W), jnp.asarray(lengths), jnp.asarray(times), neigs,
        meet_pad)
    Xj, nj = np.asarray(Xj), np.asarray(nj)
    np.testing.assert_array_equal(nmeet.numpy(), nj)
    algo = StrucLaplacian(neigs=neigs, m=4)
    for b in range(len(lengths)):
        n = int(nj[b])
        got = algo._profile_from_curve(X[b, :n].numpy().astype(np.float64))
        want = algo._profile_from_curve(Xj[b, :n].astype(np.float64))
        assert got.shape == want.shape == (n - 3, 4)
        assert want.max() > 0.01                  # block edges move the curve
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-4)


def test_meet_pad_sizing_is_jax():
    """The meet-grid capacity of a chunk (a late first beat needs nmeet
    well above n) equals the JAX package's sizing (its `consume`,
    `struc_laplacian.py:102-116`)."""
    onsets = [np.arange(10, 400, 3), np.arange(2000, 2300, 4),
              np.array([5]), np.arange(0, 600, 2)]
    for npad in (128, 384):
        need = npad + 128
        for o in onsets:
            t = o.astype(np.float64) * jax_sl.HOP_LENGTH / jax_sl.SR
            if len(o) >= 2:
                fs_ = max((t[-1] - t[0]) / (len(o) - 1), 1e-4)
                need = max(need, int(round(t[-1] / fs_)) + 8)
        from acoss_tpu_torch.benchmarking.algorithms.struc_laplacian import \
            meet_pad_for

        assert meet_pad_for(npad, onsets) == -(-need // 64) * 64


def _tile_matrices(algo_port, algo_jax, desc, n):
    got = run_pairwise(algo_port, desc, n, device="cpu")
    want = jax_run_pairwise(algo_jax, desc, n)
    return got, want


def test_tile_bit_equal_on_jax_descriptors(corpus, monkeypatch):
    """The pair scores (profile CSM -> non-mutual row kNN -> qmax, dmax
    over M + N) from the JAX package's descriptors equal its own bit for
    bit, and so do they from the port's descriptors. The JAX package's
    descriptors are made with its batch's beat count corrected
    (`_beats_from_times`): as it is, most of its profiles are float dust
    (~1e-8), whose CSMs the two libraries' matmuls round apart by up to
    3.7e-9, which flips kNN cells of 4 of the 196 pairs."""
    algo, jalgo = StrucLaplacian(**KW), JaxStrucLaplacian(**KW)
    n = corpus.n_songs
    monkeypatch.setattr(jax_sl, "laplacian_profile_batch",
                        _beats_from_times(
                            jax_structure.laplacian_profile_batch))
    for desc in (jalgo.extract_descriptors(corpus),
                 algo.extract_descriptors(_port_fs(corpus), device="cpu")):
        assert min(np.abs(p[:m]).max()
                   for p, m in zip(desc["profile"], desc["length"])) > 1e-3
        got, want = _tile_matrices(algo, jalgo, desc, n)
        for k in algo.SIMILARITY_TYPES:
            assert got[k].dtype == np.float32
            np.testing.assert_array_equal(got[k], np.asarray(want[k]))
    # a tile's plain versions are the same functions on the CPU
    dd = descriptors_from_numpy(desc, "cpu")
    row = {k: v[8:14] for k, v in dd.items()}
    col = {k: v[0:8] for k, v in dd.items()}
    a, b = algo.tile_scores(row, col), algo.tile_scores(row, col, plain=True)
    for k in a:
        assert torch.equal(a[k], b[k]) and a[k].shape == (6, 8)


def _beats_from_times(lap_batch):
    """The JAX package's `laplacian_profile_batch` called with each song's
    beat count, the number of its beat times (its caller passes the fused
    W's row count, one more: a fault of the JAX package, see the
    module's MAP test)."""
    def fixed(Wb, lengths, times, *args, **kwargs):
        beats = np.sum(np.asarray(times) < 1e17, axis=1)
        return lap_batch(Wb, np.minimum(np.asarray(lengths), beats)
                         .astype(np.int32), times, *args, **kwargs)
    return fixed


def test_jax_package_batch_reads_a_padded_time(corpus):
    """Documents the JAX package's fault that the port does not keep:
    its batched StrucLaplacian passes the fused W's row count (one more
    than the song's beats) as the beat count, so the meet grid's end time
    is the 1e18 padding and most songs' SVD curves are constant: their
    profiles are float dust (< 1e-6), and the port's are not."""
    jd = JaxStrucLaplacian(**KW).extract_descriptors(corpus)
    pd = StrucLaplacian(**KW).extract_descriptors(_port_fs(corpus),
                                                  device="cpu")
    dust = [np.abs(p[:n]).max() < 1e-6
            for p, n in zip(jd["profile"], jd["length"])]
    assert sum(dust) > corpus.n_songs // 2
    assert all(np.abs(p[:n]).max() > 1e-3
               for p, n in zip(pd["profile"], pd["length"]))


def test_benchmark_map_within_the_jax_key_spread(corpus, monkeypatch):
    """Each channel's MAP, averaged over k-means seeds 0-4, against the
    JAX package's (with the beat count of its batch corrected, as the
    port computes it) averaged over PRNG keys 0-4. The bound, 0.125, is
    the JAX package's own MAP range over keys 0-9 on this corpus (qmax
    0.668-0.753, dmax 0.617-0.739); the JAX package as it is scores
    qmax 0.594 and dmax 0.442 (from dust profiles)."""
    monkeypatch.setattr(jax_sl, "laplacian_profile_batch",
                        _beats_from_times(
                            jax_structure.laplacian_profile_batch))
    real_key = jax.random.PRNGKey
    types = StrucLaplacian.SIMILARITY_TYPES
    jax_maps, port_maps = [], []
    try:
        for seed in range(5):
            monkeypatch.setattr(jax.random, "PRNGKey",
                                lambda s, _sh=seed: real_key(s + _sh))
            jax_structure.laplacian_profile_batch.clear_cache()
            want = jax_benchmark(JaxStrucLaplacian(**KW), corpus)
            jax_maps.append([want[k].map for k in types])
            monkeypatch.setattr(port_sl, "KMEANS_SEED", seed)
            got = benchmark(StrucLaplacian(**KW), _port_fs(corpus),
                            device="cpu")
            port_maps.append([got[k].map for k in types])
            if seed == 0:
                assert sorted(got) == sorted(want)
                assert {f.name for f in dataclasses.fields(got[types[0]])} \
                    == {f.name for f in dataclasses.fields(want[types[0]])}
    finally:
        monkeypatch.setattr(jax.random, "PRNGKey", real_key)
        jax_structure.laplacian_profile_batch.clear_cache()
    diff = np.abs(np.mean(port_maps, 0) - np.mean(jax_maps, 0))
    assert (diff < 0.125).all(), (port_maps, jax_maps)
    assert np.min(port_maps) > 0.4              # chance is ~1/13


def test_host_copies_equal_jax():
    """`meet_matrix` and `spectral_cluster_sequential` (sklearn) are the
    JAX package's host functions: equal outputs on the same inputs."""
    pytest.importorskip("sklearn")
    rng = np.random.default_rng(4)
    v = np.repeat(rng.normal(size=(4, 5)) * 3, [9, 12, 7, 10], axis=0) \
        + 0.01 * rng.normal(size=(38, 5))
    times = 0.5 + 0.4 * np.arange(38)
    levels = []
    for k in (2, 3, 4):
        got = laplacian.spectral_cluster_sequential(v, k, times)
        want = jax_laplacian.spectral_cluster_sequential(v, k, times)
        np.testing.assert_array_equal(got["labels"], want["labels"])
        np.testing.assert_array_equal(got["intervals_hier"],
                                      want["intervals_hier"])
        assert got["labels_hier"] == want["labels_hier"]
        levels.append(got)
    args = ([r["intervals_hier"] for r in levels],
            [r["labels_hier"] for r in levels], 0.4)
    np.testing.assert_array_equal(laplacian.meet_matrix(*args),
                                  jax_laplacian.meet_matrix(*args))


def test_per_song_profile_runs(corpus):
    """The per-song path (sklearn's KMeans, the host meet matrix and SVD)
    gives a finite profile of the batched path's width."""
    pytest.importorskip("sklearn")
    algo = StrucLaplacian(**KW)
    p = algo._song_profile(_port_fs(corpus), 2, device="cpu")
    assert p.ndim == 2 and p.shape[1] == KW["m"] and p.shape[0] > 10
    assert np.isfinite(p).all() and p.max() > 1e-3
