"""The port's Serra09 slice end to end against the JAX package on the CPU:
descriptor extraction, the tile sweep, the kernel path's composition (with
every kernel's plain version) and the retrieval metrics, on a planted-clique
corpus whose songs are long enough (30 s base duration) that the CRPs are
not vacuous."""

from tests import _torch_threads  # noqa: F401  (caps thread pools)

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from acoss_tpu.benchmarking.algorithms import Serra09 as JaxSerra09
from acoss_tpu.benchmarking.harness import benchmark as jax_benchmark
from acoss_tpu.benchmarking.harness import run_pairwise as jax_run_pairwise
from acoss_tpu.data import make_synthetic_dataset
from acoss_tpu.ops import alignment as jax_alignment
from acoss_tpu.ops import crp as jax_crp
from acoss_tpu_torch import cli
from acoss_tpu_torch.benchmarking.algorithms import Serra09
from acoss_tpu_torch.benchmarking.evaluation import eval_statistics
from acoss_tpu_torch.benchmarking.harness import benchmark, run_pairwise
from acoss_tpu_torch.convert import descriptors_from_numpy
from acoss_tpu_torch.data import FeatureSet
from acoss_tpu_torch.ops import serra09_cuda

SIM_TYPES = ("chroma_qmax", "chroma_dmax", "mfcc_qmax", "mfcc_dmax")


@pytest.fixture(scope="module")
def corpus():
    fs = make_synthetic_dataset(n_cliques=6, clique_size=2, seed=1,
                                base_duration=30.0)
    desc = JaxSerra09().extract_descriptors(fs)
    return fs, desc, jax_run_pairwise(JaxSerra09(), desc, fs.n_songs)


def _assert_same_scores(got, want):
    assert sorted(got) == sorted(want) == sorted(SIM_TYPES)
    for k in SIM_TYPES:
        assert got[k].dtype == np.float32
        np.testing.assert_allclose(got[k], want[k], rtol=0, atol=1e-6,
                                   err_msg=k)


def _stats(Ds, labels):
    return {k: dataclasses.asdict(eval_statistics(D, labels))
            for k, D in Ds.items()}


def test_descriptors_match_jax(corpus):
    fs, desc, _ = corpus
    got = Serra09().extract_descriptors(
        FeatureSet(fs.features, fs.lengths, fs.labels, fs.track_ids),
        device="cpu")
    assert sorted(got) == sorted(desc)
    for k in desc:
        assert got[k].dtype == desc[k].dtype, k
    for k in ("chroma", "gchroma", "length"):
        np.testing.assert_array_equal(got[k], desc[k])
    # mfcc means: float32 sums in another order than XLA's
    np.testing.assert_allclose(got["mfcc"], desc["mfcc"], rtol=1e-6,
                               atol=1e-6)
    assert int(desc["length"].min()) > 20     # not the vacuous regime


@pytest.mark.parametrize("source", ["own_extraction", "jax_descriptors"])
def test_run_pairwise_matches_jax(corpus, source):
    fs, desc, want = corpus
    algo = Serra09()
    if source == "own_extraction":
        d = algo.extract_descriptors(fs, device="cpu")
    else:
        d = descriptors_from_numpy(desc, "cpu")
        assert {k: v.dtype for k, v in d.items()} == {
            "chroma": torch.float32, "mfcc": torch.float32,
            "gchroma": torch.float32, "length": torch.int32}
    got = run_pairwise(algo, d, fs.n_songs, device="cpu")
    _assert_same_scores(got, want)
    assert _stats(got, fs.labels) == _stats(want, fs.labels)
    assert all(s["map"] > 0.9 for s in _stats(got, fs.labels).values())


def test_kernel_path_composition_matches_jax_pallas_interpret(corpus):
    """tile_scores(plain=True) composes the CUDA path's CRPs (OTI per
    pair, centred MFCC, the fused CRP) and aligners with each kernel's
    plain version; the JAX package's Pallas path, interpreted, must give
    the same tile."""
    fs, desc, _ = corpus
    rows, cols = slice(0, 4), slice(6, 10)
    # a large leading MFCC term, like the energy coefficient of real HTK
    # MFCCs: without the per-pair centring the fp32 Gram trick loses the
    # distances and the CRPs change
    desc = dict(desc)
    valid = np.arange(desc["mfcc"].shape[1]) < desc["length"][:, None]
    desc["mfcc"] = desc["mfcc"].copy()
    desc["mfcc"][..., 0] += np.where(valid, 3000.0, 0.0).astype(np.float32)
    prev = jax_alignment.set_alignment_impl("pallas_interpret")
    try:
        want = JaxSerra09().tile_scores(
            jax.device_put({k: v[rows] for k, v in desc.items()}),
            jax.device_put({k: v[cols] for k, v in desc.items()}))
        want = {k: np.asarray(v) for k, v in want.items()}
    finally:
        jax_alignment.set_alignment_impl(prev)
    d = descriptors_from_numpy(desc, "cpu")
    got = Serra09().tile_scores({k: v[rows] for k, v in d.items()},
                                {k: v[cols] for k, v in d.items()},
                                plain=True)
    _assert_same_scores({k: v.numpy() for k, v in got.items()}, want)


def test_benchmark_matches_jax(corpus, tmp_path):
    fs, _, _ = corpus
    times = {}
    got = benchmark(Serra09(), fs, results_csv=str(tmp_path / "port.csv"),
                    device="cpu", times=times)
    want = jax_benchmark(JaxSerra09(), fs,
                         results_csv=str(tmp_path / "jax.csv"))
    assert {k: dataclasses.asdict(v) for k, v in got.items()} == \
        {k: dataclasses.asdict(v) for k, v in want.items()}
    assert (tmp_path / "port.csv").read_text() == \
        (tmp_path / "jax.csv").read_text()
    assert sorted(times) == ["eval", "extract", "sweep"]


def test_checkpoint_ledger_resumes_across_packages(corpus, tmp_path):
    """A finished ledger written by the port resumes in the JAX package
    with nothing left to score, and a ledger written by the JAX package
    resumes in the port without calling tile_scores."""
    fs, desc, want = corpus
    ckpt = str(tmp_path / "port_ckpt.npz")
    run_pairwise(Serra09(), desc, fs.n_songs, checkpoint_path=ckpt,
                 checkpoint_every=1, device="cpu")

    class Refuses(JaxSerra09):
        def tile_scores(self, row, col):
            raise AssertionError("a finished ledger must not rescore")

    _assert_same_scores(jax_run_pairwise(Refuses(), desc, fs.n_songs,
                                         checkpoint_path=ckpt), want)

    ckpt = str(tmp_path / "jax_ckpt.npz")
    jax_run_pairwise(JaxSerra09(), desc, fs.n_songs, checkpoint_path=ckpt)

    class RefusesToo(Serra09):
        def tile_scores(self, row, col, plain=False):
            raise AssertionError("a finished ledger must not rescore")

    _assert_same_scores(run_pairwise(RefusesToo(), desc, fs.n_songs,
                                     checkpoint_path=ckpt, device="cpu"),
                        want)


def test_ssms_channel_matches_jax():
    """Serra09(do_ssms=True) on one set of descriptors (the port's own,
    ssms corpus included; its extraction is held against JAX in
    test_torch_early_snf.py): the per-pair path's sweep and the kernel
    path's composition (the fused CRP and the matrix binarizer as plain
    versions, on ssms centred at a tile-shared origin) give the JAX
    package's scores and retrieval metrics."""
    fs = make_synthetic_dataset(n_cliques=4, clique_size=2, n_states=6,
                                base_duration=30.0, seed=2)
    kw = dict(do_ssms=True, downsample_fac=4, pad_to_multiple=16)
    algo = Serra09(**kw)
    d = algo.extract_descriptors(fs, device="cpu")
    assert isinstance(d["ssms"], torch.Tensor)
    desc = {k: v.numpy() if isinstance(v, torch.Tensor) else v
            for k, v in d.items()}
    want = jax_run_pairwise(JaxSerra09(**kw), desc, fs.n_songs)
    types = SIM_TYPES + ("ssms_scatter_qmax", "ssms_scatter_dmax")
    assert sorted(want) == sorted(algo.SIMILARITY_TYPES) == sorted(types)
    got = run_pairwise(algo, d, fs.n_songs, device="cpu")
    for k in types:
        np.testing.assert_allclose(got[k], want[k], rtol=0, atol=1e-6,
                                   err_msg=k)
    assert _stats(got, fs.labels) == _stats(want, fs.labels)
    assert want["ssms_scatter_qmax"].max() > 0
    t = {k: torch.as_tensor(v) for k, v in d.items()}
    tile = algo.tile_scores({k: v[4:8] for k, v in t.items()},
                            {k: v[0:4] for k, v in t.items()}, plain=True)
    for k in types:
        np.testing.assert_allclose(tile[k].numpy(), want[k][4:8, 0:4],
                                   rtol=0, atol=1e-6, err_msg=k)


def test_cli_benchmark_on_cpu(corpus, tmp_path, monkeypatch, capsys):
    fs, _, _ = corpus
    fs.save(str(tmp_path / "synth.npz"))
    monkeypatch.chdir(tmp_path)
    rc = cli.main(["benchmark", "-a", "Serra09", "-d", "synth.npz",
                   "-s", "vrun", "--device", "cpu", "--cachedir", "ck"])
    assert rc == 0
    out = capsys.readouterr().out
    assert "results appended to results_vrun.csv" in out
    rows = (tmp_path / "results_vrun.csv").read_text().splitlines()
    assert rows[0].startswith("name, MR, MRR, MDR, MAP")
    assert [r.split(",")[0] for r in rows[1:]] == [
        f"Serra09_{k}" for k in SIM_TYPES]
    assert (tmp_path / "ck" / "Serra09_vrun_ckpt.npz").exists()


def _tile_features(seed, bi, bj, L):
    """Random row and column descriptors of a tile: lengths from 0 (a
    padding song) and below the window m = 9 to L, MFCCs with a large
    leading term, as HTK energy."""
    rng = np.random.default_rng(seed)
    n = bi + bj
    length = rng.integers(L // 2, L + 1, n).astype(np.int32)
    length[-3:] = [L, 5, 0]
    f = {"chroma": rng.random((n, L, 12), np.float32),
         "mfcc": rng.standard_normal((n, L, 13)).astype(np.float32),
         "gchroma": rng.random((n, 12), np.float32),
         "length": length}
    f["mfcc"][..., 0] += 3000.0
    return ({k: v[:bi] for k, v in f.items()},
            {k: v[bi:] for k, v in f.items()})


@pytest.mark.parametrize("bi,bj,L", [(4, 6, 64), (1, 8, 320), (8, 1, 512),
                                     (3, 3, 576)])
def test_pair_operands_ref_matches_jax(bi, bj, L):
    """The pair operands' plain version (the prep kernel's contract) gives
    the JAX package's fused-path operands bit for bit: each row song's
    chroma rolled by the OTI towards each column song, the column songs'
    chroma, both mfccs less the row song's first frame and zero past the
    lengths, and the pairs' lengths; the OTI is the JAX package's."""
    row, col = _tile_features(bi * 100 + bj + L, bi, bj, L)
    oti = jax.vmap(jax.vmap(jax_crp.get_oti, in_axes=(None, 0)),
                   in_axes=(0, None))(row["gchroma"], col["gchroma"])
    Xch = jax.vmap(jax.vmap(jax_crp.transpose_chroma, in_axes=(None, 0)))(
        row["chroma"], oti)
    l1 = np.repeat(row["length"], bj)
    l2 = np.tile(col["length"], bi)
    Xm = jnp.repeat(row["mfcc"], bj, axis=0)
    Ym = jnp.tile(col["mfcc"], (bi, 1, 1))
    c = Xm[:, :1]
    ar = np.arange(L)
    want = [np.asarray(Xch).reshape(bi * bj, L, 12),
            np.tile(col["chroma"], (bi, 1, 1)),
            np.asarray(jnp.where((ar < l1[:, None])[..., None], Xm - c,
                                 0.0)),
            np.asarray(jnp.where((ar < l2[:, None])[..., None], Ym - c,
                                 0.0)), l1, l2]
    r, k = ({n: torch.from_numpy(v) for n, v in d.items()}
            for d in (row, col))
    port_oti = Serra09()._oti(r, k)
    np.testing.assert_array_equal(port_oti.numpy(), np.asarray(oti))
    got = serra09_cuda.pair_operands_ref(
        r["chroma"], k["chroma"], r["mfcc"], k["mfcc"], r["length"],
        k["length"], port_oti)
    for g, w in zip(got, want):
        assert g.is_contiguous() and g.numpy().dtype == w.dtype
        np.testing.assert_array_equal(g.numpy(), w)
    assert not want[3][l2 == 0].any() and np.abs(want[2]).max() > 1.0


def test_prep_and_epilogue_wrappers_on_cpu_are_the_plain_versions():
    """On CPU tensors both wrappers return their plain versions and launch
    nothing; the epilogue divides each channel's scores by
    max(l1e + l2e, 1)."""
    row, col = ({n: torch.from_numpy(v) for n, v in d.items()}
                for d in _tile_features(3, 2, 3, 64))
    oti = Serra09()._oti(row, col)
    args = (row["chroma"], col["chroma"], row["mfcc"], col["mfcc"],
            row["length"], col["length"])
    prep, epi = (serra09_cuda.pair_operands_batch,
                 serra09_cuda.scores_epilogue_batch)
    before = (prep.launches, epi.launches)
    for o in (oti, None):
        for g, w in zip(prep(*args, o),
                        serra09_cuda.pair_operands_ref(*args, o)):
            assert torch.equal(g, w)
    l1e = torch.tensor([0, 3, 7], dtype=torch.int32)
    l2e = torch.tensor([0, 0, 9], dtype=torch.int32)
    q = [torch.tensor([0.0, 3.0, 5.0]), torch.tensor([1.0, 2.0, 4.0])]
    d = [torch.tensor([2.0, 6.0, 1.0]), torch.tensor([0.5, 0.0, 8.0])]
    got = epi(q, d, l1e, l2e)
    assert torch.equal(got, serra09_cuda.scores_epilogue_ref(q, d, l1e, l2e))
    assert torch.equal(got[0, 1], torch.tensor([1.0, 2.0 / 3.0, 0.25]))
    assert (prep.launches, epi.launches) == before


@pytest.mark.parametrize("do_ssms", [False, True])
def test_channel_scores_equal_the_stacked_plain_scores(do_ssms):
    """The CUDA path's composition with every kernel's plain version (the
    pair operands, each channel's CRPs scored where its call left them,
    the epilogue) gives `tile_scores(plain=True)`'s stacked scores bit for
    bit, on a tile with bi != bj."""
    fs = make_synthetic_dataset(n_cliques=3, clique_size=2, n_states=6,
                                base_duration=30.0, seed=3)
    algo = Serra09(do_ssms=do_ssms, downsample_fac=4, pad_to_multiple=16)
    d = {k: torch.as_tensor(v) for k, v in
         algo.extract_descriptors(fs, device="cpu").items()}
    row = {k: v[1:6] for k, v in d.items()}
    col = {k: v[0:3] for k, v in d.items()}
    want = algo.tile_scores(row, col, plain=True)
    if do_ssms:
        row, col = algo._center_ssms(row, col)
    qd = algo._channel_scores(row, col, plain=True)
    assert qd.shape == (2, len(algo._channels()), 5, 3)
    for k, name in enumerate(algo._channels()):
        assert torch.equal(qd[0, k], want[f"{name}_qmax"]), name
        assert torch.equal(qd[1, k], want[f"{name}_dmax"]), name
    assert float(want["chroma_qmax"].max()) > 0
