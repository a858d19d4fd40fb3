"""The port's serving layer (`acoss_tpu_torch.serving.CoverIndex`) against
the JAX package's on the CPU: the same seeded corpus and held-out queries
through both indexes, the port's index against its own batch sweep, the
JAX serving tests' contract (ranking, persistence, quantization, padding,
the CLI, parameter drift, atomic save), the parameter snapshot of every
algorithm class, and indexes crossing between the packages both ways."""

from tests import _torch_threads  # noqa: F401  (caps thread pools)

import json
import warnings

import numpy as np
import pytest

from acoss_tpu import serving as jax_serving
from acoss_tpu.benchmarking.algorithms import ALL_ALGORITHMS as JAX_ALGOS
from acoss_tpu.benchmarking.algorithms import Serra09 as JaxSerra09
from acoss_tpu.data import make_synthetic_dataset
from acoss_tpu_torch import cli
from acoss_tpu_torch.benchmarking.algorithms import ALL_ALGORITHMS
from acoss_tpu_torch.benchmarking.algorithms import EarlySNF, Serra09
from acoss_tpu_torch.benchmarking.harness import run_pairwise
from acoss_tpu_torch.data import FeatureSet
from acoss_tpu_torch.serving import CoverIndex, _algo_params, _quantize_desc


def _port_fs(fs) -> FeatureSet:
    return FeatureSet(fs.features, fs.lengths, fs.labels, fs.track_ids)


@pytest.fixture(scope="module")
def corpus_and_queries():
    fs = make_synthetic_dataset(n_cliques=6, clique_size=2,
                                n_distractors=2, seed=13)
    # hold out one member of each of the first 3 cliques as queries
    qidx = np.array([0, 2, 4])
    cidx = np.setdiff1d(np.arange(fs.n_songs), qidx)
    pfs = _port_fs(fs)
    return (pfs, pfs.subset(cidx), pfs.subset(qidx), cidx, qidx,
            fs.subset(cidx), fs.subset(qidx))


def _algo():
    return Serra09(chroma_type="hpcp", downsample_fac=4, pad_to_multiple=8)


def _jax_algo():
    return JaxSerra09(chroma_type="hpcp", downsample_fac=4,
                      pad_to_multiple=8)


@pytest.fixture(scope="module")
def jax_rows(corpus_and_queries):
    *_, jcfs, jqfs = corpus_and_queries
    return jax_serving.CoverIndex.build(_jax_algo(), jcfs,
                                        tile=4).query(jqfs)


def test_query_rows_match_jax_index(corpus_and_queries, jax_rows):
    """The port's index answers what the JAX package's does, within the
    tolerance the two Serra09 sweeps are held to."""
    _, cfs, qfs, cidx, qidx, _, _ = corpus_and_queries
    got = CoverIndex.build(_algo(), cfs, tile=4, device="cpu").query(qfs)
    assert sorted(got) == sorted(jax_rows)
    for k in jax_rows:
        assert got[k].shape == (len(qidx), len(cidx)), k
        assert got[k].dtype == np.float32
        np.testing.assert_allclose(got[k], jax_rows[k], rtol=0, atol=1e-6,
                                   err_msg=k)


def test_query_rows_match_batch_sweep(corpus_and_queries):
    """Index query scores == the query-vs-corpus rows of a full batch sweep
    over the union (same kernels, tile layout differences only)."""
    fs, cfs, qfs, cidx, qidx, _, _ = corpus_and_queries
    algo = _algo()
    D = run_pairwise(algo, algo.extract_descriptors(fs, device="cpu"),
                     fs.n_songs, tile=4, device="cpu")
    scores = CoverIndex.build(algo, cfs, tile=4, device="cpu").query(qfs)
    assert set(scores) == set(algo.SIMILARITY_TYPES)
    for k, S in scores.items():
        np.testing.assert_allclose(S, D[k][np.ix_(qidx, cidx)], atol=2e-4,
                                   err_msg=k)


def test_top_k_finds_planted_covers(corpus_and_queries):
    fs, cfs, qfs, cidx, qidx, _, _ = corpus_and_queries
    index = CoverIndex.build(_algo(), cfs, tile=4, device="cpu")
    ranked = index.top_k(qfs, k=3, similarity_type="chroma_qmax")
    for qi, rows in enumerate(ranked):
        mate = rows[0]
        assert fs.labels[cidx[mate["index"]]] == fs.labels[qidx[qi]], \
            (qi, rows)
        assert mate["score"] >= rows[-1]["score"]


def test_top_k_default_channel_and_ties_match_jax(corpus_and_queries):
    """top_k with no similarity type ranks by the same channel as the JAX
    package, and breaks ties (stable argsort, negated distances) the same
    way."""
    _, cfs, qfs, _, _, jcfs, jqfs = corpus_and_queries
    got = CoverIndex.build(_algo(), cfs, tile=4, device="cpu").top_k(qfs,
                                                                     k=5)
    want = jax_serving.CoverIndex.build(_jax_algo(), jcfs,
                                        tile=4).top_k(jqfs, k=5)
    assert [[r["index"] for r in q] for q in got] == \
        [[r["index"] for r in q] for q in want]
    assert [[r["id"] for r in q] for q in got] == \
        [[r["id"] for r in q] for q in want]


def test_index_save_load_roundtrip(tmp_path, corpus_and_queries):
    _, cfs, qfs, _, _, _, _ = corpus_and_queries
    index = CoverIndex.build(_algo(), cfs, tile=4, device="cpu")
    ref = index.query(qfs)
    index.save(str(tmp_path / "idx"))
    loaded = CoverIndex.load(_algo(), str(tmp_path / "idx"), device="cpu")
    assert loaded.ids == index.ids
    got = loaded.query(qfs)
    for k in ref:
        np.testing.assert_allclose(got[k], ref[k], atol=1e-5)
    # wrong algorithm class is rejected
    with pytest.raises(ValueError):
        CoverIndex.load(ALL_ALGORITHMS["FTM2D"](), str(tmp_path / "idx"),
                        device="cpu")


def test_quantized_index_keeps_ranking(corpus_and_queries):
    _, cfs, qfs, _, _, _, _ = corpus_and_queries
    algo = _algo()
    ref = CoverIndex.build(algo, cfs, tile=4, device="cpu").top_k(
        qfs, k=1, similarity_type="chroma_qmax")
    for quant in ("half", "int8"):
        CoverIndex.build(_algo(), cfs, quant=quant, tile=4, device="cpu")
        # force quantization despite the tiny corpus dims
        qd = _quantize_desc(algo.extract_descriptors(cfs, device="cpu"),
                            quant, min_bytes=256)
        assert any(v.dtype in (np.float16, np.int8)
                   for v in qd.values()), quant
        idx = CoverIndex(_algo(), qd, cfs.n_songs, tile=4, device="cpu")
        got = idx.top_k(qfs, k=1, similarity_type="chroma_qmax")
        for r, g in zip(ref, got):
            assert r[0]["index"] == g[0]["index"], quant


def test_query_padding_and_batch_shapes(corpus_and_queries):
    """nq < tile pads to one tile; nq > tile spans two tile widths; both
    agree with the per-song queries."""
    _, cfs, qfs, _, _, _, _ = corpus_and_queries
    index = CoverIndex.build(_algo(), cfs, tile=2, device="cpu")
    all3 = index.query(qfs)
    for i in range(qfs.n_songs):
        one = index.query(qfs.subset(np.array([i])))
        for k in all3:
            np.testing.assert_allclose(one[k][0], all3[k][i], atol=1e-5)


def test_ragged_query_width_grows_or_refuses(corpus_and_queries):
    """A query padded narrower than the index grows to its width; one
    wider than the index is refused."""
    _, cfs, qfs, _, _, _, _ = corpus_and_queries
    algo = _algo()
    index = CoverIndex.build(algo, cfs, tile=4, device="cpu")
    qd = algo.extract_descriptors(qfs, device="cpu")
    L = index._corpus["chroma"].shape[1]
    wide = dict(qd, chroma=np.pad(qd["chroma"], [(0, 0), (0, L + 8 -
                                                         qd["chroma"]
                                                         .shape[1]),
                                                 (0, 0)]))
    with pytest.raises(ValueError, match="wider than the index"):
        index.query_descriptors(wide, qfs.n_songs)
    narrow = {k: (v[:, :qd["length"].max()] if v.ndim >= 2 else v)
              for k, v in qd.items()}
    got = index.query_descriptors(narrow, qfs.n_songs)
    want = index.query_descriptors(qd, qfs.n_songs)
    for k in want:
        np.testing.assert_array_equal(got[k], want[k])


def test_cli_query_roundtrip(tmp_path, capsys):
    jfs = make_synthetic_dataset(n_cliques=4, clique_size=2, seed=3)
    fs = _port_fs(jfs)
    qidx = np.array([0])
    cidx = np.setdiff1d(np.arange(fs.n_songs), qidx)
    fs.subset(cidx).save(str(tmp_path / "corpus.npz"))
    fs.subset(qidx).save(str(tmp_path / "query.npz"))
    args = ["query", "-a", "Serra09", "-q", str(tmp_path / "query.npz"),
            "--index-dir", str(tmp_path / "idx"), "--top", "2",
            "--similarity-type", "chroma_qmax", "--device", "cpu"]
    assert cli.main(args + ["-d", str(tmp_path / "corpus.npz")]) == 0
    out = capsys.readouterr().out
    hits = [json.loads(line) for line in out.splitlines()
            if line.startswith("{")]
    assert len(hits) == 1 and len(hits[0]["top"]) == 2
    # the planted cover (same clique as query 0) ranks first
    top = hits[0]["top"][0]
    assert fs.labels[cidx[top["index"]]] == fs.labels[qidx[0]]
    # the second invocation reuses the saved index
    assert cli.main(args + ["-d", "/nonexistent"]) == 0
    out2 = capsys.readouterr().out
    assert "loading index" in out2
    assert [json.loads(ln) for ln in out2.splitlines()
            if ln.startswith("{")] == hits


def test_load_rejects_parameter_drift(tmp_path, corpus_and_queries):
    """Same class, different constructor params: load must refuse -- the
    query-side extraction would not match the stored corpus."""
    _, cfs, _, _, _, _, _ = corpus_and_queries
    CoverIndex.build(_algo(), cfs, tile=4, device="cpu").save(
        str(tmp_path / "idx"))
    drifted = Serra09(chroma_type="crema", downsample_fac=4,
                      pad_to_multiple=8)
    with pytest.raises(ValueError, match="chroma_type"):
        CoverIndex.load(drifted, str(tmp_path / "idx"), device="cpu")
    # identical params still load
    CoverIndex.load(_algo(), str(tmp_path / "idx"), device="cpu")


def test_save_replaces_prior_index_atomically(tmp_path,
                                              corpus_and_queries):
    """Re-saving over a PRIOR INDEX replaces it wholesale (stale .npy
    memmaps with old dtypes/widths or orphan keys must not leak into the
    new store), via the temp-dir + swap."""
    _, cfs, qfs, _, _, _, _ = corpus_and_queries
    path = tmp_path / "idx"
    index = CoverIndex.build(_algo(), cfs, tile=4, device="cpu")
    ref = index.query(qfs)
    index.save(str(path))
    np.save(path / "chroma.npy", np.zeros((cfs.n_songs, 3), np.int8))
    np.save(path / "orphan.npy", np.zeros((cfs.n_songs, 2), np.float32))
    index.save(str(path))
    assert not list(tmp_path.glob("idx.tmp-*"))
    assert not list(tmp_path.glob("idx.old-*"))
    loaded = CoverIndex.load(_algo(), str(path), device="cpu")
    assert "orphan" not in loaded._corpus
    got = loaded.query(qfs)
    for k in ref:
        np.testing.assert_allclose(got[k], ref[k], atol=1e-5, err_msg=k)


def test_save_refuses_foreign_npy_directory(tmp_path,
                                            corpus_and_queries):
    """A directory holding .npy data WITHOUT an index meta is someone
    else's data -- save() must refuse rather than delete it."""
    _, cfs, _, _, _, _, _ = corpus_and_queries
    path = tmp_path / "notanindex"
    path.mkdir()
    np.save(path / "precious.npy", np.arange(5))
    index = CoverIndex.build(_algo(), cfs, tile=4, device="cpu")
    with pytest.raises(ValueError, match="not a CoverIndex"):
        index.save(str(path))
    assert np.array_equal(np.load(path / "precious.npy"), np.arange(5))


def test_load_warns_not_refuses_on_scoring_only_drift(
        tmp_path, corpus_and_queries):
    """Scoring-only knobs (SCORING_ONLY_PARAMS) don't change the stored
    descriptors; load warns and proceeds instead of refusing."""
    _, cfs, _, _, _, _, _ = corpus_and_queries
    assert EarlySNF.SCORING_ONLY_PARAMS == \
        JAX_ALGOS["EarlySNF"].SCORING_ONLY_PARAMS
    algo = EarlySNF(chroma_type="hpcp", downsample_fac=4,
                    pad_to_multiple=8, do_ssms=False)
    CoverIndex.build(algo, cfs, tile=4, device="cpu").save(
        str(tmp_path / "idx"))
    drifted = EarlySNF(chroma_type="hpcp", downsample_fac=4,
                       pad_to_multiple=8, do_ssms=False,
                       snf_precision="default")
    with pytest.warns(UserWarning, match="snf_precision"):
        CoverIndex.load(drifted, str(tmp_path / "idx"), device="cpu")


@pytest.fixture
def no_filter_bank(monkeypatch):
    """StrucScattering builds a 512^2 scattering filter bank (~30 s a
    package) in its constructor; the bank is an object, outside the
    parameter snapshot, so both packages' get a stub."""
    from acoss_tpu.benchmarking.algorithms import \
        struc_scattering as jax_struc
    from acoss_tpu_torch.benchmarking.algorithms import struc_scattering

    for mod in (jax_struc, struc_scattering):
        monkeypatch.setattr(mod, "Scattering2D",
                            lambda *a, **k: object())


@pytest.mark.parametrize("name", sorted(JAX_ALGOS))
def test_algo_params_equal_across_packages(name, no_filter_bank):
    """The snapshot an index stores is the JAX package's for every class
    at default settings, so an index saved by one package loads in the
    other."""
    assert sorted(ALL_ALGORITHMS) == sorted(JAX_ALGOS)
    assert _algo_params(ALL_ALGORITHMS[name]()) == \
        jax_serving._algo_params(JAX_ALGOS[name]())


@pytest.mark.parametrize("writer", ["jax", "torch"])
def test_index_crosses_packages(tmp_path, corpus_and_queries, jax_rows,
                                writer):
    """An index saved by either package loads in the other and answers
    the same rows."""
    _, cfs, qfs, _, _, jcfs, jqfs = corpus_and_queries
    path = str(tmp_path / "idx")
    if writer == "jax":
        jax_serving.CoverIndex.build(_jax_algo(), jcfs, tile=4).save(path)
        with warnings.catch_warnings():
            warnings.simplefilter("error")
            got = CoverIndex.load(_algo(), path, device="cpu").query(qfs)
    else:
        CoverIndex.build(_algo(), cfs, tile=4, device="cpu").save(path)
        with warnings.catch_warnings():
            warnings.simplefilter("error")
            got = jax_serving.CoverIndex.load(_jax_algo(), path).query(jqfs)
    for k in jax_rows:
        np.testing.assert_allclose(got[k], jax_rows[k], rtol=0, atol=1e-6,
                                   err_msg=k)
