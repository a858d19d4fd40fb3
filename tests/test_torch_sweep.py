"""The port's sweep engines against its own plain sweep and the JAX
package's same engines, on the CPU: plain, memmapped, streamed, bucketed
(RAM and memmapped, with `perm`, and streamed from per-bucket stores) and
hybrid sweeps give the same scores bit for bit; ledgers left half done by
one package resume in the other; the guards (ledger modes, a stale
`symmetrized.flag`, valid zero frames, a completed resume) hold; and
Serra09's bucketed int8-streamed sweep equals the JAX package's on the same
store.

The score is the max over frames and features of the elementwise product
of the two songs' (positive) descriptors: exact in fp32, independent of
the order of operations and of trailing zero padding, and symmetric, so
every engine and both packages must agree to the bit."""

from tests import _torch_threads  # noqa: F401  (caps thread pools)

import dataclasses
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import acoss_tpu.benchmarking.harness as JH
import acoss_tpu_torch.benchmarking.harness as H
from acoss_tpu.benchmarking.algorithms import Serra09 as JaxSerra09
from acoss_tpu.data.synthetic import LazySyntheticCorpus as JaxLazy
from acoss_tpu_torch import cli
from acoss_tpu_torch.benchmarking.algorithms import Serra09
from acoss_tpu_torch.data import LazySyntheticCorpus
from acoss_tpu_torch.data.descstore import extract_streamed, upcast_stream
from acoss_tpu_torch.data.store import FeatureSet

N, TILE = 22, 4


def _fs(n: int = N, seed: int = 0) -> FeatureSet:
    """Ragged songs of positive features; lengths 3..48, two all-zero
    trailing frames inside the valid part of song 0."""
    rng = np.random.default_rng(seed)
    L = 48
    lens = rng.integers(3, L + 1, n).astype(np.int32)
    lens[0] = L
    vec = (rng.random((n, L, 5)) + 0.1).astype(np.float32)
    vec *= (np.arange(L)[None, :, None] < lens[:, None, None])
    vec[0, L - 2:] = 0.0
    return FeatureSet({"vec": vec}, {"vec": lens},
                      np.array([f"W{i // 2}" for i in range(n)]),
                      np.array([f"t{i}" for i in range(n)]))


def _ragged(fs) -> dict:
    lens = np.asarray(fs.length("vec"))
    w = int(lens.max())
    return {"vec": np.asarray(fs.feature("vec")[:, :w], np.float32),
            "length": lens.astype(np.int32)}


class MaxProd(H.CoverAlgorithm):
    NAME = "MaxProd"
    TILE = TILE

    def __init__(self):
        self.calls = 0

    def extract_descriptors(self, fs, device="cuda"):
        return _ragged(fs)

    def tile_scores(self, row, col):
        self.calls += 1
        assert row["vec"].dtype == torch.float32
        prod = row["vec"][:, None] * col["vec"][None]
        return {"main": prod.flatten(2).amax(-1)}


class JaxMaxProd(JH.CoverAlgorithm):
    NAME = "MaxProd"
    TILE = TILE

    def extract_descriptors(self, fs):
        return _ragged(fs)

    def tile_scores(self, row, col):
        prod = row["vec"][:, None] * col["vec"][None]
        return {"main": jnp.max(prod.reshape(prod.shape[:2] + (-1,)), -1)}


def _store(tmp_path, fs, name="store", quant=None):
    return extract_streamed(MaxProd(), fs, str(tmp_path / name),
                            chunk_songs=9, quant=quant, half_min_bytes=64,
                            device="cpu")


def _plain(fs, desc=None):
    return H.run_pairwise(MaxProd(), desc or _ragged(fs), fs.n_songs,
                          device="cpu")["main"]


def _run(engine, pkg, tmp_path, fs, ckpt=None, out=None):
    """One sweep of `engine` by package `pkg` ("port" / "jax"), writing
    its scores or streams under `out` (default: a directory of its own)
    and reading the port's fp32 store under `tmp_path`; returns (scores in
    caller order, calls of tile_scores or None)."""
    port = pkg == "port"
    alg = MaxProd() if port else JaxMaxProd()
    mod = H if port else JH
    kw = {"device": "cpu"} if port else {}
    out = str(out or tmp_path / f"{pkg}_{engine}")
    n = fs.n_songs
    if engine in ("plain", "memmap", "streamed", "hybrid"):
        desc = _ragged(fs) if engine == "plain" else _shared_store(
            tmp_path, fs)
        if engine == "hybrid":
            D = mod.run_pairwise_hybrid(alg, desc, n, panel_songs=8,
                                        scores_dir=out,
                                        checkpoint_path=ckpt,
                                        checkpoint_every=2, **kw)
        else:
            D = mod.run_pairwise(
                alg, desc, n, checkpoint_path=ckpt, checkpoint_every=2,
                scores_dir=None if engine == "plain" else out, **kw)
        D = D["main"]
    else:
        stream = engine == "bucketed_streamed"
        memmap = engine != "bucketed_ram"
        D, perm = mod.run_pairwise_bucketed(
            alg, fs, n_buckets=3, checkpoint_path=ckpt, checkpoint_every=2,
            scores_dir=out if engine == "bucketed_memmap" else None,
            stream_dir=out if stream else None, stream_chunk=5,
            return_perm=True, **kw)
        D = D["main"]
        if memmap:
            assert isinstance(D, np.memmap)
            D = np.asarray(D)[np.ix_(np.argsort(perm), np.argsort(perm))]
    return np.asarray(D), getattr(alg, "calls", None)


def _shared_store(tmp_path, fs) -> dict:
    """One fp32 store per test directory, written by the port."""
    from acoss_tpu_torch.data.descstore import DescriptorStore

    path = str(tmp_path / "store")
    if os.path.exists(os.path.join(path, DescriptorStore.META)):
        return DescriptorStore.open(path)
    return _store(tmp_path, fs)


ENGINES = ["plain", "memmap", "streamed", "bucketed_ram", "bucketed_memmap",
           "bucketed_streamed", "hybrid"]


@pytest.mark.parametrize("engine", ENGINES)
def test_engine_matches_plain_and_jax(tmp_path, engine):
    fs = _fs()
    want = _plain(fs)
    assert (want[np.tril_indices(N, -1)] > 0).all()
    assert not np.diag(want).any()
    got, calls = _run(engine, "port", tmp_path, fs)
    np.testing.assert_array_equal(got, want)
    jax_got, _ = _run(engine, "jax", tmp_path, fs)
    np.testing.assert_array_equal(got, jax_got)
    n_tiles = -(-N // TILE)
    assert calls == n_tiles * (n_tiles + 1) // 2


@pytest.mark.parametrize("quant", ["half", "int8"])
def test_quantized_store_sweeps_match_jax(tmp_path, quant):
    """Streamed, device-resident and hybrid sweeps of a quantized store
    score the dequantized descriptors: bit-equal to the plain sweep over
    `upcast_stream(store)` and to the JAX package."""
    fs = _fs()
    store = _store(tmp_path, fs, quant=quant)
    assert store["vec"].dtype == (np.int8 if quant == "int8"
                                  else np.float16)
    deq = {k: v.numpy() for k, v in upcast_stream(
        {k: torch.from_numpy(np.array(v)) for k, v in store.items()}).items()}
    want = _plain(fs, deq)
    for resident in (False, True):
        got = H.run_pairwise(MaxProd(), store, N, device="cpu",
                             device_resident=resident)["main"]
        np.testing.assert_array_equal(got, want)
    got = H.run_pairwise_hybrid(MaxProd(), store, N, panel_songs=8,
                                device="cpu")["main"]
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(
        got, JH.run_pairwise(JaxMaxProd(), store, N)["main"])
    np.testing.assert_array_equal(
        got, JH.run_pairwise_hybrid(JaxMaxProd(), store, N,
                                    panel_songs=8)["main"])


def test_bucketed_streamed_int8_mixed_buckets_match_jax(tmp_path):
    """Per-bucket int8 stores quantize the bulk key in the long buckets
    only; cross-bucket tiles reconcile one-sided `@qscale` companions.
    Port == JAX on the same stores, and the merged small keys are fp32."""
    fs = _fs()
    sd = str(tmp_path / "s")
    kw = dict(n_buckets=3, stream_dir=sd, stream_quant="int8",
              stream_chunk=4, stream_min_bytes=500, return_desc=True,
              return_perm=True)
    Ds, desc, perm = H.run_pairwise_bucketed(MaxProd(), fs, device="cpu",
                                             **kw)
    quantized = [any(f.endswith("@qscale.npy") for f in
                     os.listdir(os.path.join(sd, "desc", f"bucket_{b:04d}")))
                 for b in range(3)]
    assert quantized == [False, True, True]
    jax_Ds, jax_desc, jax_perm = JH.run_pairwise_bucketed(
        JaxMaxProd(), fs, scores_dir=str(tmp_path / "jax_scores"), **kw)
    np.testing.assert_array_equal(perm, jax_perm)
    np.testing.assert_array_equal(Ds["main"], jax_Ds["main"])
    assert sorted(desc) == sorted(jax_desc) == ["length", "vec"]
    for k in desc:
        assert desc[k].dtype == jax_desc[k].dtype
        np.testing.assert_array_equal(desc[k], jax_desc[k])
    np.testing.assert_array_equal(desc["length"], _ragged(fs)["length"][perm])


def _interrupted(mod, run, after: int):
    """Run `run()` with `mod._TileSweeper.submit` failing after `after`
    tiles (the ledger saved first, as a kill after a checkpoint leaves
    it)."""
    orig = mod._TileSweeper.submit
    n = {"tiles": 0}

    def limited(self, ti, tj, scores):
        if n["tiles"] >= after:
            self.flush()
            self.save_ckpt()
            raise KeyboardInterrupt
        n["tiles"] += 1
        return orig(self, ti, tj, scores)

    mod._TileSweeper.submit = limited
    try:
        with pytest.raises(KeyboardInterrupt):
            run()
    finally:
        mod._TileSweeper.submit = orig


@pytest.mark.parametrize("engine", ["plain", "memmap", "bucketed_memmap",
                                    "bucketed_streamed", "hybrid"])
@pytest.mark.parametrize("first", ["jax", "port"])
def test_half_done_ledger_resumes_across_packages(tmp_path, engine, first):
    fs = _fs()
    want = _plain(fs)
    ckpt = str(tmp_path / "ledger.npz")
    # both packages sweep into the same directory (scores_dir / stream_dir)
    second = "port" if first == "jax" else "jax"

    def run(pkg):
        return _run(engine, pkg, tmp_path, fs, ckpt, out=tmp_path / "shared")

    _interrupted(H if first == "port" else JH, lambda: run(first), after=9)
    with np.load(ckpt) as z:
        done = int(z["done"].sum())
    assert 9 <= done < 21
    got, calls = run(second)
    np.testing.assert_array_equal(got, want)
    if second == "port":
        assert calls == 21 - done


@pytest.mark.parametrize("foreign", [
    {"n_buckets": 3, "bucketed": 1}, {"hybrid_panel": 8}])
def test_plain_sweep_refuses_foreign_ledgers(tmp_path, foreign):
    """Ledgers carry their mode: a plain sweep adopts neither a bucketed
    nor a hybrid ledger (written by either package), and the reverse."""
    ckpt = str(tmp_path / "ckpt.npz")
    for mod in (JH, H):
        a = mod._TileSweeper(("main",), 32, 8, True, None, ckpt,
                             ckpt_extra=foreign)
        a.done[:] = True
        a.save_ckpt()
        assert not H._TileSweeper(("main",), 32, 8, True, None,
                                  ckpt).done.any()
        assert H._TileSweeper(("main",), 32, 8, True, None, ckpt,
                              ckpt_extra=foreign).done.all()
        b = mod._TileSweeper(("main",), 32, 8, True, None, ckpt)
        b.done[:] = True
        b.save_ckpt()
        assert not H._TileSweeper(("main",), 32, 8, True, None, ckpt,
                                  ckpt_extra=foreign).done.any()
        assert H._TileSweeper(("main",), 32, 8, True, None, ckpt).done.all()


def test_stale_symmetrized_flag_is_dropped(tmp_path):
    sdir, ckpt = str(tmp_path / "scores"), str(tmp_path / "ckpt.npz")
    flag = os.path.join(sdir, "symmetrized.flag")
    fs1, fs2 = _fs(seed=0), _fs(seed=1)
    H.run_pairwise(MaxProd(), _ragged(fs1), N, scores_dir=sdir,
                   checkpoint_path=ckpt, device="cpu")
    assert os.path.exists(flag)
    # a fresh ledger over the reused scores_dir, other descriptors: the
    # result is a fresh sweep's, not the old upper triangle
    os.remove(ckpt)
    D = H.run_pairwise(MaxProd(), _ragged(fs2), N, scores_dir=sdir,
                       checkpoint_path=ckpt, device="cpu")["main"]
    np.testing.assert_array_equal(D, _plain(fs2))
    # a completed resume keeps the flag and scores nothing
    alg = MaxProd()
    D = H.run_pairwise(alg, _ragged(fs2), N, scores_dir=sdir,
                       checkpoint_path=ckpt, device="cpu")["main"]
    assert os.path.exists(flag) and alg.calls == 0
    np.testing.assert_array_equal(D, _plain(fs2))
    # skip_symmetrize leaves the upper triangle to a later pass
    D = H.run_pairwise(MaxProd(), _ragged(fs2), N, device="cpu",
                       skip_symmetrize=True)["main"]
    assert not D[np.triu_indices(N, 1)].any()


def test_scores_dir_of_another_corpus_raises(tmp_path):
    sdir = str(tmp_path / "scores")
    H.run_pairwise(MaxProd(), _ragged(_fs()), N, scores_dir=sdir,
                   device="cpu")
    with pytest.raises(ValueError, match="fresh one"):
        H.run_pairwise(MaxProd(), _ragged(_fs(N - 1)), N - 1,
                       scores_dir=sdir, device="cpu")


def test_bucket_truncation_keeps_valid_zero_frames():
    rng = np.random.default_rng(0)
    n, L = 8, 200
    feats = rng.random((n, L, 4)).astype(np.float32)
    feats[:, 150:] = 0.0            # valid frames 150..199 are zero
    for desc in ({"vec": feats, "length": np.full(n, L, np.int32)},
                 {"vec": torch.from_numpy(feats),
                  "length": torch.full((n,), L, dtype=torch.int32)}):
        (bucket,) = H._split_desc_buckets(desc, np.array([0, n]))
        assert bucket["vec"].shape[1] == L
    # without a length key the zero tail goes, rounded up to 64
    (bucket,) = H._split_desc_buckets({"vec": torch.from_numpy(feats)},
                                      np.array([0, n]))
    (jax_bucket,) = JH._split_desc_buckets({"vec": feats}, np.array([0, n]))
    assert bucket["vec"].shape == jax_bucket["vec"].shape == (n, 192, 4)


def test_bucket_split_matches_jax():
    fs = _fs()
    desc = _ragged(fs)
    edges = H._bucket_edges(N, 3, TILE)
    np.testing.assert_array_equal(edges, JH._bucket_edges(N, 3, TILE))
    for got, want in zip(H._split_desc_buckets(desc, edges, round_to=8),
                         JH._split_desc_buckets(desc, edges, round_to=8)):
        for k in want:
            np.testing.assert_array_equal(got[k], want[k])


@pytest.mark.parametrize("engine", ["streamed", "bucketed_streamed",
                                    "hybrid"])
def test_completed_resume_streams_nothing(tmp_path, engine, monkeypatch):
    fs = _fs()
    ckpt = str(tmp_path / "ledger.npz")
    want, _ = _run(engine, "port", tmp_path, fs, ckpt)
    uploads = []
    real, staged = H._upload, H._TileStager.block
    monkeypatch.setattr(H, "_upload",
                        lambda d, dev: uploads.append(1) or real(d, dev))
    monkeypatch.setattr(H._TileStager, "block",
                        lambda st, i: uploads.append(1) or staged(st, i))
    got, calls = _run(engine, "port", tmp_path, fs, ckpt)
    assert uploads == [] and calls == 0
    np.testing.assert_array_equal(got, want)


def test_tile_filter_and_full_scores(tmp_path):
    fs = _fs()
    alg = MaxProd()
    D = H.run_pairwise(alg, _ragged(fs), N, device="cpu",
                       tile_filter=lambda ti, tj: ti == tj,
                       skip_symmetrize=True)["main"]
    assert alg.calls == -(-N // TILE)
    blocks = np.arange(N) // TILE
    np.testing.assert_array_equal(D != 0, np.tril(
        blocks[:, None] == blocks[None], -1))

    class Full(MaxProd):
        def full_scores(self, desc, device):
            assert desc["vec"].dtype == torch.float32
            assert torch.device(device) == desc["vec"].device
            return {"main": torch.ones(N, N)}

    store = _store(tmp_path, fs, quant="int8")
    D = H.run_pairwise(Full(), store, N, device="cpu")["main"]
    np.testing.assert_array_equal(D, 1 - np.eye(N, dtype=np.float32))


def test_benchmark_buckets_match_jax(tmp_path):
    """benchmark(n_buckets=3) == the JAX package's, stats and CSV rows, on
    Serra09 over a planted corpus; the stage times are recorded."""
    from acoss_tpu.benchmarking.harness import benchmark as jax_benchmark
    from acoss_tpu.data import make_synthetic_dataset

    fs = make_synthetic_dataset(n_cliques=5, clique_size=2, seed=9,
                                base_duration=30.0)
    times = {}
    got = H.benchmark(Serra09(), fs, n_buckets=3, device="cpu",
                      results_csv=str(tmp_path / "port.csv"), times=times)
    want = jax_benchmark(JaxSerra09(), fs, n_buckets=3,
                         results_csv=str(tmp_path / "jax.csv"))
    assert {k: dataclasses.asdict(v) for k, v in got.items()} == \
        {k: dataclasses.asdict(v) for k, v in want.items()}
    assert (tmp_path / "port.csv").read_text() == \
        (tmp_path / "jax.csv").read_text()
    assert sorted(times) == ["eval", "extract", "sweep"]
    assert all(s.map > 0.9 for s in got.values())


@pytest.fixture(scope="module")
def lazy_serra(tmp_path_factory):
    """A Serra09 int8 bucketed sweep streamed from per-bucket stores by
    the port, then by the JAX package on the same stores."""
    tmp = tmp_path_factory.mktemp("lazy")
    kw = dict(n_cliques=3, clique_size=3, n_distractors=3,
              base_duration=30.0)
    fs = LazySyntheticCorpus(**kw).subset(np.arange(12))
    jax_fs = JaxLazy(**kw).subset(np.arange(12))
    sd = str(tmp / "stream")
    stream = dict(n_buckets=2, stream_dir=sd, stream_quant="int8",
                  stream_min_bytes=1024, return_desc=True, return_perm=True)
    Ds, desc, perm = H.run_pairwise_bucketed(Serra09(), fs, device="cpu",
                                             **stream)
    jax_Ds, jax_desc, jax_perm = JH.run_pairwise_bucketed(
        JaxSerra09(), jax_fs, scores_dir=str(tmp / "jax_scores"), **stream)
    return fs, sd, (Ds, desc, perm), (jax_Ds, jax_desc, jax_perm)


def test_serra09_bucketed_int8_stream_matches_jax(lazy_serra):
    fs, sd, (Ds, desc, perm), (jax_Ds, jax_desc, jax_perm) = lazy_serra
    np.testing.assert_array_equal(perm, jax_perm)
    b0 = os.listdir(os.path.join(sd, "desc", "bucket_0000"))
    assert "chroma@qscale.npy" in b0 and "mfcc@qscale.npy" in b0
    assert sorted(Ds) == sorted(jax_Ds) == sorted(Serra09.SIMILARITY_TYPES)
    for k in Ds:
        assert isinstance(Ds[k], np.memmap)
        np.testing.assert_array_equal(Ds[k], jax_Ds[k], err_msg=k)
        assert (np.asarray(Ds[k])[np.tril_indices(12, -1)] > 0).mean() > 0.9
    assert sorted(desc) == sorted(jax_desc)
    for k in desc:
        np.testing.assert_array_equal(desc[k], jax_desc[k])


def test_serra09_bucketed_equals_plain_sweep_of_its_stores(lazy_serra):
    """The bucketed sweep scores exactly what the plain sweep scores on
    the same dequantized descriptors in the same (sorted) order: the tile
    path ignores trailing zero padding, on both sides of a cross-bucket
    tile."""
    from acoss_tpu_torch.data.descstore import DescriptorStore

    fs, sd, (Ds, _, perm), _ = lazy_serra
    buckets = [upcast_stream({k: torch.from_numpy(np.array(v)) for k, v in
                              DescriptorStore.open(os.path.join(
                                  sd, "desc", f"bucket_{b:04d}")).items()})
               for b in range(2)]
    merged = H._merge_bucket_descs(buckets, np.arange(12))
    want = H.run_pairwise(Serra09(), merged, 12, device="cpu")
    for k in Ds:
        np.testing.assert_array_equal(Ds[k], want[k], err_msg=k)


def test_cli_stream_modes_on_cpu(tmp_path, monkeypatch, capsys):
    """--stream-dir (int8 store, then its reuse), with --n_buckets and with
    --hybrid-panel: identical retrieval rows; a full_scores algorithm is
    refused."""
    from acoss_tpu_torch.data import make_synthetic_dataset

    make_synthetic_dataset(n_cliques=4, clique_size=2, seed=1,
                           base_duration=30.0).save(str(tmp_path / "s.npz"))
    monkeypatch.chdir(tmp_path)
    base = ["benchmark", "-a", "Serra09", "-d", "s.npz", "--device", "cpu"]
    runs = {
        "plain": [],
        "stream": ["--stream-dir", "sd", "--stream-int8"],
        "reuse": ["--stream-dir", "sd", "--stream-int8"],
        "buckets": ["--stream-dir", "sb", "--n_buckets", "2", "-t", "4",
                    "--stream-chunk", "3"],
        "hybrid": ["--stream-dir", "sh", "--hybrid-panel", "16",
                   "--no-panel-prefetch", "--no-checkpoint"],
    }
    rows = {}
    for name, extra in runs.items():
        assert cli.main(base + ["-s", name] + extra) == 0
        rows[name] = (tmp_path / f"results_{name}.csv").read_text()
    out = capsys.readouterr().out
    assert "reusing descriptor store sd/desc" in out
    assert len(set(rows.values())) == 1
    assert os.path.exists(tmp_path / "sb" / "desc" / "bucket_0001")
    # a full-precision run refuses an int8 store (here with its bulk keys
    # quantized; the CLI keeps the 64 KB a song threshold)
    from acoss_tpu_torch.data import FeatureSet

    extract_streamed(Serra09(), FeatureSet.load("s.npz"), "sq/desc",
                     quant="int8", half_min_bytes=1024, device="cpu")
    with pytest.raises(ValueError, match="int8-quantized"):
        cli.main(base + ["-s", "x", "--stream-dir", "sq"])
    assert cli.main(base + ["-s", "q", "--stream-dir", "sq",
                            "--stream-int8"]) == 0

    class Full(Serra09):
        def full_scores(self, desc):
            raise AssertionError("not reached")

    monkeypatch.setitem(cli_algorithms(), "Serra09", Full)
    assert cli.main(base + ["-s", "x", "--stream-dir", "sf"]) == 1
    assert "does not support --stream-dir" in capsys.readouterr().err


def cli_algorithms() -> dict:
    from acoss_tpu_torch.benchmarking.algorithms import ALL_ALGORITHMS

    return ALL_ALGORITHMS
