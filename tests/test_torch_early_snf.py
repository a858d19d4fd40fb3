"""The port's SNF slice end to end against the JAX package on the CPU:
EarlySNF's descriptors (incl. the ssms corpus), its tile in both
compositions, `benchmark(EarlySNF)`, the throughput mode, the CLI, and
the sweep's padding of a corpus that is not a multiple of the tile.

The corpus is small (8 songs of 36..59 descriptor rows at
downsample_fac=4) but its CRPs are not vacuous: every song is longer than
the 9-frame window and one ssms block."""

from tests import _torch_threads  # noqa: F401  (caps thread pools)

import dataclasses
import functools

import jax
import numpy as np
import pytest
import torch

from acoss_tpu.benchmarking.algorithms import EarlySNF as JaxEarlySNF
from acoss_tpu.benchmarking.algorithms import serra09 as jax_serra09
from acoss_tpu.benchmarking.harness import benchmark as jax_benchmark
from acoss_tpu.data import make_synthetic_dataset
from acoss_tpu.ops import alignment as jax_alignment
from acoss_tpu.ops import ssm_features as jax_ssm_features
from acoss_tpu_torch import cli
from acoss_tpu_torch.benchmarking.algorithms import EarlySNF, Serra09
from acoss_tpu_torch.benchmarking.evaluation import eval_statistics
from acoss_tpu_torch.benchmarking.harness import benchmark, run_pairwise
from acoss_tpu_torch.convert import descriptors_from_numpy
from acoss_tpu_torch.data import FeatureSet
from acoss_tpu_torch.data import \
    make_synthetic_dataset as port_synthetic_dataset

KW = dict(downsample_fac=4, pad_to_multiple=16)
SIM_TYPES = ("chroma_qmax", "chroma_dmax", "mfcc_qmax", "mfcc_dmax",
             "ssms_scatter_qmax", "ssms_scatter_dmax", "snf_qmax",
             "snf_dmax")


@pytest.fixture(scope="module", autouse=True)
def _small_jax_buckets():
    """The JAX package pads each song's MFCCs to a 4096-frame bucket to
    bound its compiles; at downsample_fac=4 that scatters ~1000 blocks a
    song, all but ~40 masked away. A 256-frame bucket (longer than these
    songs) gives the same descriptors at a fraction of the CPU time."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jax_serra09, "build_ssms_device", functools.partial(
            jax_ssm_features.build_ssms_device, l_bucket=256))
        yield


@pytest.fixture(scope="module")
def corpus():
    fs = make_synthetic_dataset(n_cliques=4, clique_size=2, n_states=6,
                                base_duration=30.0, seed=2)
    desc = {k: np.array(v)
            for k, v in JaxEarlySNF(**KW).extract_descriptors(fs).items()}
    return fs, desc


def _np(desc):
    return {k: v.numpy() if isinstance(v, torch.Tensor) else v
            for k, v in desc.items()}


def _stats(Ds, labels):
    return {k: dataclasses.asdict(eval_statistics(D, labels))
            for k, D in Ds.items()}


def test_descriptors_match_jax(corpus):
    fs, want = corpus
    got = EarlySNF(**KW).extract_descriptors(
        FeatureSet(fs.features, fs.lengths, fs.labels, fs.track_ids),
        device="cpu")
    assert sorted(got) == sorted(want)
    assert isinstance(got["ssms"], torch.Tensor)
    got = _np(got)
    for k in ("chroma", "gchroma", "length"):
        np.testing.assert_array_equal(got[k], want[k])
    np.testing.assert_allclose(got["mfcc"], want["mfcc"], rtol=1e-6,
                               atol=1e-6)
    # scattering descriptors: FFTs of another library, float32 rounding
    # relative to the largest coefficient
    np.testing.assert_allclose(got["ssms"], want["ssms"], rtol=0,
                               atol=2e-5 * np.abs(want["ssms"]).max())
    assert 30 <= int(want["length"].min()) and want["chroma"].shape[1] <= 64


def test_tile_both_compositions_match_jax_pallas_interpret(corpus):
    """The kernel path's composition with every kernel's plain version
    (plain=True: one binarizer call over all channels, the kNN mask) and
    the per-pair path give the JAX package's Pallas-path tile (interpret
    mode): CRPs and scores are equal, so the scores agree to the last
    bit of the normalisation. A large leading MFCC term (like HTK's
    energy coefficient) needs the centred mfcc CSM; parity mode (full
    fp32) everywhere."""
    fs, desc = corpus
    desc = dict(desc)
    valid = np.arange(desc["mfcc"].shape[1]) < desc["length"][:, None]
    desc["mfcc"] = desc["mfcc"].copy()
    desc["mfcc"][..., 0] += np.where(valid, 3000.0, 0.0).astype(np.float32)
    rows, cols = slice(0, 4), slice(4, 8)
    prev = jax_alignment.set_alignment_impl("pallas_interpret")
    try:
        want = JaxEarlySNF(**KW).tile_scores(
            jax.device_put({k: v[rows] for k, v in desc.items()}),
            jax.device_put({k: v[cols] for k, v in desc.items()}))
        want = {k: np.asarray(v) for k, v in want.items()}
    finally:
        jax_alignment.set_alignment_impl(prev)
    d = descriptors_from_numpy(desc, "cpu")
    row = {k: v[rows] for k, v in d.items()}
    col = {k: v[cols] for k, v in d.items()}
    assert sorted(want) == sorted(SIM_TYPES)
    for plain in (True, False):
        got = EarlySNF(**KW).tile_scores(row, col, plain=plain)
        assert sorted(got) == sorted(SIM_TYPES)
        for k in SIM_TYPES:
            np.testing.assert_allclose(got[k].numpy(), want[k], rtol=0,
                                       atol=1e-6, err_msg=f"{k} {plain}")
    assert all(want[k].max() > 0 for k in SIM_TYPES)


def test_benchmark_matches_jax(corpus, tmp_path):
    fs, _ = corpus
    times = {}
    got = benchmark(EarlySNF(**KW), fs, results_csv=str(tmp_path / "p.csv"),
                    device="cpu", times=times)
    want = jax_benchmark(JaxEarlySNF(**KW), fs,
                         results_csv=str(tmp_path / "j.csv"))
    assert {k: dataclasses.asdict(v) for k, v in got.items()} == \
        {k: dataclasses.asdict(v) for k, v in want.items()}
    assert (tmp_path / "p.csv").read_text() == \
        (tmp_path / "j.csv").read_text()
    assert got["snf_qmax"].map > 0.9 and got["chroma_qmax"].map > 0.9
    assert sorted(times) == ["eval", "extract", "sweep"]


def test_throughput_mode_keeps_retrieval(corpus):
    """snf_precision='default' rounds the diffusion operands to bf16: the
    snf scores move by bf16 rounding, the retrieval statistics and every
    other channel stay."""
    fs, desc = corpus
    d = descriptors_from_numpy(desc, "cpu")
    hi = run_pairwise(EarlySNF(**KW), d, fs.n_songs, device="cpu")
    lo = run_pairwise(EarlySNF(snf_precision="default", **KW), d,
                      fs.n_songs, device="cpu")
    for k in SIM_TYPES:
        np.testing.assert_allclose(lo[k], hi[k], rtol=0, atol=0.05,
                                   err_msg=k)
        if not k.startswith("snf"):
            np.testing.assert_array_equal(lo[k], hi[k])
    assert _stats(lo, fs.labels) == _stats(hi, fs.labels)
    with pytest.raises(ValueError, match="snf_precision"):
        EarlySNF(snf_precision="fast")


def test_sweep_pads_only_the_last_block(corpus):
    """N = 8 songs swept with tile 3: the last block is zero-padded to a
    full tile; every other block the algorithm sees is a view of the
    corpus (not copied), and the scores equal a sweep whose tile divides
    N."""
    fs, desc = corpus
    d = descriptors_from_numpy(desc, "cpu")
    base = d["ssms"].untyped_storage().data_ptr()
    seen = []

    class Recording(Serra09):
        def tile_scores(self, row, col, plain=False):
            for blk in (row, col):
                seen.append((blk["ssms"].shape[0],
                             blk["ssms"].untyped_storage().data_ptr()
                             == base, int(blk["length"][-1]) == 0))
            return super().tile_scores(row, col, plain)

    algo = Recording(do_ssms=True, **KW)
    got = run_pairwise(algo, d, fs.n_songs, tile=3, device="cpu")
    want = run_pairwise(Serra09(do_ssms=True, **KW), d, fs.n_songs, tile=4,
                        device="cpu")
    for k in want:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    assert all(n == 3 for n, _, _ in seen)
    # blocks 0 and 1 are views; block 2 (songs 6, 7 + one zero song) not
    assert {(view, pad) for _, view, pad in seen} == {(True, False),
                                                      (False, True)}


def test_cli_early_snf_on_cpu(tmp_path, monkeypatch, capsys):
    # the CLI's defaults (downsample_fac=40): 24 x 40 s states make songs
    # of ~24 descriptor rows and ~7 ssms blocks
    fs = port_synthetic_dataset(n_cliques=4, clique_size=2, n_states=24,
                                seed=1, base_duration=40.0)
    fs.save(str(tmp_path / "synth.npz"))
    monkeypatch.chdir(tmp_path)
    rc = cli.main(["benchmark", "-a", "EarlySNF", "-d", "synth.npz", "-s",
                   "snf", "--snf-precision", "default", "--device", "cpu",
                   "--no-checkpoint"])
    assert rc == 0
    assert "results appended to results_snf.csv" in capsys.readouterr().out
    rows = (tmp_path / "results_snf.csv").read_text().splitlines()
    assert [r.split(",")[0] for r in rows[1:]] == [
        f"EarlySNF_{k}" for k in SIM_TYPES]
    assert all(0 < float(r.split(",")[4]) <= 1 for r in rows[1:])   # MAP
    rc = cli.main(["benchmark", "-a", "Serra09", "-d", "synth.npz",
                   "--snf-precision", "default", "--device", "cpu"])
    assert rc == 1
    assert "--snf-precision is not supported by Serra09" in \
        capsys.readouterr().err
