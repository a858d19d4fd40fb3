"""The port's process-sharded sweep (`acoss_tpu_torch.parallel`) against
the JAX package on the CPU: the block-row schedule, shards merged equal to
the unsharded sweep (`.npz`, memmap and hybrid-panel partials), partials
crossing between the packages both ways, the one-shot-scorer rule, and the
CLI's shard-set validation."""

from tests import _torch_threads  # noqa: F401  (caps thread pools)

import shutil

import numpy as np
import pytest

from acoss_tpu.benchmarking.algorithms import Serra09 as JaxSerra09
from acoss_tpu.data import make_synthetic_dataset
from acoss_tpu.parallel import distributed as jax_distributed
from acoss_tpu_torch import cli
from acoss_tpu_torch.benchmarking.algorithms import FTM2D, Serra09
from acoss_tpu_torch.benchmarking.harness import (run_pairwise,
                                                  run_pairwise_hybrid)
from acoss_tpu_torch.data import FeatureSet
from acoss_tpu_torch.data.descstore import extract_streamed
from acoss_tpu_torch.parallel import (assign_block_rows, merge_partials,
                                      run_process_shard,
                                      run_process_shard_hybrid)


@pytest.fixture(scope="module")
def corpus():
    """The JAX package's descriptors of a seeded corpus (both packages
    sweep the same arrays) and the port's unsharded sweep of them."""
    jfs = make_synthetic_dataset(n_cliques=6, clique_size=2, seed=4)
    fs = FeatureSet(jfs.features, jfs.lengths, jfs.labels, jfs.track_ids)
    desc = {k: np.asarray(v) for k, v in JaxSerra09(
        chroma_type="hpcp", downsample_fac=4).extract_descriptors(
            jfs).items()}
    full = run_pairwise(_algo(), desc, fs.n_songs, tile=4, device="cpu")
    return fs, desc, full


def _algo():
    return Serra09(chroma_type="hpcp", downsample_fac=4)


@pytest.mark.parametrize("n_tiles,nproc,symmetric",
                         [(3, 3, True), (10, 4, True), (7, 3, False),
                          (2, 4, True)])
def test_assign_block_rows_matches_jax(n_tiles, nproc, symmetric):
    got = assign_block_rows(n_tiles, nproc, symmetric)
    want = jax_distributed.assign_block_rows(n_tiles, nproc, symmetric)
    assert [r.tolist() for r in got] == [r.tolist() for r in want]
    assert sorted(np.concatenate(got).tolist()) == list(range(n_tiles))


@pytest.mark.parametrize("memmap", [False, True])
def test_shards_merge_to_unsharded_sweep(tmp_path, corpus, memmap):
    """3 shards x file merge == the single-process sweep, with .npz
    partials and with directories of .npy memmaps."""
    fs, desc, full = corpus
    paths = [run_process_shard(_algo(), desc, fs.n_songs, p, 3,
                               str(tmp_path), tile=4, memmap_scores=memmap,
                               device="cpu") for p in range(3)]
    assert all(p.endswith(".npz") != memmap for p in paths)
    merged = merge_partials(paths, symmetric=True,
                            out_dir=str(tmp_path / "merged") if memmap
                            else None)
    for k in full:
        np.testing.assert_array_equal(np.asarray(merged[k]), full[k],
                                      err_msg=k)


def test_hybrid_shards_merge_to_unsharded_hybrid(tmp_path, corpus):
    """Whole panels shared over 3 processes from one disk store merge to
    the unsharded hybrid sweep of the same store."""
    fs, _, _ = corpus
    store = extract_streamed(_algo(), fs, str(tmp_path / "desc"),
                             quant="int8", half_min_bytes=256,
                             device="cpu")
    assert any(k.endswith("@qscale") for k in store)
    want = run_pairwise_hybrid(_algo(), store, fs.n_songs, panel_songs=4,
                               tile=2, scores_dir=str(tmp_path / "one"),
                               device="cpu")
    paths = [run_process_shard_hybrid(_algo(), store, fs.n_songs, p, 3,
                                      str(tmp_path / "parts"),
                                      panel_songs=4, tile=2, device="cpu")
             for p in range(3)]
    merged = merge_partials(paths, symmetric=True)
    for k in want:
        np.testing.assert_array_equal(merged[k], np.asarray(want[k]),
                                      err_msg=k)


@pytest.mark.parametrize("writer", ["jax", "torch"])
def test_partials_cross_packages(tmp_path, corpus, writer):
    """Partials written by one package merge in the other: the JAX
    package's .npz partials in the port's merge, the port's memmap
    partials in the JAX package's merge; both equal the port's sweep
    within the tolerance the two Serra09 sweeps are held to."""
    fs, desc, full = corpus
    if writer == "jax":
        jalgo = JaxSerra09(chroma_type="hpcp", downsample_fac=4)
        paths = [jax_distributed.run_process_shard(
            jalgo, desc, fs.n_songs, p, 3, str(tmp_path), tile=4)
            for p in range(3)]
        merged = merge_partials(paths, symmetric=True)
    else:
        paths = [run_process_shard(_algo(), desc, fs.n_songs, p, 3,
                                   str(tmp_path), tile=4,
                                   memmap_scores=True, device="cpu")
                 for p in range(3)]
        merged = jax_distributed.merge_partials(paths, symmetric=True)
    assert sorted(merged) == sorted(full)
    for k in full:
        np.testing.assert_allclose(np.asarray(merged[k]), full[k], rtol=0,
                                   atol=1e-6, err_msg=k)


def test_one_shot_scorer_is_process_zeros(tmp_path, corpus):
    """A `full_scores` algorithm has no tiles: process 0 writes the whole
    matrix, the others an empty partial, and the merge is the matrix."""
    fs, _, _ = corpus
    algo = FTM2D()
    desc = algo.extract_descriptors(fs, device="cpu")
    want = run_pairwise(algo, desc, fs.n_songs, device="cpu")
    paths = [run_process_shard(algo, desc, fs.n_songs, p, 3, str(tmp_path),
                               device="cpu") for p in range(3)]
    for p in paths[1:]:
        with np.load(p) as z:
            assert z.files == []
    merged = merge_partials(paths, symmetric=algo.SYMMETRIC)
    for k in want:
        np.testing.assert_array_equal(merged[k], want[k])


@pytest.fixture(scope="module")
def shard_parts(corpus, tmp_path_factory):
    """Three CLI shard processes' partials of the corpus, made once."""
    fs, _, _ = corpus
    d = tmp_path_factory.mktemp("shards")
    fs.save(str(d / "fs.npz"))
    base = ["benchmark", "-a", "Serra09", "-d", str(d / "fs.npz"), "-s",
            "sh", "-t", "4", "--device", "cpu", "--cachedir",
            str(d / "cache")]
    for p in range(3):
        assert cli.main(base + ["--num-processes", "3", "--process-id",
                                str(p), "--partial-dir",
                                str(d / "parts")]) == 0
    return d, base


@pytest.fixture
def shard_cli(shard_parts, tmp_path, monkeypatch):
    """A fresh copy of the shard partials under tmp_path/parts."""
    d, base = shard_parts
    shutil.copytree(d / "parts", tmp_path / "parts")
    monkeypatch.chdir(tmp_path)
    return tmp_path, base


def test_cli_shards_merge(shard_cli, capsys):
    """The CLI's shards and merge report the unsharded benchmark's MAP."""
    tmp_path, base = shard_cli
    capsys.readouterr()
    assert cli.main(base + ["--merge", "--partial-dir", "parts"]) == 0
    merged = capsys.readouterr().out
    assert "merging 3 partials" in merged
    assert cli.main(base + ["--no-checkpoint"]) == 0
    plain = capsys.readouterr().out

    def maps(out):
        return sorted(ln for ln in out.splitlines()
                      if ln.startswith("Serra09_"))
    assert maps(merged) == maps(plain) and len(maps(plain)) == 4


@pytest.mark.parametrize("case", ["one_based_id", "missing_shard",
                                  "mixed_nproc", "unrecognized_name",
                                  "no_partials"])
def test_cli_shard_validation(shard_cli, case):
    """Bad shard input makes the CLI return 1 instead of merging a wrong
    matrix or failing deep in the schedule."""
    tmp_path, base = shard_cli
    parts = tmp_path / "parts"
    if case == "one_based_id":
        args = ["--num-processes", "3", "--process-id", "3"]
    else:
        if case == "missing_shard":
            (parts / "Serra09_part_1_3.npz").unlink()
        elif case == "mixed_nproc":
            shutil.copy(parts / "Serra09_part_0_3.npz",
                        parts / "Serra09_part_0_4.npz")
        elif case == "unrecognized_name":
            shutil.copy(parts / "Serra09_part_0_3.npz",
                        parts / "Serra09_part_0_3_old.npz")
        elif case == "no_partials":
            parts = tmp_path / "empty"
        args = ["--merge", "--partial-dir", str(parts)]
    assert cli.main(base + args) == 1
