"""The port's extraction pipeline and `extract` CLI against the JAX
package's on the CPU: `compute_features` and `batch_extract` on a 5-WAV
directory (labels, track ids and lengths equal, arrays within 1e-4 of
their largest magnitude, beat frames and keys equal), the CLI's sharded
extraction plus `--merge-shards` bit-identical to its serial run, its
FeatureSet through the `benchmark` CLI, and the port's copy of the
placeholder-corpus recipe writing the JAX script's bytes."""

from tests import _torch_threads  # noqa: F401  (caps thread pools)

import glob
import importlib.util
import sys
from pathlib import Path

import numpy as np
import pytest

from acoss_tpu.data import manifest as jax_manifest
from acoss_tpu.data.store import concat_feature_sets as jax_concat
from acoss_tpu.features import pipeline as jax_pipeline
from acoss_tpu_torch.cli import main
from acoss_tpu_torch.data import FeatureSet, concat_feature_sets, manifest
from acoss_tpu_torch.features import pipeline
from acoss_tpu_torch.features.audio import save_wav

SR = 44100
REPO = Path(__file__).resolve().parent.parent
TOL = 1e-4


def _song(rng, transpose: int, dur: float = 3.0) -> np.ndarray:
    """A four-triad progression, transposed, over a click every 0.45 s."""
    t = np.arange(int(dur * SR)) / SR
    y = np.zeros_like(t)
    seg = len(t) // 4
    for k, triad in enumerate([(0, 4, 7), (9, 12, 16), (5, 9, 12),
                               (7, 11, 14)]):
        sl = slice(k * seg, (k + 1) * seg)
        for iv in triad:
            f = 196 * 2 ** ((iv + transpose) / 12)
            for h in range(1, 4):
                y[sl] += 0.3 / h * np.sin(2 * np.pi * f * h * t[sl])
    for b in np.arange(0.05, dur, 0.45):
        i = int(b * SR)
        n = min(1000, len(y) - i)
        y[i:i + n] += rng.normal(size=n) * np.exp(-np.arange(n) / 200)
    y += 0.02 * rng.normal(size=y.size)
    return (0.6 * y / np.abs(y).max()).astype(np.float32)


@pytest.fixture(scope="module")
def wav_dir(tmp_path_factory):
    """5 WAVs in 3 clique directories, and a file that is not audio."""
    root = tmp_path_factory.mktemp("audio")
    rng = np.random.default_rng(11)
    for i, (clique, tp) in enumerate([("W_0", 0), ("W_0", 3), ("W_1", 5),
                                      ("W_1", 8), ("W_2", 2)]):
        (root / clique).mkdir(exist_ok=True)
        save_wav(str(root / clique / f"P_{i}.wav"), _song(rng, tp,
                                                        2.5 + 0.5 * i))
    return root


def _paths(wav_dir):
    paths = sorted(glob.glob(str(wav_dir / "**" / "*.wav"), recursive=True))
    return paths, [manifest.label_of(p) for p in paths], \
        [manifest.track_id_of(p) for p in paths]


def _close(got, want):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape and got.dtype == want.dtype
    scale = max(float(np.abs(want).max()), 1e-30)
    assert float(np.abs(got.astype(np.float64) - want).max()) <= TOL * scale


@pytest.fixture(scope="module")
def extracted(wav_dir, tmp_path_factory):
    """Both packages' batch_extract over the directory plus a bad file
    (skipped and logged by both)."""
    paths, labels, ids = _paths(wav_dir)
    bad = tmp_path_factory.mktemp("bad") / "W_9" / "broken.wav"
    bad.parent.mkdir()
    bad.write_bytes(b"not a wav file")
    paths, labels, ids = paths + [str(bad)], labels + ["W_9"], ids + ["x"]
    logs = tmp_path_factory.mktemp("logs")
    port = pipeline.batch_extract(paths, labels, ids,
                                  error_log=str(logs / "port.txt"),
                                  device="cpu")
    ref = jax_pipeline.batch_extract(paths, labels, ids,
                                     error_log=str(logs / "jax.txt"))
    return port, ref, logs


def test_batch_extract_matches_jax(extracted):
    port, ref, logs = extracted
    assert port.n_songs == ref.n_songs == 5
    assert "broken.wav" in (logs / "port.txt").read_text()
    assert "broken.wav" in (logs / "jax.txt").read_text()
    np.testing.assert_array_equal(port.labels, ref.labels)
    np.testing.assert_array_equal(port.track_ids, ref.track_ids)
    assert sorted(port.features) == sorted(ref.features) == \
        ["crema", "hpcp", "mfcc_htk", "novfn", "onsets", "snovfn"]
    assert sorted(port.lengths) == sorted(ref.lengths)
    for k in port.features:
        np.testing.assert_array_equal(port.length(k), ref.length(k))
        if k == "onsets":
            np.testing.assert_array_equal(port.feature(k), ref.feature(k))
        else:
            _close(port.feature(k), ref.feature(k))


def test_compute_features_matches_jax(wav_dir):
    from acoss_tpu_torch.features.audio import load_audio

    paths, _, _ = _paths(wav_dir)
    y = load_audio(paths[2])
    got = pipeline.compute_features(y, device="cpu")
    want = jax_pipeline.compute_features(y)
    assert sorted(got) == sorted(want)
    assert got["key_extractor"]["key"] == want["key_extractor"]["key"]
    assert got["key_extractor"]["scale"] == want["key_extractor"]["scale"]
    assert abs(got["key_extractor"]["strength"]
               - want["key_extractor"]["strength"]) < 1e-4
    for k in ("hpcp", "crema", "mfcc_htk"):
        _close(got[k], want[k])
    gm, wm = got["madmom_features"], want["madmom_features"]
    np.testing.assert_array_equal(gm["onsets"], wm["onsets"])
    np.testing.assert_array_equal(gm["tempos"], wm["tempos"])
    _close(gm["snovfn"], wm["snovfn"])
    # an explicit empty profile extracts nothing
    assert pipeline.compute_features(y, features=[], device="cpu") == {}


def test_compute_features_other_profile_entries(wav_dir):
    from acoss_tpu_torch.features.audio import load_audio

    y = load_audio(_paths(wav_dir)[0][0])[:SR]
    names = ["chroma_stft", "chroma_cqt", "chroma_cens", "mfcc_librosa",
             "chroma_cqt_processed", "cqt_nsg"]
    got = pipeline.compute_features(y, features=names, device="cpu")
    want = jax_pipeline.compute_features(y, features=names)
    assert sorted(got) == sorted(want) == sorted(names)
    for k in names:
        _close(got[k], want[k])


def test_thread_pool_matches_serial(wav_dir):
    paths, labels, ids = _paths(wav_dir)
    feats = ["hpcp", "madmom_features"]
    serial = pipeline.batch_extract(paths[:3], labels[:3], ids[:3],
                                    features=feats, device="cpu")
    pooled = pipeline.batch_extract(paths[:3], labels[:3], ids[:3],
                                    features=feats, n_workers=3,
                                    device="cpu")
    for k in serial.features:
        np.testing.assert_array_equal(serial.feature(k), pooled.feature(k))
    np.testing.assert_array_equal(serial.labels, pooled.labels)


def _assert_fs_equal(a, b):
    assert sorted(a.features) == sorted(b.features)
    np.testing.assert_array_equal(a.labels, b.labels)
    np.testing.assert_array_equal(a.track_ids, b.track_ids)
    for k in a.features:
        np.testing.assert_array_equal(a.feature(k), b.feature(k), err_msg=k)
        np.testing.assert_array_equal(a.length(k), b.length(k), err_msg=k)


def test_cli_cluster_shards_merge_bit_identical(wav_dir, tmp_path, capsys,
                                                monkeypatch):
    full = tmp_path / "full.npz"
    assert main(["extract", "-i", str(wav_dir), "-o", str(full),
                 "--device", "cpu",
                 "--error-log", str(tmp_path / "e.txt")]) == 0
    out = tmp_path / "merged.npz"
    for sid in range(3):
        assert main(["extract", "-i", str(wav_dir), "-o", str(out),
                     "-m", "cluster", "--num-shards", "3",
                     "--shard-id", str(sid), "-n", "2", "--device",
                     "cpu"]) == 0
        assert (tmp_path / f"merged.part_{sid}_3.npz").exists()
    part1 = tmp_path / "merged.part_1_3.npz"
    stash = part1.read_bytes()
    part1.unlink()
    assert main(["extract", "--merge-shards", "-o", str(out)]) == 1
    part1.write_bytes(stash)
    assert main(["extract", "--merge-shards", "-o", str(out)]) == 0
    merged = FeatureSet.load(str(out))
    _assert_fs_equal(FeatureSet.load(str(full)), merged)
    assert merged.n_songs == 5
    assert not (tmp_path / "e.txt").exists()
    # the port's merge equals the JAX package's concat of the same parts
    parts = [FeatureSet.load(str(tmp_path / f"merged.part_{i}_3.npz"))
             for i in range(3)]
    _assert_fs_equal(concat_feature_sets(parts), jax_concat(parts))
    # and its FeatureSet runs through the benchmark CLI
    monkeypatch.chdir(tmp_path)
    capsys.readouterr()
    assert main(["benchmark", "-a", "Serra09", "-d", str(full), "-s",
                 "run", "--device", "cpu", "--no-checkpoint"]) == 0
    printed = capsys.readouterr().out
    assert "Serra09_chroma_qmax: MR=" in printed
    assert (tmp_path / "results_run.csv").exists()


def test_cli_extract_arg_validation(tmp_path):
    assert main(["extract", "-o", str(tmp_path / "x.npz")]) == 1
    assert main(["extract", "-i", str(tmp_path), "-o",
                 str(tmp_path / "x.npz"), "-m", "cluster",
                 "--num-shards", "2", "--shard-id", "2"]) == 1
    assert main(["extract", "--merge-shards",
                 "-o", str(tmp_path / "none.npz")]) == 1
    assert main(["extract", "-i", str(tmp_path), "-o",
                 str(tmp_path / "x.npz")]) == 1      # no audio found


def test_manifest_copy_identical(tmp_path):
    paths = [f"W_{i // 3}/P_{i}.mp3" for i in range(7)]
    for mod, sub in ((manifest, "port"), (jax_manifest, "jax")):
        outs = mod.create_collection_files(paths, str(tmp_path / sub), 3)
        assert [Path(p).name for p in outs] == \
            [f"collections_{i}_3.txt" for i in (1, 2, 3)]
    for i in (1, 2, 3):
        name = f"collections_{i}_3.txt"
        assert (tmp_path / "port" / name).read_bytes() == \
            (tmp_path / "jax" / name).read_bytes()
        assert manifest.read_txt_list(str(tmp_path / "port" / name)) == \
            jax_manifest.read_txt_list(str(tmp_path / "jax" / name))
    assert manifest.subset_paths({"a": ["x", "y"], "b": ["z"]}) == \
        jax_manifest.subset_paths({"a": ["x", "y"], "b": ["z"]})
    for p in paths:
        assert manifest.label_of(p) == jax_manifest.label_of(p)
        assert manifest.track_id_of(p) == jax_manifest.track_id_of(p)
    c32 = tmp_path / "covers32k"
    c32.mkdir()
    (c32 / "list1.list").write_text("a_b/x\nc_d/y\n")
    (c32 / "list2.list").write_text("a_b/z\nc_d/w\n")
    assert manifest.covers80_list(str(c32)) == \
        jax_manifest.covers80_list(str(c32))


def test_concat_feature_sets_copy_bit_equal():
    rng = np.random.default_rng(2)
    sets = [FeatureSet(
        features={"x": rng.random((n, L, 3)).astype(np.float32),
                  "g": rng.random((n, 5)).astype(np.float32)},
        lengths={"x": rng.integers(1, L + 1, n).astype(np.int32)},
        labels=np.array([f"c{i}" for i in range(n)]),
        track_ids=np.array([f"t{n}{i}" for i in range(n)]))
        for n, L in ((2, 4), (1, 7), (3, 2))]
    _assert_fs_equal(concat_feature_sets(sets), jax_concat(sets))
    with pytest.raises(ValueError):
        concat_feature_sets([])


def _load_script(name: str):
    spec = importlib.util.spec_from_file_location(
        name, REPO / "scripts" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    sys.modules[name] = mod
    spec.loader.exec_module(mod)
    return mod


def test_placeholder_recipe_writes_the_jax_scripts_bytes(tmp_path):
    port = _load_script("torch_covers80_placeholder")
    jax_script = _load_script("covers80_parity")
    port.make_placeholder(str(tmp_path / "port"), seed=3, n_cliques=1)
    jax_script.make_placeholder(str(tmp_path / "jax"), seed=3, n_cliques=1)
    files = sorted(p.relative_to(tmp_path / "jax")
                   for p in (tmp_path / "jax").rglob("*") if p.is_file())
    assert len(files) == 4          # two takes and the two lists
    for f in files:
        assert (tmp_path / "port" / f).read_bytes() == \
            (tmp_path / "jax" / f).read_bytes(), f
    paths, labels = port.placeholder_paths(str(tmp_path / "port"))
    assert [Path(p).name for p in paths] == ["take0.wav", "take1.wav"]
    assert labels == ["artist00_song00"] * 2
