"""The port's coverstats layer (`acoss_tpu_torch.analytics`) against the
JAX package on the CPU: the same seeded corpus through both packages' key
and tempo tables, persistence functions, onset studies, shape DNA and the
whole `run_coverstats` (summary.json and every CSV), plus the port's CLI
and its refusal to skip figures silently."""

from tests import _torch_threads  # noqa: F401  (caps thread pools)

import csv
import json
import sys

import numpy as np
import pytest

from acoss_tpu import analytics as jax_analytics
from acoss_tpu.data import make_synthetic_dataset
from acoss_tpu_torch import analytics, cli
from acoss_tpu_torch.data import FeatureSet

DNA_KW = dict(downsample_fac=4, m=5, dim=64, neigs=10)
TAGS = {"a": [[("rock", 0.9), ("pop", 0.5)], [("rock", 0.8)]],
        "b": [[("jazz", 0.9)], [("jazz", 0.7), ("blues", 0.3)]],
        "c": [[("rock", 0.9)], [("jazz", 0.9)]]}


@pytest.fixture(scope="module")
def datasets():
    jfs = make_synthetic_dataset(n_cliques=6, clique_size=2, seed=9)
    return jfs, FeatureSet(jfs.features, jfs.lengths, jfs.labels,
                           jfs.track_ids)


def _assert_records_equal(got, df, atol=1e-9):
    """A port Table against the JAX package's DataFrame: same columns in
    order, same index, equal strings, floats within `atol`."""
    assert list(got.columns) == list(df.columns)
    assert got.index == [str(i) for i in df.index]
    for c in df.columns:
        want = df[c].tolist()
        if isinstance(want[0], str):
            assert got[c] == want, c
        else:
            np.testing.assert_allclose(np.asarray(got[c], float), want,
                                       rtol=0, atol=atol, err_msg=c)


def test_key_table_and_stats_match_jax(datasets):
    jfs, fs = datasets
    got, want = analytics.key_table(fs), jax_analytics.key_table(jfs)
    assert len(got) == len(want) == 6
    _assert_records_equal(got, want)
    for conf in (-1.0, 0.75):
        a = analytics.key_stats(got, min_confidence=conf)
        b = jax_analytics.key_stats(want, min_confidence=conf)
        assert a.keys() == b.keys()
        for k in a:
            np.testing.assert_array_equal(a[k], b[k], err_msg=k)


def test_tempo_table_and_stats_match_jax(datasets):
    jfs, fs = datasets
    got = analytics.tempo_table(fs, device="cpu")
    want = jax_analytics.tempo_table(jfs)
    _assert_records_equal(got, want)
    a, b = analytics.tempo_stats(got), jax_analytics.tempo_stats(want)
    assert a["n_pairs"] == b["n_pairs"] == 6
    for k in ("ratios", "q25", "q50", "q75"):
        np.testing.assert_allclose(a[k], b[k], rtol=0, atol=1e-9,
                                   err_msg=k)


def test_tag_stats_match_jax():
    assert analytics.tag_f_measure(TAGS["a"][0], TAGS["a"][1]) == \
        pytest.approx(2 / 3)
    assert analytics.tag_f_measure([], [("x", 1.0)]) == np.inf
    a, b = analytics.tag_stats(TAGS), jax_analytics.tag_stats(TAGS)
    np.testing.assert_array_equal(a["true_pairs"], b["true_pairs"])
    np.testing.assert_array_equal(a["false_pairs"], b["false_pairs"])
    assert a["ks"].statistic == b["ks"].statistic
    assert a["ks"].pvalue == b["ks"].pvalue


def test_persistence_functions_match_jax(datasets):
    jfs, _ = datasets
    x = np.array([2.0, 0.0, 1.5, 0.5, 3.0])
    dgm = analytics.lower_star_persistence(x)
    np.testing.assert_allclose(dgm[np.argsort(dgm[:, 0])],
                               [[0.0, 3.0], [0.5, 1.5]])
    rng = np.random.default_rng(0)
    for y in (rng.standard_normal(200), np.cumsum(rng.standard_normal(300))):
        for inf in (True, False):
            np.testing.assert_allclose(
                analytics.lower_star_persistence(y, inf),
                jax_analytics.lower_star_persistence(y, inf), atol=1e-5)
    d = np.array([[0.3, 0.8], [0.4, 0.6]])
    a = analytics.persistence_image(d, [-1, 2, -1, 2], res=0.1)
    b = jax_analytics.persistence_image(d, [-1, 2, -1, 2], res=0.1)
    for k in ("PI", "xr", "yr"):
        np.testing.assert_allclose(a[k], b[k], atol=1e-5, err_msg=k)
    assert a["PI"].sum() == pytest.approx(0.7, abs=0.02)
    ons = jfs.feature("onsets")[0, :jfs.length("onsets")[0], 0]
    np.testing.assert_allclose(analytics.get_onset_means(ons),
                               jax_analytics.get_onset_means(ons),
                               atol=1e-5)
    for quirk in (False, True):
        np.testing.assert_allclose(
            analytics.onset_pi_descriptor(
                ons, reference_quirk_up_for_down=quirk),
            jax_analytics.onset_pi_descriptor(
                ons, reference_quirk_up_for_down=quirk), atol=1e-5)


@pytest.mark.parametrize("study", ["onset_timing_study",
                                   "onset_stdev_study"])
def test_onset_studies_match_jax(datasets, study):
    jfs, fs = datasets
    kw = {"device": "cpu"} if study == "onset_timing_study" else {}
    a = getattr(analytics, study)(fs, **kw)
    b = getattr(jax_analytics, study)(jfs)
    assert a["labels"] == b["labels"] and len(a["labels"]) == 6
    for k in ("Is1", "Is2", "D", "stdevs", "dcover", "dfalse"):
        if k in b:
            np.testing.assert_allclose(a[k], b[k], rtol=0, atol=1e-5,
                                       err_msg=k)
    for k in ("mean_cover", "mean_false"):
        assert a[k] == pytest.approx(b[k], abs=1e-5)
    assert a["ks"].statistic == pytest.approx(b["ks"].statistic, abs=1e-5)
    assert a["mean_cover"] < a["mean_false"]


def test_shape_dna_matches_jax(datasets):
    jfs, fs = datasets
    h = fs.feature("hpcp")[0, :fs.length("hpcp")[0]]
    m = fs.feature("mfcc_htk")[0, :fs.length("mfcc_htk")[0]]
    got = analytics.get_shape_dna(h, m, device="cpu", **DNA_KW)
    want = jax_analytics.get_shape_dna(h, m, **DNA_KW)
    assert got["w"].shape == (11,)
    np.testing.assert_allclose(got["w"], want["w"], rtol=0, atol=1e-4)
    np.testing.assert_allclose(got["W"], want["W"], rtol=0, atol=1e-4)
    idx = np.arange(8)
    a = analytics.shape_dna_study(fs.subset(idx), device="cpu", **DNA_KW)
    b = jax_analytics.shape_dna_study(jfs.subset(idx), **DNA_KW)
    for k in ("ws", "dcover", "dfalse"):
        np.testing.assert_allclose(a[k], b[k], rtol=0, atol=1e-4,
                                   err_msg=k)


def _read_csv(path):
    with open(path, newline="") as f:
        return list(csv.reader(f))


@pytest.fixture(scope="module")
def coverstats_runs(datasets, tmp_path_factory):
    jfs, fs = datasets
    out = tmp_path_factory.mktemp("coverstats")
    tags = {str(lbl): [[["rock", 0.9]], [["rock", 0.8]]]
            for lbl in sorted(set(fs.labels))}
    got = analytics.run_coverstats(fs, str(out / "torch"), pair_tags=tags,
                                   figures=False, device="cpu")
    want = jax_analytics.run_coverstats(jfs, str(out / "jax"),
                                        pair_tags=tags, figures=False)
    return out, got, want


def _close(a, b, atol):
    if isinstance(a, dict):
        assert a.keys() == b.keys()
        for k in a:
            _close(a[k], b[k], atol)
    elif isinstance(a, float) and isinstance(b, float):
        assert a == pytest.approx(b, abs=atol)
    else:
        assert a == b


def test_run_coverstats_summary_matches_jax(coverstats_runs):
    out, got, want = coverstats_runs
    assert set(got["studies"]) == {"key", "tempo", "onset", "stdev",
                                   "shapedna", "tag"}
    with open(out / "torch" / "summary.json") as f:
        assert json.load(f) == got
    _close(got, want, 1e-4)
    for fname in ("onsettiming.npz", "stdevs.npz", "shapedna.npz",
                  "tags.npz"):
        with np.load(out / "torch" / fname) as a, \
                np.load(out / "jax" / fname) as b:
            assert a.files == b.files, fname
            for k in a.files:
                if a[k].dtype.kind == "U":
                    np.testing.assert_array_equal(a[k], b[k])
                else:
                    np.testing.assert_allclose(a[k], b[k], rtol=0,
                                               atol=1e-4, err_msg=k)


@pytest.mark.parametrize("name", ["keys.csv", "tempos.csv", "stdevs.csv"])
def test_coverstats_csvs_match_jax(coverstats_runs, name):
    """The CSVs the port writes without pandas have the header, index
    column and rows of the JAX package's `DataFrame.to_csv`."""
    out, _, _ = coverstats_runs
    got, want = _read_csv(out / "torch" / name), \
        _read_csv(out / "jax" / name)
    assert got[0] == want[0] and got[0][0] == ""
    assert len(got) == len(want) == 7
    for g, w in zip(got[1:], want[1:]):
        assert len(g) == len(w)
        for a, b in zip(g, w):
            try:
                assert float(a) == pytest.approx(float(b), abs=1e-9)
            except ValueError:
                assert a == b


def test_coverstats_cli(datasets, tmp_path):
    _, fs = datasets
    fsp = tmp_path / "fs.npz"
    fs.save(str(fsp))
    out = tmp_path / "out"
    rc = cli.main(["coverstats", "-d", str(fsp), "-o", str(out),
                   "--studies", "tempo,stdev", "--no-figures",
                   "--device", "cpu"])
    assert rc == 0
    for fname in ("tempos.csv", "stdevs.csv", "summary.json"):
        assert (out / fname).exists(), fname
    assert not (out / "TempoRatios.svg").exists()
    assert cli.main(["coverstats", "-d", str(fsp), "-o", str(out),
                     "--studies", "nope", "--device", "cpu"]) == 1
    assert cli.main(["coverstats", "-d", str(fsp), "-o", str(out),
                     "--studies", "tag", "--device", "cpu"]) == 1


def test_figures_without_matplotlib_raise(datasets, tmp_path, monkeypatch):
    """Figures are never skipped silently: without matplotlib, asking for
    them raises an error that names --no-figures, before any study."""
    _, fs = datasets
    monkeypatch.setitem(sys.modules, "matplotlib", None)
    with pytest.raises(ImportError, match="--no-figures"):
        analytics.run_coverstats(fs, str(tmp_path / "o"), studies=("stdev",),
                                 device="cpu")
    assert not (tmp_path / "o").exists()


def test_figures_written_with_matplotlib(datasets, tmp_path):
    _, fs = datasets
    analytics.run_coverstats(fs, str(tmp_path), studies=("tempo", "stdev"),
                             device="cpu")
    assert (tmp_path / "TempoRatios.svg").exists()
    assert (tmp_path / "StdevDistances.svg").exists()
