"""The frozen generator renders the program's songs draw for draw, and
the reference's width and int8 rule agree with the program's store."""

import os
import sys

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__)))))

from portbench.data.synthetic import (FEATURES, DatacosCorpus,  # noqa: E402
                                      Renderer, covers80)
from portbench.reference import serra09 as ref  # noqa: E402


def _same(fs, songs):
    for i, s in enumerate(songs):
        for k in FEATURES:
            n = fs.length(k)[i]
            assert np.array_equal(fs.feature(k)[i, :n], s[k]), (i, k)


def test_covers80_is_make_synthetic_dataset():
    from acoss_tpu_torch.data import make_synthetic_dataset

    fs = make_synthetic_dataset(n_cliques=3, clique_size=2, n_states=6,
                                base_duration=30.0, beat_period=5.0,
                                seed=3000000061)
    songs, labels = covers80(3, 2, 6, 30.0, 5.0, 3000000061)
    _same(fs, songs)
    assert list(fs.labels) == labels


def test_datacos_is_lazy_synthetic_corpus():
    from acoss_tpu_torch.data import LazySyntheticCorpus

    kw = dict(n_cliques=2, clique_size=3, n_distractors=2, n_states=6,
              base_duration=30.0, beat_period=5.0, seed=3000000067)
    lazy = LazySyntheticCorpus(**kw)
    ours = DatacosCorpus(**kw)
    idx = np.arange(ours.n_songs)
    with Renderer(2) as r:
        songs = r.songs(ours, idx, FEATURES)
    _same(lazy.subset(idx), songs)
    assert list(lazy.labels) == list(ours.labels)
    assert [ours.frames(*ours.locate(i)) for i in idx] == \
        [s["hpcp"].shape[0] for s in songs]
    # a further cover renders alone, the same as from the program
    far = ours.member(1, 7)
    assert far["hpcp"].shape[0] == ours.frames(1, 7)


def test_int8_round_trip_is_the_stores():
    from acoss_tpu_torch.data.descstore import quantize_int8

    v = np.random.default_rng(3).normal(size=(3, 5, 4)).astype(np.float32)
    v[1] = 0.0
    q, s = quantize_int8(v)
    assert np.array_equal(ref.quantize_int8(v),
                          q.astype(np.float32) * s[:, None, None])


def test_padded_width():
    assert ref.padded_width([40 * 64]) == 64
    assert ref.padded_width([40 * 64 + 1, 10]) == 128


def test_every_seed_gets_the_configured_width():
    """A seed whose first corpus has another padded width draws the next
    one of its sequence; a seed whose first fits keeps it."""
    from portbench.corpus import Corpus

    corpus = {"kind": "datacos", "n_cliques": 2, "clique_size": 2,
              "n_distractors": 1, "n_states": 4, "base_duration": 640.0,
              "beat_period": 30.0}
    first = {s: Corpus({"corpus": dict(corpus, width=None)}, s).width
             for s in range(3000000071, 3000000101)}
    assert len(set(first.values())) > 1          # the widths do vary
    want = max(set(first.values()), key=list(first.values()).count)
    for s, w in first.items():
        c = Corpus({"corpus": dict(corpus, width=want)}, s)
        assert c.width == want
        if w == want:
            assert c.lazy.seed == s
        else:
            assert c.lazy.seed != s
