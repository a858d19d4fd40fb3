"""Set-up shared by the drivers: the configuration's algorithm, its corpus
rendered from the seed, the program's descriptors of it, and the
reference's view of the same songs.

A configuration file names the algorithm and its parameters, the corpus
geometry (`covers80`, or `datacos` rendered song by song on several host
cores) and, for a disk store, the store's parameters. The program gets the
rendered songs as its own `FeatureSet`; the reference gets the same raw
arrays.
"""

from __future__ import annotations

import os

import numpy as np

from portbench.data.synthetic import Renderer, DatacosCorpus, covers80
from portbench.reference import serra09 as ref

#: the raw features the two configurations read
KEYS = ("hpcp", "mfcc_htk")


def algorithm(config: dict):
    """The program's algorithm object the configuration names."""
    from acoss_tpu_torch.benchmarking.algorithms import ALL_ALGORITHMS

    return ALL_ALGORITHMS[config["algorithm"]](**config["params"])


def feature_set(songs: list, labels):
    """The program's FeatureSet of rendered songs."""
    from acoss_tpu_torch.data.store import FeatureSet

    labels = np.asarray(labels)
    ids = [f"{lab}/S_{i}" for i, lab in enumerate(labels)]
    return FeatureSet.from_songs(songs, labels, ids, ragged_features=KEYS)


def render_workers() -> int:
    return min(8, os.cpu_count() or 1)


class Corpus:
    """The configuration's corpus for one seed: song count, labels, raw
    songs on request, and the reference's padded descriptor width.

    The configuration states the corpus's padded width (`width`, rows):
    the longest song sets it, so a seed whose songs would give another
    width (the longest song past 512 rows, or none past 448: about one
    seed in 40) draws the next corpus of its own seeded sequence, and
    every run does the same work a tile."""

    def __init__(self, config: dict, seed: int):
        c = dict(config["corpus"])
        self.kind = c.pop("kind")
        want = c.pop("width", None)
        for k in range(64):
            self._draw(c, seed if k == 0 else int(np.random.SeedSequence(
                [seed, 6151, k]).generate_state(1, np.uint64)[0] >> 1))
            if want is None or self.width == want:
                return
        raise ValueError(f"no corpus of width {want} in 64 draws of seed "
                         f"{seed}")

    def _draw(self, c: dict, seed: int) -> None:
        if self.kind == "covers80":
            self.songs, self.labels = covers80(seed=seed, keys=KEYS, **c)
            self.n_songs = len(self.songs)
            self.frames = [s["hpcp"].shape[0] for s in self.songs]
            self.lazy = None
        elif self.kind == "datacos":
            self.lazy = DatacosCorpus(seed=seed, **c)
            self.n_songs = self.lazy.n_songs
            self.labels = self.lazy.labels
            self.frames = [self.lazy.frames(*self.lazy.locate(i))
                           for i in range(self.n_songs)]
            self.songs = None
        else:
            raise ValueError(f"unknown corpus kind {self.kind!r}")
        # the reference's width, worked out from the song lengths alone
        self.width = ref.padded_width(self.frames)

    def raw(self, idx, renderer: Renderer | None = None) -> list:
        """The raw songs `idx` (dicts of hpcp and mfcc_htk)."""
        if self.songs is not None:
            return [self.songs[int(i)] for i in idx]
        if renderer is None:
            renderer = Renderer(1)
        return renderer.songs(self.lazy, idx, KEYS)


class ProgramCorpus:
    """The `n_songs` / `subset(idx)` view `descstore.extract_streamed`
    reads: each subset is rendered on the renderer's cores into the
    program's FeatureSet, and the next chunk is rendered while the program
    extracts this one."""

    def __init__(self, corpus: Corpus, renderer: Renderer):
        self.corpus = corpus
        self.renderer = renderer
        self.n_songs = corpus.n_songs
        self._next = None

    def subset(self, idx):
        idx = np.asarray(idx)
        if self._next is not None and np.array_equal(self._next[0], idx):
            songs = self._next[1]()
        else:
            songs = self.corpus.raw(idx, self.renderer)
        self._next = None
        nxt = np.arange(idx[-1] + 1, min(idx[-1] + 1 + len(idx),
                                         self.n_songs))
        if len(nxt):
            later = self.renderer.songs_later(self.corpus.lazy, nxt, KEYS)
            if later is not None:
                self._next = (nxt, later)
        return feature_set(songs, self.corpus.labels[idx])


def streamed_store(run, algo, corpus: Corpus) -> dict:
    """The program's int8 descriptor store of the corpus, written under
    the run's scratch directory by `descstore.extract_streamed`; returns
    its read-only memmaps."""
    from acoss_tpu_torch.data.descstore import extract_streamed

    store = run.config["store"]
    with Renderer(render_workers()) as renderer:
        return extract_streamed(
            algo, ProgramCorpus(corpus, renderer),
            os.path.join(run.workdir, "store"),
            chunk_songs=store["chunk_songs"], quant=store["quant"],
            half_min_bytes=store["quant_min_bytes"], device=run.device)


def reference_descriptors(run, corpus: Corpus, idx, int8: bool,
                          songs: list | None = None) -> dict:
    """The reference's descriptors of songs `idx` (or of the given raw
    `songs`) at the corpus width; with `int8`, the keys the store's rule
    quantizes go through its int8 round trip."""
    params = run.config["params"]
    if songs is None:
        songs = corpus.raw(idx)
    keys = ()
    if int8:
        # the store quantizes a float32 key of at least quant_min_bytes a
        # song (chroma 12 and mfcc 13 floats a row)
        least = run.config["store"]["quant_min_bytes"]
        keys = tuple(k for k, d in (("chroma", 12), ("mfcc", 13))
                     if 4 * d * corpus.width >= least)
    return ref.descriptors(
        songs, corpus.width, run.device,
        ssms=bool(params.get("do_ssms", False)),
        m=params.get("m", 9), ssm_win_mul=params.get("ssm_win_mul", 2),
        ssm_res=params.get("ssm_res", 64), int8=keys)


def reference_tile(run, row: dict, col: dict, dtype=None) -> dict:
    """The reference's scores of every pair of a tile, as host arrays."""
    import torch

    params = run.config["params"]
    if run.config["algorithm"] == "EarlySNF":
        out = ref.early_snf_tile(row, col, params.get("kappa", 0.095),
                                 params.get("m", 9),
                                 params.get("snf_niters", 3),
                                 params.get("sequential", True))
    else:
        out = ref.serra09_tile(row, col, params.get("kappa", 0.095),
                               params.get("m", 9),
                               dtype or torch.float32)
    return {k: v.cpu().numpy() for k, v in out.items()}


def take(desc: dict, idx) -> dict:
    """Rows `idx` of every descriptor tensor."""
    import torch

    t = None
    out = {}
    for k, v in desc.items():
        if t is None or t.device != v.device:
            t = torch.as_tensor(np.asarray(idx), device=v.device)
        out[k] = v[t]
    return out
