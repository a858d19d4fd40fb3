"""The benchmark's corpus generator: a frozen copy of the port's planted
cover-clique generator (`acoss_tpu_torch.data.synthetic`), numpy only,
so that a later change to the program cannot move the yardstick.

Each clique shares a latent chord / timbre sequence; each performance is a
transposed, time-warped, noisy rendering of it. The same seed renders the
same songs, draw for draw, as the program's generator.

- `covers80`: the covers80 geometry (`make_synthetic_dataset`: one seeded
  stream renders every song in order);
- `DatacosCorpus`: the Da-TACOS geometry (`LazySyntheticCorpus`: cliques
  of 13 plus distractor singletons, each song from its own stream, so any
  subset renders alone and on any core).

Songs come back as dicts of numpy arrays holding the requested features.
"""

from __future__ import annotations

import multiprocessing
from concurrent.futures import ProcessPoolExecutor

import numpy as np

FEATURES = ("hpcp", "crema", "mfcc_htk", "onsets", "novfn", "snovfn")


def _chord_templates(n_chords: int = 24) -> np.ndarray:
    """Major/minor triad templates with harmonic bleed."""
    T = np.zeros((n_chords, 12))
    for root in range(12):
        for q, intervals in enumerate([(0, 4, 7), (0, 3, 7)]):
            row = np.zeros(12)
            for k, iv in enumerate(intervals):
                row[(root + iv) % 12] = 1.0 / (1 + k * 0.3)
            T[root * 2 + q] = row
    return T


def _render_song(rng, states, durations, templates, transposition,
                 tempo_factor, noise, beat_period, tempo_curve):
    """Render a latent chord-state sequence into per-frame features."""
    frames = []
    for s, d in zip(states, durations):
        d = max(1, int(round(d * tempo_factor)))
        chroma = np.roll(templates[s], transposition)
        frames.append(np.tile(chroma, (d, 1)))
    chroma = np.concatenate(frames, axis=0)
    L = chroma.shape[0]
    chroma = chroma + noise * rng.random((L, 12))
    chroma = np.maximum(chroma, 0)
    chroma = chroma / np.maximum(
        np.linalg.norm(chroma, axis=1, keepdims=True), 1e-8)
    onsets = []
    t, k = 1.0, 0
    while t < L - 1:
        onsets.append(t)
        t += beat_period * tempo_factor * tempo_curve[k % len(tempo_curve)]
        k += 1
    onsets = np.round(np.asarray(onsets)
                      + rng.normal(0, 0.3, size=len(onsets)))
    onsets = np.unique(np.clip(onsets, 0, L - 1)).astype(np.int64)
    novfn = np.zeros(L)
    novfn[onsets] = 1.0
    kernel = np.exp(-0.5 * (np.arange(-4, 5) / 1.5) ** 2)
    novfn = np.convolve(novfn, kernel, mode="same")
    novfn = novfn + 0.05 * rng.random(L)
    snovfn = novfn + 0.05 * rng.random(L)
    return chroma.astype(np.float32), onsets, novfn.astype(np.float32), \
        snovfn.astype(np.float32)


def _clique_latents(rng, n_states: int, base_duration: float):
    states = rng.integers(0, 24, size=n_states)
    durations = base_duration * (0.5 + rng.random(n_states))
    raw = rng.normal(0, 1, 64)
    kernel = np.exp(-0.5 * (np.arange(-8, 9) / 4.0) ** 2)
    smooth = np.convolve(raw, kernel / kernel.sum(), mode="same")
    tempo_curve = 1.0 + 0.35 * smooth / max(np.abs(smooth).max(), 1e-9)
    timbre = rng.normal(size=(n_states, 13)).astype(np.float32)
    return states, durations, tempo_curve, timbre


def _member(rng, latents, templates, p, noise, beat_period, tempo_range,
            keys) -> dict:
    states, durations, tempo_curve, timbre = latents
    transposition = int(rng.integers(0, 12)) if p else 0
    tempo_factor = float(rng.uniform(*tempo_range)) if p else 1.0
    chroma, onsets, novfn, snovfn = _render_song(
        rng, states, durations, templates, transposition, tempo_factor,
        noise, beat_period, tempo_curve)
    L = chroma.shape[0]
    src = np.repeat(timbre, 4, axis=0)
    ii = np.linspace(0, len(src) - 1, L)
    mfcc = src[np.round(ii).astype(int)] + \
        0.5 * rng.normal(size=(L, 13)).astype(np.float32)
    song = {"hpcp": chroma, "crema": np.roll(chroma, 1, axis=1),
            "mfcc_htk": mfcc.astype(np.float32),
            "onsets": onsets[:, None].astype(np.int32),
            "novfn": novfn[:, None], "snovfn": snovfn[:, None]}
    return {k: song[k] for k in keys}


def covers80(n_cliques: int, clique_size: int, n_states: int,
             base_duration: float, beat_period: float, seed: int,
             noise: float = 0.22, cover_tempo_range=(0.8, 1.25),
             keys=FEATURES) -> tuple[list, list]:
    """(songs, labels) of `make_synthetic_dataset(n_cliques, clique_size,
    n_states=..., base_duration=..., beat_period=..., seed=...)`."""
    rng = np.random.default_rng(seed)
    templates = _chord_templates()
    songs, labels = [], []
    for c in range(n_cliques):
        latents = _clique_latents(rng, n_states, base_duration)
        for p in range(clique_size):
            songs.append(_member(rng, latents, templates, p, noise,
                                 beat_period, cover_tempo_range, keys))
            labels.append(f"W_{c}")
    return songs, labels


class DatacosCorpus:
    """The Da-TACOS benchmark subset's layout, rendered on demand: cliques
    `W_<c>` of `clique_size` performances, then `n_distractors` singleton
    cliques. Song i renders from its own seeded streams (the program's
    `LazySyntheticCorpus`), and `member(c, p)` renders any further cover
    p of clique c the same way."""

    def __init__(self, n_cliques: int, clique_size: int, n_distractors: int,
                 n_states: int, base_duration: float, beat_period: float,
                 seed: int, noise: float = 0.22,
                 cover_tempo_range=(0.8, 1.25)):
        self.n_cliques = n_cliques
        self.clique_size = clique_size
        self.n_distractors = n_distractors
        self.n_states = n_states
        self.base_duration = base_duration
        self.beat_period = beat_period
        self.seed = seed
        self.noise = noise
        self.cover_tempo_range = tuple(cover_tempo_range)
        self.n_songs = n_cliques * clique_size + n_distractors
        self.labels = np.asarray(
            [f"W_{c}" for c in range(n_cliques) for _ in range(clique_size)]
            + [f"W_d{d}" for d in range(n_distractors)])

    def locate(self, i: int) -> tuple[int, int]:
        """song index -> (clique id, member id); distractors get clique
        ids past n_cliques."""
        body = self.n_cliques * self.clique_size
        if i < body:
            return divmod(i, self.clique_size)
        return self.n_cliques + (i - body), 0

    def _latents(self, c: int):
        rng_c = np.random.default_rng([self.seed, 7919, c])
        return _clique_latents(rng_c, self.n_states, self.base_duration)

    def member(self, c: int, p: int, keys=FEATURES) -> dict:
        rng_m = np.random.default_rng([self.seed, 104729, c, p])
        return _member(rng_m, self._latents(c), _chord_templates(), p,
                       self.noise, self.beat_period, self.cover_tempo_range,
                       keys)

    def frames(self, c: int, p: int) -> int:
        """The full-rate frame count of member p of clique c, from the two
        streams' first draws alone (no rendering)."""
        _, durations, _, _ = self._latents(c)
        rng_m = np.random.default_rng([self.seed, 104729, c, p])
        tempo = 1.0
        if p:
            rng_m.integers(0, 12)
            tempo = float(rng_m.uniform(*self.cover_tempo_range))
        return int(sum(max(1, int(round(d * tempo))) for d in durations))


def _render_one(args) -> dict:
    corpus, c, p, keys = args
    return corpus.member(c, p, keys)


class Renderer:
    """Renders `DatacosCorpus` songs on several host cores (`spawn`ed
    workers: each song is independent of every other)."""

    def __init__(self, workers: int):
        self.workers = max(1, workers)
        self._pool = None

    def __enter__(self) -> "Renderer":
        if self.workers > 1:
            self._pool = ProcessPoolExecutor(
                self.workers, mp_context=multiprocessing.get_context("spawn"))
        return self

    def __exit__(self, *exc) -> None:
        if self._pool is not None:
            self._pool.shutdown(wait=True)
            self._pool = None

    def members(self, corpus: DatacosCorpus, cp: list, keys) -> list:
        """Members (clique, member) of the corpus, rendered now."""
        jobs = [(corpus, int(c), int(p), tuple(keys)) for c, p in cp]
        if self._pool is None:
            return [_render_one(j) for j in jobs]
        return list(self._pool.map(_render_one, jobs, chunksize=4))

    def songs(self, corpus: DatacosCorpus, idx, keys) -> list:
        """Songs `idx` of the corpus, rendered now."""
        return self.members(corpus, [corpus.locate(int(i)) for i in idx],
                            keys)

    def songs_later(self, corpus: DatacosCorpus, idx, keys):
        """Songs `idx` rendering on the workers meanwhile: a callable that
        returns them (None without workers)."""
        if self._pool is None:
            return None
        futs = [self._pool.submit(_render_one, (corpus, *corpus.locate(
            int(i)), tuple(keys))) for i in idx]
        return lambda: [f.result() for f in futs]
