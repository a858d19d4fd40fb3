"""Synthetic cover-clique dataset generator (numpy copy of
`acoss_tpu.data.synthetic.make_synthetic_dataset`).

There is no audio corpus to test on, so end-to-end regression uses planted
cover cliques: each clique shares a latent chord / timbre sequence; each
"performance" is a transposed, time-warped, noisy rendering. A correct
pipeline (OTI + CRP + qmax) must rank clique members far above
distractors. The same seed gives the same arrays as the JAX package's
generator, draw for draw.

Feature names mirror the reference's per-track h5 schema: hpcp, crema,
mfcc_htk (stored frames-first), madmom-style onsets / novfn / snovfn.
"""

from __future__ import annotations

import numpy as np

from acoss_tpu_torch.data.store import FeatureSet


def _chord_templates(rng: np.random.Generator, n_chords: int = 24):
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

    # Beat grid: onsets following the clique-shared tempo CURVE (so covers
    # share tempo-variation structure, like real performances), globally
    # scaled by the per-cover tempo factor.
    onsets = []
    t, k = 1.0, 0
    while t < L - 1:
        onsets.append(t)
        t += beat_period * tempo_factor * tempo_curve[k % len(tempo_curve)]
        k += 1
    onsets = np.round(np.asarray(onsets)
                      + rng.normal(0, 0.3, size=len(onsets)))
    onsets = np.unique(np.clip(onsets, 0, L - 1)).astype(np.int64)

    # Novelty functions: smoothed pulse trains at the onsets.
    novfn = np.zeros(L)
    novfn[onsets] = 1.0
    kernel = np.exp(-0.5 * (np.arange(-4, 5) / 1.5) ** 2)
    novfn = np.convolve(novfn, kernel, mode="same")
    novfn = novfn + 0.05 * rng.random(L)
    snovfn = novfn + 0.05 * rng.random(L)
    return chroma.astype(np.float32), onsets, novfn.astype(np.float32), \
        snovfn.astype(np.float32)


def make_synthetic_dataset(
    n_cliques: int = 10,
    clique_size: int = 2,
    n_distractors: int = 0,
    n_states: int = 48,
    base_duration: float = 8.0,
    beat_period: float = 4.0,
    noise: float = 0.22,
    seed: int = 0,
    cover_tempo_range: tuple = (0.8, 1.25),
) -> FeatureSet:
    """Build a planted-clique FeatureSet.

    Defaults give ~160-480-frame songs with ~40-120 beats. Distractors are
    singleton cliques (like the Da-TACOS benchmark's 2000 singletons).
    `cover_tempo_range` sets the global tempo factor drawn for each cover
    ((1.0, 1.0) produces tempo-aligned covers — used to isolate whether a
    channel's low planted-corpus MAP comes from tempo warping or from the
    channel itself).
    """
    rng = np.random.default_rng(seed)
    templates = _chord_templates(rng)
    songs, labels, track_ids = [], [], []

    def add_clique(cid: str, size: int):
        states = rng.integers(0, len(templates), size=n_states)
        durations = base_duration * (0.5 + rng.random(n_states))
        # Clique-shared tempo curve: smooth multiplicative beat-period
        # modulation (covers share its SHAPE; global speed still differs).
        raw = rng.normal(0, 1, 64)
        kernel = np.exp(-0.5 * (np.arange(-8, 9) / 4.0) ** 2)
        smooth = np.convolve(raw, kernel / kernel.sum(), mode="same")
        tempo_curve = 1.0 + 0.35 * smooth / max(np.abs(smooth).max(), 1e-9)
        # Timbre latent shared across the clique.
        timbre = rng.normal(size=(n_states, 13)).astype(np.float32)
        for p in range(size):
            transposition = int(rng.integers(0, 12)) if p else 0
            tempo_factor = float(rng.uniform(*cover_tempo_range)) \
                if p else 1.0
            chroma, onsets, novfn, snovfn = _render_song(
                rng, states, durations, templates, transposition,
                tempo_factor, noise, beat_period, tempo_curve)
            L = chroma.shape[0]
            # mfcc follows the same latent timbre states, warped to L frames.
            src = np.repeat(timbre, 4, axis=0)
            ii = np.linspace(0, len(src) - 1, L)
            mfcc = src[np.round(ii).astype(int)] + \
                0.5 * rng.normal(size=(L, 13)).astype(np.float32)
            songs.append({
                "hpcp": chroma,
                "crema": np.roll(chroma, 1, axis=1),  # correlated variant
                "mfcc_htk": mfcc.astype(np.float32),
                "onsets": onsets[:, None].astype(np.int32),
                "novfn": novfn[:, None],
                "snovfn": snovfn[:, None],
            })
            labels.append(cid)
            track_ids.append(f"{cid}/P_{p}")

    for c in range(n_cliques):
        add_clique(f"W_{c}", clique_size)
    for d in range(n_distractors):
        add_clique(f"W_d{d}", 1)

    return FeatureSet.from_songs(
        songs, labels, track_ids,
        ragged_features=("hpcp", "crema", "mfcc_htk", "onsets",
                         "novfn", "snovfn"),
    )


class LazySyntheticCorpus:
    """Planted-clique corpus generated ON DEMAND, for Da-TACOS-scale runs.

    (numpy copy of `acoss_tpu.data.synthetic.LazySyntheticCorpus`: the
    same arguments render the same songs, bit for bit.)

    `make_synthetic_dataset` materializes every song up front — fine at
    covers80 scale, ~40 GB of host RAM at the Da-TACOS benchmark's
    15,000 songs (1000 cliques x 13 + 2000 distractor singletons). This
    class exposes the two members chunked extraction
    (`descstore.extract_streamed`) and the bucketed sweep use —
    `n_songs` and `subset(idxs)` — and renders only the requested songs,
    each from a deterministic per-(clique, member) RNG stream, so any
    chunking of the corpus yields bit-identical songs.

    Layout matches the Da-TACOS subset convention: cliques `W_<c>` of
    `clique_size` performances `P_<p>`, then `n_distractors` singleton
    cliques `W_d<d>`.
    """

    def __init__(self, n_cliques: int = 1000, clique_size: int = 13,
                 n_distractors: int = 2000, n_states: int = 48,
                 base_duration: float = 300.0, beat_period: float = 30.0,
                 noise: float = 0.22, seed: int = 0,
                 cover_tempo_range: tuple = (0.8, 1.25)):
        self.n_cliques = n_cliques
        self.clique_size = clique_size
        self.n_distractors = n_distractors
        self.n_states = n_states
        self.base_duration = base_duration
        self.beat_period = beat_period
        self.noise = noise
        self.seed = seed
        self.cover_tempo_range = cover_tempo_range
        labels, track_ids = [], []
        for c in range(n_cliques):
            labels += [f"W_{c}"] * clique_size
            track_ids += [f"W_{c}/P_{p}" for p in range(clique_size)]
        for d in range(n_distractors):
            labels.append(f"W_d{d}")
            track_ids.append(f"W_d{d}/P_0")
        self.labels = np.asarray(labels)
        self.track_ids = np.asarray(track_ids)
        self._templates = _chord_templates(np.random.default_rng(seed))

    @property
    def n_songs(self) -> int:
        return len(self.labels)

    def _locate(self, i: int) -> tuple[int, int]:
        """song index -> (clique id, member id); distractor cliques get
        ids past n_cliques."""
        body = self.n_cliques * self.clique_size
        if i < body:
            return divmod(i, self.clique_size)
        return self.n_cliques + (i - body), 0

    def _render(self, i: int) -> dict:
        c, p = self._locate(i)
        # clique-shared latents from the clique stream; per-member noise
        # / transposition / tempo from the member stream — members render
        # identically no matter which subset() call produces them
        rng_c = np.random.default_rng([self.seed, 7919, c])
        states = rng_c.integers(0, len(self._templates),
                                size=self.n_states)
        durations = self.base_duration * (0.5 + rng_c.random(self.n_states))
        raw = rng_c.normal(0, 1, 64)
        kernel = np.exp(-0.5 * (np.arange(-8, 9) / 4.0) ** 2)
        smooth = np.convolve(raw, kernel / kernel.sum(), mode="same")
        tempo_curve = 1.0 + 0.35 * smooth / max(np.abs(smooth).max(), 1e-9)
        timbre = rng_c.normal(size=(self.n_states, 13)).astype(np.float32)

        rng_m = np.random.default_rng([self.seed, 104729, c, p])
        transposition = int(rng_m.integers(0, 12)) if p else 0
        tempo_factor = float(rng_m.uniform(*self.cover_tempo_range)) \
            if p else 1.0
        chroma, onsets, novfn, snovfn = _render_song(
            rng_m, states, durations, self._templates, transposition,
            tempo_factor, self.noise, self.beat_period, tempo_curve)
        L = chroma.shape[0]
        src = np.repeat(timbre, 4, axis=0)
        ii = np.linspace(0, len(src) - 1, L)
        mfcc = src[np.round(ii).astype(int)] + \
            0.5 * rng_m.normal(size=(L, 13)).astype(np.float32)
        return {
            "hpcp": chroma,
            "crema": np.roll(chroma, 1, axis=1),
            "mfcc_htk": mfcc.astype(np.float32),
            "onsets": onsets[:, None].astype(np.int32),
            "novfn": novfn[:, None],
            "snovfn": snovfn[:, None],
        }

    def subset(self, idx) -> FeatureSet:
        idx = np.asarray(idx)
        return FeatureSet.from_songs(
            [self._render(int(i)) for i in idx],
            self.labels[idx], self.track_ids[idx],
            ragged_features=("hpcp", "crema", "mfcc_htk", "onsets",
                             "novfn", "snovfn"),
        )
