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
