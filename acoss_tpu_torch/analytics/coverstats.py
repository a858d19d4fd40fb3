""""What is a cover?" statistical studies on cover pairs (port of
`acoss_tpu.analytics.coverstats`, numpy + scipy, no pandas).

Parity target: the reference's `coverstats/coverstats.py:10-241` -- key
statistics (same-scale / same-key proportions, transposition-distance
distribution), tempo-ratio statistics, and auto-tag F-measure KS tests,
computed over a pairs dataset (the Da-TACOS `whatisacover` subset in the
reference).

The inputs are a `FeatureSet` (keys/tempos are derived from stored
features on the fly); the per-pair tables are `Table`s: plain column
records with the JAX package's DataFrame column names and the clique
label as the index, written as the CSV that pandas' `to_csv` wrote.
"""

from __future__ import annotations

import csv

import numpy as np
import torch
from scipy.stats import ks_2samp

from acoss_tpu_torch.data.store import FeatureSet
from acoss_tpu_torch.features.key import key_extractor
from acoss_tpu_torch.features.onsets import estimate_tempo

_KEY2IDX = {"C": 0, "C#": 1, "D": 2, "D#": 3, "Eb": 3, "E": 4, "F": 5,
            "F#": 6, "G": 7, "G#": 8, "Ab": 8, "A": 9, "A#": 10,
            "Bb": 10, "B": 11}


class Table:
    """Column records: `index` holds the row labels (clique labels) and
    `columns` maps each column name, in order, to its list of values."""

    def __init__(self, index: list, columns: list[str], rows: list[list]):
        self.index = [str(i) for i in index]
        self.columns = {c: [r[j] for r in rows]
                        for j, c in enumerate(columns)}

    def __len__(self) -> int:
        return len(self.index)

    def __getitem__(self, name: str) -> list:
        return self.columns[name]

    def values(self, *names: str) -> np.ndarray:
        """The named columns side by side, (len, len(names))."""
        if not self.index:
            return np.zeros((0, len(names)))
        return np.stack([np.asarray(self.columns[n]) for n in names],
                        axis=1)

    def to_csv(self, path: str) -> None:
        """The layout of pandas' `DataFrame.to_csv`: a header row with an
        empty first cell, then the label and the values of each row."""
        with open(path, "w", newline="") as f:
            w = csv.writer(f, lineterminator="\n")
            w.writerow([""] + list(self.columns))
            # pandas writes a float by its shortest repr (float64:
            # `repr(float)`, float32: numpy's float32 repr); str gives both
            for i, label in enumerate(self.index):
                w.writerow([label] + [str(col[i]) for col in
                                      self.columns.values()])


def get_cover_pairs(fs: FeatureSet, extractor) -> dict:
    """label -> [extractor(song_index), ...] over all songs
    (`coverstats.py:10-37` with the FeatureSet replacing the h5 glob)."""
    pairs: dict = {}
    for i in range(fs.n_songs):
        pairs.setdefault(fs.labels[i], []).append(extractor(fs, i))
    return pairs


def key_table(fs: FeatureSet, chroma_type: str = "hpcp") -> Table:
    """Per-pair key info table (the reference's keys.csv,
    `coverstats.py:44-58`)."""
    def extract(fs, i):
        chroma = fs.feature(chroma_type)[i, :fs.length(chroma_type)[i]]
        try:
            res = key_extractor(chroma)
        except ValueError:
            # degenerate track (empty / non-finite chroma): key_extractor
            # refuses to fabricate a key; drop the track from the table
            # instead of aborting the whole study
            res = None
        if res is not None:
            res["track_id"] = str(fs.track_ids[i])
        return res

    pairs = get_cover_pairs(fs, extract)
    rows, index = [], []
    for label, members in pairs.items():
        members = [m for m in members if m is not None]
        if len(members) < 2:
            continue
        s1, s2 = members[0], members[1]
        index.append(label)
        rows.append([s1["track_id"], s1["key"], s1["scale"],
                     s1["strength"], s2["track_id"], s2["key"],
                     s2["scale"], s2["strength"]])
    return Table(index, ["ID1", "Key1", "Scale1", "Strength1",
                         "ID2", "Key2", "Scale2", "Strength2"], rows)


def key_stats(df: Table, min_confidence: float = 0.75) -> dict:
    """Same-scale / same-key proportions + transposition distances
    (`coverstats.py:60-125`)."""
    strengths = df.values("Strength1", "Strength2").astype(float)
    keep = np.min(strengths, axis=1) > min_confidence
    scale = df.values("Scale1", "Scale2")[keep]
    same_scale = scale[:, 0] == scale[:, 1]
    keys = df.values("Key1", "Key2")[keep]
    same_key = same_scale & (keys[:, 0] == keys[:, 1])
    keyidx = np.array([[_KEY2IDX[k] for k in row] for row in keys]) \
        if len(keys) else np.zeros((0, 2), int)
    transposed = (~same_key) & same_scale
    dist = np.abs(keyidx[transposed, 0] - keyidx[transposed, 1]) \
        if len(keys) else np.array([])
    dist = np.minimum(dist, 12 - dist)
    n = max(int(keep.sum()), 1)
    return {
        "n_pairs_confident": int(keep.sum()),
        "frac_same_scale": float(same_scale.sum()) / n,
        "frac_same_key": float(same_key.sum()) / n,
        "transposition_distances": dist,
    }


def tempo_table(fs: FeatureSet, novfn: str = "snovfn",
                sr: int = 44100, hop_length: int = 512,
                device: str | torch.device = "cuda") -> Table:
    """Per-pair strongest-tempo table (the reference's tempos.csv,
    `coverstats.py:132-146`; tempo re-estimated from the stored novelty
    function, its tempogram on `device`, instead of madmom's stored
    candidates)."""
    def extract(fs, i):
        env = fs.feature(novfn)[i, :fs.length(novfn)[i], 0]
        return (estimate_tempo(env, sr, hop_length, device=device), 1.0)

    pairs = get_cover_pairs(fs, extract)
    rows, index = [], []
    for label, members in pairs.items():
        if len(members) < 2:
            continue
        index.append(label)
        rows.append(list(members[0]) + list(members[1]))
    return Table(index, ["Tempo1", "Strength1", "Tempo2", "Strength2"],
                 rows)


def tempo_stats(df: Table, min_confidence: float = 0.0) -> dict:
    """Tempo-ratio distribution quantiles (`coverstats.py:147-177`)."""
    keep = np.min(df.values("Strength1", "Strength2").astype(float),
                  axis=1) > min_confidence
    t = df.values("Tempo1", "Tempo2").astype(float)[keep]
    ratios = t[:, 1] / np.maximum(t[:, 0], 1e-9)
    ratios[ratios < 1] = 1.0 / ratios[ratios < 1]
    return {
        "n_pairs": int(keep.sum()),
        "ratios": ratios,
        "q25": float(np.quantile(ratios, 0.25)) if len(ratios) else np.nan,
        "q50": float(np.quantile(ratios, 0.50)) if len(ratios) else np.nan,
        "q75": float(np.quantile(ratios, 0.75)) if len(ratios) else np.nan,
    }


def tag_f_measure(tags1, tags2, cutoff: float = 0.062) -> float:
    """F-measure between two (tag, confidence) lists
    (`coverstats.py:179-197`, including the inf-on-empty convention)."""
    t1 = {s for s, f in tags1 if float(f) > cutoff}
    t2 = {s for s, f in tags2 if float(f) > cutoff}
    if not t1 or not t2:
        return np.inf
    r = len(t1 & t2) / len(t1)
    p = len(t2 & t1) / len(t2)
    if r == 0 or p == 0:
        return 0.0
    return 2 * r * p / (r + p)


def tag_stats(pair_tags: dict, cutoff: float = 0.062) -> dict:
    """True-pair vs false-pair tag F-measure distributions + KS test
    (`coverstats.py:199-241`). `pair_tags`: label -> [tags1, tags2]."""
    keys = list(pair_tags.keys())
    true_pairs = np.array([
        tag_f_measure(pair_tags[k][0], pair_tags[k][1], cutoff)
        for k in keys])
    false_pairs = []
    for k in keys:
        for k2 in keys:
            if k != k2:
                false_pairs.append(tag_f_measure(
                    pair_tags[k][0], pair_tags[k2][1], cutoff))
    false_pairs = np.array(false_pairs)
    true_pairs = true_pairs[np.isfinite(true_pairs)]
    false_pairs = false_pairs[np.isfinite(false_pairs)]
    ks = ks_2samp(true_pairs, false_pairs) if (
        len(true_pairs) and len(false_pairs)) else None
    return {"true_pairs": true_pairs, "false_pairs": false_pairs,
            "ks": ks}
