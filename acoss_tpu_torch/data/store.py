"""Arrays-of-songs feature store (numpy copy of `acoss_tpu.data.store`).

Each feature is ONE padded dense array over all songs, `(N, Lmax, d)`
plus a `(N,)` length vector, so a tile of the pair grid is a single slice
of the device-resident corpus.

On-disk format: a single .npz per dataset, the same keys as the JAX
package writes (`feat::<name>`, `len::<name>`, `labels`, `track_ids`,
`_meta`), so a FeatureSet saved by `acoss_tpu` loads here unchanged and
vice versa. Ragged songs are zero-padded to the per-feature max length;
callers rely on the invariant that padding is exactly zero.
"""

from __future__ import annotations

import dataclasses
import json
import os

import numpy as np


def pad_stack(arrays: list[np.ndarray], pad_to: int | None = None):
    """Stack ragged (L_i, d) arrays into ((N, Lmax, d), lengths)."""
    lengths = np.array([a.shape[0] for a in arrays], dtype=np.int32)
    L = int(lengths.max()) if pad_to is None else pad_to
    rest = arrays[0].shape[1:]
    out = np.zeros((len(arrays), L) + rest, dtype=arrays[0].dtype)
    for i, a in enumerate(arrays):
        n = min(a.shape[0], L)
        out[i, :n] = a[:n]
    return out, np.minimum(lengths, L)


@dataclasses.dataclass
class FeatureSet:
    """A dataset of N songs as dense padded feature arrays.

    features: name -> (N, Lmax, d) ragged-padded or (N, d) fixed-size array.
    lengths:  name -> (N,) valid frame counts (only for ragged features).
    labels:   (N,) cover-clique label per song.
    track_ids: (N,) unique track identifier.
    """

    features: dict
    lengths: dict
    labels: np.ndarray
    track_ids: np.ndarray

    @property
    def n_songs(self) -> int:
        return len(self.labels)

    def feature(self, name: str):
        return self.features[name]

    def length(self, name: str):
        if name in self.lengths:
            return self.lengths[name]
        n = self.features[name].shape[0]
        return np.full(n, self.features[name].shape[1], dtype=np.int32)

    def subset(self, idx) -> "FeatureSet":
        idx = np.asarray(idx)
        return FeatureSet(
            features={k: v[idx] for k, v in self.features.items()},
            lengths={k: v[idx] for k, v in self.lengths.items()},
            labels=self.labels[idx],
            track_ids=self.track_ids[idx],
        )

    def save(self, path: str) -> None:
        os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
        payload = {
            "labels": np.asarray(self.labels, dtype=np.str_),
            "track_ids": np.asarray(self.track_ids, dtype=np.str_),
            "_meta": np.array(json.dumps({
                "features": sorted(self.features),
                "ragged": sorted(self.lengths),
            })),
        }
        for k, v in self.features.items():
            payload[f"feat::{k}"] = v
        for k, v in self.lengths.items():
            payload[f"len::{k}"] = v
        np.savez_compressed(path, **payload)

    @classmethod
    def load(cls, path: str) -> "FeatureSet":
        with np.load(path, allow_pickle=False) as z:
            feats, lens = {}, {}
            for k in z.files:
                if k.startswith("feat::"):
                    feats[k[6:]] = z[k]
                elif k.startswith("len::"):
                    lens[k[5:]] = z[k]
            return cls(features=feats, lengths=lens,
                       labels=z["labels"], track_ids=z["track_ids"])

    @classmethod
    def from_songs(cls, songs: list[dict], labels, track_ids,
                   ragged_features: tuple = ()) -> "FeatureSet":
        """Build from a list of per-song dicts {feature_name: array}."""
        names = songs[0].keys()
        feats, lens = {}, {}
        for name in names:
            arrays = [np.asarray(s[name]) for s in songs]
            if name in ragged_features or len(
                {a.shape[0] for a in arrays}
            ) > 1:
                feats[name], lens[name] = pad_stack(arrays)
            else:
                feats[name] = np.stack(arrays)
        return cls(features=feats, lengths=lens,
                   labels=np.asarray(labels), track_ids=np.asarray(track_ids))
