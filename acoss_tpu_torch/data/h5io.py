"""Interop with the reference's per-track HDF5 feature files (a copy of
`acoss_tpu.data.h5io`, numpy + h5py).

The reference stores one deepdish h5 per track (`extractors.py:72`) with
the schema at `extractors.py:43-53`. This reader walks those files with
h5py (deepdish writes plain HDF5 groups/datasets for dict/ndarray
payloads) so existing acoss feature dirs load into a FeatureSet without
re-extraction. h5py is imported only here, when a directory is read: a
machine without it runs everything else, and raises ImportError when
asked for a directory of h5 files.
"""

from __future__ import annotations

import glob
import os

import numpy as np

from acoss_tpu_torch.data.store import FeatureSet


def _h5_to_dict(node) -> dict:
    import h5py

    out = {}
    for k, v in node.items():
        if isinstance(v, h5py.Group):
            out[k] = _h5_to_dict(v)
        else:
            val = v[()]
            if isinstance(val, bytes):
                val = val.decode()
            out[k] = val
    for k, v in node.attrs.items():
        if k not in out and not k.startswith(("CLASS", "TITLE", "VERSION",
                                              "PYTABLES")):
            out[k] = v
    return out


def load_track_h5(path: str) -> dict:
    """One reference-format track file -> nested dict."""
    import h5py

    with h5py.File(path, "r") as f:
        d = _h5_to_dict(f)
    # deepdish wraps payloads under a 'data' group in some versions
    if set(d) == {"data"}:
        d = d["data"]
    return d


def feature_set_from_h5_dir(datapath: str,
                            chroma_keys=("hpcp", "crema")) -> FeatureSet:
    """Load a directory of per-track h5 files (the reference's
    `datapath/*.h5` contract, `CoverAlgorithm.py:41`) into a FeatureSet."""
    files = sorted(glob.glob(os.path.join(datapath, "*.h5")))
    if not files:
        raise FileNotFoundError(f"no .h5 files under {datapath}")
    songs, labels, track_ids = [], [], []
    for f in files:
        d = load_track_h5(f)
        song = {}
        for k in chroma_keys:
            if k in d:
                song[k] = np.asarray(d[k], np.float32)
        if "mfcc_htk" in d:
            song["mfcc_htk"] = np.asarray(d["mfcc_htk"], np.float32).T
        m = d.get("madmom_features", {})
        if "onsets" in m:
            song["onsets"] = np.asarray(m["onsets"],
                                        np.int32).reshape(-1, 1)
        for k in ("novfn", "snovfn"):
            if k in m:
                song[k] = np.asarray(m[k], np.float32).reshape(-1, 1)
        songs.append(song)
        labels.append(str(d.get("label", "unknown")))
        track_ids.append(str(d.get("track_id",
                                   os.path.splitext(
                                       os.path.basename(f))[0])))
    return FeatureSet.from_songs(songs, labels, track_ids,
                                 ragged_features=tuple(songs[0].keys()))
