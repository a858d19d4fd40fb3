"""Dataset manifests: Da-TACOS subset JSONs, covers80 lists, collections
(copy of `acoss_tpu.data.manifest`).

Parity targets:
- `preprocess/local_config.py:24-48`: subset JSON ->
  per-track relative paths (`W_<workid>/P_<perfid>.mp3`), split into N
  collection text files for array-job sharding;
- `preprocess/covers80.py:10-22`: the covers80 two-list
  layout (list1.list / list2.list under covers32k/).

The clique label of a track is its parent directory name — the contract
that puts `label` into the feature store (`extractors.py:51`).
"""

from __future__ import annotations

import json
import os

import numpy as np


def load_subset_json(path: str) -> dict[str, list[str]]:
    """{clique_id: [relative track paths]} (benchmark/whatisacover
    subsets)."""
    with open(path) as f:
        return json.load(f)


def subset_paths(subset: dict) -> list[str]:
    """Flatten a subset dict into the *_paths.txt ordering."""
    return [p for clique in subset.values() for p in clique]


def label_of(path: str) -> str:
    """Clique label = parent directory name (`extractors.py:51`)."""
    return os.path.basename(os.path.dirname(path))


def track_id_of(path: str) -> str:
    return os.path.splitext(os.path.basename(path))[0]


def create_collection_files(paths: list[str], out_dir: str,
                            n_splits: int, prefix: str = "collections"
                            ) -> list[str]:
    """Split a path list into `n_splits` collection txts
    (`local_config.py:39-48`) — the array-job unit of work."""
    os.makedirs(out_dir, exist_ok=True)
    outs = []
    for i, chunk in enumerate(np.array_split(np.asarray(paths), n_splits)):
        p = os.path.join(out_dir, f"{prefix}_{i + 1}_{n_splits}.txt")
        with open(p, "w") as f:
            f.write("\n".join(chunk.tolist()))
        outs.append(p)
    return outs


def read_txt_list(path: str) -> list[str]:
    with open(path) as f:
        return [ln.strip() for ln in f if ln.strip()]


def covers80_list(covers32k_dir: str) -> tuple[list[str], list[str]]:
    """(paths, labels) of the covers80 dataset from its two list files
    (`covers80.py:10-22`): 160 tracks, 80 cliques of 2; the clique is the
    artist_song directory."""
    paths, labels = [], []
    for listfile in ("list1.list", "list2.list"):
        for rel in read_txt_list(os.path.join(covers32k_dir, listfile)):
            paths.append(os.path.join(covers32k_dir, rel + ".mp3"))
            labels.append(rel.split("/")[0])
    return paths, labels
