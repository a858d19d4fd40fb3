"""Low-latency cover-song retrieval against a prebuilt corpus index (port
of `acoss_tpu.serving`).

The reference is batch-only: scoring one new song against a corpus means
re-running an N x N sweep (`CoverAlgorithm.py:156-192`). A `CoverIndex`
is built once (descriptors extracted, padded to a tile multiple and kept
on the device, optionally fp16/int8-quantized like the streamed stores)
and answers 1 x N queries with one `tile_scores` call per corpus tile,
each tile's scores written into one preallocated (nq, n_tiles * tile)
device tensor per channel, and one readback at the end.

The returned scores are the algorithm's raw similarity channels.
`CoverAlgorithm.post_process` hooks are deliberately NOT applied: they
are corpus-global batch passes (late SNF fusion over the full square
pair matrix, `ChenFusion.py:82-85`) that are undefined for a 1 x N row.

The on-disk index is a `DescriptorStore` plus `index_meta.json`, the JAX
package's format: an index saved by either package loads in the other.
"""

from __future__ import annotations

import json
import os
import shutil
import warnings

import numpy as np
import torch

from acoss_tpu_torch.benchmarking.harness import _host, _upload
from acoss_tpu_torch.data.descstore import (DescriptorStore, quantize_int8,
                                            upcast_stream)


def _algo_params(algorithm) -> dict:
    """JSON-safe snapshot of an algorithm instance's scalar/tuple
    configuration -- what `CoverIndex.load` compares to catch parameter
    drift between index build and query time."""
    out = {}
    for k, v in sorted(vars(algorithm).items()):
        if isinstance(v, tuple):
            v = list(v)
        if v is None or isinstance(v, (bool, int, float, str, list)):
            out[k] = v
    return out


def _quantize_desc(desc: dict, quant: str | None,
                   min_bytes: int = 65536) -> dict:
    """The extract_streamed quantization layout, applied in RAM: heavy
    float32 leaves -> fp16 or int8 + @qscale companions."""
    if quant is None:
        return dict(desc)
    if quant not in ("half", "int8"):
        raise ValueError(f"unknown quant mode {quant!r}")
    out = {}
    for k, v in desc.items():
        v = _host(v)
        if v.dtype == np.float32 and v[:1].nbytes >= min_bytes:
            if quant == "int8":
                out[k], out[k + "@qscale"] = quantize_int8(v)
            else:
                out[k] = v.astype(np.float16)
        else:
            out[k] = v
    return out


def _pad_rows(t: torch.Tensor, rows: int) -> torch.Tensor:
    """`t` zero-padded along axis 0 to `rows`, on its own device."""
    if t.shape[0] == rows:
        return t
    return torch.cat([t, t.new_zeros((rows - t.shape[0],) + t.shape[1:])])


class CoverIndex:
    """Device-resident retrieval index over one algorithm's descriptors.

    Build once (`CoverIndex.build` / `load`), query many times (`query` /
    `top_k`). The corpus descriptors are padded to a tile multiple and
    kept on `device` (default "cuda"; "cpu" runs the kernels' plain
    versions); each query batch is padded to a multiple of the tile.
    """

    META = "index_meta.json"

    def __init__(self, algorithm, desc: dict, n_songs: int,
                 ids: list[str] | None = None, tile: int | None = None,
                 device: str | torch.device = "cuda"):
        self.algorithm = algorithm
        self.device = torch.device(device)
        self.n_songs = int(n_songs)
        self.tile = int(tile or algorithm.TILE)
        self.ids = list(ids) if ids is not None else [
            str(i) for i in range(n_songs)]
        if len(self.ids) != self.n_songs:
            raise ValueError(
                f"{len(self.ids)} ids for {self.n_songs} songs")
        self.n_tiles = -(-self.n_songs // self.tile)
        pad_to = self.n_tiles * self.tile
        corpus = {}
        for k, v in desc.items():
            if v.shape[0] != self.n_songs:
                raise ValueError(
                    f"descriptor {k!r} has leading dim {v.shape[0]}, "
                    f"expected n_songs={self.n_songs}")
            # a tensor already on the device (e.g. Serra09 ssms) is padded
            # there: a host round trip would defeat the point
            corpus[k] = _pad_rows(_upload({k: v}, self.device)[k], pad_to)
        self._corpus = corpus

    # ------------------------------------------------------------------
    # construction
    # ------------------------------------------------------------------

    @classmethod
    def build(cls, algorithm, fs, ids: list[str] | None = None,
              quant: str | None = None, tile: int | None = None,
              device: str | torch.device = "cuda") -> "CoverIndex":
        """Extract the corpus descriptors on `device` and keep them there.
        `quant` ('half'/'int8') shrinks the device footprint 2x/4x with
        on-device dequant per tile (the --stream-half/--stream-int8
        contract)."""
        desc = _quantize_desc(
            algorithm.extract_descriptors(fs, device=device), quant)
        if ids is None and getattr(fs, "track_ids", None) is not None:
            ids = [str(t) for t in fs.track_ids]
        return cls(algorithm, desc, fs.n_songs, ids=ids, tile=tile,
                   device=device)

    def save(self, path: str) -> None:
        """Persist to a DescriptorStore + meta (algorithm name, params,
        tile, ids) so serving restarts skip extraction.

        Written to a temp sibling directory first, then swapped in, so
        `path` always holds either the previous complete index or the new
        one -- never a half-written mix (a stale store's memmaps would
        otherwise be reopened r+ with their OLD dtype/width by
        `DescriptorStore.ensure`). Refuses to replace a directory with .npy
        content that is NOT a CoverIndex (no index meta): that is someone
        else's data, not debris."""
        path = os.path.abspath(path)
        if os.path.isdir(path):
            entries = os.listdir(path)
            foreign = [fn for fn in entries if fn.endswith(".npy")
                       or fn == DescriptorStore.META]
            if foreign and self.META not in entries:
                raise ValueError(
                    f"{path} contains array data ({foreign[:3]}...) but"
                    f" no {self.META}; refusing to overwrite a "
                    f"directory that is not a CoverIndex")
        elif os.path.exists(path):
            raise ValueError(f"{path} exists and is not a directory")
        os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
        tmp = f"{path}.tmp-{os.getpid()}"
        if os.path.isdir(tmp):
            shutil.rmtree(tmp)
        os.makedirs(tmp)
        store = DescriptorStore(tmp, self.n_songs)
        # sliced out of the padded corpus: keeping the unpadded originals
        # would hold device-resident leaves twice for the index's
        # lifetime; the device-to-host copy is paid here, only on save
        for k, v in self._corpus.items():
            store.write(k, 0, _host(v[:self.n_songs]))
        store.flush()
        with open(os.path.join(tmp, self.META), "w") as f:
            json.dump({"algorithm": type(self.algorithm).__name__,
                       "name": self.algorithm.NAME,
                       "params": _algo_params(self.algorithm),
                       "tile": self.tile,
                       "n_songs": self.n_songs,
                       "ids": self.ids}, f)
        if os.path.isdir(path):
            old = f"{path}.old-{os.getpid()}"
            os.rename(path, old)
            os.rename(tmp, path)
            shutil.rmtree(old)
        else:
            os.rename(tmp, path)

    @classmethod
    def load(cls, algorithm, path: str,
             device: str | torch.device = "cuda") -> "CoverIndex":
        with open(os.path.join(path, cls.META)) as f:
            meta = json.load(f)
        if meta["algorithm"] != type(algorithm).__name__:
            raise ValueError(
                f"index at {path} was built with {meta['algorithm']}, "
                f"not {type(algorithm).__name__}")
        # the class name alone is not enough: query descriptors are
        # extracted by THIS instance, so any parameter drift against the
        # stored corpus (chroma_type, kappa, downsample_fac, ...) would
        # silently produce wrong rankings
        saved = meta.get("params")
        if saved is not None:
            now = _algo_params(algorithm)
            diff = {k for k in set(saved) | set(now)
                    if saved.get(k) != now.get(k)}
            # scoring-only knobs (SNF precision / update order, ...) don't
            # change the stored descriptors: warn, don't refuse
            scoring_only = diff & set(
                getattr(algorithm, "SCORING_ONLY_PARAMS", ()))
            diff -= scoring_only
            if scoring_only:
                warnings.warn(
                    f"index at {path}: scoring-only parameter drift "
                    f"(queries score with the CURRENT values): "
                    + ", ".join(f"{k}: index={saved.get(k)!r} "
                                f"vs query={now.get(k)!r}"
                                for k in sorted(scoring_only)),
                    stacklevel=2)
            if diff:
                raise ValueError(
                    f"index at {path} was built with different "
                    f"algorithm parameters: "
                    + ", ".join(f"{k}: index={saved.get(k)!r} "
                                f"vs query={now.get(k)!r}"
                                for k in sorted(diff)))
        desc = dict(DescriptorStore.open(path))
        return cls(algorithm, desc, meta["n_songs"], ids=meta["ids"],
                   tile=meta["tile"], device=device)

    # ------------------------------------------------------------------
    # queries
    # ------------------------------------------------------------------

    def _query_tiles(self, q_tile: dict) -> dict:
        """Score a padded query batch against every corpus tile: one
        `tile_scores` call a tile (never all tiles at once: a tile may
        build working copies of its column block), each written into the
        channel's preallocated (qt, n_tiles * tile) tensor; nothing
        synchronises inside the loop."""
        tile = self.tile
        q32 = upcast_stream(q_tile)
        qt = next(iter(q32.values())).shape[0]
        # sorted channels: the JAX package's query returns its channels
        # in sorted order (a jitted dict), so top_k's default channel is
        # the same in both packages
        out = {k: torch.empty((qt, self.n_tiles * tile),
                              dtype=torch.float32, device=self.device)
               for k in sorted(self.algorithm.SIMILARITY_TYPES)}
        for t in range(self.n_tiles):
            col = upcast_stream({k: v[t * tile:(t + 1) * tile]
                                 for k, v in self._corpus.items()})
            scores = self.algorithm.tile_scores(q32, col)
            if set(scores) != set(out):
                raise ValueError(
                    f"tile_scores gave {sorted(scores)}, expected "
                    f"{sorted(out)}")
            for k, v in scores.items():
                out[k][:, t * tile:(t + 1) * tile] = v
        return out

    def query_descriptors(self, qdesc: dict, nq: int) -> dict:
        """Score `nq` query songs' descriptors against the whole corpus:
        {similarity_type: (nq, n_songs) float32 numpy}. Queries are padded
        to a multiple of the tile width."""
        qt = -(-nq // self.tile) * self.tile
        q_tile = {}
        for k, v in qdesc.items():
            ck = self._corpus.get(k)
            if ck is None:
                raise ValueError(f"query descriptor {k!r} not in index")
            t = _upload({k: v}, self.device)[k]
            if t.shape[1:] != ck.shape[1:]:
                # ragged padded widths: grow the shorter side (queries
                # and corpus were padded independently)
                tgt = tuple(max(a, b)
                            for a, b in zip(t.shape[1:], ck.shape[1:]))
                grown = t.new_zeros(t.shape[:1] + tgt)
                grown[tuple(slice(0, s) for s in t.shape)] = t
                t = grown
                if tuple(ck.shape[1:]) != tgt:
                    raise ValueError(
                        f"query descriptor {k!r} is wider than the "
                        f"index ({tuple(t.shape[1:])} vs "
                        f"{tuple(ck.shape[1:])}); rebuild the index at "
                        f"the larger width")
            q_tile[k] = _pad_rows(t, qt)
        out = self._query_tiles(q_tile)
        return {k: v[:nq, :self.n_songs].cpu().numpy()
                for k, v in out.items()}

    def query(self, fs_query) -> dict:
        """Extract + score a FeatureSet of query songs."""
        qdesc = self.algorithm.extract_descriptors(fs_query,
                                                   device=self.device)
        return self.query_descriptors(qdesc, fs_query.n_songs)

    def top_k(self, fs_query, k: int = 10,
              similarity_type: str | None = None) -> list[list[dict]]:
        """Ranked retrieval: for each query song, the top-k corpus entries
        as {id, index, score} (scores are similarities: DISTANCE channels
        are negated before ranking, `CoverAlgorithm.py:330-340`
        convention; ties keep corpus order)."""
        scores = self.query(fs_query)
        stype = similarity_type or next(iter(scores))
        if stype not in scores:
            raise ValueError(
                f"unknown similarity type {stype!r}; index produces "
                f"{sorted(scores)}")
        S = scores[stype]
        if stype in self.algorithm.DISTANCE_TYPES:
            S = -S
        k = min(k, self.n_songs)
        results = []
        for row in S:
            order = np.argsort(-row, kind="stable")[:k]
            results.append([{"id": self.ids[j], "index": int(j),
                             "score": float(row[j])} for j in order])
        return results
