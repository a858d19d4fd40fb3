"""The pair-grid benchmark harness (port of
`acoss_tpu.benchmarking.harness`).

The N x N pair grid is cut into (tile x tile) blocks; each block's scores
come from ONE `tile_scores` call over the cross product of a row block and
a column block of songs, and blocks stream back into host score matrices
(RAM arrays, or `.npy` memmaps in a `scores_dir`). Symmetric algorithms
score only block-row >= block-column and keep the strict lower triangle,
then mirror it (the reference's combinations + `D += D.T`). A resumable
`.npz` ledger records finished tiles; its format is the JAX package's, so
a sweep started by either package resumes in the other.

Four engines share that machinery (`_TileSweeper`):
  - `run_pairwise`: the descriptor corpus on the device (default), or
    streamed tile by tile from disk memmaps (`data.descstore`);
  - `run_pairwise_bucketed`: songs length-sorted into buckets, each with
    its own padded width (in RAM, on the device, or in per-bucket disk
    stores);
  - `run_pairwise_hybrid`: a panel of songs on the device, scored against
    column tiles streamed from a disk store;
  - `algorithm.full_scores`, a one-shot path for algorithms that have one.

Descriptors may be stored quantized (float16, or int8 with a per-song
`@qscale` companion); every engine restores fp32 on the device
(`descstore.upcast_stream`) before `tile_scores`.

Algorithms implement:
  - ``extract_descriptors(fs, device) -> dict[str, np.ndarray]``: per-song
    compact descriptors (batched arrays or tensors, leading dim N).
  - ``tile_scores(row_desc, col_desc) -> dict[type, (bi, bj) tensor]``:
    scoring of the full cross product of a row block against a column
    block of songs, on the descriptors' device.
  - optionally ``full_scores(desc, device) -> dict[type, (N, N)]``:
    every score in one call, from the whole corpus: its array leaves as
    tensors on `device`, any other leaf (a list of ragged per-song
    arrays, an int) as extracted.
"""

from __future__ import annotations

import os
import time
from collections import deque
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch

from acoss_tpu_torch.benchmarking.evaluation import (EvalStats,
                                                     eval_statistics,
                                                     write_results_csv)
from acoss_tpu_torch.convert import descriptors_from_numpy
from acoss_tpu_torch.data.descstore import (QSCALE, DescriptorStore,
                                            check_stream_consistency,
                                            extract_streamed, upcast_stream)
from acoss_tpu_torch.data.store import FeatureSet
from acoss_tpu_torch.utils import profiling as _prof


class CoverAlgorithm:
    """Base class for cover-song scoring algorithms."""

    NAME = "base"
    SIMILARITY_TYPES: tuple = ("main",)
    #: similarity types holding DISTANCES (lower = more similar); these are
    #: negated before ranking.
    DISTANCE_TYPES: tuple = ()
    SYMMETRIC = True
    TILE = 16
    #: instance attributes that only tune SCORING throughput/numerics (SNF
    #: precision / update order, ...) and do not change the extracted
    #: descriptors: a serving `CoverIndex` built under one value answers
    #: queries correctly under another, so `CoverIndex.load` warns
    #: instead of refusing when these drift.
    SCORING_ONLY_PARAMS: frozenset = frozenset(
        {"sequential", "snf_precision"})

    def extract_descriptors(self, fs: FeatureSet,
                            device: str | torch.device = "cuda") -> dict:
        raise NotImplementedError

    def tile_scores(self, row_desc: dict, col_desc: dict) -> dict:
        raise NotImplementedError

    full_scores = None  # optional override

    def post_process(self, Ds: dict, desc: dict,
                     device: str | torch.device = "cuda") -> dict:
        """Optional hook applied to the full (host numpy) score matrices
        after the sweep; `device` is the benchmark's device, on which it
        runs its tensor work."""
        return Ds

    def bucket_lengths(self, fs: FeatureSet) -> np.ndarray:
        """Per-song length proxy used by the bucketed sweep; defaults to
        the first ragged feature's lengths."""
        if fs.lengths:
            return fs.lengths[sorted(fs.lengths)[0]]
        return np.full(fs.n_songs, 1, np.int32)


def _host(v) -> np.ndarray:
    """A descriptor (array, memmap or tensor) as a host numpy array."""
    return v.cpu().numpy() if isinstance(v, torch.Tensor) else np.asarray(v)


def _host_leaf(v) -> bool:
    """A descriptor leaf in host memory (an array, or a CPU tensor)."""
    return not isinstance(v, torch.Tensor) or v.device.type == "cpu"


def _upload(desc: dict, device) -> dict:
    """Descriptors on `device`; disk memmaps are read into RAM first (a
    tensor cannot wrap a read-only mapping). Counts the leaves it copies
    from host memory to a device and their bytes (`store:h2d_copies`,
    `store:h2d_bytes`)."""
    with _prof.stages.stage("store:h2d"):
        out = descriptors_from_numpy(
            {k: np.array(v) if isinstance(v, np.memmap) else v
             for k, v in desc.items()}, device)
        if _prof.stages.enabled:
            moved = [t for k, t in out.items() if t.device.type != "cpu"
                     and _host_leaf(desc[k])]
            _prof.stages.add("store:h2d_copies", len(moved))
            _prof.stages.add("store:h2d_bytes",
                             sum(t.nbytes for t in moved))
    return out


def _upload_full(desc: dict, device) -> dict:
    """The corpus as `full_scores` takes it: array leaves uploaded to
    `device` and restored to fp32 (`upcast_stream`), other leaves (the
    Struc* shingles' per-song lists and their int width) passed through
    untouched."""
    arrays = {k: v for k, v in desc.items()
              if isinstance(v, (np.ndarray, torch.Tensor))}
    return {**{k: v for k, v in desc.items() if k not in arrays},
            **upcast_stream(_upload(arrays, device))}


def _device_blocks(desc: dict, n: int, tile: int, device):
    """Upload rows [0, n) of every descriptor to `device` ONCE and return
    `block(i)`, the rows [i * tile, (i + 1) * tile) as views; only the
    last block is copied and zero-padded to a full tile (the corpus itself
    is never copied: the ssms corpus of EarlySNF is gigabytes)."""
    dd = _upload(desc, device)
    n_tiles = -(-n // tile)
    first = (n_tiles - 1) * tile
    last = {k: torch.cat([v[first:n], v.new_zeros(
        (n_tiles * tile - n,) + v.shape[1:])]) for k, v in dd.items()}

    def block(i: int) -> dict:
        if i == n_tiles - 1:
            return last
        return {k: v[i * tile:(i + 1) * tile] for k, v in dd.items()}

    return block


def _tile_slice(desc: dict, lo: int, hi: int, tile: int) -> dict:
    """Rows [lo, hi) of each descriptor copied to host RAM (out of a disk
    memmap if the store is disk-backed), zero-padded up to `tile` rows:
    host memory never holds more than the active tiles."""
    out = {}
    with _prof.stages.stage("store:read"):
        for k, v in desc.items():
            s = np.array(v[lo:hi])
            if s.shape[0] < tile:
                s = np.pad(s, [(0, tile - s.shape[0])]
                           + [(0, 0)] * (s.ndim - 1))
            out[k] = s
    return out


def _symmetrize_from_lower(D, block: int = 4096) -> None:
    """Mirror the strict lower triangle of D onto the upper triangle in
    place, blockwise (works on np.memmap without materializing the
    matrix; valid because tiles only ever write strictly-lower entries).
    Pure assignment, so the pass is IDEMPOTENT: a crash mid-symmetrize
    followed by a resume re-derives the same upper triangle instead of
    double-adding."""
    n = D.shape[0]
    for i0 in range(0, n, block):
        i1 = min(i0 + block, n)
        A = np.tril(np.array(D[i0:i1, i0:i1]), -1)
        D[i0:i1, i0:i1] = A + A.T
        for j0 in range(0, i0, block):
            j1 = min(j0 + block, n)
            D[j0:j1, i0:i1] = np.array(D[i0:i1, j0:j1]).T


class _TileSweeper:
    """Shared engine behind the pair-grid sweeps: score-matrix storage
    (RAM or `scores_dir` .npy memmaps), the resumable tile ledger, the
    pending buffer of device-resident tile results with batched readback
    flushes, and the idempotent lower-triangle symmetrization. The sweeps
    differ only in how they enumerate tiles and compute each tile's
    scores."""

    #: tiles whose device-resident results are read back in one transfer
    FLUSH_EVERY = 128

    def __init__(self, sim_types, n_songs: int, tile: int,
                 symmetric: bool, scores_dir: str | None,
                 checkpoint_path: str | None, checkpoint_every: int = 16,
                 ckpt_extra: dict | None = None):
        with _prof.stages.stage("sweep:open"):
            self.sim_types = tuple(sim_types)
            self.n_songs = n_songs
            self.tile = tile
            self.symmetric = symmetric
            self.scores_dir = scores_dir
            self.checkpoint_path = checkpoint_path
            self.checkpoint_every = checkpoint_every
            self.ckpt_extra = dict(ckpt_extra or {})
            self.n_tiles = n_tiles = -(-n_songs // tile)

            if scores_dir is not None:
                os.makedirs(scores_dir, exist_ok=True)
                self.Ds = {}
                for k in self.sim_types:
                    fn = os.path.join(scores_dir, f"{k}.npy")
                    if os.path.exists(fn):
                        m = np.lib.format.open_memmap(fn, mode="r+")
                        if m.shape != (n_songs, n_songs) or \
                                m.dtype != np.float32:
                            # a scores_dir reused across corpora would mix
                            # stale and new scores (or die mid-sweep)
                            raise ValueError(
                                f"{fn} holds a {m.dtype} {m.shape} matrix "
                                f"but this sweep needs float32 "
                                f"({n_songs}, {n_songs}); delete the "
                                f"scores_dir or use a fresh one")
                        self.Ds[k] = m
                    else:
                        self.Ds[k] = np.lib.format.open_memmap(
                            fn, mode="w+", dtype=np.float32,
                            shape=(n_songs, n_songs))
            else:
                self.Ds = {k: np.zeros((n_songs, n_songs), np.float32)
                           for k in self.sim_types}
            self.done = np.zeros((n_tiles, n_tiles), dtype=bool)

            if checkpoint_path and os.path.exists(checkpoint_path):
                with np.load(checkpoint_path) as z:
                    # the extra meta key sets must match EXACTLY in both
                    # directions: a plain sweep must not adopt a bucketed
                    # sweep's ledger (whose tiles index the length-SORTED
                    # order) just because its own ckpt_extra is empty
                    base = {"done", "tile", "n_songs"}
                    extra = {k for k in z.files
                             if k not in base and not k.startswith("D::")}
                    meta_ok = (int(z["tile"]) == tile
                               and int(z["n_songs"]) == n_songs
                               and extra == set(self.ckpt_extra)
                               and all(int(z[k]) == int(v)
                                       for k, v in self.ckpt_extra.items()))
                    if meta_ok:
                        self.done = z["done"]
                        if scores_dir is None:
                            for k in self.Ds:
                                self.Ds[k] = z[f"D::{k}"]

            # `symmetrized.flag` certifies that the memmaps' upper triangle
            # mirrors the CURRENT lower triangle. If this sweep will (re)write
            # any tile (a fresh run over a reused scores_dir, or a partial
            # resume) the certificate is stale: drop it so finalize()
            # re-mirrors. Only the tiles a symmetric sweep enumerates count:
            # strict-upper ledger entries are never set.
            if scores_dir is not None and self.symmetric:
                flag = os.path.join(scores_dir, "symmetrized.flag")
                pending = ~self.done[np.tril_indices(n_tiles)]
                if os.path.exists(flag) and pending.any():
                    os.remove(flag)

            self._row_idx = np.arange(tile)
            self._pending: list = []
            self._n_done_this_run = 0

    def save_ckpt(self) -> None:
        if not self.checkpoint_path:
            return
        with _prof.stages.stage("sweep:ledger"):
            payload = {"done": self.done, "tile": self.tile,
                       "n_songs": self.n_songs, **self.ckpt_extra}
            if self.scores_dir is None:
                for k, D in self.Ds.items():
                    payload[f"D::{k}"] = D
            else:
                for D in self.Ds.values():
                    D.flush()
            tmp = self.checkpoint_path + ".tmp.npz"
            np.savez(tmp, **payload)
            os.replace(tmp, self.checkpoint_path)

    def flush(self) -> None:
        """Read back all pending tile results in ONE stacked transfer per
        similarity type and scatter them into the matrices."""
        if not self._pending:
            return
        with _prof.stages.stage("sweep:flush"):
            stacked = {k: torch.stack([p[2][k] for p in self._pending])
                       .cpu().numpy() for k in self.sim_types}
        with _prof.stages.stage("sweep:scatter"):
            for b, (ti, tj, _) in enumerate(self._pending):
                ij = np.meshgrid(self._row_idx + ti * self.tile,
                                 self._row_idx + tj * self.tile,
                                 indexing="ij")
                keep = (ij[0] < self.n_songs) & (ij[1] < self.n_songs)
                if self.symmetric:
                    keep &= ij[0] > ij[1]
                else:
                    keep &= ij[0] != ij[1]
                for k in stacked:
                    self.Ds[k][ij[0][keep], ij[1][keep]] = \
                        stacked[k][b][keep]
                self.done[ti, tj] = True
                self._n_done_this_run += 1
            self._pending.clear()

    def submit(self, ti: int, tj: int, scores: dict) -> None:
        """Queue one tile's (still device-resident) scores; flushes in
        batches so the host keeps queueing work while the device runs."""
        self._pending.append((ti, tj, scores))
        if len(self._pending) >= self.FLUSH_EVERY:
            self.flush()
        if self.checkpoint_path and \
                self._n_done_this_run // self.checkpoint_every != \
                (self._n_done_this_run + len(self._pending)) \
                // self.checkpoint_every:
            self.flush()
            self.save_ckpt()

    def finalize(self, skip_symmetrize: bool = False) -> dict:
        self.flush()
        self.save_ckpt()
        if self.symmetric and not skip_symmetrize:
            # idempotent mirror (assignment from the strict lower
            # triangle): safe to re-run after a crash at any point
            flag = (os.path.join(self.scores_dir, "symmetrized.flag")
                    if self.scores_dir is not None else None)
            if flag is None or not os.path.exists(flag):
                for k in self.Ds:
                    if self.scores_dir is not None:
                        _symmetrize_from_lower(self.Ds[k])
                    else:
                        L = np.tril(self.Ds[k], -1)
                        self.Ds[k] = L + L.T
                if flag is not None:
                    with open(flag, "w") as f:
                        f.write("1")
        return self.Ds


def _zigzag(ti: int, n_cols: int) -> list:
    """Column order of block-row ti: consecutive tiles share a block."""
    cols = list(range(n_cols))
    return cols[::-1] if ti % 2 == 1 else cols


def run_pairwise(
    algorithm: CoverAlgorithm,
    desc: dict,
    n_songs: int,
    tile: int | None = None,
    checkpoint_path: str | None = None,
    checkpoint_every: int = 16,
    verbose: bool = False,
    tile_filter=None,
    skip_symmetrize: bool = False,
    scores_dir: str | None = None,
    device_resident: bool | None = None,
    device: str | torch.device = "cuda",
) -> dict:
    """Sweep the pair grid, returning {similarity_type: (N, N) np.float32}.

    `device_resident` (default: on, unless a descriptor is an np.memmap)
    uploads the descriptor corpus (numpy arrays or tensors) to `device`
    ONCE; every tile is a slice of it, so no descriptor bytes cross the
    host link during the sweep. Off, the sweep STREAMS: the row tile is
    uploaded once per block-row (only if that row has work) and each
    column tile is sliced from the (memmapped) descriptors and uploaded
    on its own, so host memory stays bounded by the tile size. Quantized
    descriptors are restored to fp32 on the device per tile. Tile results
    stay on the device until a batched flush.

    With `checkpoint_path`, the ledger of completed tiles (plus the
    partial score matrices when they live in RAM) is saved every
    `checkpoint_every` tiles and the sweep resumes from it. With
    `scores_dir`, the score matrices are `.npy` memmaps in that directory
    (the ledger then holds only the done map). `tile_filter(ti, tj)`
    restricts the sweep to a subset of tiles (a process shard), and
    `skip_symmetrize` leaves the upper triangle unmirrored.

    An algorithm with `full_scores` gets the whole corpus in one call
    instead: array leaves as fp32 tensors on `device`, other leaves as
    they are.
    """
    if algorithm.full_scores is not None:
        Ds = {k: np.array(_host(v), dtype=np.float32)
              for k, v in algorithm.full_scores(
                  _upload_full(desc, device), device=device).items()}
        for D in Ds.values():
            np.fill_diagonal(D, 0.0)
        return Ds

    tile = tile or algorithm.TILE
    n_tiles = -(-n_songs // tile)
    sweep = _TileSweeper(algorithm.SIMILARITY_TYPES, n_songs, tile,
                         algorithm.SYMMETRIC, scores_dir, checkpoint_path,
                         checkpoint_every)
    if device_resident is None:
        device_resident = not any(isinstance(v, np.memmap)
                                  for v in desc.values())
    if device_resident:
        block = _device_blocks(desc, n_songs, tile, device)
    else:
        def block(i: int) -> dict:
            return _upload(_tile_slice(desc, i * tile, (i + 1) * tile,
                                       tile), device)

    t0 = time.time()
    for ti in range(n_tiles):
        cols = [tj for tj in _zigzag(ti, ti + 1 if algorithm.SYMMETRIC
                                     else n_tiles)
                if not sweep.done[ti, tj]
                and (tile_filter is None or tile_filter(ti, tj))]
        if not cols:
            # a resume or a process shard must not stream descriptors it
            # will never score
            continue
        with _prof.stages.stage("sweep:row"):
            row = upcast_stream(block(ti))
        for tj in cols:
            with _prof.stages.stage("sweep:tile", ti=ti, tj=tj):
                col = upcast_stream(block(tj))
                with _prof.stages.stage("score:tile"):
                    scores = algorithm.tile_scores(row, col)
            sweep.submit(ti, tj, scores)
        if verbose:
            sweep.flush()
            print(f"[{algorithm.NAME}] block-row {ti + 1}/{n_tiles} "
                  f"({time.time() - t0:.1f}s)", flush=True)
    return sweep.finalize(skip_symmetrize)


def _bucket_edges(n_songs: int, n_buckets: int, tile: int) -> np.ndarray:
    """Equal song splits with every INTERIOR boundary rounded to a tile
    multiple, so each (tile x tile) tile of the global grid lies entirely
    inside one bucket-block. Returns boundaries [0, ..., n_songs]."""
    raw = np.cumsum([len(a) for a in
                     np.array_split(np.arange(n_songs), n_buckets)])[:-1]
    interior = [int(round(e / tile)) * tile for e in raw]
    edges = np.unique([0] + interior + [n_songs])
    return edges[(edges >= 0) & (edges <= n_songs)]


def _pad_axis1(t: torch.Tensor, width: int) -> torch.Tensor:
    return torch.cat([t, t.new_zeros((t.shape[0], width - t.shape[1])
                                     + t.shape[2:])], dim=1)


def _pad_tile_pair_axis1(row: dict, col: dict):
    """Zero-pad each >=2-D descriptor of a cross-bucket tile pair up to the
    pair's larger axis-1 extent.

    Iterates the UNION of the two key sets: per-bucket streamed stores
    decide their quantized keys from bucket-local padded widths, so a
    near-threshold key can carry a `@qscale` companion in one bucket but
    not the other. One-sided keys pass through on their own side, and
    `upcast_stream` dequantizes each side on its own."""
    out_r, out_c = {}, {}
    for k in sorted(set(row) | set(col)):
        r, c = row.get(k), col.get(k)
        if r is not None and c is not None \
                and r.ndim >= 2 and r.shape[1] != c.shape[1]:
            L = max(r.shape[1], c.shape[1])
            if r.shape[1] < L:
                r = _pad_axis1(r, L)
            if c.shape[1] < L:
                c = _pad_axis1(c, L)
        if r is not None:
            out_r[k] = r
        if c is not None:
            out_c[k] = c
    return out_r, out_c


def _split_desc_buckets(desc: dict, edges: np.ndarray,
                        round_to: int = 64) -> list[dict]:
    """Split ONE whole-corpus (length-sorted) descriptor extraction into
    per-bucket dicts: rows sliced per bucket, axis 1 truncated to the
    bucket's trailing-nonzero extent (rounded up to `round_to`). The
    tile kernels ignore trailing zero padding, so this recovers the
    per-bucket padding win without extracting once per bucket."""
    out = []
    for b in range(len(edges) - 1):
        lo, hi = int(edges[b]), int(edges[b + 1])
        # content truncation alone is unsound: a song's trailing VALID
        # frames can be all-zero (silence -> zero chroma / mfcc), and the
        # plain sweep sees those zero frames as real kNN candidates. The
        # per-song LENGTH keys (the 'length*' naming every algorithm uses)
        # bound the truncation from below.
        len_maxes = []
        for k, v in desc.items():
            if not k.startswith("length"):
                continue
            a = _host(v[lo:hi])
            if a.ndim == 1 and np.issubdtype(a.dtype, np.integer) \
                    and a.size:
                len_maxes.append(int(a.max()))
        d = {}
        for k, v in desc.items():
            s = v[lo:hi]
            if s.ndim >= 2 and s.shape[1] > 1:
                axes = (0,) + tuple(range(2, s.ndim))
                if isinstance(s, torch.Tensor):
                    # reduce on the device; only the (L,) mask comes back
                    colmask = _host(s.movedim(1, 0).reshape(s.shape[1], -1)
                                    .ne(0).any(dim=1))
                else:
                    colmask = np.asarray(s != 0).any(axis=axes)
                nz = np.flatnonzero(colmask)
                width = int(nz[-1]) + 1 if nz.size else 1
                width = max([width] + [m for m in len_maxes
                                       if m <= s.shape[1]])
                width = min(-(-width // round_to) * round_to, s.shape[1])
                s = s[:, :width]
            d[k] = s
        out.append(d)
    return out


def _merge_bucket_descs(descs: list[dict], inv: np.ndarray,
                        keys=None) -> dict:
    """Concatenate per-bucket descriptor dicts back into `inv` song order
    (axis 1 zero-padded up to the widest bucket) as host arrays, so
    `post_process` can consume them without a second extraction. `keys`
    restricts the merge."""
    out = {}
    for k in (keys if keys is not None else descs[0]):
        arrs = [_host(d[k]) for d in descs]
        if arrs[0].ndim >= 2:
            width = max(a.shape[1] for a in arrs)
            arrs = [np.pad(a, [(0, 0), (0, width - a.shape[1])]
                           + [(0, 0)] * (a.ndim - 2)) for a in arrs]
        out[k] = np.concatenate(arrs, axis=0)[inv]
    return out


def _small_dequantized(d: dict) -> dict:
    """The keys of one bucket's descriptors of at most 64 KB a song (as
    fp32), dequantized on the host."""
    small = {k: _host(v) for k, v in d.items()
             if not k.endswith(QSCALE) and _host(v[:1]).size * 4 <= 65536}
    for k in list(small):
        if small[k].dtype == np.int8 and k + QSCALE in d:
            small[k + QSCALE] = _host(d[k + QSCALE])
    out = upcast_stream({k: torch.from_numpy(np.array(v))
                         for k, v in small.items()})
    return {k: v.numpy() for k, v in out.items()}


def run_pairwise_bucketed(
    algorithm: CoverAlgorithm,
    fs: FeatureSet,
    n_buckets: int = 4,
    tile: int | None = None,
    verbose: bool = False,
    checkpoint_path: str | None = None,
    return_desc: bool = False,
    scores_dir: str | None = None,
    stream_dir: str | None = None,
    stream_chunk: int = 256,
    stream_quant: str | None = None,
    stream_min_bytes: int = 65536,
    checkpoint_every: int = 16,
    return_perm: bool = False,
    device: str | torch.device = "cuda",
    times: dict | None = None,
):
    """Length-bucketed pair sweep on `run_pairwise`'s machinery.

    Songs are length-sorted (`algorithm.bucket_lengths`) and split into
    buckets whose boundaries are rounded to tile multiples, so every tile
    of the global grid lies in exactly ONE bucket-block. Each bucket's
    descriptors are padded to the bucket's own width (the reference's
    ~10x song-length spread otherwise pads every pair to the global max),
    and a cross-bucket tile pads the narrower side up to the wider one on
    the device. The tile kernels ignore trailing zero padding, so the
    scores are those of the plain sweep over the same descriptors in the
    sorted order.

    Descriptors: without `stream_dir`, one whole-corpus extraction on the
    sorted songs, split into buckets by row slice + trailing-zero
    truncation and uploaded to the device once. With `stream_dir`, each
    bucket's descriptors live in a disk `DescriptorStore` under
    `stream_dir/desc/bucket_NNNN` (reused on resume, checked with
    `check_stream_consistency`; written with `stream_quant` 'half' or
    'int8' for keys of at least `stream_min_bytes` a song), the tiles
    stream from them, and the scores go to `stream_dir/scores` memmaps
    unless `scores_dir` says otherwise.

    Ordering: with RAM scores (no `scores_dir`, no `stream_dir`) the
    returned matrices are unpermuted back to the caller's song order.
    With memmapped scores they STAY in length-sorted order; pass
    `return_perm=True` for the sort permutation and evaluate with
    `labels[perm]` (retrieval stats are permutation-invariant).
    `return_desc` appends the merged descriptors (caller order for RAM
    scores, sorted order otherwise), dequantized, SMALL keys only (<= 64
    KB a song): they feed post_process hooks, which read lengths and
    global vectors. `times`, if given, receives the seconds of the
    extraction (`extract`, as soon as it ends) and of the sweep
    (`sweep`).

    Returns Ds [, merged_desc][, perm].
    """
    tile = tile or algorithm.TILE
    n = fs.n_songs
    lengths = np.asarray(algorithm.bucket_lengths(fs))
    perm = np.argsort(lengths, kind="stable")
    inv = np.empty_like(perm)
    inv[perm] = np.arange(len(perm))
    fss = fs.subset(perm)
    edges = _bucket_edges(n, n_buckets, tile)
    nb = len(edges) - 1
    if scores_dir is None and stream_dir is not None:
        scores_dir = os.path.join(stream_dir, "scores")

    t0 = time.perf_counter()
    if stream_dir is not None:
        descs: list[dict] = []
        for b in range(nb):
            lo, hi = int(edges[b]), int(edges[b + 1])
            path = os.path.join(stream_dir, "desc", f"bucket_{b:04d}")
            if os.path.exists(os.path.join(path, DescriptorStore.META)):
                if verbose:
                    print(f"[{algorithm.NAME}] reusing bucket store {path}")
                d = DescriptorStore.open(path)
                check_stream_consistency(d, stream_quant, path)
                descs.append(d)
            else:
                with _prof.stages.stage("extract:bucket"):
                    descs.append(extract_streamed(
                        algorithm, fss.subset(np.arange(lo, hi)), path,
                        chunk_songs=stream_chunk, verbose=verbose,
                        quant=stream_quant,
                        half_min_bytes=stream_min_bytes, device=device))
    else:
        with _prof.stages.stage("extract"):
            desc_all = _prof.stages.block(
                algorithm.extract_descriptors(fss, device=device))
        descs = _split_desc_buckets(desc_all, edges)
    _sync(device)
    t1 = time.perf_counter()
    if times is not None:
        times["extract"] = t1 - t0

    device_resident = stream_dir is None
    n_tiles = -(-n // tile)
    tile0 = edges[:-1] // tile
    bucket_of = np.searchsorted(edges, np.arange(n_tiles) * tile,
                                side="right") - 1
    if device_resident:
        blocks = [_device_blocks(d, int(edges[b + 1] - edges[b]), tile,
                                 device) for b, d in enumerate(descs)]

    def block(ti: int) -> dict:
        b = int(bucket_of[ti])
        if device_resident:
            return blocks[b](ti - int(tile0[b]))
        lo = ti * tile - int(edges[b])
        return _upload(_tile_slice(descs[b], lo, lo + tile, tile), device)

    sweep = _TileSweeper(algorithm.SIMILARITY_TYPES, n, tile,
                         algorithm.SYMMETRIC, scores_dir,
                         checkpoint_path, checkpoint_every,
                         ckpt_extra={"n_buckets": nb, "bucketed": 1})
    for ti in range(n_tiles):
        cols = [tj for tj in _zigzag(ti, ti + 1 if algorithm.SYMMETRIC
                                     else n_tiles)
                if not sweep.done[ti, tj]]
        if not cols:
            continue
        # the row tile is fetched only when this row has work: a resume
        # must not re-stream the whole store
        with _prof.stages.stage("sweep:row"):
            row = block(ti)
        for tj in cols:
            with _prof.stages.stage("sweep:tile", ti=ti, tj=tj):
                r, c = _pad_tile_pair_axis1(row, block(tj))
                r, c = upcast_stream(r), upcast_stream(c)
                with _prof.stages.stage("score:tile"):
                    scores = algorithm.tile_scores(r, c)
            sweep.submit(ti, tj, scores)
        if verbose:
            sweep.flush()
            print(f"[{algorithm.NAME}] block-row {ti + 1}/{n_tiles} "
                  f"(bucket {int(bucket_of[ti]) + 1}/{nb}, "
                  f"{time.perf_counter() - t1:.1f}s)", flush=True)
    Ds = sweep.finalize()
    if times is not None:
        times["sweep"] = time.perf_counter() - t1

    sorted_order = scores_dir is not None
    if not sorted_order:
        Ds = {k: D[np.ix_(inv, inv)] for k, D in Ds.items()}
    ret = [Ds]
    if return_desc:
        # the small keys only: pulling a device-resident bulk corpus (the
        # ssms) host-side would cost minutes for data nobody reads. Each
        # bucket's keys are dequantized BEFORE the merge, since buckets
        # may quantize different key sets.
        smalls = [_small_dequantized(d) for d in descs]
        keys = sorted(set.intersection(*[set(s) for s in smalls]))
        ret.append(_merge_bucket_descs(
            smalls, np.arange(n) if sorted_order else inv, keys=keys))
    if return_perm:
        ret.append(perm)
    return ret[0] if len(ret) == 1 else tuple(ret)


def run_pairwise_hybrid(
    algorithm: CoverAlgorithm,
    desc: dict,
    n_songs: int,
    panel_songs: int = 128,
    tile: int | None = None,
    scores_dir: str | None = None,
    checkpoint_path: str | None = None,
    checkpoint_every: int = 64,
    verbose: bool = False,
    skip_symmetrize: bool = False,
    panel_filter=None,
    prefetch_panels: bool = True,
    panel_times: list | None = None,
    device: str | torch.device = "cuda",
) -> dict:
    """Hybrid device-panel / disk-column sweep, for corpora whose
    descriptors fit neither device memory nor host RAM.

    A PANEL of `panel_songs` songs' descriptors stays on the device for
    its whole row sweep; column tiles stream from the disk store
    (`data.descstore.DescriptorStore` memmaps), and each uploaded column
    tile is scored against every row tile of the panel that still needs
    it, one `tile_scores` call a row tile (never all row tiles at once:
    a tile may build working copies of the column tile). Each descriptor
    byte thus crosses the host->device link once per panel instead of
    once per row tile. Zigzag column order across panels keeps the tail
    of one panel's columns in the host page cache for the next.

    The next two column tiles load on worker threads while the current
    one is scored, and with `prefetch_panels` the next panel's upload
    overlaps this panel's sweep (two panels on the device; turn it off
    when one panel already fills most of it). The copies are plain
    synchronous `.to(device)` calls on the device's default stream, so
    they are ordered with the scoring work. Resume, ledger and memmapped
    scores are `run_pairwise`'s. `panel_filter(p) -> bool` restricts the
    sweep to a subset of panels (the multi-process unit); `panel_times`,
    if given, receives the cumulative seconds at each panel's end.
    """
    tile = tile or algorithm.TILE
    panel_songs = -(-panel_songs // tile) * tile
    n_tiles = -(-n_songs // tile)
    tiles_per_panel = panel_songs // tile
    n_panels = -(-n_tiles // tiles_per_panel)

    sweep = _TileSweeper(algorithm.SIMILARITY_TYPES, n_songs, tile,
                         algorithm.SYMMETRIC, scores_dir,
                         checkpoint_path, checkpoint_every,
                         ckpt_extra={"hybrid_panel": panel_songs})
    done = sweep.done

    def needs(ti: int, tj: int) -> bool:
        return not done[ti, tj] and (not algorithm.SYMMETRIC or tj <= ti)

    def load_col(tj: int) -> dict:
        return _upload(_tile_slice(desc, tj * tile, (tj + 1) * tile, tile),
                       device)

    def load_panel(t_lo: int) -> dict:
        return _upload(_tile_slice(desc, t_lo * tile, t_lo * tile
                                   + panel_songs, panel_songs), device)

    # plan the active panels up front (a tile belongs to exactly one
    # panel's rows, so a later panel's ledger entries cannot change while
    # an earlier one sweeps): the plan lets panel p + 1's upload overlap
    # panel p's sweep
    plan = []
    for p in range(n_panels):
        if panel_filter is not None and not panel_filter(p):
            continue
        t_lo = p * tiles_per_panel
        row_tiles = range(t_lo, min(t_lo + tiles_per_panel, n_tiles))
        cols = _zigzag(p, row_tiles[-1] + 1 if algorithm.SYMMETRIC
                       else n_tiles)
        needed = [tj for tj in cols
                  if any(needs(ti, tj) for ti in row_tiles)]
        if needed:
            plan.append((p, t_lo, row_tiles, needed))

    t0 = time.time()
    with ThreadPoolExecutor(2) as prefetch, \
            ThreadPoolExecutor(1) as panel_pool:
        panel_fut = None
        for pi, (p, t_lo, row_tiles, needed) in enumerate(plan):
            with _prof.stages.stage("hybrid:panel_upload"):
                panel = (panel_fut.result() if panel_fut is not None
                         else load_panel(t_lo))
            panel_fut = (panel_pool.submit(load_panel, plan[pi + 1][1])
                         if prefetch_panels and pi + 1 < len(plan)
                         else None)
            futs = deque(prefetch.submit(load_col, tj)
                         for tj in needed[:2])
            for ci, tj in enumerate(needed):
                with _prof.stages.stage("hybrid:col_tile", panel=p, tj=tj):
                    col = futs.popleft().result()
                    if ci + 2 < len(needed):
                        futs.append(prefetch.submit(load_col,
                                                    needed[ci + 2]))
                    col = upcast_stream(col)
                for ti in row_tiles:
                    if not needs(ti, tj):
                        continue
                    i = (ti - t_lo) * tile
                    row = upcast_stream({k: v[i:i + tile]
                                         for k, v in panel.items()})
                    with _prof.stages.stage("score:tile"):
                        scores = algorithm.tile_scores(row, col)
                    sweep.submit(ti, tj, scores)
            del panel
            sweep.flush()
            if panel_times is not None:
                panel_times.append(time.time() - t0)
            if verbose:
                print(f"[{algorithm.NAME}] panel {p + 1}/{n_panels} "
                      f"({time.time() - t0:.1f}s)", flush=True)
    return sweep.finalize(skip_symmetrize)


def _sync(device) -> None:
    device = torch.device(device)
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def benchmark(
    algorithm: CoverAlgorithm,
    fs: FeatureSet,
    tile: int | None = None,
    results_csv: str | None = None,
    checkpoint_path: str | None = None,
    verbose: bool = False,
    device: str | torch.device = "cuda",
    times: dict | None = None,
    n_buckets: int = 1,
) -> dict[str, EvalStats]:
    """End-to-end: descriptors -> pair sweep -> retrieval metrics (+CSV).

    Runs on `device` (CUDA by default; "cpu" only when asked for). TF32
    matmuls are switched off first: they flip kNN decisions. `n_buckets >
    1` takes the length-bucketed sweep (for corpora with a wide
    song-length spread) unless the algorithm has `full_scores`; both
    sweeps checkpoint and resume with `checkpoint_path`. If `times` is
    given, the wall seconds of the extract, sweep and eval stages are
    stored in it (the sweep's ends at a device synchronize).
    """
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    device = torch.device(device)

    stage = {}
    if n_buckets > 1 and algorithm.full_scores is None:
        with _prof.stages.stage("extract+sweep:bucketed"):
            Ds, desc = run_pairwise_bucketed(
                algorithm, fs, n_buckets=n_buckets, tile=tile,
                verbose=verbose, checkpoint_path=checkpoint_path,
                return_desc=True, device=device, times=stage)
            _sync(device)
    else:
        t0 = time.perf_counter()
        with _prof.stages.stage("extract"):
            desc = algorithm.extract_descriptors(fs, device=device)
            _sync(device)
        t1 = time.perf_counter()
        with _prof.stages.stage("sweep"):
            Ds = run_pairwise(algorithm, desc, fs.n_songs, tile=tile,
                              checkpoint_path=checkpoint_path,
                              verbose=verbose, device=device)
            _sync(device)
        stage.update(extract=t1 - t0, sweep=time.perf_counter() - t1)
    t2 = time.perf_counter()
    with _prof.stages.stage("post_process"):
        Ds = algorithm.post_process(Ds, desc, device=device)
    out = {}
    for k, D in Ds.items():
        S = -D if k in algorithm.DISTANCE_TYPES else D
        with _prof.stages.stage("eval"):
            stats = eval_statistics(S, fs.labels)
        out[k] = stats
        if verbose:
            print(f"[{algorithm.NAME}:{k}] MR={stats.mr:.3g} "
                  f"MRR={stats.mrr:.3g} MDR={stats.mdr:.3g} "
                  f"MAP={stats.map:.3g}")
        if results_csv:
            write_results_csv(results_csv, algorithm.NAME, k, stats)
    if times is not None:
        times.update(stage, eval=time.perf_counter() - t2)
    return out
