"""The pair-grid benchmark harness (port of the RAM-resident sweep of
`acoss_tpu.benchmarking.harness`).

The N x N pair grid is cut into (tile x tile) blocks; each block's scores
come from ONE `tile_scores` call over the cross product of a row block and
a column block of songs, and blocks stream back into host score matrices.
Symmetric algorithms score only block-row >= block-column and keep the
strict lower triangle, then mirror it (the reference's combinations +
`D += D.T`). A resumable `.npz` ledger records finished tiles; its format
is the JAX package's, so a sweep started by either package resumes in the
other.

Algorithms implement:
  - ``extract_descriptors(fs, device) -> dict[str, np.ndarray]``: per-song
    compact descriptors (batched arrays, leading dim N).
  - ``tile_scores(row_desc, col_desc) -> dict[type, (bi, bj) tensor]``:
    scoring of the full cross product of a row block against a column
    block of songs, on the descriptors' device.
"""

from __future__ import annotations

import os
import time

import numpy as np
import torch

from acoss_tpu_torch.benchmarking.evaluation import (EvalStats,
                                                     eval_statistics,
                                                     write_results_csv)
from acoss_tpu_torch.convert import descriptors_from_numpy
from acoss_tpu_torch.data.store import FeatureSet


class CoverAlgorithm:
    """Base class for cover-song scoring algorithms."""

    NAME = "base"
    SIMILARITY_TYPES: tuple = ("main",)
    #: similarity types holding DISTANCES (lower = more similar); these are
    #: negated before ranking.
    DISTANCE_TYPES: tuple = ()
    SYMMETRIC = True
    TILE = 16

    def extract_descriptors(self, fs: FeatureSet,
                            device: str | torch.device = "cuda") -> dict:
        raise NotImplementedError

    def tile_scores(self, row_desc: dict, col_desc: dict) -> dict:
        raise NotImplementedError

    def post_process(self, Ds: dict, desc: dict,
                     device: str | torch.device = "cuda") -> dict:
        """Optional hook applied to the full (host numpy) score matrices
        after the sweep; `device` is the benchmark's device, on which it
        runs its tensor work."""
        return Ds


class _TileSweeper:
    """Score-matrix storage in host RAM, the resumable tile ledger, the
    pending buffer of device-resident tile results with batched readback
    flushes, and the lower-triangle symmetrization."""

    #: tiles whose device-resident results are read back in one transfer
    FLUSH_EVERY = 128

    def __init__(self, sim_types, n_songs: int, tile: int,
                 symmetric: bool, checkpoint_path: str | None,
                 checkpoint_every: int = 16):
        self.sim_types = tuple(sim_types)
        self.n_songs = n_songs
        self.tile = tile
        self.symmetric = symmetric
        self.checkpoint_path = checkpoint_path
        self.checkpoint_every = checkpoint_every
        self.n_tiles = n_tiles = -(-n_songs // tile)
        self.Ds = {k: np.zeros((n_songs, n_songs), np.float32)
                   for k in self.sim_types}
        self.done = np.zeros((n_tiles, n_tiles), dtype=bool)

        if checkpoint_path and os.path.exists(checkpoint_path):
            with np.load(checkpoint_path) as z:
                # a ledger with extra meta keys (a bucketed sweep's, whose
                # tiles index a length-sorted order) is not this sweep's
                extra = {k for k in z.files
                         if k not in ("done", "tile", "n_songs")
                         and not k.startswith("D::")}
                if (int(z["tile"]) == tile and int(z["n_songs"]) == n_songs
                        and not extra):
                    self.done = z["done"]
                    for k in self.Ds:
                        self.Ds[k] = z[f"D::{k}"]

        self._row_idx = np.arange(tile)
        self._pending: list = []
        self._n_done_this_run = 0

    def save_ckpt(self) -> None:
        if not self.checkpoint_path:
            return
        payload = {"done": self.done, "tile": self.tile,
                   "n_songs": self.n_songs}
        for k, D in self.Ds.items():
            payload[f"D::{k}"] = D
        tmp = self.checkpoint_path + ".tmp.npz"
        np.savez(tmp, **payload)
        os.replace(tmp, self.checkpoint_path)

    def flush(self) -> None:
        """Read back all pending tile results in ONE stacked transfer per
        similarity type and scatter them into the matrices."""
        if not self._pending:
            return
        stacked = {k: torch.stack([p[2][k] for p in self._pending])
                   .cpu().numpy() for k in self.sim_types}
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
                self.Ds[k][ij[0][keep], ij[1][keep]] = stacked[k][b][keep]
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

    def finalize(self) -> dict:
        self.flush()
        self.save_ckpt()
        if self.symmetric:
            for k in self.Ds:
                L = np.tril(self.Ds[k], -1)
                self.Ds[k] = L + L.T
        return self.Ds


def run_pairwise(
    algorithm: CoverAlgorithm,
    desc: dict,
    n_songs: int,
    tile: int | None = None,
    checkpoint_path: str | None = None,
    checkpoint_every: int = 16,
    verbose: bool = False,
    device: str | torch.device = "cuda",
) -> dict:
    """Sweep the pair grid, returning {similarity_type: (N, N) np.float32}.

    The padded descriptor corpus (numpy arrays or tensors) is uploaded to
    `device` ONCE; every tile is a slice of it, so no descriptor bytes
    cross the host link during the sweep. When n_songs is not a multiple
    of the tile, only the last block of songs is copied and zero-padded
    to a full tile (the corpus itself is never copied: the ssms corpus of
    EarlySNF is gigabytes). Tile results stay on the device until a
    batched flush. With `checkpoint_path`, the ledger of completed tiles
    plus the partial score matrices is saved every `checkpoint_every`
    tiles and the sweep resumes from it.
    """
    tile = tile or algorithm.TILE
    n_tiles = -(-n_songs // tile)
    sweep = _TileSweeper(algorithm.SIMILARITY_TYPES, n_songs, tile,
                         algorithm.SYMMETRIC, checkpoint_path,
                         checkpoint_every)
    dd = descriptors_from_numpy(desc, device)
    first = (n_tiles - 1) * tile          # of the last block of songs
    last = {k: torch.cat([v[first:], v.new_zeros(
        (n_tiles * tile - v.shape[0],) + v.shape[1:])]) for k, v in dd.items()}

    def block(i: int) -> dict:
        """Songs [i * tile, (i + 1) * tile) of every descriptor."""
        if i == n_tiles - 1:
            return last
        return {k: v[i * tile:(i + 1) * tile] for k, v in dd.items()}

    t0 = time.time()
    for ti in range(n_tiles):
        # zigzag column order: consecutive tiles share a block
        cols = list(range(ti + 1) if algorithm.SYMMETRIC
                    else range(n_tiles))
        if ti % 2 == 1:
            cols = cols[::-1]
        cols = [tj for tj in cols if not sweep.done[ti, tj]]
        if not cols:
            continue
        row = block(ti)
        for tj in cols:
            sweep.submit(ti, tj, algorithm.tile_scores(row, block(tj)))
        if verbose:
            sweep.flush()
            print(f"[{algorithm.NAME}] block-row {ti + 1}/{n_tiles} "
                  f"({time.time() - t0:.1f}s)")
    return sweep.finalize()


def benchmark(
    algorithm: CoverAlgorithm,
    fs: FeatureSet,
    tile: int | None = None,
    results_csv: str | None = None,
    checkpoint_path: str | None = None,
    verbose: bool = False,
    device: str | torch.device = "cuda",
    times: dict | None = None,
) -> dict[str, EvalStats]:
    """End-to-end: descriptors -> pair sweep -> retrieval metrics (+CSV).

    Runs on `device` (CUDA by default; "cpu" only when asked for). TF32
    matmuls are switched off first: they flip kNN decisions. If `times`
    is given, the wall seconds of the extract, sweep and eval stages are
    stored in it (the sweep's ends at a device synchronize).
    """
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    device = torch.device(device)

    def sync():
        if device.type == "cuda":
            torch.cuda.synchronize(device)

    t0 = time.perf_counter()
    desc = algorithm.extract_descriptors(fs, device=device)
    sync()
    t1 = time.perf_counter()
    Ds = run_pairwise(algorithm, desc, fs.n_songs, tile=tile,
                      checkpoint_path=checkpoint_path, verbose=verbose,
                      device=device)
    sync()
    t2 = time.perf_counter()
    Ds = algorithm.post_process(Ds, desc, device=device)
    out = {}
    for k, D in Ds.items():
        S = -D if k in algorithm.DISTANCE_TYPES else D
        stats = eval_statistics(S, fs.labels)
        out[k] = stats
        if verbose:
            print(f"[{algorithm.NAME}:{k}] MR={stats.mr:.3g} "
                  f"MRR={stats.mrr:.3g} MDR={stats.mdr:.3g} "
                  f"MAP={stats.map:.3g}")
        if results_csv:
            write_results_csv(results_csv, algorithm.NAME, k, stats)
    if times is not None:
        times.update(extract=t1 - t0, sweep=t2 - t1,
                     eval=time.perf_counter() - t2)
    return out
