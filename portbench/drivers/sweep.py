"""The pair-sweep traffic: `harness.run_pairwise` over consecutive bands of
block-rows of the corpus's pair grid, as a process shard sweeps its share
(`tile_filter`), starting a fresh sweep when the grid is done.

Traffic parameters (the cell's `traffic`):
  engine      "stream": the corpus's int8 descriptor store is written by
              `descstore.extract_streamed` in set-up and the sweep streams
              each tile from its memmaps, with `scores_dir` memmaps and
              the tile ledger; "resident": the descriptors are extracted
              once and kept on the device, scores in RAM
  tile        songs a side of a tile
  band_rows   block-rows a band

The window ends at the end of a band, which ends at a flush (the scores
on the host) and a synchronise. `pairs_per_s` is the pairs of every band
the window finished over the window's seconds.
"""

from __future__ import annotations

import os
import shutil
import time

import numpy as np
import torch

from portbench import corpus as C

#: tiles between two writes of the tile ledger, as the 15,000-song run
#: writes it (`scripts/torch_datacos15k.py --checkpoint-every`)
CHECKPOINT_EVERY = 256
#: the band of the window the traced run profiles (0 is the first)
TRACE_BAND = 3
#: the check draws one off-diagonal tile from each of this many equal
#: runs of the finished block-rows, beside a diagonal tile and a tile of
#: the last block-row
CHECK_TILES = 8


def band_pairs(n: int, tile: int, lo: int, hi: int) -> int:
    """Distinct song pairs (i > j) whose tiles lie in block-rows [lo, hi)
    of a symmetric sweep over n songs."""
    first, last = min(lo * tile, n), min(hi * tile, n)
    return sum(i for i in range(first, last))


class Driver:
    def __init__(self, run):
        self.run = run
        self.t = run.traffic
        self.tile = int(self.t["tile"])
        self.stream = self.t["engine"] == "stream"

    # -- set-up ----------------------------------------------------------
    def setup(self) -> None:
        from acoss_tpu_torch.benchmarking.harness import run_pairwise

        run = self.run
        self.algo = C.algorithm(run.config)
        self.corpus = C.Corpus(run.config, run.seed)
        self.n = self.corpus.n_songs
        if self.stream:
            self.desc = dict(C.streamed_store(run, self.algo, self.corpus))
            self.scores_dir = os.path.join(run.workdir, "scores")
            self.ledger = os.path.join(run.workdir, "ledger.npz")
        else:
            fs = C.feature_set(self.corpus.songs, self.corpus.labels)
            self.desc = self.algo.extract_descriptors(fs, device=run.device)
            del fs
            self.scores_dir = self.ledger = None
            self.acc = {k: np.zeros((self.n, self.n), np.float32)
                        for k in self.algo.SIMILARITY_TYPES}
        self.n_tiles = -(-self.n // self.tile)
        rows = int(self.t["band_rows"])
        self.bands = [(lo, min(lo + rows, self.n_tiles))
                      for lo in range(0, self.n_tiles, rows)]
        # warm-up: one off-diagonal tile through the window's own path
        # (kernel build, cuBLAS, the allocator); scores to scratch
        run_pairwise(self.algo, self.desc, self.n, tile=self.tile,
                     tile_filter=lambda ti, tj: (ti, tj) == (1, 0),
                     skip_symmetrize=True, device_resident=not self.stream,
                     device=run.device)

    # -- the window ----------------------------------------------------------
    def _band(self, lo: int, hi: int) -> None:
        from acoss_tpu_torch.benchmarking.harness import run_pairwise

        Ds = run_pairwise(
            self.algo, self.desc, self.n, tile=self.tile,
            tile_filter=lambda ti, tj: lo <= ti < hi,
            skip_symmetrize=True, scores_dir=self.scores_dir,
            checkpoint_path=self.ledger,
            checkpoint_every=CHECKPOINT_EVERY,
            device_resident=not self.stream, device=self.run.device)
        if not self.stream:
            a, b = lo * self.tile, min(hi * self.tile, self.n)
            for k, D in Ds.items():
                self.acc[k][a:b] = D[a:b]

    def window(self, seconds: float, tracer) -> dict:
        done = set()
        pairs = 0
        tiles = 0
        k = 0
        t0 = time.perf_counter()
        while True:
            b = k % len(self.bands)
            if b == 0 and self.ledger and os.path.exists(self.ledger):
                os.remove(self.ledger)             # a fresh sweep
            lo, hi = self.bands[b]
            n_tiles = sum(ti + 1 for ti in range(lo, hi))
            if k == TRACE_BAND:
                with tracer.stretch(n_tiles):
                    self._band(lo, hi)
            else:
                self._band(lo, hi)
            done.add(b)
            pairs += band_pairs(self.n, self.tile, lo, hi)
            tiles += n_tiles
            k += 1
            elapsed = time.perf_counter() - t0
            if elapsed >= seconds and k > TRACE_BAND:
                break
        self.done_bands = done
        return {"metrics": {"pairs_per_s": pairs / elapsed},
                "attempted": pairs, "failed": 0, "seconds": elapsed,
                "tiles": tiles}

    # -- the check -----------------------------------------------------------
    def _pick_tiles(self) -> list:
        """The tiles the check compares, drawn from the seed among those
        the window finished: one off the diagonal from each of
        `CHECK_TILES` equal runs of the finished block-rows (so every
        stretch of the grid, and of the store's chunks, has one), one on
        the diagonal (its triangle mask), and where the last block-row is
        partial, one of it (the padded slice)."""
        rng = np.random.default_rng([self.run.seed, 17])
        rows = sorted(ti for b in self.done_bands
                      for ti in range(*self.bands[b]))
        pick = set()
        for part in np.array_split(np.asarray(rows), CHECK_TILES):
            cand = [(int(ti), tj) for ti in part for tj in range(ti)]
            if cand:
                pick.add(cand[int(rng.integers(len(cand)))])
        ti = rows[int(rng.integers(len(rows)))]
        pick.add((ti, ti))
        last = self.n_tiles - 1
        if self.n % self.tile and last in rows and last > 0:
            pick.add((last, int(rng.integers(last))))
        return sorted(pick)

    def checked(self, ti: int, tj: int, scores) -> np.ndarray:
        """The entries of tile (ti, tj)'s (rows, cols) scores the sweep
        writes, flat: every pair, or on the diagonal the pairs i > j."""
        scores = np.asarray(scores)
        if ti != tj:
            return scores.reshape(-1)
        return scores[np.tril_indices(scores.shape[0], -1, scores.shape[1])]

    def answers(self) -> dict:
        """The program's scores of a seeded sample of finished tiles."""
        self.sample = self._pick_tiles()
        Ds = (self.acc if not self.stream else
              {k: np.load(os.path.join(self.scores_dir, f"{k}.npy"),
                          mmap_mode="r")
               for k in self.algo.SIMILARITY_TYPES})
        prog = {}
        for k, D in Ds.items():
            prog[k] = np.concatenate([
                self.checked(ti, tj, D[self._rows(ti)][:, self._rows(tj)])
                for ti, tj in self.sample])
        return {"program": prog}

    def _rows(self, t: int):
        return np.arange(t * self.tile, min((t + 1) * self.tile, self.n))

    def release(self) -> None:
        self.desc = None
        self.acc = None
        if self.scores_dir:
            shutil.rmtree(os.path.join(self.run.workdir, "store"),
                          ignore_errors=True)

    def reference(self, answers: dict, dtype=None) -> dict:
        """The reference's scores of the sampled tiles, from the raw
        songs."""
        out: dict = {}
        for ti, tj in self.sample:
            rows, cols = self._rows(ti), self._rows(tj)
            d = C.reference_descriptors(
                self.run, self.corpus, np.concatenate([rows, cols]),
                int8=self.stream)
            r = C.take(d, np.arange(len(rows)))
            c = C.take(d, np.arange(len(rows), len(rows) + len(cols)))
            for k, v in C.reference_tile(self.run, r, c, dtype).items():
                out.setdefault(k, []).append(self.checked(ti, tj, v))
            del d, r, c
            if self.run.device.type == "cuda":
                torch.cuda.empty_cache()
        return {k: np.concatenate(v) for k, v in out.items()}
