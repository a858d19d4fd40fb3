"""The device-mesh traffic: whole-corpus sweeps of the triangular fold
(`parallel.mesh.sharded_pair_scores_triangular`, the CLI's `--mesh RxC`
for a symmetric algorithm) back to back, closed loop, each gathering the
symmetric score matrices into host memory as the CLI has them before its
evaluation.

Traffic parameters (the cell's `traffic`):
  mesh      "RxC": the grid of devices, flattened for the fold as the CLI
            does; the run's device "cuda" takes the first R x C cards, a
            named device ("cuda:0", "cpu") fills every slot
  col_tile  songs a column tile of a device block (the CLI's `-t`)

Set-up renders the corpus from the seed, extracts its descriptors on the
mesh's first device (as the CLI does, into host arrays) and sweeps once
(every call shape of the window, on every device). The window ends at the
end of a sweep; `pairs_per_s` is N(N-1)/2 pairs a finished sweep over the
window's seconds. The window also reports the seconds spent inside the
sweeps (`sweep_seconds`: a traced window's profiler read-back left out)
and the indices of the mesh's cards (`cards`).
"""

from __future__ import annotations

import time

import numpy as np
import torch

from portbench import corpus as C
from portbench.data.synthetic import Renderer

#: the sweep of the window the traced run profiles (0 is the first)
TRACE_SWEEP = 1


class Driver:
    def __init__(self, run):
        self.run = run
        r, c = (int(x) for x in run.traffic["mesh"].split("x"))
        self.shape = (r, c)
        self.col_tile = int(run.traffic["col_tile"])

    # -- set-up ----------------------------------------------------------
    def setup(self) -> None:
        from acoss_tpu_torch.parallel.mesh import (make_pair_mesh,
                                                   mesh_devices)

        run = self.run
        r, c = self.shape
        self.devices = list(make_pair_mesh(
            mesh_devices(run.device, r * c), (r, c)).ravel())
        self.algo = C.algorithm(run.config)
        self.corpus = C.Corpus(run.config, run.seed)
        self.n = self.corpus.n_songs
        with Renderer(C.render_workers()) as renderer:
            songs = self.corpus.raw(np.arange(self.n), renderer)
        fs = C.feature_set(songs, self.corpus.labels)
        del songs
        self.desc = self.algo.extract_descriptors(fs, device=self.devices[0])
        del fs
        two_d = 2 * len(self.devices)
        # the fold's chunk, as `sharded_pair_scores_triangular` cuts it
        chunk = max(-(-self.n // two_d), self.col_tile)
        self.chunk = -(-chunk // self.col_tile) * self.col_tile
        self.calls = self._sweep_calls()
        self.Ds = self._sweep()
        self._synchronize()

    def _sweep_calls(self) -> int:
        """The `tile_scores` calls of one sweep: 2D + 1 chunk x chunk
        blocks a device, each a column tile by row sub-block."""
        from acoss_tpu_torch.parallel.mesh import MAX_PAIRS_PER_CALL

        sub = max(1, MAX_PAIRS_PER_CALL // self.col_tile)
        d = len(self.devices)
        return (d * (2 * d + 1) * -(-self.chunk // sub)
                * (self.chunk // self.col_tile))

    def _sweep(self) -> dict:
        from acoss_tpu_torch.parallel.mesh import \
            sharded_pair_scores_triangular

        return sharded_pair_scores_triangular(
            self.algo.tile_scores, self.desc, self.n, devices=self.devices,
            col_tile=self.col_tile)

    def _synchronize(self) -> None:
        for dev in {d for d in self.devices if d.type == "cuda"}:
            torch.cuda.synchronize(dev)

    # -- the window ----------------------------------------------------------
    def window(self, seconds: float, tracer) -> dict:
        pairs = self.n * (self.n - 1) // 2
        k = 0
        in_sweeps = 0.0
        t0 = time.perf_counter()
        while True:
            t = time.perf_counter()
            if k == TRACE_SWEEP:
                with tracer.stretch(self.calls):
                    self.Ds = self._sweep()
                    # the stretch synchronises only the current device
                    self._synchronize()
                    in_sweeps += time.perf_counter() - t
            else:
                self.Ds = self._sweep()
                in_sweeps += time.perf_counter() - t
            k += 1
            elapsed = time.perf_counter() - t0
            if elapsed >= seconds and k > TRACE_SWEEP:
                break
        return {"metrics": {"pairs_per_s": pairs * k / elapsed},
                "attempted": pairs * k, "failed": 0, "seconds": elapsed,
                "sweep_seconds": in_sweeps,
                "cards": sorted({d.index for d in self.devices
                                 if d.type == "cuda"})}

    # -- the check -----------------------------------------------------------
    def _pick_tiles(self) -> list:
        """(kind, ti, tj) of the col_tile-sided tiles the check compares,
        drawn from the seed: for each device a tile off the diagonal of
        one of its fold blocks (a device whose blocks hold no song pair
        below the diagonal has none), a tile of the upper triangle (kind
        "upper": the mirror), a tile on the diagonal (its strict lower
        pairs, the zero diagonal and the mirror), and a tile of the last,
        partial row of tiles, in the fold's last chunk with the padding."""
        from acoss_tpu_torch.parallel.mesh import fold_blocks

        rng = np.random.default_rng([self.run.seed, 19])
        n_t = -(-self.n // self.col_tile)
        per = self.chunk // self.col_tile
        pick = []
        for owned in fold_blocks(len(self.devices)):
            cand = [(ti, tj) for rc, cc in owned
                    for ti in range(rc * per, min((rc + 1) * per, n_t))
                    for tj in range(cc * per, min((cc + 1) * per, ti))]
            if cand:
                pick.append(("lower", *cand[int(rng.integers(len(cand)))]))
        ti = int(rng.integers(1, n_t))
        pick.append(("upper", ti, int(rng.integers(ti))))
        ti = int(rng.integers(n_t))
        pick.append(("diagonal", ti, ti))
        pick.append(("lower", n_t - 1, int(rng.integers(n_t - 1))))
        return pick

    def _rows(self, t: int):
        return np.arange(t * self.col_tile,
                         min((t + 1) * self.col_tile, self.n))

    def answers(self) -> dict:
        """The last sweep's scores of a seeded sample of tiles."""
        self.sample = self._pick_tiles()
        prog: dict = {}
        for kind, ti, tj in self.sample:
            a, b = (tj, ti) if kind == "upper" else (ti, tj)
            for k, D in self.Ds.items():
                prog.setdefault(k, []).append(
                    D[self._rows(a)][:, self._rows(b)].reshape(-1))
        return {"program": {k: np.concatenate(v) for k, v in prog.items()}}

    def release(self) -> None:
        self.desc = None
        self.Ds = None

    def reference(self, answers: dict, dtype=None) -> dict:
        """The reference's scores of the sampled tiles, from the raw
        songs: a pair (i > j) scores row song i against column song j;
        the upper triangle is the lower one's mirror and the diagonal
        0."""
        out: dict = {}
        for kind, ti, tj in self.sample:
            rows, cols = self._rows(ti), self._rows(tj)
            d = C.reference_descriptors(
                self.run, self.corpus, np.concatenate([rows, cols]),
                int8=False)
            r = C.take(d, np.arange(len(rows)))
            c = C.take(d, np.arange(len(rows), len(rows) + len(cols)))
            for k, v in C.reference_tile(self.run, r, c, dtype).items():
                if kind == "upper":
                    v = v.T
                elif kind == "diagonal":
                    v = np.tril(v, -1)
                    v = v + v.T
                out.setdefault(k, []).append(v.reshape(-1))
            del d, r, c
            if self.run.device.type == "cuda":
                torch.cuda.empty_cache()
        return {k: np.concatenate(v) for k, v in out.items()}
