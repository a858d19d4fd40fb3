"""Multi-process distribution of the pair sweep (port of
`acoss_tpu.parallel.distributed`).

The reference distributes across nodes with SGE array jobs + HDF5 batch
files merged by scatter-add (`CoverAlgorithm.py:249-317`,
`runcovers80.sh`). The port keeps that elastic, file-mediated structure at
the PROCESS level; each process drives its own device (within a process
the device-mesh sweeps of `parallel.mesh` apply):

0. `initialize()` wires `torch.distributed` from its arguments or the
   environment, for callers that want a process group;
1. block-rows of the tile grid are assigned to processes with a balanced
   greedy schedule (`assign_block_rows`: lower-triangular rows have
   unequal cost);
2. each process sweeps only its tiles (`run_pairwise(...,
   tile_filter=...)`, or whole panels of `run_pairwise_hybrid`) and
   writes a partial-score file;
3. `merge_partials` scatter-adds the partial matrices -- the "all-reduce
   over files" of `load_batches` (`CoverAlgorithm.py:297-317`) -- and
   symmetrizes once at the end.

Partials are the JAX package's layouts (`<NAME>_part_<pid>_<nproc>.npz`
with keys `D::<type>`, or a directory of `<type>.npy` memmaps), so a
partial written by either package merges in the other. Partial files are
idempotent, so preempted processes simply rerun.
"""

from __future__ import annotations

import os

import numpy as np
import torch

from acoss_tpu_torch.benchmarking.harness import (CoverAlgorithm,
                                                  _symmetrize_from_lower,
                                                  run_pairwise,
                                                  run_pairwise_hybrid)


def initialize(coordinator_address: str | None = None,
               num_processes: int | None = None,
               process_id: int | None = None,
               device: str | torch.device = "cuda") -> None:
    """`torch.distributed.init_process_group` pass-through: the NCCL
    backend for a CUDA `device`, gloo for the CPU. With
    `coordinator_address` ("host:port") the rendezvous is
    `tcp://<address>`; without it, the MASTER_ADDR / MASTER_PORT /
    WORLD_SIZE / RANK environment variables (`env://`). A None
    `num_processes` or `process_id` is read from the environment. No-op
    when num_processes == 1."""
    if num_processes == 1:
        return
    import torch.distributed as dist

    backend = "nccl" if torch.device(device).type == "cuda" else "gloo"
    init = (f"tcp://{coordinator_address}" if coordinator_address
            else "env://")
    dist.init_process_group(
        backend, init_method=init,
        world_size=-1 if num_processes is None else num_processes,
        rank=-1 if process_id is None else process_id)


def _stem(algorithm, process_id: int, num_processes: int) -> str:
    return f"{algorithm.NAME}_part_{process_id}_{num_processes}"


def assign_block_rows(n_tiles: int, num_processes: int,
                      symmetric: bool = True) -> list[np.ndarray]:
    """Balanced assignment of tile-grid block-rows to processes.

    Lower-triangular row ti costs (ti + 1) tiles; greedy longest-first
    keeps the per-process tile counts within one row of optimal.
    """
    costs = [(ti + 1 if symmetric else n_tiles, ti)
             for ti in range(n_tiles)]
    costs.sort(reverse=True)
    loads = np.zeros(num_processes, dtype=np.int64)
    rows: list[list[int]] = [[] for _ in range(num_processes)]
    for cost, ti in costs:
        p = int(np.argmin(loads))
        loads[p] += cost
        rows[p].append(ti)
    return [np.array(sorted(r), dtype=np.int64) for r in rows]


def run_process_shard(
    algorithm: CoverAlgorithm,
    desc: dict,
    n_songs: int,
    process_id: int,
    num_processes: int,
    out_dir: str,
    tile: int | None = None,
    verbose: bool = False,
    memmap_scores: bool = False,
    device: str | torch.device = "cuda",
) -> str:
    """Sweep this process's block-rows on `device` and write the partial
    scores.

    Returns the partial path (idempotent: rerunning overwrites). With
    `memmap_scores` the partial is a DIRECTORY of `.npy` memmaps (one per
    similarity type) written in place by the sweep -- no dense partial
    ever sits in RAM, the Da-TACOS-scale mode."""
    tile = tile or algorithm.TILE
    os.makedirs(out_dir, exist_ok=True)
    stem = _stem(algorithm, process_id, num_processes)
    if algorithm.full_scores is not None:
        # One-shot scorers (FTM2D, ANFScattering, Struc* Grams) compute
        # the whole matrix in one call -- there are no tiles to shard.
        # Process 0 computes it as its partial; the other shards write an
        # EMPTY partial so the merge stays uniform (every shard computing
        # the full matrix would make the merge add num_processes copies).
        path = os.path.join(out_dir, stem + ".npz")
        if process_id == 0:
            Ds = run_pairwise(algorithm, desc, n_songs, tile=tile,
                              verbose=verbose, device=device)
            np.savez(path, **{f"D::{k}": v for k, v in Ds.items()})
        else:
            np.savez(path)
        return path
    n_tiles = -(-n_songs // tile)
    mine = set(assign_block_rows(n_tiles, num_processes,
                                 algorithm.SYMMETRIC)[process_id].tolist())
    scores_dir = os.path.join(out_dir, stem) if memmap_scores else None
    Ds = run_pairwise(algorithm, desc, n_songs, tile=tile, verbose=verbose,
                      tile_filter=lambda ti, tj: ti in mine,
                      skip_symmetrize=True, scores_dir=scores_dir,
                      device=device)
    if memmap_scores:
        for D in Ds.values():
            D.flush()
        return scores_dir
    path = os.path.join(out_dir, stem + ".npz")
    np.savez(path, **{f"D::{k}": v for k, v in Ds.items()})
    return path


def run_process_shard_hybrid(
    algorithm: CoverAlgorithm,
    desc: dict,
    n_songs: int,
    process_id: int,
    num_processes: int,
    out_dir: str,
    panel_songs: int = 128,
    tile: int | None = None,
    verbose: bool = False,
    prefetch_panels: bool = True,
    device: str | torch.device = "cuda",
) -> str:
    """One process's share of the hybrid device-panel / disk-column sweep
    (descriptors too big for device memory AND host RAM).

    The decomposition unit is the PANEL (a block of rows kept on the
    device for its whole sweep): panels are assigned to processes with the
    same balanced greedy schedule as tile rows (symmetric panel p costs
    ~p+1 column tiles), each process streams column tiles from the SHARED
    disk store (`desc` should be a `DescriptorStore`) and writes its
    partial scores as a directory of per-type `.npy` memmaps -- nothing
    dense in RAM. Merge with `merge_partials`, exactly like
    `run_process_shard(memmap_scores=True)` partials."""
    tile = tile or algorithm.TILE
    panel_r = -(-panel_songs // tile) * tile
    tiles_per_panel = panel_r // tile
    n_tiles = -(-n_songs // tile)
    n_panels = -(-n_tiles // tiles_per_panel)
    mine = set(assign_block_rows(
        n_panels, num_processes,
        algorithm.SYMMETRIC)[process_id].tolist())
    os.makedirs(out_dir, exist_ok=True)
    scores_dir = os.path.join(out_dir,
                              _stem(algorithm, process_id, num_processes))
    Ds = run_pairwise_hybrid(
        algorithm, desc, n_songs, panel_songs=panel_songs, tile=tile,
        scores_dir=scores_dir, verbose=verbose, skip_symmetrize=True,
        panel_filter=lambda p: p in mine,
        prefetch_panels=prefetch_panels, device=device)
    for D in Ds.values():
        D.flush()
    return scores_dir


def merge_partials(paths: list[str], symmetric: bool = True,
                   out_dir: str | None = None) -> dict:
    """Scatter-add partial score files into the full matrices
    (`load_batches`, `CoverAlgorithm.py:297-317`).

    Accumulates IN PLACE (peak host memory = the full matrices + one
    partial's single type, not + a whole partial), optionally into `.npy`
    memmaps under `out_dir` so the merged matrices never have to fit in
    RAM at Da-TACOS scale. Each partial may be a `.npz` file (keys
    `D::<type>`) or a DIRECTORY of per-type `.npy` memmaps written by
    `run_process_shard(memmap_scores=True)`."""

    def _items(p):
        if os.path.isdir(p):
            for fn in sorted(os.listdir(p)):
                if fn.endswith(".npy"):
                    yield (os.path.splitext(fn)[0],
                           np.load(os.path.join(p, fn), mmap_mode="r"))
        else:
            with np.load(p) as z:
                for k in z.files:
                    yield k[3:], z[k]

    Ds: dict = {}
    for p in paths:
        for name, arr in _items(p):
            if name not in Ds:
                if out_dir is not None:
                    os.makedirs(out_dir, exist_ok=True)
                    Ds[name] = np.lib.format.open_memmap(
                        os.path.join(out_dir, f"{name}.npy"),
                        mode="w+", dtype=np.float32, shape=arr.shape)
                    Ds[name][:] = 0.0
                else:
                    Ds[name] = np.zeros(arr.shape, np.float32)
            Ds[name] += arr
    if symmetric:
        for k in Ds:
            # partials hold disjoint strict-lower tiles, so mirroring the
            # lower triangle (blockwise, idempotent) is exact and never
            # materializes a transposed temporary
            _symmetrize_from_lower(Ds[k])
    return Ds
