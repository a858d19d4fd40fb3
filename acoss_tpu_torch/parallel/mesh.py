"""Sharding the N x N pair grid over a grid of devices (port of
`acoss_tpu.parallel.mesh`).

The reference's "distributed backend" is joblib + SGE array jobs writing
disjoint memmap cells / HDF5 batch files (`CoverAlgorithm.py:138-317`).
Here a mesh is an explicit (r, c) grid of `torch.device`s over the pair
grid itself: row songs are split over the mesh's rows, column songs over
its columns, and every device scores its (N/r x N/c) block of pairs with
no communication (the outer-product structure of the pair sweep is the
whole distribution strategy; the host gathers the blocks). This is the
block arithmetic of `do_batch_subbatch` (`CoverAlgorithm.py:203-247`).

Inside a device block, columns go in tiles of `col_tile` and rows in
sub-blocks of at most `MAX_PAIRS_PER_CALL // col_tile` songs, so one
`tile_scores` call scores a bounded number of pairs whatever the corpus
(the CUDA selection kernels put a call's pairs on a grid axis of at most
65,535 blocks, and each pair's CRP scratch is its own L x L). Scores are
per pair, so the split does not change them.

A device may appear more than once in a mesh (`[torch.device("cpu")] * 8`,
or one card repeated): its blocks then run one after another. The calls
are enqueued round robin, one a device slot a turn (each slot's in its
own block order), and every block before the first readback: a CUDA
stream holds only about a thousand pending launches before the host
blocks in it, so a slot enqueued whole would hold the host until that
card had nearly drained, and the cards would run one after another.

Spans and counters (`utils.profiling.stages`): `mesh:restore` (a slot's
rows and columns copied to its device and restored to fp32), `mesh:enqueue`
(one `tile_scores` call), `mesh:gather` (a block read back into the host
matrix), `mesh:fold` (the fold's triangle, mirror and crop; the
rectangular sweep's crop); counters `mesh:calls` (calls enqueued) and
`mesh:blocks` (blocks read back).
"""

from __future__ import annotations

import contextlib
import math

import numpy as np
import torch

from acoss_tpu_torch.data.descstore import upcast_stream
from acoss_tpu_torch.utils.profiling import stages

#: The most pairs one `tile_scores` call of a mesh block scores.
MAX_PAIRS_PER_CALL = 4096


def mesh_devices(device: str | torch.device, n: int) -> list:
    """`n` device slots for a mesh: with a bare "cuda", the first `n`
    visible cards (fewer raises, and no card raises); a device that names
    one device ("cpu", "cuda:0") fills every slot."""
    device = torch.device(device)
    if device.type != "cuda" or device.index is not None:
        return [device] * n
    have = torch.cuda.device_count()
    if have < n:
        raise RuntimeError(f"a mesh of {n} devices needs {n} CUDA devices, "
                           f"{have} visible (name one device, such as "
                           f"cuda:0 or cpu, to repeat it)")
    return [torch.device("cuda", i) for i in range(n)]


def make_pair_mesh(devices=None, shape: tuple[int, int] | None = None
                   ) -> np.ndarray:
    """An (r, c) grid (an object array) of `torch.device`s over the pair
    grid. `devices` defaults to every visible CUDA device (none raises);
    `shape` defaults to r <= c, r * c = len(devices), r as large as
    divides."""
    if devices is None:
        devices = [torch.device("cuda", i)
                   for i in range(torch.cuda.device_count())]
        if not devices:
            raise RuntimeError("no CUDA device for a pair mesh")
    devices = [torch.device(d) for d in devices]
    n = len(devices)
    if shape is None:
        r = int(math.isqrt(n))
        while n % r:
            r -= 1
        shape = (r, n // r)
    if shape[0] * shape[1] != n:
        raise ValueError(f"cannot arrange {n} devices as a {shape[0]} x "
                         f"{shape[1]} mesh")
    grid = np.empty(n, dtype=object)
    grid[:] = devices
    return grid.reshape(shape)


def _pad_rows(desc: dict, n_to: int) -> dict:
    """Every leaf zero-padded along its song axis to `n_to` rows."""
    out = {}
    for k, v in desc.items():
        if isinstance(v, torch.Tensor):
            out[k] = torch.cat([v, v.new_zeros((n_to - v.shape[0],)
                                               + v.shape[1:])])
        else:
            v = np.asarray(v)
            out[k] = np.pad(v, [(0, n_to - v.shape[0])]
                            + [(0, 0)] * (v.ndim - 1))
    return out


def _rows_on(desc: dict, lo: int, hi: int, device) -> dict:
    """Rows [lo, hi) of every leaf, copied to `device`: a host leaf in one
    copy (a 98 MB corpus takes ~12 ms to a card where a host copy first
    took ~37 ms, H100)."""
    return {k: v[lo:hi].to(device) if isinstance(v, torch.Tensor)
            else torch.from_numpy(np.ascontiguousarray(v[lo:hi])).to(
                device, copy=True)
            for k, v in desc.items()}


def _slice(desc: dict, lo: int, hi: int) -> dict:
    return {k: v[lo:hi] for k, v in desc.items()}


def _device_scope(device: torch.device):
    """The device current while a block is enqueued (CUDA only)."""
    return torch.cuda.device(device) if device.type == "cuda" \
        else contextlib.nullcontext()


def _slot_calls(tile_scores_fn, dev: torch.device, load, col_tile: int,
                done: list):
    """A generator that enqueues one device slot's `tile_scores` calls, one
    a step. `load()` (run on the slot's first step, under the slot's
    device) returns its blocks, [(key, rows, cols)] of fp32 leaves on
    `dev`; in each block, row sub-blocks of at most MAX_PAIRS_PER_CALL //
    col_tile songs meet column tiles of `col_tile`. A block's
    {type: (n_rows, n_cols) tensor} is appended to `done` as (key,
    scores) after its last call; nothing is read back."""
    name = str(dev)
    sub = max(1, MAX_PAIRS_PER_CALL // col_tile)
    with _device_scope(dev):
        blocks = load()
    for key, rows, cols in blocks:
        n_rows = next(iter(rows.values())).shape[0]
        n_cols = next(iter(cols.values())).shape[0]
        starts = range(0, n_rows, sub)
        pieces = [[] for _ in starts]
        for t in range(0, n_cols, col_tile):
            col_t = _slice(cols, t, t + col_tile)
            for piece, lo in zip(pieces, starts):
                with _device_scope(dev), stages.stage(
                        "mesh:enqueue", dev=name, rc=key[0], cc=key[1]):
                    piece.append(tile_scores_fn(_slice(rows, lo, lo + sub),
                                                col_t))
                stages.add("mesh:calls", 1)
                yield
        with _device_scope(dev):
            done.append((key, {
                k: torch.cat([torch.cat([s[k] for s in piece], dim=1)
                              for piece in pieces])
                for k in pieces[0][0]}))


def _round_robin(slots: list) -> None:
    """Advance every generator one step a turn, in order, until all end."""
    while slots:
        slots = [g for g in slots if next(g, False) is not False]


def _restore(desc: dict, lo: int, hi: int, dev: torch.device) -> dict:
    """Rows [lo, hi) of every leaf on `dev`, restored to fp32."""
    with stages.stage("mesh:restore", dev=str(dev)):
        return upcast_stream(_rows_on(desc, lo, hi, dev))


def _gather(done: list, n_pad: int, rows: int, cols: int) -> dict:
    """{type: (n_pad, n_pad) np.float32} with each block (key (i, j)) of
    `done` read back into rows [i * rows, (i + 1) * rows) and columns
    [j * cols, (j + 1) * cols)."""
    Ms = {}
    for (i, j), scores in done:
        with stages.stage("mesh:gather"):
            for k, v in scores.items():
                M = Ms.setdefault(k, np.zeros((n_pad, n_pad), np.float32))
                M[i * rows:(i + 1) * rows,
                  j * cols:(j + 1) * cols] = v.cpu().numpy()
        stages.add("mesh:blocks", 1)
    return Ms


def sharded_pair_scores(tile_scores_fn, desc: dict, n_songs: int,
                        mesh, col_tile: int = 8) -> dict:
    """The full N x N score matrices over a device mesh.

    Args:
      tile_scores_fn: ``(row_desc, col_desc) -> {type: (bi, bj)}``, an
        algorithm's tile scorer (e.g. ``Serra09().tile_scores``).
      desc: per-song descriptors with leading dim n_songs (numpy arrays
        or tensors; fp16 leaves and int8 leaves with `@qscale` companions
        are restored to fp32 on each block's device).
      mesh: from `make_pair_mesh`.
      col_tile: column-tile width inside each device block.

    Returns {type: (N, N) np.float32} for the first n_songs rows and
    columns (scores of padding songs are cropped; the self-pair diagonal
    is NOT zeroed here).
    """
    mesh = np.asarray(mesh, dtype=object)
    r, c = mesh.shape
    # pad the song axis so both splits and the column tiling divide evenly
    quantum = math.lcm(r, c * col_tile)
    n_pad = -(-n_songs // quantum) * quantum
    desc = _pad_rows(desc, n_pad)
    nr, nc = n_pad // r, n_pad // c

    done = []

    def slot(i, j):
        dev = torch.device(mesh[i, j])
        return _slot_calls(tile_scores_fn, dev, lambda: [(
            (i, j), _restore(desc, i * nr, (i + 1) * nr, dev),
            _restore(desc, j * nc, (j + 1) * nc, dev))], col_tile, done)

    _round_robin([slot(i, j) for i in range(r) for j in range(c)])
    Ms = _gather(done, n_pad, nr, nc)
    with stages.stage("mesh:fold"):
        return {k: v[:n_songs, :n_songs] for k, v in Ms.items()}


def fold_blocks(n_devices: int) -> list[list[tuple[int, int]]]:
    """The triangular fold's (row chunk, column chunk) blocks of each
    device: songs are cut into 2D chunks and device d owns row chunks d
    (columns 0..d) and 2D-1-d (columns 0..2D-1-d), 2D+1 blocks each."""
    two_d = 2 * n_devices
    return [[(d, kk) if kk <= d else (two_d - 1 - d, kk - d - 1)
             for kk in range(two_d + 1)] for d in range(n_devices)]


def sharded_pair_scores_triangular(tile_scores_fn, desc: dict,
                                   n_songs: int, devices=None,
                                   col_tile: int = 8) -> dict:
    """Symmetric pair sweep over a 1D list of devices computing ONLY the
    lower-triangular block grid: half the work of the rectangular
    `sharded_pair_scores`.

    Load balance by FOLDING (`fold_blocks`): every device computes exactly
    2D+1 equal-size blocks, the mesh analog of the reference's balanced
    pair-block linearization (`CoverAlgorithm.py:228-244`). Every device
    holds a copy of the whole (padded) corpus, since its blocks need
    arbitrary column chunks. `devices` defaults to every visible CUDA
    device.

    Returns {type: (N, N) np.float32} with the strict lower triangle
    filled and mirrored (diagonal zeroed), ready for evaluation.
    """
    devices = [torch.device(d) for d in (
        devices if devices is not None else make_pair_mesh().ravel())]
    two_d = 2 * len(devices)
    chunk = max(-(-n_songs // two_d), col_tile)
    chunk = -(-chunk // col_tile) * col_tile
    n_pad = two_d * chunk
    desc = _pad_rows(desc, n_pad)

    done = []

    def slot(dev, owned):
        def load():
            full = _restore(desc, 0, n_pad, dev)
            return [((rc, cc), _slice(full, rc * chunk, (rc + 1) * chunk),
                     _slice(full, cc * chunk, (cc + 1) * chunk))
                    for rc, cc in owned]
        return _slot_calls(tile_scores_fn, dev, load, col_tile, done)

    _round_robin([slot(dev, owned) for dev, owned in
                  zip(devices, fold_blocks(len(devices)))])
    Ms = _gather(done, n_pad, chunk, chunk)
    out = {}
    with stages.stage("mesh:fold"):
        for k, M in Ms.items():
            L = np.tril(M, -1)
            out[k] = (L + L.T)[:n_songs, :n_songs]
    return out
