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
or one card repeated): its blocks then run one after another. Every block
is enqueued before the first readback, so blocks on distinct cards
overlap.
"""

from __future__ import annotations

import contextlib
import math

import numpy as np
import torch

from acoss_tpu_torch.data.descstore import upcast_stream

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
    """Rows [lo, hi) of every leaf, copied to `device`."""
    return {k: (v[lo:hi] if isinstance(v, torch.Tensor)
                else torch.from_numpy(np.array(v[lo:hi]))).to(device)
            for k, v in desc.items()}


def _slice(desc: dict, lo: int, hi: int) -> dict:
    return {k: v[lo:hi] for k, v in desc.items()}


def _device_scope(device: torch.device):
    """The device current while a block is enqueued (CUDA only)."""
    return torch.cuda.device(device) if device.type == "cuda" \
        else contextlib.nullcontext()


def _block_scores(tile_scores_fn, rows: dict, cols: dict,
                  col_tile: int) -> dict:
    """{type: (n_rows, n_cols) tensor} of a device block: row sub-blocks
    of at most MAX_PAIRS_PER_CALL // col_tile songs against column tiles
    of `col_tile`, each side restored to fp32 (`upcast_stream`); nothing
    is read back."""
    n_rows = next(iter(rows.values())).shape[0]
    n_cols = next(iter(cols.values())).shape[0]
    sub = max(1, MAX_PAIRS_PER_CALL // col_tile)
    row_blocks = [upcast_stream(_slice(rows, lo, lo + sub))
                  for lo in range(0, n_rows, sub)]
    pieces = [[] for _ in row_blocks]
    for t in range(0, n_cols, col_tile):
        col_t = upcast_stream(_slice(cols, t, t + col_tile))
        for piece, row in zip(pieces, row_blocks):
            piece.append(tile_scores_fn(row, col_t))
    return {k: torch.cat([torch.cat([s[k] for s in piece], dim=1)
                          for piece in pieces])
            for k in pieces[0][0]}


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
    pending = []
    for i in range(r):
        for j in range(c):
            dev = torch.device(mesh[i, j])
            with _device_scope(dev):
                rows = _rows_on(desc, i * nr, (i + 1) * nr, dev)
                cols = _rows_on(desc, j * nc, (j + 1) * nc, dev)
                pending.append((i, j, _block_scores(tile_scores_fn, rows,
                                                    cols, col_tile)))
    out = {}
    for i, j, scores in pending:
        for k, v in scores.items():
            M = out.setdefault(k, np.zeros((n_pad, n_pad), np.float32))
            M[i * nr:(i + 1) * nr, j * nc:(j + 1) * nc] = v.cpu().numpy()
    return {k: v[:n_songs, :n_songs] for k, v in out.items()}


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
    pending = []
    for dev, blocks in zip(devices, fold_blocks(len(devices))):
        with _device_scope(dev):
            full = _rows_on(desc, 0, n_pad, dev)
            for rc, cc in blocks:
                rows = _slice(full, rc * chunk, (rc + 1) * chunk)
                cols = _slice(full, cc * chunk, (cc + 1) * chunk)
                pending.append((rc, cc, _block_scores(
                    tile_scores_fn, rows, cols, col_tile)))
    Ms = {}
    for rc, cc, scores in pending:
        for k, v in scores.items():
            M = Ms.setdefault(k, np.zeros((n_pad, n_pad), np.float32))
            M[rc * chunk:(rc + 1) * chunk,
              cc * chunk:(cc + 1) * chunk] = v.cpu().numpy()
    out = {}
    for k, M in Ms.items():
        L = np.tril(M, -1)
        out[k] = (L + L.T)[:n_songs, :n_songs]
    return out
