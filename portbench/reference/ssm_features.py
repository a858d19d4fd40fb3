"""MFCC block-SSM scattering descriptors for Serra09's ssms channel and
EarlySNF: a frozen copy of `acoss_tpu_torch.ops.ssm_features`.

Slide a window of m * downsample_fac frames over the full-rate MFCCs with
hop = downsample_fac; per block: moving-average smooth (width
downsample_fac / 2, via cumsum), Z-normalize (subtract column means, unit
row norms), Euclidean SSM, anti-aliased resize to res x res, 2D
scattering (J=2, L=8), flatten: scatter_dim(64) = 81 * 16 * 16 = 20,736
floats a block.

`build_ssms_device` builds the whole (N, pad_to, sdim) corpus on the
device in chunks of blocks, so at most one chunk's SSMs are live and no
descriptor bytes go back to the host.
"""

from __future__ import annotations

import numpy as np
import torch

from portbench.reference.resize import resize
from portbench.reference.scattering import Scattering2D

_SCATTERING_CACHE: dict = {}


def get_scattering2d(res: int, J: int = 2, L: int = 8) -> Scattering2D:
    key = (res, J, L)
    if key not in _SCATTERING_CACHE:
        _SCATTERING_CACHE[key] = Scattering2D((res, res), J=J, L=L)
    return _SCATTERING_CACHE[key]


def scatter_dim(res: int, J: int = 2, L: int = 8) -> int:
    n_ch = 1 + J * L + L * L * (J * (J - 1)) // 2
    return n_ch * (res // 2 ** J) ** 2


def _blocks_to_scatter(blocks: torch.Tensor, win: int, res: int,
                       J: int, L: int) -> torch.Tensor:
    """(B, block_len, d) MFCC blocks -> (B, scatter_dim) descriptors."""
    x = torch.cumsum(blocks, dim=1)
    x = x[:, win:, :] - x[:, :-win, :]              # moving-window sums
    x = x - torch.mean(x, dim=1, keepdim=True)      # Z-normalize columns
    norm = torch.sqrt(torch.sum(x * x, dim=2, keepdim=True))
    x = x / torch.where(norm == 0, 1.0, norm)
    sq = torch.sum(x * x, dim=2)
    D2 = sq[:, :, None] + sq[:, None, :] - 2.0 * torch.matmul(
        x, x.transpose(1, 2))
    D = torch.sqrt(torch.clamp_min(D2, 0.0))
    D = resize(D, (res, res))
    S = get_scattering2d(res, J, L)._scatter(D)
    return S.reshape(S.shape[0], -1)


def _blocks(mfcc: np.ndarray, span: int, hop: int, device) -> torch.Tensor:
    """(n_blocks, span, d) views of a song's blocks, one every `hop`
    frames (none when the song is shorter than one block), on `device`."""
    x = torch.from_numpy(np.ascontiguousarray(mfcc, np.float32)).to(device)
    if x.shape[0] < span:
        return x.new_zeros((0, span, x.shape[1]))
    return x.unfold(0, span, hop).transpose(1, 2)


def get_ssm_scatter_sequence(
    mfcc: np.ndarray,
    downsample_fac: int = 40,
    m: int = 18,
    res: int = 64,
    J: int = 2,
    L: int = 8,
    chunk: int = 32,
    device: str | torch.device = "cuda",
) -> np.ndarray:
    """Sequence of scattered block-SSM descriptors for one song.

    Args:
      mfcc: (L_frames, d) full-rate MFCCs (frames-first).
      downsample_fac: hop between blocks AND 2x the smoothing width.
      m: delays; block length = m * downsample_fac.

    Returns (n_blocks, scatter_dim) float32 numpy (possibly 0 blocks).
    """
    blocks = _blocks(mfcc, m * downsample_fac, downsample_fac, device)
    outs = [np.zeros((0, scatter_dim(res, J, L)), dtype=np.float32)]
    for c0 in range(0, blocks.shape[0], chunk):
        outs.append(_blocks_to_scatter(
            blocks[c0:c0 + chunk].contiguous(), downsample_fac // 2, res, J,
            L).cpu().numpy())
    return np.concatenate(outs, axis=0)


def length_match(ssms: np.ndarray, M: int, dim: int) -> np.ndarray:
    """Pad (repeating the last row) or truncate to exactly M rows; all-zero
    if there were no blocks."""
    if ssms.shape[0] == 0:
        return np.zeros((M, dim), dtype=np.float32)
    if ssms.shape[0] < M:
        pad = np.repeat(ssms[-1:], M - ssms.shape[0], axis=0)
        ssms = np.concatenate([ssms, pad], axis=0)
    return ssms[:M]


def build_ssms_device(
    mfccs: list, Ms: list, pad_to: int, downsample_fac: int = 40,
    m: int = 18, res: int = 64, J: int = 2, L: int = 8, chunk: int = 64,
    device: str | torch.device = "cuda",
) -> torch.Tensor:
    """Device-resident (N, pad_to, sdim) ssms_scatter corpus.

    Equal to stacking `length_match(get_ssm_scatter_sequence(mfcc), M,
    sdim)` over songs, cut or zero-padded to pad_to rows, but the
    descriptors never visit the host: each song's MFCCs are uploaded once,
    its blocks are scattered `chunk` at a time (a chunk of 64 blocks of
    700 x 700 SSMs is ~125 MB) and written straight into the corpus
    buffer. Rows past a song's M (or all rows, for a song shorter than one
    block) are exactly zero.

    Args:
      mfccs: per-song full-rate (L_i, d) float32 MFCCs (already cropped
        to n * downsample_fac frames).
      Ms: per-song target row counts (n - m_serra + 1).
    """
    sdim = scatter_dim(res, J, L)
    span = m * downsample_fac
    win = downsample_fac // 2
    big = torch.zeros((len(mfccs), pad_to, sdim), dtype=torch.float32,
                      device=device)
    for i, (mfcc, M) in enumerate(zip(mfccs, Ms)):
        blocks = _blocks(mfcc, span, downsample_fac, device)
        rows = min(M, pad_to)
        n_blocks = min(blocks.shape[0], rows)
        if n_blocks <= 0:
            continue                      # the song's rows stay zero
        for c0 in range(0, n_blocks, chunk):
            c1 = min(c0 + chunk, n_blocks)
            big[i, c0:c1] = _blocks_to_scatter(
                blocks[c0:c1].contiguous(), win, res, J, L)
        # length_match: repeat the last block's row up to M
        if rows > n_blocks:
            big[i, n_blocks:rows] = big[i, n_blocks - 1]
    return big
