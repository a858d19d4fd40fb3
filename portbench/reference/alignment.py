"""Batched row-streaming local aligners qmax and dmax in plain PyTorch: a
frozen copy of the plain versions of `acoss_tpu_torch.ops.alignment`, so
that the benchmark's reference does not move with the program.

The recurrences have NO intra-row dependency: every predecessor of cell
(i, j) lives in rows i-1, i-2 (and i-3 for dmax), so a whole row is one
vector op over shifted previous rows, batched over pairs. The plain
versions loop over the M rows in Python.

Inputs are padded to (B, M, N) with per-pair true lengths; cells outside
(m_len, n_len) are masked to 0, so S may hold anything in the padding.

Semantics (the reference's `SequenceAlignment.c`):
- qmax: match +1 else a state-dependent gap penalty clamped at 0; cells
  start at i, j >= 2; a pair with a side shorter than 3 scores 0.
- dmax: five predecessors; the long paths add the S values they skip;
  cells start at i, j >= 3; a side shorter than 4 scores 0.
- swconstrained: +-1 match with affine gaps (opening -0.5, extension
  -0.7); cells start at i, j >= 2; a side shorter than 3 scores 0.
"""

from __future__ import annotations

import torch


def _shift(x: torch.Tensor, k: int) -> torch.Tensor:
    """shift(x, k)[..., j] = x[..., j - k], zeros shifted in at the front."""
    if k == 0:
        return x
    out = torch.zeros_like(x)
    out[..., k:] = x[..., :-k]
    return out


def _prep(S, m_len, n_len):
    S = torch.as_tensor(S)
    if S.ndim == 2:
        S = S[None]
    B, M, N = S.shape
    m_len = torch.as_tensor(m_len, device=S.device).to(torch.int64) \
        .expand(B)
    n_len = torch.as_tensor(n_len, device=S.device).to(torch.int64) \
        .expand(B)
    z = torch.zeros((B, N), dtype=torch.float32, device=S.device)
    return S, M, N, m_len, n_len, z


def _colmask(N, start, n_len):
    j = torch.arange(N, device=n_len.device)[None, :]
    return (j >= start) & (j < n_len[:, None])


def qmax_batch(S, m_len, n_len, gap_onset: float = 0.5,
               gap_extension: float = 0.5) -> torch.Tensor:
    """Batched Serra 2009 Qmax scores.

    Args:
      S: (B, M, N) binary CRP (uint8/float).
      m_len, n_len: (B,) true row/col counts.
      gap_onset / gap_extension: penalty after a match / after a gap.

    Returns: (B,) float32 max-cell scores (unnormalized; callers divide by
    m_len + n_len).
    """
    S, M, N, m_len, n_len, z = _prep(S, m_len, n_len)
    const_gap = gap_onset == gap_extension
    colmask = _colmask(N, 2, n_len)
    A, B2, GA, GB, best = z, z, z, z, z[:, 0]
    for i in range(M):
        sd = S[:, i].to(torch.float32)
        p1 = _shift(A, 1)    # (i-1, j-1)
        p2 = _shift(B2, 1)   # (i-2, j-1)
        p3 = _shift(A, 2)    # (i-1, j-2)
        pre = torch.maximum(torch.maximum(p1, p2), p3)
        match = pre + 1.0
        if const_gap:
            gap = torch.clamp_min(pre - gap_extension, 0.0)
            Gd = z
        else:
            gap = torch.clamp_min(torch.maximum(
                torch.maximum(p1 - _shift(GA, 1), p2 - _shift(GB, 1)),
                p3 - _shift(GA, 2)), 0.0)
            Gd = torch.where(sd > 0, gap_onset, gap_extension)
        Dd = torch.where(sd > 0, match, gap)
        valid = colmask & ((i >= 2) & (i < m_len))[:, None]
        Dd = torch.where(valid, Dd, 0.0)
        best = torch.maximum(best, Dd.max(dim=-1).values)
        A, B2, GA, GB = Dd, A, Gd, GA
    ok = (m_len >= 3) & (n_len >= 3)
    return torch.where(ok, best, 0.0)


def dmax_batch(S, m_len, n_len, gap_onset: float = 0.5,
               gap_extension: float = 0.5) -> torch.Tensor:
    """Batched Chen 2017 Dmax scores: five predecessors; the
    (i-2,j-1)/(i-1,j-2)/(i-3,j-1)/(i-1,j-3) paths add the intermediate S
    values they skip over."""
    S, M, N, m_len, n_len, z = _prep(S, m_len, n_len)
    colmask = _colmask(N, 3, n_len)

    def gamma(s):
        return torch.where(s > 0, gap_onset, gap_extension)

    # A/B2/B3 = D rows i-1, i-2, i-3; SA/SB/SC = S rows i-1, i-2, i-3.
    A, B2, B3, SA, SB, SC, best = z, z, z, z, z, z, z[:, 0]
    for i in range(M):
        sd = S[:, i].to(torch.float32)
        p1 = _shift(A, 1)                # D[i-1, j-1]
        p2 = _shift(B2, 1) + SA          # D[i-2, j-1] + S[i-1, j]
        p3 = _shift(A, 2) + _shift(sd, 1)  # D[i-1, j-2] + S[i, j-1]
        p4 = _shift(B3, 1) + SB + SA     # D[i-3,j-1]+S[i-2,j]+S[i-1,j]
        p5 = _shift(A, 3) + _shift(sd, 2) + _shift(sd, 1)
        m5 = torch.maximum(torch.maximum(torch.maximum(p1, p2), p3),
                           torch.maximum(p4, p5))
        match = m5 + 1.0
        gap = torch.maximum(
            torch.maximum(
                torch.maximum(p1 - gamma(_shift(SA, 1)),
                              p2 - gamma(_shift(SB, 1))),
                torch.maximum(p3 - gamma(_shift(SA, 2)),
                              p4 - gamma(_shift(SC, 1)))),
            torch.clamp_min(p5 - gamma(_shift(SA, 3)), 0.0))
        Dd = torch.where(sd > 0, match, gap)
        valid = colmask & ((i >= 3) & (i < m_len))[:, None]
        Dd = torch.where(valid, Dd, 0.0)
        best = torch.maximum(best, Dd.max(dim=-1).values)
        A, B2, B3, SA, SB, SC = Dd, A, B2, sd, SA, SB
    ok = (m_len >= 4) & (n_len >= 4)
    return torch.where(ok, best, 0.0)
