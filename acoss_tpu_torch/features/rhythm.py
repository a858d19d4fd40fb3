"""Local autocorrelation tempogram (port of `acoss_tpu.features.rhythm`'s
`tempogram_aggregated_batch`, the stand-in of `librosa.feature.tempogram`):
hop-1 Hann-windowed frames of an onset envelope, each frame's
autocorrelation by FFT, normalized by its largest magnitude, then
mean-aggregated between boundary frames.

Songs are batched by length on the device: one `torch.fft.rfft` / `irfft`
over a batch's (B, frames, win) windows and one `index_add_` segment sum.
A batch is padded to its longest song; padded frames only add to a junk
segment that is dropped, so no song's output depends on the padding.
"""

from __future__ import annotations

import numpy as np
import torch

from acoss_tpu_torch.ops.segment import fix_frames


def _ramp_pad_envelope(oenv: np.ndarray, win_length: int) -> np.ndarray:
    """librosa's edge padding: a linear ramp from 0 to the first value
    before the envelope and from the last value to 0 after it, float32.
    Frame t < L reads samples t .. t + win_length - 1 of it."""
    half = win_length // 2
    return np.concatenate([
        np.linspace(0.0, 1.0, half, endpoint=False) * oenv[0],
        oenv,
        np.linspace(1.0, 0.0, half + 1)[1:] * oenv[-1],
    ]).astype(np.float32)


def _segment_prep(oenv: np.ndarray, boundaries, win_length: int):
    """One song's host prep: (ramped envelope, segment id of each frame,
    segment frame counts float64)."""
    L = oenv.size
    b = fix_frames(boundaries, L)
    seg_of_frame = np.zeros(L, dtype=np.int64)
    seg_of_frame[b[1:-1]] = 1
    return (_ramp_pad_envelope(oenv, win_length), np.cumsum(seg_of_frame),
            np.diff(b).astype(np.float64))


def _tempogram_segsum(padded: torch.Tensor, seg_ids: torch.Tensor,
                      win_length: int, n_seg: int) -> torch.Tensor:
    """Segment sums of the tempogram frames of a batch: padded (B, F +
    win_length - 1 or more) envelopes, seg_ids (B, F) in [0, n_seg) ->
    (B, n_seg, win_length) float32."""
    B, F = seg_ids.shape
    frames = padded.unfold(1, win_length, 1)[:, :F]       # (B, F, win)
    window = torch.from_numpy(np.hanning(win_length).astype(np.float32)) \
        .to(padded.device)
    n_fft = 2 * win_length
    spec = torch.fft.rfft(frames * window, n=n_fft, dim=-1)
    ac = torch.fft.irfft(spec * torch.conj(spec), n=n_fft,
                         dim=-1)[..., :win_length]
    peak = torch.amax(torch.abs(ac), dim=-1, keepdim=True)
    ac = ac / torch.where(peak == 0, 1.0, peak)
    sums = torch.zeros((B * n_seg, win_length), dtype=ac.dtype,
                       device=ac.device)
    offs = torch.arange(B, device=ac.device)[:, None] * n_seg
    sums.index_add_(0, (seg_ids + offs).reshape(-1),
                    ac.reshape(-1, win_length))
    return sums.reshape(B, n_seg, win_length)


def tempogram_aggregated_batch(envelopes: list, boundaries_list: list,
                               win_length: int = 384,
                               device: str | torch.device = "cuda",
                               batch_size: int = 16) -> list:
    """Mean-aggregated tempograms of a corpus: for each (L,) onset envelope
    the (n_segments, win_length) float64 means of its tempogram frames
    between the boundary frames (augmented with 0 and L, as
    `segment.sync_agg`), in input order. Songs are swept length-sorted,
    `batch_size` at a time, on `device`; only the segment sums come back."""
    preps = [_segment_prep(np.ascontiguousarray(e, np.float32).ravel(), b,
                           win_length)
             for e, b in zip(envelopes, boundaries_list)]
    order = sorted(range(len(preps)), key=lambda i: preps[i][1].size)
    out = [None] * len(preps)
    for lo in range(0, len(order), batch_size):
        chunk = order[lo:lo + batch_size]
        F = max(preps[i][1].size for i in chunk)
        n_seg = max(preps[i][2].size for i in chunk) + 1    # + junk segment
        P = np.zeros((len(chunk), F + win_length), np.float32)
        S = np.full((len(chunk), F), n_seg - 1, np.int64)
        for b, i in enumerate(chunk):
            ramped, seg_ids, _ = preps[i]
            P[b, :ramped.size] = ramped
            S[b, :seg_ids.size] = seg_ids
        sums = _tempogram_segsum(torch.from_numpy(P).to(device),
                                 torch.from_numpy(S).to(device), win_length,
                                 n_seg).cpu().numpy()
        for b, i in enumerate(chunk):
            counts = preps[i][2]
            out[i] = sums[b, :counts.size] / counts[:, None]
    return out


def tempogram_aggregated(onset_envelope: np.ndarray, boundaries: np.ndarray,
                         win_length: int = 384,
                         device: str | torch.device = "cuda") -> np.ndarray:
    """One song's `tempogram_aggregated_batch`: the (n_segments,
    win_length) means of its tempogram frames between boundary frames."""
    return tempogram_aggregated_batch([onset_envelope], [boundaries],
                                      win_length, device=device)[0]
