"""Local autocorrelation tempogram (port of `acoss_tpu.features.rhythm`,
the stand-in of `librosa.feature.tempogram`): hop-1 Hann-windowed frames
of an onset envelope, each frame's autocorrelation by FFT, normalized by
its largest magnitude (`tempogram`), optionally mean-aggregated between
boundary frames (`tempogram_aggregated_batch`).

Songs are batched by length on the device: one `torch.fft.rfft` / `irfft`
over a batch's (B, frames, win) windows and one segment sum. A batch is
padded to its longest song; padded frames only add to a junk segment that
is dropped, so no song's output depends on the padding. The JAX package
also pads every envelope to a multiple of 4,096 frames to bound its
compiles; the port has no compiles and computes the song's frames only.

The segment sum is order-fixed on the card: `index_add_` on a CUDA tensor
adds by atomics in no fixed order, so two runs could differ in the last
bits and StrucLaplacian's clusterings with them. On CUDA it is a one-hot
segment matmul with TF32 off, a chunk of frames at a time; on the CPU it
stays `index_add_`, which adds in frame order.
"""

from __future__ import annotations

import numpy as np
import torch

from acoss_tpu_torch.ops.crp import cuda_tf32
from acoss_tpu_torch.ops.segment import fix_frames

#: one-hot elements of a segment-matmul chunk on the card (256 MiB fp32)
SEGSUM_CHUNK_ELEMS = 2 ** 26


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


def _tempogram_frames(padded: torch.Tensor, F: int,
                      win_length: int) -> torch.Tensor:
    """The normalized autocorrelations of the first F hop-1 frames of
    ramped envelopes padded (B, >= F + win_length - 1): (B, F, win)."""
    frames = padded.unfold(1, win_length, 1)[:, :F]       # (B, F, win)
    window = torch.from_numpy(np.hanning(win_length).astype(np.float32)) \
        .to(padded.device)
    n_fft = 2 * win_length
    spec = torch.fft.rfft(frames * window, n=n_fft, dim=-1)
    ac = torch.fft.irfft(spec * torch.conj(spec), n=n_fft,
                         dim=-1)[..., :win_length]
    peak = torch.amax(torch.abs(ac), dim=-1, keepdim=True)
    return ac / torch.where(peak == 0, 1.0, peak)


def segment_sum(x: torch.Tensor, seg_ids: torch.Tensor,
                n_seg: int) -> torch.Tensor:
    """Sums of the rows of x (B, F, d) by segment id (B, F) in [0, n_seg):
    (B, n_seg, d), in a fixed order on either device (module
    docstring)."""
    B, F, d = x.shape
    if x.device.type == "cpu":
        sums = torch.zeros((B * n_seg, d), dtype=x.dtype)
        offs = torch.arange(B)[:, None] * n_seg
        sums.index_add_(0, (seg_ids + offs).reshape(-1), x.reshape(-1, d))
        return sums.reshape(B, n_seg, d)
    sums = torch.zeros((B, n_seg, d), dtype=x.dtype, device=x.device)
    segs = torch.arange(n_seg, device=x.device)[None, :, None]
    chunk = max(SEGSUM_CHUNK_ELEMS // (B * n_seg), 1)
    with cuda_tf32(False):
        for f0 in range(0, F, chunk):
            onehot = (seg_ids[:, None, f0:f0 + chunk] == segs).to(x.dtype)
            sums += torch.bmm(onehot, x[:, f0:f0 + chunk])
    return sums


def _tempogram_segsum(padded: torch.Tensor, seg_ids: torch.Tensor,
                      win_length: int, n_seg: int) -> torch.Tensor:
    """Segment sums of the tempogram frames of a batch: padded (B, F +
    win_length - 1 or more) envelopes, seg_ids (B, F) in [0, n_seg) ->
    (B, n_seg, win_length) float32."""
    ac = _tempogram_frames(padded, seg_ids.shape[1], win_length)
    return segment_sum(ac, seg_ids, n_seg)


def tempogram(onset_envelope: np.ndarray, win_length: int = 384,
              sr: int = 44100, hop_length: int = 512,
              device: str | torch.device = "cuda") -> np.ndarray:
    """Local autocorrelation tempogram of one (L,) onset envelope,
    (win_length, L) float32, computed on `device`. sr and hop_length are
    accepted for signature parity with librosa: the autocorrelation only
    depends on the envelope and win_length."""
    oenv = np.ascontiguousarray(onset_envelope, dtype=np.float32).ravel()
    ramped = torch.from_numpy(_ramp_pad_envelope(oenv, win_length))
    ac = _tempogram_frames(ramped.to(device)[None], oenv.size, win_length)
    return ac[0].T.cpu().numpy()


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
