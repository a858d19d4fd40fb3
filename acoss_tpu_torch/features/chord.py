"""Chord-template HMM chroma, the `crema` slot's chord-aware substitute
(port of `acoss_tpu.features.chord`).

The reference fills the `crema` feature with the CREMA chord model's
chord-pitch posteriors (`preprocess/features.py:277-296`). With no
pretrained chord model, the JAX package builds the classical template
equivalent: major/minor triad templates and a no-chord state, Pearson
correlation emissions over CQT chroma, forward-backward posterior
smoothing under a sticky transition prior, and the posterior-weighted
mixture of templates as output.

The emissions are one matmul in PyTorch on the chroma's device; the
forward-backward recursions are the hand-written kernel of `ops.hmm_cuda`
on the card (its plain version on the CPU). The JAX package pads the
frames to a multiple of 2,048 to bound its compiles (exact: pad frames
carry uniform emissions, whose messages stay uniform); the port runs the
song's frames only, which changes nothing but rounding.
"""

from __future__ import annotations

import numpy as np
import torch

from acoss_tpu_torch.features.chroma import cqt_tensor, fold_chroma
from acoss_tpu_torch.features.spectral import as_signal
from acoss_tpu_torch.ops.crp import cuda_tf32
from acoss_tpu_torch.ops.hmm_cuda import chord_forward_backward


def chord_templates(harmonic_bleed: float = 0.0) -> np.ndarray:
    """(25, 12) templates: 12 major + 12 minor triads (root, third,
    fifth) + a uniform no-chord state; rows unit-normalized."""
    T = np.zeros((25, 12), np.float32)
    for root in range(12):
        for q, third in enumerate((4, 3)):
            row = np.zeros(12, np.float32)
            row[root] = 1.0
            row[(root + third) % 12] = 1.0
            row[(root + 7) % 12] = 1.0
            if harmonic_bleed:
                row[(root + 7) % 12] += harmonic_bleed      # 3rd harmonic
                row[(root + 4) % 12] += harmonic_bleed / 2  # 5th harmonic
            T[2 * root + q] = row
    T[24] = 1.0
    return T / np.linalg.norm(T, axis=1, keepdims=True)


def _unit_centred(x: torch.Tensor) -> torch.Tensor:
    """Rows centred and scaled to unit norm (a zero row stays zero)."""
    c = x - torch.mean(x, dim=1, keepdim=True)
    n = torch.sqrt(torch.sum(c * c, dim=1, keepdim=True))
    return c / torch.where(n > 0, n, 1.0)


def chord_log_emissions(chroma: torch.Tensor, templates: torch.Tensor,
                        temperature: float) -> torch.Tensor:
    """(T, C) log emission probabilities: softmax over the templates of
    the Pearson correlations over `temperature` (centring gives the flat
    no-chord template a score of exactly 0, so it wins only when no chord
    correlates)."""
    with cuda_tf32(False):
        logits = _unit_centred(chroma) @ _unit_centred(templates).T
    return torch.log_softmax(logits / temperature, dim=1)


def log_transitions(n_states: int, self_prob: float) -> np.ndarray:
    """(C, C) log of the sticky transition matrix: `self_prob` on the
    diagonal, the rest spread evenly."""
    trans = np.full((n_states, n_states), (1.0 - self_prob) / (n_states - 1),
                    np.float32)
    np.fill_diagonal(trans, self_prob)
    return np.log(trans)


def _posteriors(chroma: torch.Tensor, self_prob: float, temperature: float,
                templates: np.ndarray) -> torch.Tensor:
    tmpl = torch.from_numpy(templates).to(chroma.device)
    log_emis = chord_log_emissions(chroma, tmpl, temperature).contiguous()
    log_trans = torch.from_numpy(
        log_transitions(templates.shape[0], self_prob)).to(chroma.device)
    return chord_forward_backward(log_emis, log_trans)


def chord_posteriors(chroma, self_prob: float = 0.97,
                     temperature: float = 0.08,
                     templates: np.ndarray | None = None,
                     device: str | torch.device = "cuda") -> np.ndarray:
    """Posterior chord probabilities (T, 25) for a chroma sequence,
    computed on `device`."""
    tmpl = templates if templates is not None else chord_templates()
    x = torch.as_tensor(np.asarray(chroma, np.float32)).to(device)
    return _posteriors(x, self_prob, temperature, tmpl).cpu().numpy()


def _chord_chroma(chroma: torch.Tensor, self_prob: float,
                  temperature: float) -> np.ndarray:
    tmpl = chord_templates()
    gamma = _posteriors(chroma, self_prob, temperature, tmpl)
    with cuda_tf32(False):
        out = gamma @ torch.from_numpy(tmpl).to(gamma.device)
    mx = torch.amax(out, dim=1, keepdim=True)
    return (out / torch.where(mx > 0, mx, 1.0)).cpu().numpy()


def chord_chroma(chroma, self_prob: float = 0.97, temperature: float = 0.08,
                 device: str | torch.device = "cuda") -> np.ndarray:
    """Chord-pitch chroma (T, 12): posterior-weighted chord templates
    (the CREMA chord_pitch analog, `features.py:277-296`), unit-max a
    frame. The no-chord posterior spreads uniformly, which its (uniform)
    template already encodes."""
    x = torch.as_tensor(np.asarray(chroma, np.float32)).to(device)
    return _chord_chroma(x, self_prob, temperature)


def crema_substitute(y, sr: int = 44100, hop_length: int = 512,
                     device: str | torch.device = "cuda") -> np.ndarray:
    """The pipeline's `crema` feature: CQT chroma -> chord-template HMM
    posterior smoothing -> chord-pitch chroma (T, 12), on `device`."""
    C = cqt_tensor(as_signal(y, device), sr, hop_length)
    return _chord_chroma(fold_chroma(C), 0.97, 0.08)
