"""The plain model of the hmm_fb kernel's chunked algorithm
(`hmm_cuda.chord_forward_backward_chunked_ref`: chunk transfers, boundary
scan, replay, with the kernel's checked linear one-frame products) on the
CPU, against the sequential plain version (`chord_forward_backward_ref`),
a float64 run of that version, and the JAX package's forward-backward
(`_chord_posteriors_padded`, the scans under `chord_posteriors`) run in
float64. All within atol 1e-5. Inputs are made from a numpy seed: flat or
peaked emissions, the sticky chord prior or Dirichlet-random transitions,
7, 25 and 32 states, songs of 1, 2, L - 1, L, L + 1, 3L + 5 and 6,000
frames at two chunk lengths L."""

from tests import _torch_threads  # noqa: F401  (caps thread pools)

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from acoss_tpu.features import chord as jax_chord
from acoss_tpu_torch.features import chord
from acoss_tpu_torch.ops import hmm_cuda

ATOL = 1e-5
CHUNKS = (16, 77)
# (states, emissions, transitions): every combination appears at every
# length below 6,000; a length runs three of them, one for each C
COMBOS = [(7, "peaked", "dirichlet"), (25, "peaked", "sticky"),
          (32, "flat", "sticky"), (7, "flat", "sticky"),
          (25, "flat", "dirichlet"), (32, "peaked", "dirichlet"),
          (7, "peaked", "sticky"), (25, "peaked", "dirichlet"),
          (32, "flat", "dirichlet"), (7, "flat", "dirichlet"),
          (25, "flat", "sticky"), (32, "peaked", "sticky")]


def _length(name: str, L: int) -> int:
    return {"1": 1, "2": 2, "L-1": L - 1, "L": L, "L+1": L + 1,
            "3L+5": 3 * L + 5, "6000": 6000}[name]


def _log_trans(rng, C: int, trans: str) -> np.ndarray:
    if trans == "sticky":
        return chord.log_transitions(C, 0.97)
    with np.errstate(divide="ignore"):
        p = rng.dirichlet(np.full(C, 0.05 if trans == "spiky" else 1.0), C)
        return np.log(p).astype(np.float32)


def _inputs(T: int, C: int, emis: str, trans: str, seed: int):
    """(T, C) log emissions and (C, C) log transitions, float32 tensors:
    flat (uniform), peaked (log-softmax of N(0, 4) logits) or wild
    (N(0, 40) logits: emissions spread over hundreds of nats)."""
    rng = np.random.default_rng(seed)
    sd = {"flat": 0.0, "peaked": 4.0, "wild": 40.0}[emis]
    logits = rng.normal(0, sd, (T, C)).astype(np.float32)
    le = torch.log_softmax(torch.from_numpy(logits), dim=1).contiguous()
    return le, torch.from_numpy(_log_trans(rng, C, trans))


def _err(a: torch.Tensor, b: torch.Tensor) -> float:
    return float((a.double() - b.double()).abs().max())


@pytest.mark.parametrize("chunk", CHUNKS)
@pytest.mark.parametrize("length", ["1", "2", "L-1", "L", "L+1", "3L+5",
                                    "6000"])
def test_chunked_model_matches_sequential(length, chunk):
    """The chunked model against the sequential plain version and its
    float64 run: one chunk (T <= L), a one-frame last chunk (L + 1),
    ragged chunks (3L + 5), and 6,000 frames (78 or 375 chunks)."""
    T = _length(length, chunk)
    i = CHUNKS.index(chunk) * 7 + ["1", "2", "L-1", "L", "L+1", "3L+5",
                                   "6000"].index(length)
    combos = ([COMBOS[1 if chunk == CHUNKS[0] else 5]] if T == 6000 else
              [COMBOS[(3 * i + k) % len(COMBOS)] for k in range(3)])
    for C, emis, trans in combos:
        le, lt = _inputs(T, C, emis, trans, seed=T * 97 + C)
        got = hmm_cuda.chord_forward_backward_chunked_ref(le, lt, chunk)
        want = hmm_cuda.chord_forward_backward_ref(le, lt)
        want64 = hmm_cuda.chord_forward_backward_ref(le.double(),
                                                     lt.double())
        assert got.shape == (T, C) and got.dtype == torch.float32
        assert torch.isfinite(got).all()
        assert _err(got, want) <= ATOL, (C, emis, trans)
        assert _err(got, want64) <= ATOL, (C, emis, trans)
        torch.testing.assert_close(got.sum(1), torch.ones(T), rtol=0,
                                   atol=ATOL)
        if emis == "flat" and trans == "sticky":
            # uniform emissions under a symmetric prior: uniform
            torch.testing.assert_close(got, torch.full_like(got, 1 / C),
                                       rtol=0, atol=1e-6)


def _switch_inputs(T: int = 300, C: int = 3, seg: int = 100):
    """A song that moves from state to state every `seg` frames, each
    emission ruling out every other state (log 0 vs -1000), under
    transitions of log -200 between states: the step into the next state
    is a one-frame product whose every linear factor underflows."""
    A = torch.full((C, C), -200.0)
    A.fill_diagonal_(0.0)
    E = torch.full((T, C), -1000.0)
    E[torch.arange(T), (torch.arange(T) // seg) % C] = 0.0
    return E, A


def test_chunked_model_takes_the_exact_branch(monkeypatch):
    """Where one-frame products fall below TINY they are taken again in
    log space: spiky transitions (Dirichlet(0.05) rows and a -inf
    transition out of every state) under emissions spread over hundreds
    of nats, and a song whose state changes are products that underflow
    whole. The model matches the sequential version and its float64 run;
    on the second song the linear product alone (TINY = 0) is wrong."""
    T, L = 300, 16
    hits = []
    real = hmm_cuda._log_product

    def spy(x, w):
        wmax = hmm_cuda._finite_or_zero(torch.amax(w, dim=-2, keepdim=True))
        s = (torch.exp(x)[..., :, None] * torch.exp(w - wmax)).sum(dim=-2)
        hits.append(int((s < hmm_cuda.TINY).sum()))
        return real(x, w)

    songs = []
    for C in (7, 25):
        le, lt = _inputs(T, C, "wild", "spiky", seed=C)
        lt[torch.arange(C), (torch.arange(C) + 1) % C] = -torch.inf
        songs.append((le, lt))
    songs.append(_switch_inputs(T))
    for le, lt in songs:
        hits.clear()
        with monkeypatch.context() as m:
            m.setattr(hmm_cuda, "_log_product", spy)
            got = hmm_cuda.chord_forward_backward_chunked_ref(le, lt, L)
        assert sum(hits) > 0
        assert _err(got, hmm_cuda.chord_forward_backward_ref(le, lt)) <= ATOL
        assert _err(got, hmm_cuda.chord_forward_backward_ref(
            le.double(), lt.double())) <= ATOL
    want = hmm_cuda.chord_forward_backward_ref(*songs[-1])
    assert (want.argmax(1) == (torch.arange(T) // 100) % 3).all()
    monkeypatch.setattr(hmm_cuda, "TINY", 0.0)
    fast = hmm_cuda.chord_forward_backward_chunked_ref(*songs[-1], L)
    assert not _err(fast, want) <= 0.5


def test_log_product_exact_branch():
    """Where every factor of the linear product underflows, the product
    is the exact log-sum-exp, not log(0)."""
    x = torch.tensor([0.0, -100.0])
    w = torch.tensor([[-200.0, -200.0], [0.0, -300.0]])
    got = hmm_cuda._log_product(x, w)
    want = torch.logsumexp(x[:, None] + w, dim=0)
    assert torch.isfinite(got).all()
    torch.testing.assert_close(got, want, rtol=0, atol=1e-5)
    # where the product is in range, the linear form
    x = torch.tensor([0.0, -1.0])
    w = torch.tensor([[-0.5, -2.0], [-0.1, -0.3]])
    torch.testing.assert_close(hmm_cuda._log_product(x, w),
                               torch.logsumexp(x[:, None] + w, dim=0),
                               rtol=0, atol=1e-6)


def _jax_posteriors64(chroma, templates, log_trans, temperature):
    """The JAX package's padded forward-backward scans in float64."""
    T = chroma.shape[0]
    Tp = max(-(-T // jax_chord.FRAME_BUCKET) * jax_chord.FRAME_BUCKET,
             jax_chord.FRAME_BUCKET)
    padded = np.zeros((Tp, chroma.shape[1]))
    padded[:T] = chroma
    valid = np.zeros(Tp, bool)
    valid[:T] = True
    with jax.enable_x64(True):
        gamma = jax_chord._chord_posteriors_padded(
            jnp.asarray(padded, jnp.float64),
            jnp.asarray(templates, jnp.float64),
            jnp.asarray(log_trans, jnp.float64), jnp.float64(temperature),
            jnp.asarray(valid))
        return np.asarray(gamma)[:T]


@pytest.mark.parametrize("T,C,chroma_kind,trans,chunk", [
    (1, 25, "random", "sticky", 16),
    (17, 7, "random", "dirichlet", 16),
    (236, 32, "flat", "dirichlet", 77),
    (6000, 25, "random", "sticky", 77),
])
def test_chunked_model_matches_jax(T, C, chroma_kind, trans, chunk):
    """The chunked model on the port's emissions (chroma -> Pearson
    correlation with C templates, the default 25 or random ones) against
    the JAX package's forward-backward on the same chroma, templates and
    transitions, run in float64. (The JAX function in float32 is 3e-5 to
    1.4e-3 off its own float64 run at these lengths: its unshifted
    messages grow to ~-10^4 over the padded frames.)"""
    rng = np.random.default_rng(T + C)
    chroma = (np.ones((T, 12)) if chroma_kind == "flat"
              else rng.random((T, 12))).astype(np.float32)
    templates = (chord.chord_templates() if C == 25 else
                 rng.random((C, 12)).astype(np.float32))
    lt = _log_trans(rng, C, trans)
    le = chord.chord_log_emissions(torch.from_numpy(chroma),
                                   torch.from_numpy(templates), 0.08)
    got = hmm_cuda.chord_forward_backward_chunked_ref(
        le.contiguous(), torch.from_numpy(lt), chunk)
    want = _jax_posteriors64(chroma, templates, lt, 0.08)
    assert got.shape == want.shape
    assert float(np.abs(got.numpy().astype(np.float64) - want).max()) <= ATOL


def test_chunk_length():
    """About sqrt(T / 2) frames a chunk, but at least T / 132 (phase 1's
    blocks in one wave on the H100's 132 SMs), at least 2 and at most
    MAX_CHUNK: the smoke run's two songs take 54 and 196. The model
    takes no chunk below 2."""
    assert [hmm_cuda.chunk_length(T) for T in (0, 1, 2, 5, 5762, 25832)] \
        == [2, 2, 2, 2, 54, 196]
    assert hmm_cuda.chunk_length(25832, sms=256) == 114
    assert hmm_cuda.chunk_length(10 ** 8) == hmm_cuda.MAX_CHUNK
    with pytest.raises(ValueError):
        hmm_cuda.chord_forward_backward_chunked_ref(torch.zeros(3, 2),
                                                    torch.zeros(2, 2), 1)
