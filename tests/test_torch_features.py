"""The port's feature extraction (`acoss_tpu_torch.features`) against the
JAX package's on the CPU: the same numpy-seeded signals (a chord
progression over a click train, a tone with a vibrato, a click train)
through each JAX function and its port. Float outputs agree within 1e-4
of the output's largest magnitude (the two FFT libraries and the matmul
orders round differently; measured: 1e-7..1e-5); integer outputs (beat
frames, key, mode) are equal; the numpy copies are bit-equal."""

from tests import _torch_threads  # noqa: F401  (caps thread pools)

import numpy as np
import pytest
import torch

from acoss_tpu.features import audio as jax_audio
from acoss_tpu.features import chord as jax_chord
from acoss_tpu.features import chroma as jax_chroma
from acoss_tpu.features import fingerprint as jax_fp
from acoss_tpu.features.hpcp import hpcp as jax_hpcp
from acoss_tpu.features import key as jax_key
from acoss_tpu.features import mfcc as jax_mfcc
from acoss_tpu.features import nsgcq as jax_nsgcq
from acoss_tpu.features import onsets as jax_onsets
from acoss_tpu.features import rhythm as jax_rhythm
from acoss_tpu.features import spectral as jax_spectral
from acoss_tpu_torch.features import (audio, chord, chroma, fingerprint,
                                      key, mfcc, nsgcq, onsets, rhythm,
                                      spectral)
from acoss_tpu_torch.features.hpcp import hpcp
from acoss_tpu_torch.ops import hmm_cuda

SR = 44100
#: float outputs: max |port - JAX| <= TOL * max |JAX|
TOL = 1e-4


def _close(got, want, tol: float = TOL):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape, (got.shape, want.shape)
    assert np.isfinite(got).all()
    scale = max(float(np.abs(want).max()), 1e-30)
    err = float(np.abs(got.astype(np.float64) - want).max())
    assert err <= tol * scale, f"max abs err {err} > {tol} x {scale}"


def _chords(rng, dur: float) -> np.ndarray:
    """Four triads with four harmonics each over a click every 0.5 s."""
    t = np.arange(int(dur * SR)) / SR
    y = np.zeros_like(t)
    seg = len(t) // 4
    for k, triad in enumerate([(0, 4, 7), (5, 9, 12), (7, 11, 14),
                               (9, 12, 16)]):
        sl = slice(k * seg, (k + 1) * seg)
        for iv in triad:
            f = 220 * 2 ** (iv / 12)
            for h in range(1, 5):
                y[sl] += 0.3 / h * np.sin(2 * np.pi * f * h * t[sl])
    for b in np.arange(0, dur, 0.5):
        i = int(b * SR)
        n = min(1300, len(y) - i)
        y[i:i + n] += rng.normal(size=n) * np.exp(-np.arange(n) / 260)
    y += 0.02 * rng.normal(size=y.size)
    return (0.5 * y / np.abs(y).max()).astype(np.float32)


def _vibrato(rng, dur: float) -> np.ndarray:
    t = np.arange(int(dur * SR)) / SR
    f = 330 * (1 + 0.01 * np.sin(2 * np.pi * 5 * t))
    y = np.sin(2 * np.pi * np.cumsum(f) / SR) + 0.05 * rng.normal(size=t.size)
    return (0.4 * y).astype(np.float32)


def _clicks(rng, dur: float) -> np.ndarray:
    y = 0.01 * rng.normal(size=int(dur * SR))
    for b in np.arange(0.1, dur, 0.4):
        i = int(b * SR)
        y[i:i + 400] += np.hanning(400) * np.sin(np.arange(400) * 0.9)
    return y.astype(np.float32)


@pytest.fixture(scope="module")
def signals():
    rng = np.random.default_rng(0)
    return {"chords": _chords(rng, 4.0), "vibrato": _vibrato(rng, 2.5),
            "clicks": _clicks(rng, 3.0)}


SIGNALS = ["chords", "vibrato", "clicks"]


# ------------------------------------------------------------ spectral --

@pytest.mark.parametrize("kw", [
    {"n_fft": 2048, "hop_length": 512},
    {"n_fft": 4096, "hop_length": 512, "center": False,
     "window": "blackmanharris62"},
    {"n_fft": 1024, "hop_length": 256, "win_length": 800},
    {"n_fft": 512, "hop_length": 128, "window": "ones", "center": False},
])
def test_stft_matches_jax(signals, kw):
    y = signals["chords"]
    want = np.asarray(jax_spectral.stft(y, **kw))
    pkw = dict(kw)
    if "window" in pkw:
        pkw["window_name"] = pkw.pop("window")
    got = spectral.stft(torch.from_numpy(y), **pkw).numpy()
    _close(got.real, want.real)
    _close(got.imag, want.imag)
    mag = spectral.magnitude_spectrogram(torch.from_numpy(y), kw["n_fft"],
                                         kw["hop_length"], power=2.0)
    _close(mag.numpy(), np.asarray(jax_spectral.magnitude_spectrogram(
        y, kw["n_fft"], kw["hop_length"], power=2.0)))


@pytest.mark.parametrize("center", [True, False])
def test_frame_signal_equal(signals, center):
    y = signals["vibrato"][:5000]
    got = spectral.frame_signal(torch.from_numpy(y), 1024, 300, center)
    want = np.asarray(jax_spectral.frame_signal(y, 1024, 300, center))
    np.testing.assert_array_equal(got.numpy(), want)


def test_spectral_numpy_copies_bit_equal():
    for htk in (True, False):
        f = np.array([0.0, 440.0, 999.0, 1000.0, 5000.0])
        np.testing.assert_array_equal(spectral.hz_to_mel(f, htk),
                                      jax_spectral.hz_to_mel(f, htk))
        m = np.linspace(0, 40, 9)
        np.testing.assert_array_equal(spectral.mel_to_hz(m, htk),
                                      jax_spectral.mel_to_hz(m, htk))
        for norm in (None, "slaney"):
            np.testing.assert_array_equal(
                spectral.mel_filterbank(SR, 2048, 40, 20.0, 8000, htk, norm),
                jax_spectral.mel_filterbank(SR, 2048, 40, 20.0, 8000, htk,
                                            norm))
    for kw in ({"ortho": True}, {"htk": True}, {"ortho": False}):
        np.testing.assert_array_equal(spectral.dct_matrix(13, 26, **kw),
                                      jax_spectral.dct_matrix(13, 26, **kw))
    for L in (0, 100, 22050, 123457):
        assert spectral.n_frames_centered(L, 512) == \
            jax_spectral.n_frames_centered(L, 512)
        assert spectral.n_frames_uncentered(L, 4096, 512) == \
            jax_spectral.n_frames_uncentered(L, 4096, 512)
    np.testing.assert_array_equal(chroma.chroma_filterbank(SR, 4096),
                                  jax_chroma.chroma_filterbank(SR, 4096))
    np.testing.assert_array_equal(
        chroma.cqt_kernels(SR, 32.70319566, 24, 12, 8192),
        jax_chroma.cqt_kernels(SR, 32.70319566, 24, 12, 8192))
    np.testing.assert_array_equal(chord.chord_templates(0.3),
                                  jax_chord.chord_templates(0.3))
    for got, want in zip(nsgcq.nsgcq_windows(4096, SR),
                         jax_nsgcq.nsgcq_windows(4096, SR)):
        np.testing.assert_array_equal(got, want)


# ------------------------------------------------------ the spectral L1 --

@pytest.mark.parametrize("name", SIGNALS)
def test_hpcp_matches_jax(signals, name):
    y = signals[name]
    _close(hpcp(y, device="cpu"), jax_hpcp(y))


def test_hpcp_options_match_jax(signals):
    y = signals["chords"]
    kw = {"whitening": False, "n_bins": 36, "harmonics": 4,
          "max_peaks": 30}
    _close(hpcp(y, device="cpu", **kw), jax_hpcp(y, **kw))


def test_hpcp_shorter_than_a_frame():
    y = np.zeros(1000, np.float32)
    assert hpcp(y, device="cpu").shape == jax_hpcp(y).shape \
        == (0, 12)


@pytest.mark.parametrize("name", SIGNALS)
def test_mfcc_htk_matches_jax(signals, name):
    y = signals[name]
    _close(mfcc.mfcc_htk(y, device="cpu"), jax_mfcc.mfcc_htk(y))


@pytest.mark.parametrize("name", ["chords", "clicks"])
def test_mfcc_librosa_matches_jax(signals, name):
    y = signals[name]
    _close(mfcc.mfcc_librosa(y, device="cpu"), jax_mfcc.mfcc_librosa(y))


@pytest.mark.parametrize("fn", ["chroma_stft", "cqt", "chroma_cqt",
                                "chroma_cens", "chroma_cqt_processed"])
def test_chroma_family_matches_jax(signals, fn, monkeypatch):
    """chroma_cqt_processed's kNN smoothing takes each frame's 10 most
    similar frames, a choice that a CQT summed in another order (another
    MKL thread count) flips at a near tie; so that case holds the port's
    CQT to the JAX package's, then runs the port's smoothing on the JAX
    CQT."""
    y = signals["chords"]
    if fn == "chroma_cqt_processed":
        port_cqt = chroma.cqt

        def cqt(y, sr, hop_length, device):
            want = np.asarray(jax_chroma.cqt(y, sr, hop_length))
            _close(port_cqt(y, sr, hop_length, device=device), want)
            return want

        monkeypatch.setattr(chroma, "cqt", cqt)
    _close(getattr(chroma, fn)(y, device="cpu"), getattr(jax_chroma, fn)(y))


@pytest.mark.parametrize("name", ["vibrato", "clicks"])
def test_cqt_chroma_matches_jax_other_signals(signals, name):
    y = signals[name]
    _close(chroma.chroma_cqt(y, device="cpu"), jax_chroma.chroma_cqt(y))


def test_nn_filter_and_cens_bit_equal():
    rng = np.random.default_rng(3)
    X = rng.random((60, 12)).astype(np.float32)
    np.testing.assert_array_equal(chroma.nn_filter(X),
                                  jax_chroma.nn_filter(X))
    np.testing.assert_array_equal(chroma.cens_from_chroma(X),
                                  jax_chroma.cens_from_chroma(X))


@pytest.mark.parametrize("name", SIGNALS)
@pytest.mark.parametrize("max_size", [1, 3])
def test_onset_strength_matches_jax(signals, name, max_size):
    y = signals[name]
    _close(onsets.onset_strength(y, max_size=max_size, device="cpu"),
           jax_onsets.onset_strength(y, max_size=max_size))


@pytest.mark.parametrize("name", SIGNALS)
def test_tempogram_matches_jax(signals, name):
    env = jax_onsets.onset_strength(signals[name])
    got = rhythm.tempogram(env, device="cpu")
    assert got.shape == (384, env.size)
    _close(got, jax_rhythm.tempogram(env))
    _close(rhythm.tempogram(env, win_length=64, device="cpu"),
           jax_rhythm.tempogram(env, win_length=64))


@pytest.mark.parametrize("name", SIGNALS)
def test_beats_and_tempo_equal(signals, name):
    """The beat tracker reads the port's tempogram: the same tempo and
    the same beat frames as the JAX package's on the same envelope."""
    env = jax_onsets.onset_strength(signals[name])
    tempo, beats = onsets.beat_track_dp(env, device="cpu")
    want_tempo, want_beats = jax_onsets.beat_track_dp(env)
    assert tempo == want_tempo
    np.testing.assert_array_equal(beats, want_beats)
    assert onsets.estimate_tempo(env, device="cpu") == \
        jax_onsets.estimate_tempo(env)


def test_beat_tracker_on_silence():
    tempo, beats = onsets.beat_track_dp(np.zeros(100), device="cpu")
    assert tempo == 0.0 and beats.size == 0


@pytest.mark.parametrize("name", SIGNALS)
def test_madmom_substitute_matches_jax(signals, name):
    y = signals[name]
    got = onsets.madmom_features_substitute(y, device="cpu")
    want = jax_onsets.madmom_features_substitute(y)
    assert sorted(got) == sorted(want)
    np.testing.assert_array_equal(got["tempos"], want["tempos"])
    np.testing.assert_array_equal(got["onsets"], want["onsets"])
    for k in ("novfn", "snovfn"):
        assert got[k].dtype == want[k].dtype
        _close(got[k], want[k])


# --------------------------------------------------------------- chords --

def test_chord_posteriors_plain_forward_backward_matches_jax(signals):
    """The posteriors through the plain forward-backward (the CPU path of
    the hmm_fb wrapper) against the JAX package's two padded scans."""
    C = jax_chroma.chroma_cqt(signals["chords"])
    before = hmm_cuda.chord_forward_backward.launches
    got = chord.chord_posteriors(C, device="cpu")
    assert hmm_cuda.chord_forward_backward.launches == before
    want = jax_chord.chord_posteriors(C)
    _close(got, want)
    np.testing.assert_allclose(got.sum(axis=1), 1.0, atol=1e-5)
    _close(chord.chord_chroma(C, device="cpu"), jax_chord.chord_chroma(C))


def _fb64(log_emis: np.ndarray, log_trans: np.ndarray) -> np.ndarray:
    """Forward-backward posteriors in float64 numpy by normalized
    products (no logs), uniform start."""
    E, A = np.exp(log_emis.astype(np.float64)), np.exp(log_trans)
    T, C = E.shape
    alpha = np.zeros_like(E)
    alpha[0] = E[0] / C
    alpha[0] /= alpha[0].sum()
    for t in range(1, T):
        alpha[t] = (alpha[t - 1] @ A) * E[t]
        alpha[t] /= alpha[t].sum()
    beta = np.ones_like(E)
    for t in range(T - 2, -1, -1):
        beta[t] = A @ (E[t + 1] * beta[t + 1])
        beta[t] /= beta[t].sum()
    g = alpha * beta
    return g / g.sum(axis=1, keepdims=True)


@pytest.mark.parametrize("T", [1, 2, 9])
def test_chord_posteriors_short_and_flat(T):
    """T = 1 (no recursion step) and flat chroma (uniform emissions):
    within 2e-5 of float64 forward-backward, and within 1e-3 of the JAX
    package's, whose betas come through 2,048 - T padded frames whose
    log messages grow to ~-6,500 (float32 rounding ~5e-4 there)."""
    rng = np.random.default_rng(T)
    tmpl = torch.from_numpy(chord.chord_templates())
    log_trans = chord.log_transitions(25, 0.97)
    for C in (rng.random((T, 12)).astype(np.float32),
              np.ones((T, 12), np.float32)):
        got = chord.chord_posteriors(C, device="cpu")
        le = chord.chord_log_emissions(torch.from_numpy(C), tmpl, 0.08)
        np.testing.assert_allclose(got, _fb64(le.numpy(), log_trans),
                                   rtol=0, atol=2e-5)
        _close(got, jax_chord.chord_posteriors(C), tol=1e-3)


def test_forward_backward_ref_against_float64_numpy():
    """The plain recursions against float64 products on a random
    40-frame, 7-state HMM."""
    rng = np.random.default_rng(5)
    E = rng.random((40, 7)) + 0.05
    A = rng.random((7, 7)) + 0.1
    A /= A.sum(axis=1, keepdims=True)
    got = hmm_cuda.chord_forward_backward(
        torch.from_numpy(np.log(E).astype(np.float32)),
        torch.from_numpy(np.log(A).astype(np.float32)))
    np.testing.assert_allclose(got.numpy(), _fb64(np.log(E), np.log(A)),
                               rtol=0, atol=2e-5)


def test_crema_substitute_matches_jax(signals):
    y = signals["chords"]
    _close(chord.crema_substitute(y, device="cpu"),
           jax_chord.crema_substitute(y))


# ---------------------------------------------------------------- nsgcq --

def test_nsgcqgram_matches_jax(signals):
    y = signals["vibrato"][:SR]
    got = nsgcq.nsgcqgram(y, device="cpu")
    want = jax_nsgcq.nsgcqgram(y)
    # one scale for the three bands: the DC band of this signal is ~1e-9
    scale = max(float(np.abs(w).max()) for w in want)
    for g, w in zip(got, want):
        assert g.dtype == w.dtype == np.complex64 and g.shape == w.shape
        assert float(np.abs(g - w).max()) <= TOL * scale
    _close(nsgcq.cqt_nsg(y, device="cpu"), jax_nsgcq.cqt_nsg(y))


# ------------------------------------------------------- numpy copies --

def test_key_extractor_equal(signals):
    rng = np.random.default_rng(7)
    for H in (rng.random((50, 12)), hpcp(signals["chords"],
                                              device="cpu")):
        assert key.key_extractor(H) == jax_key.key_extractor(H)
    with pytest.raises(ValueError):
        key.key_extractor(np.zeros((0, 12)))


def test_audio_copies_bit_equal(signals, tmp_path):
    y = signals["chords"]
    a, b = tmp_path / "a.wav", tmp_path / "b.wav"
    audio.save_wav(str(a), y)
    jax_audio.save_wav(str(b), y)
    assert a.read_bytes() == b.read_bytes()
    for got, want in zip(audio.load_wav(str(a)), jax_audio.load_wav(str(a))):
        np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(audio.load_audio(str(a), 22050),
                                  jax_audio.load_audio(str(a), 22050))
    np.testing.assert_array_equal(audio.resample(y, SR, 16000),
                                  jax_audio.resample(y, SR, 16000))
    np.testing.assert_array_equal(audio.audio_slicer(y, SR, 1.5, 0.25),
                                  jax_audio.audio_slicer(y, SR, 1.5, 0.25))


def test_two_d_fft_mag_equal():
    from acoss_tpu.features.pipeline import two_d_fft_mag as jax_fft_mag
    from acoss_tpu_torch.features.pipeline import two_d_fft_mag

    X = np.random.default_rng(2).random((12, 40))
    np.testing.assert_array_equal(two_d_fft_mag(X), jax_fft_mag(X))


def test_export_onset_clicks_writes_jax_bytes(signals, tmp_path):
    """The same WAV bytes as the JAX package's for the same onsets (a
    blip past the end is cut short)."""
    y = signals["clicks"]
    onsets = np.array([10, 50, 100, y.size // 512 - 1])
    a, b = tmp_path / "a.wav", tmp_path / "b.wav"
    audio.export_onset_clicks(y, str(a), onsets)
    jax_audio.export_onset_clicks(y, str(b), onsets)
    assert a.read_bytes() == b.read_bytes()
    got, sr = audio.load_wav(str(a))
    assert sr == SR and got.size == y.size
    assert not np.allclose(got[10 * 512:10 * 512 + 100],
                           y[10 * 512:10 * 512 + 100], atol=1e-3)


def test_fingerprint_copy_bit_equal(signals):
    y = np.concatenate([signals["chords"], signals["vibrato"],
                        signals["clicks"]])
    fp = fingerprint.chromaprint(y, SR)
    assert fp == jax_fp.chromaprint(y, SR)
    subs, alg = fingerprint.decode_chromaprint(fp)
    want_subs, want_alg = jax_fp.decode_chromaprint(fp)
    np.testing.assert_array_equal(subs, want_subs)
    assert alg == want_alg and subs.size > 0
