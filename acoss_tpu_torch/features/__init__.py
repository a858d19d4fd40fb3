"""Audio feature extraction in PyTorch (port of `acoss_tpu.features`, the
reference's L1 layer).

  spectral  -> STFT / mel / DCT plumbing under everything
  chroma    -> chroma_stft / chroma_cqt / chroma_cens /
               chroma_cqt_processed (+ the CQT itself)
  hpcp      -> essentia HPCP pipeline (peaks + whitening + harmonics)
  mfcc      -> mfcc_htk (essentia/HTK) and mfcc_librosa
  onsets    -> superflux novelty, Ellis DP beat tracking, the
               madmom_features substitute dict
  rhythm    -> autocorrelation tempogram (single song and aggregated)
  chord     -> chord-template HMM chroma (the crema slot; the
               forward-backward kernel of `ops.hmm_cuda`)
  nsgcq     -> non-stationary Gabor constant-Q transform
  key       -> Krumhansl-Schmuckler key extractor (numpy)
  audio     -> WAV/ffmpeg decode, polyphase resample, slicing (numpy)
  fingerprint -> the chromaprint algorithm (numpy)
  pipeline  -> compute_features / batch_extract (the extractors.py analog)

The spectral stages run on the device the caller names (the card by
default); the host stages are numpy copies of the JAX package's.
"""

from acoss_tpu_torch.features.chroma import (  # noqa: F401
    chroma_cens, chroma_cqt, chroma_cqt_processed, chroma_stft, cqt)
from acoss_tpu_torch.features.hpcp import hpcp  # noqa: F401
from acoss_tpu_torch.features.key import key_extractor  # noqa: F401
from acoss_tpu_torch.features.mfcc import mfcc_htk, mfcc_librosa  # noqa: F401
from acoss_tpu_torch.features.onsets import (  # noqa: F401
    beat_track_dp, madmom_features_substitute, onset_strength)
from acoss_tpu_torch.features.pipeline import (  # noqa: F401
    PROFILE, batch_extract, compute_features)
from acoss_tpu_torch.features.rhythm import tempogram  # noqa: F401
