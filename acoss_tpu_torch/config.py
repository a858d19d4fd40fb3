"""Typed configuration tree (a copy of `acoss_tpu.config`, pure Python).

Replaces the reference's scattered configuration (per-script argparse with
uniform flags, the `PROFILE` dict at `extractors.py:22-29`, the hard-coded
path constants of `local_config.py:9-17`, and per-file tuning globals) with
one dataclass tree. The CLI (`acoss_tpu_torch.cli`) keeps the reference's
flag names (-d/-s/-c/-n/...).
"""

from __future__ import annotations

import dataclasses


@dataclasses.dataclass
class PathsConfig:
    """`local_config.py` analog -- dataset/feature/cache locations."""
    audio_dir: str = "."
    feature_store: str = "features.npz"
    cache_dir: str = "cache"
    results_dir: str = "."


@dataclasses.dataclass
class FeatureProfile:
    """`extractors.py:22-29` PROFILE analog."""
    sample_rate: int = 44100
    hop_length: int = 512
    features: tuple = ("hpcp", "key_extractor", "madmom_features",
                       "mfcc_htk", "crema")


@dataclasses.dataclass
class AlgorithmConfig:
    name: str = "Serra09"
    chroma_type: str = "hpcp"
    kappa: float = 0.095
    m: int = 9
    downsample_fac: int = 40
    oti: bool = True
    extra: dict = dataclasses.field(default_factory=dict)


@dataclasses.dataclass
class MeshConfig:
    """Device-mesh shape for the sharded pair sweep (rows x cols over the
    pair grid); 1 x 1 = single device."""
    rows: int = 1
    cols: int = 1
    col_tile: int = 8


@dataclasses.dataclass
class BenchmarkConfig:
    paths: PathsConfig = dataclasses.field(default_factory=PathsConfig)
    profile: FeatureProfile = dataclasses.field(
        default_factory=FeatureProfile)
    algorithm: AlgorithmConfig = dataclasses.field(
        default_factory=AlgorithmConfig)
    mesh: MeshConfig = dataclasses.field(default_factory=MeshConfig)
    shortname: str = "covers80"
    tile: int | None = None
