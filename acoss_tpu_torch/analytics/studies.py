"""End-to-end coverstats study runner (port of
`acoss_tpu.analytics.studies`): one call / CLI command runs the "what is
a cover?" studies over a FeatureSet and writes the artifacts.

Parity target: the reference's runnable study scripts --
`coverstats/coverstats.py:44-58,75-125,132-177,199-241` (keys.csv + key
stats + figures, tempos.csv + ratio stats, tag F-measures),
`coverstats/OnsetTiming.py:104-181` (persistence-image and stdev studies
with saved distance arrays and comparison figures) and
`coverstats/SongStructure.py` (shape-DNA eigenvalue study).

Inputs come from a FeatureSet instead of per-track h5 globs, distance
arrays are saved as .npz instead of .mat, and scalar results are also
collected into one machine-readable summary.json (the JAX package's
artifacts and keys). matplotlib is imported only when figures are asked
for; asking for them without matplotlib raises before any study runs.
"""

from __future__ import annotations

import json
import os

import numpy as np
import torch

from acoss_tpu_torch.analytics import coverstats as cs
from acoss_tpu_torch.analytics.onset_timing import (onset_stdev_study,
                                                    onset_timing_study)
from acoss_tpu_torch.analytics.song_structure import shape_dna_study
from acoss_tpu_torch.data.store import FeatureSet

ALL_STUDIES = ("key", "tempo", "onset", "stdev", "shapedna", "tag")


def _pyplot():
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    return plt


def _hist_compare_figure(path: str, dcover: np.ndarray, dfalse: np.ndarray,
                         xlabel: str, title: str, q: float = 0.98) -> None:
    """True-vs-false density histogram (`OnsetTiming.py:135-145`)."""
    plt = _pyplot()
    fig, ax = plt.subplots(figsize=(5, 2.5))
    hi = float(np.quantile(dfalse, q)) if len(dfalse) else 1.0
    bins = np.linspace(0, max(hi, 1e-12), 40)
    ax.hist(dcover, bins=bins, density=True, alpha=0.6,
            label="True Covers")
    ax.hist(dfalse, bins=bins, density=True, alpha=0.6,
            label="False Covers")
    ax.set_xlabel(xlabel)
    ax.set_ylabel("Density")
    ax.set_title(title)
    ax.legend()
    fig.savefig(path, bbox_inches="tight")
    plt.close(fig)


def _hist_figure(path: str, x: np.ndarray, xlabel: str, title: str,
                 bins=30) -> None:
    plt = _pyplot()
    fig, ax = plt.subplots(figsize=(2.5, 2.5))
    ax.hist(np.asarray(x, dtype=float), bins=bins, density=False)
    ax.set_xlabel(xlabel)
    ax.set_ylabel("Count")
    ax.set_title(title)
    fig.savefig(path, bbox_inches="tight")
    plt.close(fig)


def _ks_summary(ks) -> dict:
    if ks is None:
        return {"ks_stat": None, "ks_pvalue": None}
    return {"ks_stat": float(ks.statistic), "ks_pvalue": float(ks.pvalue)}


def run_coverstats(fs: FeatureSet, outdir: str,
                   studies=ALL_STUDIES, chroma_type: str = "hpcp",
                   figures: bool = True, pair_tags: dict | None = None,
                   min_key_confidence: float = 0.75,
                   verbose: bool = False,
                   device: str | torch.device = "cuda") -> dict:
    """Run the requested studies over `fs` (device work on `device`),
    write artifacts under `outdir`, and return the scalar summary (also
    saved as summary.json).

    Artifacts per study (reference analogs in parentheses):
    - key:      keys.csv, Transposition.svg, KeyConfidences.svg
                (`coverstats.py:44-58,75,120-125`)
    - tempo:    tempos.csv, TempoRatios.svg (`coverstats.py:132-177`)
    - onset:    onsettiming.npz {dcover,dfalse}, OnsetTimings.svg
                (`OnsetTiming.py:104-148`)
    - stdev:    stdevs.csv, stdevs.npz, StdevDistances.svg
                (`OnsetTiming.py:151-181`)
    - shapedna: shapedna.npz {ws,dcover,dfalse}, ShapeDNA.svg
                (`SongStructure.py:100-148`)
    - tag:      tags.npz {true_pairs,false_pairs}, AutoTag.svg
                (`coverstats.py:199-241`; needs `pair_tags`)
    """
    if figures:
        try:
            import matplotlib  # noqa: F401
        except ImportError as e:
            raise ImportError(
                "coverstats figures need matplotlib, which is not "
                "installed; pass figures=False (--no-figures on the CLI) "
                "to write the CSV/.npz artifacts and summary.json only"
            ) from e
    os.makedirs(outdir, exist_ok=True)
    summary: dict = {"n_songs": int(fs.n_songs), "studies": {}}

    def note(msg):
        if verbose:
            print(msg, flush=True)

    if "key" in studies:
        note("study: key")
        df = cs.key_table(fs, chroma_type=chroma_type)
        df.to_csv(os.path.join(outdir, "keys.csv"))
        stats = cs.key_stats(df, min_confidence=min_key_confidence)
        if figures:
            strengths = df.values("Strength1", "Strength2").astype(float)
            if len(strengths):
                _hist_figure(os.path.join(outdir, "KeyConfidences.svg"),
                             strengths.min(axis=1), "Strength",
                             "Minimum Key Confidences")
            if len(stats["transposition_distances"]):
                _hist_figure(os.path.join(outdir, "Transposition.svg"),
                             stats["transposition_distances"],
                             "Transposition Distance in Halfsteps",
                             "Transposition Changes",
                             bins=np.arange(8) - 0.5)
        summary["studies"]["key"] = {
            "n_pairs_confident": stats["n_pairs_confident"],
            "frac_same_scale": stats["frac_same_scale"],
            "frac_same_key": stats["frac_same_key"],
        }

    if "tempo" in studies:
        note("study: tempo")
        df = cs.tempo_table(fs, device=device)
        df.to_csv(os.path.join(outdir, "tempos.csv"))
        stats = cs.tempo_stats(df)
        if figures and len(stats["ratios"]):
            _hist_figure(os.path.join(outdir, "TempoRatios.svg"),
                         stats["ratios"], "Ratio", "Tempo Ratios")
        summary["studies"]["tempo"] = {
            "n_pairs": stats["n_pairs"], "q25": stats["q25"],
            "q50": stats["q50"], "q75": stats["q75"],
        }

    if "onset" in studies:
        note("study: onset timing (persistence images)")
        res = onset_timing_study(fs, device=device)
        np.savez(os.path.join(outdir, "onsettiming.npz"),
                 dcover=res["dcover"], dfalse=res["dfalse"],
                 labels=np.asarray(res["labels"], dtype=np.str_))
        if figures and len(res["dfalse"]):
            _hist_compare_figure(
                os.path.join(outdir, "OnsetTimings.svg"),
                res["dcover"], res["dfalse"],
                "Persistence Image Distance",
                "Persistence Image Distances")
        summary["studies"]["onset"] = {
            "mean_cover": res["mean_cover"],
            "mean_false": res["mean_false"],
            **_ks_summary(res["ks"]),
        }

    if "stdev" in studies:
        note("study: tempo-curve stdevs")
        res = onset_stdev_study(fs)
        np.savez(os.path.join(outdir, "stdevs.npz"),
                 stdevs=res["stdevs"], dcover=res["dcover"],
                 dfalse=res["dfalse"])
        cs.Table(res["labels"], ["Stdev1", "Stdev2"],
                 res["stdevs"].tolist()).to_csv(
            os.path.join(outdir, "stdevs.csv"))
        if figures and len(res["dfalse"]):
            _hist_compare_figure(
                os.path.join(outdir, "StdevDistances.svg"),
                res["dcover"], res["dfalse"],
                "|std(y1) - std(y2)|", "Tempo-Curve Stdev Distances")
        summary["studies"]["stdev"] = {
            "mean_cover": res["mean_cover"],
            "mean_false": res["mean_false"],
            **_ks_summary(res["ks"]),
        }

    if "shapedna" in studies:
        note("study: shape DNA")
        res = shape_dna_study(fs, chroma_type=chroma_type, device=device)
        np.savez(os.path.join(outdir, "shapedna.npz"), ws=res["ws"],
                 dcover=res["dcover"], dfalse=res["dfalse"])
        if figures and len(res["dfalse"]):
            _hist_compare_figure(
                os.path.join(outdir, "ShapeDNA.svg"),
                res["dcover"], res["dfalse"],
                "Eigenvalue Distance", "Shape DNA Distances")
        summary["studies"]["shapedna"] = {
            "mean_cover": float(np.mean(res["dcover"]))
            if len(res["dcover"]) else None,
            "mean_false": float(np.mean(res["dfalse"]))
            if len(res["dfalse"]) else None,
            **_ks_summary(res["ks"]),
        }

    if "tag" in studies and pair_tags is not None:
        note("study: auto-tag F-measure")
        res = cs.tag_stats(pair_tags)
        np.savez(os.path.join(outdir, "tags.npz"),
                 true_pairs=res["true_pairs"],
                 false_pairs=res["false_pairs"])
        if figures and len(res["false_pairs"]):
            _hist_compare_figure(
                os.path.join(outdir, "AutoTag.svg"),
                res["true_pairs"], res["false_pairs"],
                "F-Measure", "Auto Tagging F-Measure Distributions")
        summary["studies"]["tag"] = {
            "mean_true": float(np.mean(res["true_pairs"]))
            if len(res["true_pairs"]) else None,
            "mean_false": float(np.mean(res["false_pairs"]))
            if len(res["false_pairs"]) else None,
            **_ks_summary(res["ks"]),
        }

    with open(os.path.join(outdir, "summary.json"), "w") as f:
        json.dump(summary, f, indent=2)
    note(f"coverstats artifacts written to {outdir}")
    return summary
