"""The covers80 placeholder recipe on the PyTorch/CUDA port: synthesize a
covers80-layout WAV corpus, extract its features with
`acoss_tpu_torch.features.batch_extract` and run `benchmark` of Serra09,
FTM2D and StrucFTM2D on them.

    python3 scripts/torch_covers80_placeholder.py [--audio-dir DIR]
        [--cliques 80] [--features F.npz] [--only Serra09 FTM2D StrucFTM2D]
        [--device cuda]

`make_placeholder` is a copy of the JAX package's recipe
(`scripts/covers80_parity.py`, which imports jax through its package): 80
cliques x 2 takes of noisy chord-progression WAVs with a shared verse /
chorus form, tempo curve and timbre, one take transposed and tempo-scaled;
the same seed writes the same bytes. The corpus and the features are
reused when present. Each step prints one JSON line with its seconds
(extraction per song; each benchmark's extract / sweep / eval) and each
benchmark's MAP per similarity type. Work files default to
build/torch_covers80 in the checkout.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

from acoss_tpu_torch.features.audio import save_wav  # noqa: E402

SR = 44100


def make_placeholder(covers32k: str, seed: int = 0,
                     n_cliques: int = 80) -> None:
    """Synthesize a covers80-layout placeholder corpus (WAV): each song
    ~60-75 s with a percussive beat grid (~2.3 beats/s, a clique-shared
    tempo curve, a per-cover tempo factor), an A B A B C B form of
    8-chord sections shared within the clique and transposed per cover,
    and a clique-specific harmonic timbre."""
    rng = np.random.default_rng(seed)
    names = [f"artist{c:02d}_song{c:02d}" for c in range(n_cliques)]
    lists = {"list1.list": [], "list2.list": []}

    def chord_audio(states, beats_per_chord, transpose, tempo_factor,
                    tempo_curve, timbre, prng):
        beat0 = 0.43 * tempo_factor          # ~2.3 beats/s at factor 1
        sig_parts = []
        k = 0
        for s, nb in zip(states, beats_per_chord):
            root = (s // 2 + transpose) % 12
            third = 4 if s % 2 == 0 else 3
            dur = 0.0
            beat_ts = []
            for _ in range(int(nb)):
                beat_ts.append(dur)
                dur += beat0 * tempo_curve[k % len(tempo_curve)]
                k += 1
            n = int(dur * SR)
            t = np.arange(n) / SR
            sig = np.zeros(n)
            for iv in (0, third, 7):
                f0 = 440.0 * 2 ** (((root + iv) - 9) / 12 - 1)
                for h, amp in enumerate(timbre, start=1):
                    fh = f0 * h
                    if fh > 8000:
                        break
                    sig += amp * np.sin(2 * np.pi * fh * t +
                                        prng.uniform(0, 6.28))
            sig /= max(np.abs(sig).max(), 1e-9)
            # percussive beat: short noise bursts at the beat grid (the
            # superflux novelty + DP tracker lock onto these)
            for bt in beat_ts:
                i0 = int(bt * SR)
                ln = min(int(0.03 * SR), n - i0)
                if ln > 0:
                    env = np.exp(-np.arange(ln) / (0.006 * SR))
                    sig[i0:i0 + ln] += 1.4 * env * prng.normal(size=ln)
            sig_parts.append(sig)
        y = np.concatenate(sig_parts)
        y += 0.05 * prng.normal(size=y.size)
        return (0.8 * y / np.abs(y).max()).astype(np.float32)

    for c, name in enumerate(names):
        os.makedirs(os.path.join(covers32k, name), exist_ok=True)
        # verse/chorus form: 3 distinct 8-chord sections, A B A B C B
        sections = [rng.integers(0, 24, size=8) for _ in range(3)]
        form = [0, 1, 0, 1, 2, 1]
        states = np.concatenate([sections[f] for f in form])
        beats_per_chord = rng.integers(2, 5, size=states.size)
        # clique-shared latents: tempo curve + instrument timbre
        raw = rng.normal(0, 1, 32)
        kern = np.exp(-0.5 * (np.arange(-6, 7) / 3.0) ** 2)
        sm = np.convolve(raw, kern / kern.sum(), mode="same")
        tempo_curve = 1.0 + 0.12 * sm / max(np.abs(sm).max(), 1e-9)
        timbre = rng.random(10) ** 2 * (1.0 / np.arange(1, 11))
        timbre /= timbre.sum()
        for p, listfile in enumerate(lists):
            tp = int(rng.integers(0, 12)) if p else 0
            fac = float(rng.uniform(0.85, 1.2)) if p else 1.0
            rel = f"{name}/take{p}"
            save_wav(os.path.join(covers32k, rel + ".wav"),
                     chord_audio(states, beats_per_chord, tp, fac,
                                 tempo_curve, timbre, rng), SR)
            lists[listfile].append(rel)
    for listfile, rels in lists.items():
        with open(os.path.join(covers32k, listfile), "w") as f:
            f.write("\n".join(rels) + "\n")


def placeholder_paths(covers32k: str) -> tuple[list[str], list[str]]:
    """(WAV paths, clique labels) of a placeholder corpus, in its list
    order (list1 then list2, as `manifest.covers80_list`)."""
    from acoss_tpu_torch.data.manifest import covers80_list

    paths, labels = covers80_list(covers32k)
    return [os.path.splitext(p)[0] + ".wav" for p in paths], labels


ALGORITHMS = ("Serra09", "FTM2D", "StrucFTM2D")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    work = os.path.join(REPO, "build", "torch_covers80")
    ap.add_argument("--audio-dir", default=os.path.join(work, "covers32k"))
    ap.add_argument("--cliques", type=int, default=80)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--features",
                    default=os.path.join(work, "features.npz"))
    ap.add_argument("--only", nargs="*", default=list(ALGORITHMS),
                    choices=ALGORITHMS)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    from acoss_tpu_torch.benchmarking.algorithms import ALL_ALGORITHMS
    from acoss_tpu_torch.benchmarking.harness import benchmark
    from acoss_tpu_torch.data.store import FeatureSet
    from acoss_tpu_torch.features.pipeline import batch_extract

    if not os.path.exists(os.path.join(args.audio_dir, "list1.list")):
        t0 = time.perf_counter()
        make_placeholder(args.audio_dir, args.seed, args.cliques)
        print(json.dumps({"step": "synthesize", "songs": 2 * args.cliques,
                          "s": time.perf_counter() - t0}), flush=True)
    if os.path.exists(args.features):
        fs = FeatureSet.load(args.features)
    else:
        paths, labels = placeholder_paths(args.audio_dir)
        errors = args.features + ".errors.txt"
        t0 = time.perf_counter()
        fs = batch_extract(paths, labels, error_log=errors,
                           device=args.device)
        s = time.perf_counter() - t0
        fs.save(args.features)
        print(json.dumps({"step": "extract", "songs": fs.n_songs,
                          "of": len(paths), "s": s,
                          "s_per_song": s / len(paths)}), flush=True)
        if fs.n_songs != len(paths):
            print(f"extraction failed for some songs: {errors}",
                  file=sys.stderr)
            return 1
    for name in args.only:
        times = {}
        stats = benchmark(ALL_ALGORITHMS[name](), fs, device=args.device,
                          times=times)
        print(json.dumps({"step": "benchmark", "algorithm": name,
                          "songs": fs.n_songs, **{f"{k}_s": v for k, v in
                                                  times.items()},
                          "map": {k: float(v.map)
                                  for k, v in stats.items()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
