"""Check and time the chord HMM's forward-backward kernel (`csrc/hmm.cu`)
on the card.

    python3 scripts/torch_hmm_fb.py [--chunks 38,76,152] [--parent DIR]
                                    [--variants a,b] [--reps 50] [--ptxas]

Prints the card's name and power limit, then one JSON line a step:
- `check`: the kernel against its plain version (`chord_forward_backward_ref`)
  and the plain model of its chunked algorithm at the same chunk (atol
  1e-5 each), and two calls bit-equal, on random emissions (log-softmax of
  N(0, 4) logits; the sticky 25-state chord prior, Dirichlet-random
  transitions at 7 and 32 states, and spiky ones with -inf entries under
  emissions spread over hundreds of nats, and a song whose state changes
  underflow every linear factor: these take the exact branch) at
  the chunk edges T = L - 1, L, L + 1, 2L - 1, 3L + 5 and at 1, 2, 5,762
  and 25,832 frames;
- `time`: device ms a call (CUDA events over `--reps` calls after a
  warm-up) at (5,762, 25) and (25,832, 25), the frames of the smoke run's
  first placeholder song and of its 300 s song, for the default chunk and
  each of `--chunks`, with each phase's device ms by torch.profiler;
- `parent`: with `--parent DIR` (an unpacked earlier checkout), its
  single-warp kernel built from DIR/acoss_tpu_torch/csrc/hmm.cu and timed
  at the same shapes in turns with this one (parent, this, this, parent).
- `variant`: with `--variants a,b` (names in VARIANTS), copies of
  `hmm.cu` with a text substitution each, built at once under
  build/hmm_variants and timed the same way; those that keep the function
  are held to the plain version (atol 1e-5), the diagnostic ones are not.
- `replay`: one chunk of T frames (chunk = T), the replay phase alone, at
  T = 512 and 1,024: its ms over T is a replay step's latency.
`--ptxas` prints nvcc's register and spill report for `hmm.cu` first.
Nothing under `csrc/` is modified. Exits nonzero if a check fails.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import os
import re
import subprocess
import sys
from pathlib import Path

import numpy as np
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

from acoss_tpu_torch.features import chord  # noqa: E402
from acoss_tpu_torch.ops import _build, hmm_cuda  # noqa: E402

SHAPES = ((5762, 25), (25832, 25))
# (text in hmm.cu, its replacement) a variant, and whether it keeps the
# function
VARIANTS = {
    "diag_no_block_barrier": (
        [("    __syncthreads();\n    g = finite_or_zero",
          "    __syncwarp();\n    g = finite_or_zero")], False),
    "diag_no_exact_check": (
        [("if (__any_sync(kFull, on && small)) {\n    const float ex",
          "if (C < 0) {\n    const float ex")], False),
}


def _inputs(T: int, C: int, seed: int, trans: str = "sticky"):
    """Log emissions (T, C) and log transitions (C, C), float32 on the
    CPU: `sticky` the chord prior, `dirichlet` random rows, `spiky` rows
    of Dirichlet(0.05) (entries of 0, so -inf) under emissions of N(0, 40)
    logits, `switch` as below."""
    if trans == "switch":
        # the state changes every 100 frames, each emission ruling out the
        # others, under transitions of log -200: every linear factor of a
        # change underflows, so only the exact branch gets it right
        A = torch.full((C, C), -200.0)
        A.fill_diagonal_(0.0)
        E = torch.full((T, C), -1000.0)
        E[torch.arange(T), (torch.arange(T) // 100) % C] = 0.0
        return E, A
    rng = np.random.default_rng(seed)
    logits = rng.normal(0, 40 if trans == "spiky" else 4, (T, C))
    le = torch.log_softmax(torch.from_numpy(logits.astype(np.float32)), 1)
    if trans == "sticky":
        lt = chord.log_transitions(C, 0.97)
    else:
        with np.errstate(divide="ignore"):
            lt = np.log(rng.dirichlet(
                np.full(C, 0.05 if trans == "spiky" else 1.0), C))
    return le.contiguous(), torch.from_numpy(lt.astype(np.float32))


def _ms(fn, reps: int) -> float:
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def _split(fn) -> dict:
    """Device ms of each kernel one call launches, by torch.profiler."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    return {(re.search(r"(\w+)\(", e.key) or re.search(r"(.*)", e.key))[1]:
            round(e.self_device_time_total / 1e3, 5)
            for e in prof.key_averages()
            if e.device_type == DeviceType.CUDA
            and e.self_device_time_total > 0}


def _print(kind: str, **kw) -> None:
    print(json.dumps({"step": kind, **kw}), flush=True)


def ptxas_report() -> None:
    r = subprocess.run(
        [_build.find_nvcc(), *_build.COMPILE_FLAGS, "-Xptxas", "-v", "-c",
         "-o", os.devnull, str(_build.CSRC / "hmm.cu")],
        capture_output=True, text=True)
    for line in r.stderr.splitlines():
        if "Compiling entry" in line or "registers" in line \
                or "spill" in line:
            print(line.strip(), flush=True)


def check(dev) -> bool:
    ok = True
    cases = []
    for L in (16, 64):
        for T in (L - 1, L, L + 1, 2 * L - 1, 3 * L + 5):
            cases += [(T, 25, "sticky", L), (T, 7, "dirichlet", L),
                      (T, 32, "spiky", L)]
    cases += [(300, 3, "switch", 16), (300, 3, "switch", None),
              (1, 25, "sticky", None), (2, 25, "sticky", None),
              (5762, 25, "sticky", None), (5762, 32, "spiky", None),
              (25832, 25, "sticky", None), (25832, 7, "dirichlet", 100)]
    for T, C, trans, L in cases:
        le, lt = _inputs(T, C, T * 31 + C, trans)
        Lk = _default_chunk(T, dev) if L is None else L
        got = _run(le.to(dev), lt.to(dev), L)
        again = _run(le.to(dev), lt.to(dev), L)
        torch.cuda.synchronize()
        got = got.cpu()
        want = hmm_cuda.chord_forward_backward_ref(le.to(dev),
                                                   lt.to(dev)).cpu()
        model = hmm_cuda.chord_forward_backward_chunked_ref(le, lt, Lk)
        err = float((got - want).abs().max())
        err_model = float((got - model).abs().max())
        same = bool(torch.equal(got, again.cpu()))
        good = (err <= 1e-5 and err_model <= 1e-5 and same
                and bool(torch.isfinite(got).all()))
        ok &= good
        _print("check", T=T, C=C, trans=trans, chunk=Lk, err_plain=err,
               err_model=err_model, repeat_bit_equal=same, ok=good)
    return ok


def _variant_libs(names: list[str]) -> dict:
    """Build every named variant of hmm.cu at once; name -> ctypes lib."""
    out = os.path.join(ROOT, "build", "hmm_variants")
    procs = {}
    for name in names:
        subs, _ = VARIANTS[name]
        d = os.path.join(out, name)
        os.makedirs(d, exist_ok=True)
        for f in ("hmm.cu", "device.cuh"):
            text = (_build.CSRC / f).read_text()
            for a, b in subs if f == "hmm.cu" else ():
                if a not in text:
                    raise ValueError(f"{name}: {a!r} not in {f}")
                text = text.replace(a, b)
            with open(os.path.join(d, f), "w") as fh:
                fh.write(text)
        lib = os.path.join(d, "libhmm.so")
        procs[name] = (lib, subprocess.Popen(
            [_build.find_nvcc(), *_build.NVCC_FLAGS, "-o", lib,
             os.path.join(d, "hmm.cu")], stderr=subprocess.PIPE, text=True))
    libs = {}
    for name, (path, proc) in procs.items():
        if proc.wait() != 0:
            raise RuntimeError(f"{name}: {proc.stderr.read()}")
        lib = ctypes.CDLL(path)
        for fn, (argtypes, restype) in _build.SIGNATURES.items():
            if fn.startswith("acoss_hmm_fb"):
                getattr(lib, fn).argtypes = argtypes
                getattr(lib, fn).restype = restype
        libs[name] = lib
    return libs


def _call(lib, le, lt, L: int):
    """The wrapper's call of `acoss_hmm_fb`, through another build."""
    T, C = le.shape
    gamma = torch.empty_like(le)
    scratch = torch.empty(lib.acoss_hmm_fb_scratch(T, C, L),
                          dtype=torch.float32, device=le.device)
    rc = lib.acoss_hmm_fb(le.data_ptr(), lt.data_ptr(), T, C, L,
                          scratch.data_ptr(), gamma.data_ptr(),
                          le.device.index, torch.cuda.current_stream(
                              le.device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"acoss_hmm_fb: CUDA error {rc}")
    return gamma


def _default_chunk(T: int, dev) -> int:
    return hmm_cuda.chunk_length(T, hmm_cuda._sm_count(dev))


def _run(le, lt, L: int | None):
    """The wrapper (L None: its own chunk length), or this checkout's
    kernel library called with chunks of L frames."""
    if L is None:
        return hmm_cuda.chord_forward_backward(le, lt)
    return _call(_build.library(), le, lt, L)


def time_variants(dev, names: list[str], reps: int) -> bool:
    ok = True
    libs = _variant_libs(names)
    for T, C in SHAPES:
        le, lt = _inputs(T, C, T)
        le, lt = le.to(dev), lt.to(dev)
        L = _default_chunk(T, dev)
        want = hmm_cuda.chord_forward_backward_ref(le, lt)
        for name, lib in libs.items():
            def run(lib=lib):
                return _call(lib, le, lt, L)
            err = float((run() - want).abs().max())
            good = err <= 1e-5 or not VARIANTS[name][1]
            ok &= good
            _print("variant", name=name, T=T, C=C, chunk=L, err_plain=err,
                   ok=good, ms=_ms(run, reps), phases_ms=_split(run))
        this = _ms(lambda: hmm_cuda.chord_forward_backward(le, lt), reps)
        _print("variant", name="as is", T=T, C=C, chunk=L, ms=this)
    return ok


def time_replay(dev, reps: int) -> None:
    for T in (512, 1024):
        le, lt = _inputs(T, 25, T)
        le, lt = le.to(dev), lt.to(dev)
        ms = _ms(lambda: _run(le, lt, T), reps)
        _print("replay", T=T, C=25, chunk=T, ms=ms, us_a_step=1e3 * ms / T)


def _parent_lib(parent: str):
    src = os.path.join(parent, "acoss_tpu_torch", "csrc", "hmm.cu")
    out = os.path.join(ROOT, "build", "hmm_parent.so")
    _build.compile_once(
        Path(out),
        lambda t: [_build.find_nvcc(), *_build.NVCC_FLAGS, "-o", str(t), src])
    lib = ctypes.CDLL(out)
    P, I = ctypes.c_void_p, ctypes.c_int
    lib.acoss_hmm_fb.argtypes = [P, P, I, I, P, I, P]
    lib.acoss_hmm_fb.restype = I
    return lib


def time_shapes(dev, chunks: list[int], reps: int, parent: str | None):
    lib = _parent_lib(parent) if parent else None
    for T, C in SHAPES:
        le, lt = _inputs(T, C, T)
        le, lt = le.to(dev), lt.to(dev)
        for L in [None, *chunks]:
            def run(L=L):
                return _run(le, lt, L)
            _print("time", T=T, C=C,
                   chunk=_default_chunk(T, dev) if L is None else L,
                   ms=_ms(run, reps), phases_ms=_split(run))
        if lib is None:
            continue
        gamma = torch.empty_like(le)
        stream = torch.cuda.current_stream(dev).cuda_stream

        def old():
            rc = lib.acoss_hmm_fb(le.data_ptr(), lt.data_ptr(), T, C,
                                  gamma.data_ptr(), dev.index or 0, stream)
            if rc != 0:
                raise RuntimeError(f"parent acoss_hmm_fb: CUDA error {rc}")
            return gamma

        def new():
            return hmm_cuda.chord_forward_backward(le, lt)

        want = hmm_cuda.chord_forward_backward_ref(le, lt)
        old_err = float((old() - want).abs().max())
        turns = [("parent", old), ("this", new), ("this", new),
                 ("parent", old)]
        times = [(k, _ms(fn, max(2, reps // 10) if k == "parent" else reps))
                 for k, fn in turns]
        _print("parent", T=T, C=C, parent_err_plain=old_err,
               turns=[[k, ms] for k, ms in times])


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--chunks", default="",
                    help="comma-separated chunk lengths to time beside "
                         "the default")
    ap.add_argument("--parent", default=None)
    ap.add_argument("--reps", type=int, default=50)
    ap.add_argument("--variants", default="",
                    help="comma-separated names from VARIANTS")
    ap.add_argument("--ptxas", action="store_true")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("needs a CUDA device")
    dev = torch.device("cuda", torch.cuda.current_device())
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip(), flush=True)
    if args.ptxas:
        ptxas_report()
    _build.library()
    ok = check(dev)
    chunks = [int(c) for c in args.chunks.split(",") if c]
    time_shapes(dev, chunks, args.reps, args.parent)
    time_replay(dev, args.reps)
    names = [v for v in args.variants.split(",") if v]
    if names:
        ok &= time_variants(dev, names, args.reps)
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
