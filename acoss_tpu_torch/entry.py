"""Entry points of the port's multi-device proof (port of `entry` and
`dryrun_multichip` of the JAX package's `__graft_entry__.py`).

- ``entry(device)``: one Serra09 pair-grid tile (OTI -> CSM -> sliding
  CSM -> mutual-kNN binarize -> batched qmax / dmax) and its arguments,
  on `device`.
- ``dryrun_multichip(n_devices, device)``: an n-device mesh over the pair
  grid on tiny shapes, checked against an unsharded single-device tile
  loop bit for bit; also EarlySNF's per-pair fusion, the fp16 and int8
  descriptor contracts, the triangular fold the CLI uses for symmetric
  algorithms, and a 2-process shard + merge round trip. With
  `device="cuda"` the mesh takes n visible cards; a device that names one
  device ("cpu", "cuda:0") fills every slot.
"""

from __future__ import annotations

import tempfile

import numpy as np
import torch


def _tiny_descriptors(n_songs: int, seed: int = 0,
                      device: str | torch.device = "cuda"):
    from acoss_tpu_torch.benchmarking.algorithms import Serra09
    from acoss_tpu_torch.data import make_synthetic_dataset

    fs = make_synthetic_dataset(
        n_cliques=max(2, n_songs // 2), clique_size=2, n_states=12,
        base_duration=4.0, seed=seed)
    fs = fs.subset(np.arange(n_songs))
    algo = Serra09(chroma_type="hpcp", downsample_fac=4, pad_to_multiple=16)
    return algo, algo.extract_descriptors(fs, device=device), fs


def entry(device: str | torch.device = "cuda"):
    """(fn, example_args): Serra09's tile scorer and a (4 x 4) tile of
    tiny descriptors on `device`."""
    from acoss_tpu_torch.convert import descriptors_from_numpy

    algo, desc, _ = _tiny_descriptors(8, device=device)
    desc = descriptors_from_numpy(desc, device)
    row = {k: v[:4] for k, v in desc.items()}
    col = {k: v[4:8] for k, v in desc.items()}
    return algo.tile_scores, (row, col)


def _unsharded(algo, desc: dict, n: int, device, ct: int = 2) -> dict:
    """Every (ct x ct) tile of the full grid, one `tile_scores` call each
    on one device: the single-device reference of the mesh sweep."""
    from acoss_tpu_torch.convert import descriptors_from_numpy

    dd = descriptors_from_numpy(desc, device)
    ref = {}
    for i in range(0, n, ct):
        row = {k: v[i:i + ct] for k, v in dd.items()}
        for j in range(0, n, ct):
            col = {k: v[j:j + ct] for k, v in dd.items()}
            for k, v in algo.tile_scores(row, col).items():
                ref.setdefault(k, np.zeros((n, n), np.float32))[
                    i:i + ct, j:j + ct] = v.cpu().numpy()
    return ref


def _check_close(what: str, got: dict, want: dict, rel: float) -> None:
    """got within rel x max(max |want|, 1) of want, for every type."""
    for k in want:
        scale = max(float(np.abs(want[k]).max()), 1.0)
        err = float(np.abs(got[k] - want[k]).max())
        if not err <= rel * scale:
            raise AssertionError(f"{what} {k}: max abs err {err} > "
                                 f"{rel} x {scale}")


def dryrun_multichip(n_devices: int,
                     device: str | torch.device = "cuda") -> None:
    """One full sharded pair sweep over an n-device mesh: the flagship
    Serra09 and the heaviest per-pair program (EarlySNF's joint-affinity
    cross-diffusion), with every check of the JAX package's dry run.
    Prints one "dryrun_multichip OK: ..." line; raises on any failure."""
    from acoss_tpu_torch.benchmarking.algorithms import EarlySNF
    from acoss_tpu_torch.data.descstore import quantize_int8
    from acoss_tpu_torch.parallel import (make_pair_mesh, merge_partials,
                                          run_process_shard,
                                          sharded_pair_scores,
                                          sharded_pair_scores_triangular)
    from acoss_tpu_torch.parallel.mesh import mesh_devices

    devices = mesh_devices(device, n_devices)
    mesh = make_pair_mesh(devices)
    home = devices[0]
    algo, desc, fs = _tiny_descriptors(max(8, 2 * n_devices), device=home)
    n = fs.n_songs
    out = sharded_pair_scores(algo.tile_scores, desc, n, mesh, col_tile=2)
    for k, v in out.items():
        if v.shape != (n, n) or not np.isfinite(v).all():
            raise AssertionError(f"{k}: shape {v.shape} or non-finite")

    # sharded == UNSHARDED: one plain single-device tile loop over the
    # same pair grid reproduces the mesh sweep exactly (the determinism
    # contract of the reference's do_batch_subbatch,
    # CoverAlgorithm.py:203-247)
    ref = _unsharded(algo, desc, n, home)
    for k in out:
        if not np.array_equal(out[k], ref[k]):
            raise AssertionError(f"sharded sweep != unsharded single-device "
                                 f"matrix: {k}")

    esnf = EarlySNF(chroma_type="hpcp", downsample_fac=4,
                    pad_to_multiple=16, do_ssms=False)
    out2 = sharded_pair_scores(esnf.tile_scores, desc, n, mesh, col_tile=2)
    for k, v in out2.items():
        if v.shape != (n, n) or not np.isfinite(v).all():
            raise AssertionError(f"EarlySNF {k}: shape {v.shape} or "
                                 f"non-finite")

    # half-precision descriptors (the --stream-half layout) restored to
    # fp32 on each block's device: within input-quantization tolerance
    half = {k: v.astype(np.float16) if v.dtype == np.float32 else v
            for k, v in desc.items()}
    outh = sharded_pair_scores(algo.tile_scores, half, n, mesh, col_tile=2)
    _check_close("fp16 mesh", outh, out, 5e-3)

    # int8 leaves + per-song @qscale companions (the --stream-int8
    # layout), dequantized on each block's device: equal to a sweep over
    # the same values dequantized on the host (per-song scalars such as
    # the lengths stay exact, as under extract_streamed's threshold)
    qdesc = {}
    for k, v in desc.items():
        if v.dtype == np.float32 and v.ndim > 1:
            qdesc[k], qdesc[k + "@qscale"] = quantize_int8(v)
        else:
            qdesc[k] = v
    deq = {k: (qdesc[k].astype(np.float32) * qdesc[k + "@qscale"].reshape(
        (-1,) + (1,) * (qdesc[k].ndim - 1))) if k + "@qscale" in qdesc
        else v for k, v in qdesc.items() if not k.endswith("@qscale")}
    outq = sharded_pair_scores(algo.tile_scores, qdesc, n, mesh, col_tile=2)
    outd = sharded_pair_scores(algo.tile_scores, deq, n, mesh, col_tile=2)
    _check_close("int8 mesh", outq, outd, 1e-5)

    # the triangular fold (the CLI's path for symmetric algorithms)
    # equals the rectangular sweep on the strict lower triangle, mirrored
    # with a zero diagonal
    outt = sharded_pair_scores_triangular(algo.tile_scores, desc, n,
                                          devices=devices, col_tile=2)
    tril = np.tril_indices(n, k=-1)
    for k, v in outt.items():
        if not (np.array_equal(v[tril], out[k][tril])
                and np.array_equal(v, v.T) and not np.diag(v).any()):
            raise AssertionError(f"triangular fold != rectangular sweep: "
                                 f"{k}")

    # multi-process shard + merge (the CLI's --num-processes / --merge):
    # two shards write partials, merge_partials scatter-adds and mirrors
    with tempfile.TemporaryDirectory() as td:
        paths = [run_process_shard(algo, desc, n, pid, 2, td, tile=2,
                                   device=home) for pid in range(2)]
        outm = merge_partials(paths, symmetric=algo.SYMMETRIC)
    for k, v in outm.items():
        if not np.array_equal(v[tril], out[k][tril]):
            raise AssertionError(f"2-process shard merge != mesh sweep: {k}")

    print(f"dryrun_multichip OK: mesh {mesh.shape} on "
          f"{sorted({str(d) for d in devices})}, {n} songs, "
          f"types={sorted(out)} + sharded==unsharded (exact) + "
          f"earlysnf {sorted(out2)} + fp16/int8 mesh contracts + "
          f"triangular fold + 2-process shard merge", flush=True)
