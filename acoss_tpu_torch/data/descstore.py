"""Disk-backed descriptor store for Da-TACOS-scale sweeps (port of
`acoss_tpu.data.descstore`; everything but `upcast_stream` is the same
numpy code).

Every descriptor key is ONE on-disk `.npy` memmap with leading dim N,
written chunk by chunk at extraction time and sliced tile by tile during
the sweep, so host memory holds only the active tile rows. The on-disk
format (one `<key>.npy` per key plus `descstore.json`) is the JAX
package's, so a store written by either package opens in the other.

Quantized stores ('half': float16 leaves; 'int8': int8 leaves with a
per-song `<key>@qscale` float32 companion) shrink the disk store, the
host->device tile traffic and the device corpus; the sweeps restore fp32
on the device with `upcast_stream` before any compute.
"""

from __future__ import annotations

import json
import os
import shutil
import sys

import numpy as np
import torch

from acoss_tpu_torch.utils.profiling import stages


class DescriptorStore:
    """Directory of per-key `.npy` memmaps with leading dimension N."""

    META = "descstore.json"

    def __init__(self, path: str, n_songs: int):
        self.path = path
        self.n_songs = n_songs
        self._maps: dict = {}
        os.makedirs(path, exist_ok=True)

    # -- writing ----------------------------------------------------------
    def ensure(self, key: str, tail_shape: tuple, dtype) -> np.memmap:
        """Create (or open for writing) the memmap behind `key`."""
        if key not in self._maps:
            fn = os.path.join(self.path, f"{key}.npy")
            if os.path.exists(fn):
                self._maps[key] = np.lib.format.open_memmap(fn, mode="r+")
            else:
                self._maps[key] = np.lib.format.open_memmap(
                    fn, mode="w+", dtype=np.dtype(dtype),
                    shape=(self.n_songs,) + tuple(tail_shape))
        return self._maps[key]

    def write(self, key: str, start: int, values: np.ndarray) -> None:
        """Write rows [start, start + len(values)) of `key`, padding the
        trailing axes up to the store's width."""
        m = self.ensure(key, values.shape[1:], values.dtype)
        if values.shape[1:] != m.shape[1:]:
            pad = [(0, 0)] + [(0, t - s) for s, t in
                              zip(values.shape[1:], m.shape[1:])]
            if any(p[1] < 0 for p in pad):
                raise ValueError(
                    f"{key}: chunk wider than store "
                    f"{values.shape[1:]} > {m.shape[1:]}")
            values = np.pad(values, pad)
        m[start:start + len(values)] = values

    def flush(self) -> None:
        for m in self._maps.values():
            m.flush()
        meta = {"n_songs": self.n_songs,
                "keys": sorted(os.path.splitext(f)[0]
                               for f in os.listdir(self.path)
                               if f.endswith(".npy"))}
        with open(os.path.join(self.path, self.META), "w") as f:
            json.dump(meta, f)

    # -- reading ----------------------------------------------------------
    @classmethod
    def open(cls, path: str) -> dict:
        """Read-only descriptor dict of memmaps (drop-in for the in-RAM
        desc dict: the sweeps slice it per tile)."""
        with open(os.path.join(path, cls.META)) as f:
            meta = json.load(f)
        return {k: np.load(os.path.join(path, f"{k}.npy"), mmap_mode="r")
                for k in meta["keys"]}

    def delete(self) -> None:
        self._maps.clear()
        shutil.rmtree(self.path, ignore_errors=True)


QSCALE = "@qscale"      # companion-leaf suffix for int8 quantization


def quantize_int8(v: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """Per-song symmetric int8 quantization: (int8 values, float32
    scale of shape (n_songs,)) with v ~= int8 * scale[:, None, ...].
    All-zero songs get scale 1 so the dequant stays exact zeros."""
    v = np.asarray(v, dtype=np.float32)
    amax = np.abs(v).reshape(v.shape[0], -1).max(axis=1)
    scale = np.where(amax > 0, amax / 127.0, 1.0).astype(np.float32)
    q = np.round(v / scale.reshape((-1,) + (1,) * (v.ndim - 1)))
    return np.clip(q, -127, 127).astype(np.int8), scale


def upcast_stream(d: dict) -> dict:
    """Restore float32 descriptor tensors on their device: float16 and
    bfloat16 leaves are converted, an int8 leaf with a `<key>@qscale`
    companion becomes int8 * scale (ONE fp32 multiply, the JAX package's
    arithmetic, so the dequantized values are bit-equal to its). The
    companions are consumed (dropped from the returned dict); every other
    leaf passes through."""
    out = {}
    with stages.stage("store:upcast"):
        for k, v in d.items():
            if k.endswith(QSCALE):
                continue
            if v.dtype in (torch.float16, torch.bfloat16):
                v = v.float()
            elif v.dtype == torch.int8 and k + QSCALE in d:
                s = d[k + QSCALE].float()
                v = v.float() * s.view(s.shape + (1,) * (v.ndim - s.ndim))
            out[k] = v
    return out


def store_quant(desc: dict) -> str | None:
    """The quantization mode a store was written with: 'int8' if any
    leaf has a `@qscale` companion, 'half' if any leaf is float16,
    else None."""
    if any(k.endswith(QSCALE) for k in desc):
        return "int8"
    if any(getattr(v, "dtype", None) == np.float16
           for v in desc.values()):
        return "half"
    return None


def check_stream_consistency(desc: dict, quant: str | None,
                             path: str) -> None:
    """A REUSED store must match the requested precision mode: feeding a
    quantized store to a higher-precision run silently breaks the
    precision the caller asked for, so that direction raises; the reverse
    only forfeits the throughput win and just notes it."""
    rank = {None: 0, "half": 1, "int8": 2}
    have = store_quant(desc)
    if rank[have] > rank[quant]:
        raise ValueError(
            f"{path} holds {have}-quantized descriptors but a "
            f"{quant or 'full'}-precision run was requested; delete the "
            f"store or request --stream-{have}")
    if rank[have] < rank[quant]:
        print(f"note: {quant} precision requested but {path} is "
              f"{have or 'full'} precision; reusing it as-is",
              file=sys.stderr)


def extract_streamed(algorithm, fs, store_path: str,
                     chunk_songs: int = 256, verbose: bool = False,
                     half_min_bytes: int = 65536,
                     quant: str | None = None,
                     device: str | torch.device = "cuda") -> dict:
    """Chunked descriptor extraction into a DescriptorStore.

    Each chunk of songs is extracted with the algorithm's ordinary
    `extract_descriptors(..., device=device)` on a FeatureSet subset
    (anything with `n_songs` and `subset(idx)`, such as a
    `LazySyntheticCorpus`); descriptors it returns as tensors come back to
    the host. Chunk-local padded widths differ, so chunks are staged to
    temporary files on the first pass (tracking per-key maximum widths),
    then copied into the final fixed-width memmaps. Peak host memory is
    one chunk's descriptors. Returns the read-only descriptor dict.

    `quant` ('half' or 'int8') stores the float32 descriptors whose
    per-song slice is at least `half_min_bytes` (decided on the first
    chunk) compressed; small keys (lengths, global chroma) stay exact.
    A throughput mode: full-precision parity runs leave it off.
    """
    if quant not in (None, "half", "int8"):
        raise ValueError(f"unknown quant mode {quant!r}")
    n = fs.n_songs
    # the store is always built from scratch (there is no chunk-level
    # resume): debris of an interrupted run has stale widths / dtypes that
    # ensure() would reopen. Callers that want reuse check for META and
    # DescriptorStore.open() instead.
    if os.path.isdir(store_path):
        for fn in os.listdir(store_path):
            if fn.endswith(".npy") or fn == DescriptorStore.META:
                os.remove(os.path.join(store_path, fn))
    tmp_dir = store_path + ".chunks"
    os.makedirs(tmp_dir, exist_ok=True)
    widths: dict = {}
    dtypes: dict = {}
    quant_keys: set = set()
    starts = list(range(0, n, chunk_songs))
    for ci, lo in enumerate(starts):
        hi = min(lo + chunk_songs, n)
        desc = algorithm.extract_descriptors(fs.subset(np.arange(lo, hi)),
                                             device=device)
        payload = {}
        for k, v in desc.items():
            v = v.cpu().numpy() if isinstance(v, torch.Tensor) \
                else np.asarray(v)
            if v.dtype == object or v.ndim == 0 or v.shape[0] != hi - lo:
                raise ValueError(
                    f"algorithm {type(algorithm).__name__} does not "
                    f"support streamed extraction: descriptor {k!r} is "
                    f"not a fixed-rank array with leading dim n_songs "
                    f"(got dtype={v.dtype}, shape={v.shape})")
            # the quantized-key set is decided ONCE, on the first chunk, so
            # a near-threshold key is never compressed in some chunks and
            # fp32 in others
            if (quant and ci == 0 and v.dtype == np.float32
                    and v[:1].nbytes >= half_min_bytes):
                quant_keys.add(k)
            if k in quant_keys and v.dtype == np.float32:
                if quant == "int8":
                    v, payload[k + QSCALE] = quantize_int8(v)
                else:
                    v = v.astype(np.float16)
            payload[k] = v
        for k, v in payload.items():   # incl. @qscale companions
            prev = widths.get(k)
            widths[k] = (v.shape[1:] if prev is None else
                         tuple(max(a, b)
                               for a, b in zip(prev, v.shape[1:])))
            dtypes[k] = v.dtype
        np.savez(os.path.join(tmp_dir, f"chunk_{ci}.npz"), **payload)
        if verbose:
            print(f"[extract_streamed] chunk {ci + 1}/{len(starts)} "
                  f"({hi}/{n} songs)", flush=True)
    store = DescriptorStore(store_path, n)
    for k in widths:
        store.ensure(k, widths[k], dtypes[k])
    for ci, lo in enumerate(starts):
        fn = os.path.join(tmp_dir, f"chunk_{ci}.npz")
        with np.load(fn) as z:
            for k in z.files:
                store.write(k, lo, z[k])
        # each staged chunk goes as soon as it lands in the memmaps:
        # transient disk stays ~one chunk above the store's final size
        os.remove(fn)
    store.flush()
    shutil.rmtree(tmp_dir, ignore_errors=True)
    return DescriptorStore.open(store_path)
