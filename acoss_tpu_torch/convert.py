"""Descriptor hand-over between the JAX package and the port."""

from __future__ import annotations

import numpy as np
import torch


def descriptors_from_numpy(desc: dict,
                           device: str | torch.device = "cuda") -> dict:
    """Turn a descriptor dict (numpy arrays, or anything `np.asarray`
    accepts, such as the output of the JAX package's
    `Serra09.extract_descriptors`: chroma (N, L, 12) f32, mfcc (N, L, 13)
    f32, gchroma (N, 12) f32, length (N,) i32) into tensors on `device`
    with the same keys and dtypes. Tensors are moved as they are."""
    out = {}
    for k, v in desc.items():
        t = v if isinstance(v, torch.Tensor) else \
            torch.from_numpy(np.ascontiguousarray(np.asarray(v)))
        out[k] = t.to(device)
    return out
