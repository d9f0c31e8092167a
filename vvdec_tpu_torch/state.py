"""Per-frame state carried between the JAX reference and the port.

A decoder has no weights.  What the two packages exchange, in the stage
tests and when a frame is handed over, is per-frame state: padded recon
and residual planes, the [S, K, 33] intra descriptor batches, the packed
int16 filter parameter vector and the device DPB planes.  These two
functions are the only conversion points; dtypes are kept as they are.
"""

from __future__ import annotations

import numpy as np
import torch


def to_torch(x, device):
    """numpy arrays (or anything np.asarray accepts, e.g. JAX arrays) ->
    torch tensors on `device`, which the caller names ("cuda" or "cpu");
    lists and tuples are converted item by item, None passes through."""
    if x is None:
        return None
    if isinstance(x, (list, tuple)):
        return type(x)(to_torch(v, device) for v in x)
    a = np.ascontiguousarray(np.asarray(x))
    return torch.from_numpy(a.copy()).to(device)


def to_numpy(x):
    """torch tensors (on any device) -> numpy arrays; lists and tuples
    are converted item by item, None passes through."""
    if x is None:
        return None
    if isinstance(x, (list, tuple)):
        return type(x)(to_numpy(v) for v in x)
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)
