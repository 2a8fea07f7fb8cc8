"""The operands' sparsity fingerprint, mirroring ``fingerprint`` of
``src/repro/plan/structure.py``.

A hash over the ELLPACK *index* planes, the logical shapes and the value
dtypes (values excluded): two operand pairs share a fingerprint iff they
have the same sparsity pattern in the same slots and the same value dtypes,
the condition under which a ``Plan`` sized for one fits the other. It hashes
the same numpy int32 bytes, shape reprs and ``dtype.str``s as the reference,
so a fingerprint, and the ``Plan.fp`` it stamps, is equal across the two
packages.
"""
from __future__ import annotations

import hashlib

import numpy as np
import torch

from ..core.formats import EllCols, EllRows


def _dtype_str(dtype: torch.dtype) -> str:
    return torch.empty(0, dtype=dtype).numpy().dtype.str


def fingerprint(a: EllRows, b: EllCols) -> str:
    """Sparsity fingerprint of an operand pair (sha1 hex digest)."""
    h = hashlib.sha1()
    for idx, logical in ((a.idx, a.n_rows), (b.idx, b.n_cols)):
        arr = np.ascontiguousarray(idx.cpu().numpy())
        h.update(repr((arr.shape, int(logical), arr.dtype.str)).encode())
        h.update(arr.tobytes())
    h.update(repr((_dtype_str(a.val.dtype), _dtype_str(b.val.dtype))).encode())
    return h.hexdigest()
