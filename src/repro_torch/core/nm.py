"""N:M balanced-sparsity weight format (nmSPARSE-style condensed planes),
mirroring ``src/repro/core/nm.py``.

A weight W (d_in, d_out) is *N:M balanced along the reduction dimension*
when every M consecutive entries of each column hold at most N non-zeros.
The condensed storage keeps, per window and column, exactly N slots:

  * ``val`` (R, d_out) — dense value planes, R = d_in · N / M rows
  * ``off`` (R, d_out) — the within-window offset of each kept value, int8

Row r of the planes belongs to window ``r // N``; the original row of
``val[r, j]`` is ``(r // N) · M + off[r, j]``. Windows with fewer than N
non-zeros pad with val = 0 and a distinct unused offset, so offsets stay a
partial permutation of the window. That balance is what lets
``kernels/nm_spmm.py`` give every thread the same work.

``detect_nm`` is the planner-facing check (``plan.planner.plan_spmm_format``).
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Sequence, Tuple

import torch

# candidate windows probed by auto-detection, most structured first
NM_CANDIDATES: Tuple[Tuple[int, int], ...] = ((1, 4), (2, 4), (2, 8), (4, 8))


@dataclasses.dataclass(frozen=True)
class NmWeights:
    """Condensed N:M weight (right operand of x @ W). val/off: (R, d_out)."""

    val: torch.Tensor  # (R, d_out) float, condensed value planes
    off: torch.Tensor  # (R, d_out) int8, within-window offsets in [0, m)
    n: int
    m: int
    d_in: int          # logical reduction dim (= R * m / n)

    @property
    def d_out(self) -> int:
        return self.val.shape[1]

    @property
    def r(self) -> int:
        return self.val.shape[0]

    @property
    def windows(self) -> int:
        return self.d_in // self.m

    def to_dense(self) -> torch.Tensor:
        """Scatter back to (d_in, d_out). Oracle/debug only."""
        r, d_out = self.val.shape
        dev = self.val.device
        win = torch.arange(r, device=dev) // self.n
        rows = win[:, None] * self.m + self.off.long()
        cols = torch.arange(d_out, device=dev).expand(r, d_out)
        dense = torch.zeros((self.d_in, d_out), dtype=self.val.dtype,
                            device=dev)
        # offsets are distinct per (window, col); pad slots add 0
        return dense.index_put_((rows.reshape(-1), cols.reshape(-1)),
                                self.val.reshape(-1), accumulate=True)


def nm_from_dense(w: torch.Tensor, n: int, m: int) -> NmWeights:
    """Condense a dense (d_in, d_out) N:M-balanced weight, on its device.

    Raises if some window holds more than N non-zeros (the pattern is not
    N:M — prune first with models.sparse.magnitude_prune_nm).
    """
    d_in, d_out = w.shape
    if d_in % m:
        raise ValueError(f"d_in={d_in} not a multiple of M={m}")
    ww = w.reshape(d_in // m, m, d_out)
    top = int((ww != 0).sum(dim=1).max()) if ww.numel() else 0
    if top > n:
        raise ValueError(
            f"pattern is not {n}:{m} balanced (window with {top} non-zeros)")
    # a stable argsort pushes zeros last: the first N offsets per window are
    # the non-zeros (in original order), the rest point at zero slots — a
    # partial permutation, so gathering values pads with exact 0s
    order = torch.argsort((ww == 0).to(torch.int8), dim=1,
                          stable=True)[:, :n, :]
    vals = torch.take_along_dim(ww, order, dim=1)
    return NmWeights(val=vals.reshape(-1, d_out),
                     off=order.to(torch.int8).reshape(-1, d_out),
                     n=n, m=m, d_in=d_in)


def is_nm_balanced(w: torch.Tensor, n: int, m: int) -> bool:
    """True iff every M-window of every column has ≤ N non-zeros."""
    d_in = w.shape[0]
    if d_in % m:
        return False
    counts = (w.reshape(d_in // m, m, -1) != 0).sum(dim=1)
    return bool(counts.max() <= n) if counts.numel() else True


def detect_nm(w: torch.Tensor,
              candidates: Sequence[Tuple[int, int]] = NM_CANDIDATES,
              ) -> Optional[Tuple[int, int]]:
    """First candidate (N, M) the pattern satisfies, or None.

    Candidates are probed in order (most structured first) and only count
    when N < M — an N:N window is dense and buys nothing. A dense weight
    matches no candidate, so callers fall back to ELLPACK.
    """
    for n, m in candidates:
        if n < m and is_nm_balanced(w, n, m):
            return (n, m)
    return None
