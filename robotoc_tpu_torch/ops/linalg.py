"""Small dense linear algebra for batched tiny matrices.

Counterpart of robotoc_tpu/ops/linalg.py. All functions act on the
trailing two dims and broadcast over leading batch dims; none writes into
its input, so they run under torch.func.vmap/jacfwd.
"""
from __future__ import annotations

import torch


def _set_row(A, k, row):
    """A with row k replaced (functional)."""
    return torch.cat([A[..., :k, :], row.unsqueeze(-2), A[..., k + 1:, :]],
                     dim=-2)


def _set_col(A, k, col):
    return torch.cat([A[..., :, :k], col.unsqueeze(-1), A[..., :, k + 1:]],
                     dim=-1)


def gauss_jordan_inverse(A):
    """Inverse by Gauss-Jordan elimination WITHOUT pivoting (valid when
    every leading principal minor is nonsingular: SPD matrices and the
    symmetric quasi-definite contact KKT block). One rank-1 sweep per
    pivot, then row k <- row/p, col k <- -col/p, pivot <- 1/p."""
    n = A.shape[-1]
    for k in range(n):
        p = A[..., k, k]
        row = A[..., k, :] / p.unsqueeze(-1)
        col = A[..., :, k]
        A = A - col.unsqueeze(-1) * row.unsqueeze(-2)
        rinv = (1.0 / p).unsqueeze(-1)
        A = _set_row(A, k, torch.cat([row[..., :k], rinv, row[..., k + 1:]],
                                     dim=-1))
        ncol = -col / p.unsqueeze(-1)
        A = _set_col(A, k, torch.cat([ncol[..., :k], rinv,
                                      ncol[..., k + 1:]], dim=-1))
    return A


def spd_inverse(A):
    """Inverse of a small SPD matrix (unpivoted GJ + symmetrization)."""
    Ai = gauss_jordan_inverse(A)
    return 0.5 * (Ai + Ai.transpose(-1, -2))


def spd_solve(A, rhs):
    """Solve A x = rhs for small SPD A via the explicit GJ inverse.
    rhs: (..., n) or (..., n, m)."""
    Ai = spd_inverse(A)
    if rhs.dim() == A.dim() - 1:
        return (Ai @ rhs.unsqueeze(-1)).squeeze(-1)
    return Ai @ rhs


def pivoted_gauss_jordan_inverse(A):
    """Inverse of a small (..., n, n) matrix by Gauss-Jordan WITH partial
    pivoting. Row swaps are `where` selections on the argmax row, so the
    function has no data-dependent Python branch and runs under vmap."""
    n = A.shape[-1]
    eye = torch.eye(n, dtype=A.dtype, device=A.device)
    Aug = torch.cat([A, eye.expand(A.shape[:-2] + (n, n))], dim=-1)
    rows = torch.arange(n, device=A.device)
    for k in range(n):
        p = torch.argmax(Aug[..., k:, k].abs(), dim=-1) + k       # (...)
        rp = torch.take_along_dim(
            Aug, p[..., None, None].expand(p.shape + (1, 2 * n)), dim=-2)
        rk = Aug[..., k:k + 1, :]
        is_k = (rows == k).unsqueeze(-1)                          # (n, 1)
        is_p = (rows == p.unsqueeze(-1)).unsqueeze(-1)            # (..., n, 1)
        Aug = torch.where(is_p, rk, Aug)
        Aug = torch.where(is_k, rp, Aug)
        row = Aug[..., k, :] / Aug[..., k, k].unsqueeze(-1)
        Aug = Aug - Aug[..., :, k:k + 1] * row.unsqueeze(-2)
        Aug = _set_row(Aug, k, row)
    return Aug[..., :, n:]
