"""Linear solves with the reference's rule for a singular system.

``jnp.linalg.solve`` / ``inv`` / ``cholesky`` return non-finite values
where a factorization fails, and the reference carries on with them;
``torch.linalg.solve`` / ``inv`` raise for the whole batch (and
synchronize the card to find out).  These helpers run the same
factorization through the ``*_ex`` forms, which neither raise nor sync,
and fill every batch element whose factorization failed with NaN.  On a
non-singular input they return exactly what the raising forms return.
"""

import torch


def _nan_where(info, a):
    """``a`` with the batch elements whose ``info`` is nonzero set to NaN."""
    bad = (info != 0).reshape(info.shape + (1,) * (a.dim() - info.dim()))
    return torch.where(bad, torch.full_like(a, float("nan")), a)


def cholesky_nan(A):
    """Lower Cholesky factor; NaN where the factorization fails (as
    jnp.linalg.cholesky), batched over leading axes."""
    L, info = torch.linalg.cholesky_ex(A)
    return _nan_where(info, L)


def inv_nan(A):
    """A^-1; NaN where A is singular (jnp.linalg.inv gives inf / nan)."""
    Ai, info = torch.linalg.inv_ex(A)
    return _nan_where(info, Ai)


def solve_nan(A, b):
    """A^-1 b; NaN where A is singular (as jnp.linalg.solve)."""
    x, info = torch.linalg.solve_ex(A, b)
    return _nan_where(info, x)


def svd_nan(A):
    """torch.linalg.svd; NaN factors for the batch elements of ``A`` that
    hold a non-finite value, as jnp.linalg.svd returns, where
    torch.linalg.svd raises.  Reached by a NaN from the helpers above."""
    bad = ~torch.isfinite(A).all(dim=-1).all(dim=-1)
    U, S, Vh = torch.linalg.svd(torch.where(bad[..., None, None],
                                            torch.zeros_like(A), A))
    return _nan_where(bad, U), _nan_where(bad, S), _nan_where(bad, Vh)
