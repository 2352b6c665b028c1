"""Block LOBPCG for the top-k eigenpairs of a symmetric operator given
as a callable (port of JAX's ``jax.experimental.sparse.linalg.lobpcg_standard``).

This is a copy, in PyTorch, of jax 0.9.0's
``jax/experimental/sparse/linalg.py`` (Copyright 2022 The JAX Authors,
Apache License 2.0): ``_lobpcg_standard_callable``, ``_check_inputs``,
``_eigh_ascending``, ``_svqb``, ``_project_out``, ``_orthonormalize``,
``_rayleigh_ritz_orth`` and ``_extend_basis`` (the deterministic block
Householder extension).  tdax's sparse UMAP calls JAX's version on the
operator I + M - 2 v0 v0^T, a sparse matrix plus a dense rank-one term,
so the callable form is needed; ``torch.lobpcg`` takes no callable.

Kept from JAX: the orthonormal [X, P, R] basis with zero columns
allowed, the convergence test (a pair is converged when its residual
norm is below ``tol * 10 * n * (|A x| + theta)``, ``tol`` the f32 eps by
default) and the early stop once all k pairs have converged.  Every
product runs in true f32 (``_mm``'s ``Precision.HIGHEST``: the caller's
``runtime.get_device`` turns TF32 off), and every ``eigh`` symmetrizes
its input first, as ``jnp.linalg.eigh`` does.  The loop condition is
read on the host once an iteration.  Ritz vectors are defined up to
sign.
"""

from __future__ import annotations

from collections.abc import Callable

import torch


def lobpcg_standard(A: Callable[[torch.Tensor], torch.Tensor], X: torch.Tensor, m: int = 100,
                    tol: float | None = None) -> tuple[torch.Tensor, torch.Tensor, int]:
    """Top-k eigenpairs of the symmetric operator ``A`` from the start
    block ``X [n, k]`` (``k * 5 < n``): returns ``(theta [k], X [n, k],
    iterations)``, eigenvalues descending."""
    n, k = X.shape
    _check_inputs(A, X)
    if tol is None:
        tol = float(torch.finfo(X.dtype).eps)

    X = _orthonormalize(X)
    P = _extend_basis(X, X.shape[1])
    AX = A(X)
    theta = (X * AX).sum(0, keepdim=True)
    i, converged = 0, 0
    while i < m and converged < k:
        # the residual basis: R with (X, P) projected out
        R = _project_out(torch.cat((X, P), 1), AX - theta * X)
        XPR = torch.cat((X, P, R), 1)
        theta_all, Q = _rayleigh_ritz_orth(A, XPR)

        B = Q[:, :k]
        B = B / torch.linalg.vector_norm(B, dim=0, keepdim=True)
        X = XPR @ B
        X = X / torch.linalg.vector_norm(X, dim=0, keepdim=True)

        # the difference directions: [0; Q[k:, :k]] orthogonalized against
        # Q[:, :k] in the standard basis, mapped through XPR (orthonormal)
        q, _ = torch.linalg.qr(Q[:k, k:].T)
        P = XPR @ (Q[:, k:] @ q)
        norm_p = torch.linalg.vector_norm(P, dim=0, keepdim=True)
        P = P / torch.where(norm_p == 0, 1.0, norm_p)

        AX = A(X)
        theta = theta_all[None, :k]
        resid_norms = torch.linalg.vector_norm(AX - theta * X, dim=0)
        reltol = (torch.linalg.vector_norm(AX, dim=0) + theta_all[:k]) * n * 10
        converged = int((resid_norms < tol * reltol).sum())
        i += 1
    return theta[0], X, i


def _check_inputs(A, X: torch.Tensor) -> None:
    n, k = X.shape
    if k == 0:
        raise ValueError(f"must have search dim > 0, got {k}")
    if k * 5 >= n:
        raise ValueError(f"expected search dim * 5 < matrix dim (got {k * 5}, {n})")
    out = A(torch.zeros((n, 1), dtype=X.dtype, device=X.device))
    if out.dtype != X.dtype:
        raise ValueError(f"A, X must have same dtypes (were {out.dtype}, {X.dtype})")
    if tuple(out.shape) != (n, 1):
        raise ValueError(f"A must be ({n}, {n}) matrix A, got output {tuple(out.shape)}")


def _eigh_ascending(a: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """JAX's ``_eigh_ascending``, whose name belies it: eigenvalues (and
    vectors) in DESCENDING order."""
    w, v = torch.linalg.eigh((a + a.T) / 2)
    return w.flip(0), v.flip(1)


def _svqb(X: torch.Tensor) -> torch.Tensor:
    """A truncated orthonormal basis for X [n, k] (SVQB): the eigenbasis
    of the normalized X^T X, near-degenerate directions zeroed."""
    norms = torch.linalg.vector_norm(X, dim=0, keepdim=True)
    X = X / torch.where(norms == 0, 1.0, norms)
    inner = X.T @ X
    w, V = _eigh_ascending(inner)
    tau = torch.finfo(X.dtype).eps * w[0]
    padded = torch.maximum(w, tau)
    sqrted = torch.where(tau > 0, padded, 1.0) ** -0.5
    ortho = X @ (V * sqrted[None, :])
    keep = ((w > tau) & (torch.diagonal(inner) > 0.0))[None, :]
    ortho = ortho * keep.to(ortho.dtype)
    norms = torch.linalg.vector_norm(ortho, dim=0, keepdim=True)
    keep = keep & (norms > 0.0)
    return ortho / torch.where(keep, norms, 1.0)


def _project_out(basis: torch.Tensor, U: torch.Tensor) -> torch.Tensor:
    """U's component in the orthogonal complement of the orthonormal
    ``basis`` (zero columns allowed): twice subtract and orthonormalize,
    twice subtract again, and zero every column whose norm fell below
    0.99, so [basis, U] stays zero-or-orthonormal."""
    for _ in range(2):
        U = U - basis @ (basis.T @ U)
        U = _orthonormalize(U)
    for _ in range(2):
        U = U - basis @ (basis.T @ U)
    norm_u = torch.linalg.vector_norm(U, dim=0, keepdim=True)
    return U * (norm_u >= 0.99).to(U.dtype)


def _orthonormalize(basis: torch.Tensor) -> torch.Tensor:
    for _ in range(2):  # twice is enough
        basis = _svqb(basis)
    return basis


def _rayleigh_ritz_orth(A, S: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Eigenpairs (descending) of A projected onto the orthonormal S."""
    return _eigh_ascending(S.T @ A(S))


def _extend_basis(X: torch.Tensor, m: int) -> torch.Tensor:
    """m more orthonormal directions beside the orthonormal X [n, k], by
    a block Householder reflector: H(w) = I - 2 w w^T maps [0; I_m; 0]
    to the extension."""
    n, k = X.shape
    x_upper, x_lower = X[:k], X[k:]
    u, s, vt = torch.linalg.svd(x_upper)
    y = torch.cat([x_upper + u @ vt, x_lower], 0)
    w = y @ (vt.T * ((2 * (1 + s)) ** -0.5)[None, :])
    # -2 w w[k:]^T [I_m; 0], product order as jnp.linalg.multi_dot picks it
    h = -2 * (w @ w[k:k + m].T)
    h[k:k + m] += torch.eye(m, dtype=X.dtype, device=X.device)
    return h
