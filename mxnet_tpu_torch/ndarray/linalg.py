"""``mx.nd.linalg_*``: the linear-algebra ops.

Counterpart of ``mxnet_tpu/ndarray/linalg.py`` (reference: MXNet's
``src/operator/tensor/la_op.cc``).  Every op takes batched ``(..., m,
n)`` stacks, runs through ``ndarray.apply`` (so ``autograd.record()``
builds its graph) and takes its gradient from ``torch.linalg``'s
autograd.  The factorizations are LAPACK's on the CPU and cuSOLVER's on
the card, as XLA's were the reference's: plain PyTorch, no kernel of the
port.  ``syevd``'s eigenvectors and ``gelqf``'s factors carry the sign
choices of the library that computed them; no sign is normalized here,
as none is in the reference.

The family is exported flat (``nd.linalg_potrf``) and by its short name
in this module (``nd.linalg.potrf``, ``nd.linalg.gemm2``), as the
reference exports it.
"""
from __future__ import annotations

import math

import torch

from .ndarray import apply
from .ops import host_sync, linalg_gemm2  # noqa: F401 (``gemm2``)

__all__ = []


def _register(fn):
    __all__.append(fn.__name__)
    return fn


@_register
def linalg_gemm(A, B, C, transpose_a=False, transpose_b=False, alpha=1.0,
                beta=1.0, axis=-2):
    """``alpha op(A) op(B) + beta C``; ``axis`` names the matrices' row
    axis (-2 by default)."""
    def fn(a, b, c):
        if axis != -2:
            a, b, c = (torch.movedim(x, axis, -2) for x in (a, b, c))
        if transpose_a:
            a = a.transpose(-1, -2)
        if transpose_b:
            b = b.transpose(-1, -2)
        r = alpha * torch.matmul(a, b) + beta * c
        return torch.movedim(r, -2, axis) if axis != -2 else r
    return apply(fn, [A, B, C])


@_register
def linalg_potrf(A):
    """The lower Cholesky factor ``L`` of ``A = L L^T``; a NaN lower
    triangle for a matrix that is not positive definite, as
    ``jnp.linalg.cholesky`` gives.  ``cholesky_ex`` reads no error flag
    back to the host, so a CUDA graph capture holds it."""
    def fn(a):
        low, info = torch.linalg.cholesky_ex(a)
        return torch.where((info != 0)[..., None, None],
                           torch.full_like(low, math.nan).tril(), low)
    return apply(fn, [A])


@_register
def linalg_potri(A):
    """``(A A^T)^-1`` from the Cholesky factor ``A``."""
    def fn(l):
        eye = torch.eye(l.shape[-1], dtype=l.dtype,
                        device=l.device).expand(l.shape)
        linv = torch.linalg.solve_triangular(l, eye, upper=False)
        return linv.transpose(-1, -2) @ linv
    return apply(fn, [A])


@_register
def linalg_trsm(A, B, transpose=False, rightside=False, lower=True,
                alpha=1.0):
    """``X`` of ``op(A) X = alpha B`` (``rightside``: ``X op(A) = alpha
    B``) for the triangle of ``A`` that ``lower`` names."""
    def fn(a, b):
        # the transpose of a lower triangle is an upper one
        upper = lower if transpose else not lower
        t = a.transpose(-1, -2) if transpose else a
        return torch.linalg.solve_triangular(t, alpha * b, upper=upper,
                                             left=not rightside)
    return apply(fn, [A, B])


@_register
def linalg_trmm(A, B, transpose=False, rightside=False, lower=True,
                alpha=1.0):
    """``alpha op(tri(A)) B`` (``rightside``: ``alpha B op(tri(A))``)."""
    def fn(a, b):
        t = torch.tril(a) if lower else torch.triu(a)
        if transpose:
            t = t.transpose(-1, -2)
        return alpha * (torch.matmul(b, t) if rightside
                        else torch.matmul(t, b))
    return apply(fn, [A, B])


@_register
def linalg_syrk(A, transpose=False, alpha=1.0):
    """``alpha A A^T`` (``transpose``: ``alpha A^T A``)."""
    def fn(a):
        at = a.transpose(-1, -2)
        return alpha * (torch.matmul(at, a) if transpose
                        else torch.matmul(a, at))
    return apply(fn, [A])


@_register
def linalg_sumlogdiag(A):
    """``sum(log(diag(A)))`` of each matrix."""
    return apply(lambda a: torch.sum(torch.log(torch.diagonal(
        a, dim1=-2, dim2=-1)), -1), [A])


@_register
def linalg_extractdiag(A, offset=0):
    return apply(lambda a: torch.diagonal(a, offset, -2, -1), [A])


@_register
def linalg_makediag(A, offset=0):
    """Vectors to diagonal (``offset``: off-diagonal) matrices."""
    return apply(lambda a: torch.diag_embed(a, offset, -2, -1), [A])


def _trian_indices(n, offset, lower, device):
    """The (rows, columns) of the triangle of the ``n - |offset|``
    matrix shifted by ``offset``: ``q (q + 1) / 2`` entries, row-major
    (the reference's, not numpy's ``tril_indices(k=offset)``), made on
    ``device``."""
    q = n - abs(offset)
    ri, ci = (torch.tril_indices if lower else torch.triu_indices)(
        q, q, device=device)
    return (ri, ci + offset) if offset >= 0 else (ri - offset, ci)


@_register
def linalg_extracttrian(A, offset=0, lower=True):
    """Each matrix's (shifted) triangle as a vector."""
    def fn(a):
        rows, cols = _trian_indices(a.shape[-1], offset, lower, a.device)
        return a[..., rows, cols]
    return apply(fn, [A])


@_register
def linalg_maketrian(A, offset=0, lower=True):
    """The inverse of :func:`linalg_extracttrian`: vectors of ``q (q +
    1) / 2`` entries to ``q + |offset|`` matrices."""
    def fn(a):
        q = (math.isqrt(8 * a.shape[-1] + 1) - 1) // 2
        n = q + abs(offset)
        rows, cols = _trian_indices(n, offset, lower, a.device)
        out = torch.zeros(a.shape[:-1] + (n, n), dtype=a.dtype,
                          device=a.device)
        out[..., rows, cols] = a
        return out
    return apply(fn, [A])


@_register
def linalg_gelqf(A):
    """The LQ factorization ``A = L Q`` (``Q``'s rows orthonormal), from
    the QR factorization of ``A^T``: ``(L, Q)``."""
    def fn(a):
        q, r = torch.linalg.qr(a.transpose(-1, -2))
        return r.transpose(-1, -2), q.transpose(-1, -2)
    return apply(fn, [A], n_out=2)


@_register
def linalg_syevd(A):
    """The symmetric eigendecomposition ``A = U^T diag(L) U``: ``(U,
    L)``, the eigenvectors as ``U``'s rows, the eigenvalues ascending.

    A float32 stack is decomposed in float64 and the factors rounded
    back: on an H100, cuSOLVER's float32 ``eigh`` leaves eigenvalues
    9e-5 and reconstructions 1.8e-4 relative off on (64, 256, 256) SPD
    matrices, where LAPACK's float32 and cuSOLVER's float64 rounded to
    float32 stay near 1e-6 or below (``tools/port_eigh_accuracy.py``).
    The CPU takes the same path, so both devices compute alike.

    cuSOLVER's ``syevd`` works through a host buffer and torch reads its
    convergence flag back, so inside a CUDA graph capture this raises
    ``MXNetError`` naming itself (the reference runs it under ``jit``;
    ROADMAP §3)."""
    host_sync("linalg_syevd")

    def fn(a):
        if a.dtype != torch.float32:
            w, v = torch.linalg.eigh(a)
        else:
            w, v = (t.float() for t in torch.linalg.eigh(a.double()))
        return v.transpose(-1, -2), w
    return apply(fn, [A], n_out=2)


@_register
def linalg_inverse(A):
    """``A^-1``.  ``inv_ex`` reads no error flag back to the host, so a
    CUDA graph capture holds it, and a singular matrix raises nothing,
    as in the reference."""
    return apply(lambda a: torch.linalg.inv_ex(a)[0], [A])


@_register
def linalg_det(A):
    return apply(torch.linalg.det, [A])


@_register
def linalg_slogdet(A):
    """``(sign, log|det|)``."""
    return apply(lambda a: tuple(torch.linalg.slogdet(a)), [A], n_out=2)


# the short names (``nd.linalg.potrf``), ``gemm2`` among them
for _n in list(globals()):
    if _n.startswith("linalg_"):
        globals()[_n[len("linalg_"):]] = globals()[_n]
del _n
