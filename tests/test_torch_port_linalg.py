"""``nd.linalg_*`` and ``nd.linalg.<short>`` against ``mxnet_tpu.nd``'s,
on the CPU, through the op harness of ``test_torch_port_ops_tail``
(outputs, dtypes and the gradients of the listed inputs for a random
head).  Every case is a batch of two small, well-conditioned matrices:
SPD ones are ``B B^T + n I``.  Tolerances:

- exact for the diagonal and triangle copies (``extractdiag``,
  ``makediag``, ``extracttrian``, ``maketrian``);
- 1e-5 relative (``F32``) for the products (``gemm``, ``gemm2``,
  ``trmm``, ``syrk``);
- 1e-4 relative (``FACT``) for the factorizations, solves, inverses and
  determinants and their gradients: LAPACK's blocked algorithms in
  torch and XLA round in different orders.

``syevd``'s eigenvectors and ``gelqf``'s factors carry the sign choices
of the library that computed them.  ``gelqf``'s come out as the
reference's on the CPU and are held as they come; ``syevd``'s differ in
the sign of some rows (a standing difference, ROADMAP §3), so they are
held up to each row's sign.  Both are held by their reconstruction, and
their gradients through sign-invariant functions of the factors.
"""
import numpy as np
import pytest

import mxnet_tpu as jmx

import mxnet_tpu_torch as mx
from test_torch_port_ops_tail import EXACT, F32, _check, _f

FACT = 1e-4
RNG = np.random.RandomState(31)
N = 4


def _spd(seed, n=N, batch=2):
    b = np.random.RandomState(seed).randn(batch, n, n)
    return (b @ b.transpose(0, 2, 1) + n * np.eye(n)).astype(np.float32)


def _lower(seed, n=N):
    return np.linalg.cholesky(_spd(seed, n)).astype(np.float32)


M = RNG.randn(2, N, N).astype(np.float32)
M2 = RNG.randn(2, N, 3).astype(np.float32)
WIDE = RNG.randn(2, 3, 5).astype(np.float32)
SPD, L = _spd(1), _lower(2)
VEC = RNG.randn(2, 6).astype(np.float32)

CASES = {}


def case(cid, call, inputs, grads=(), tol=FACT):
    CASES[cid] = (call, inputs, grads, tol)


case("gemm", _f("linalg_gemm", alpha=0.5, beta=2.0), [M, M2, M2], (0, 1, 2),
     F32)
case("gemm-transposes", _f("linalg_gemm", transpose_a=True,
                           transpose_b=True), [M, WIDE[:, :, :4],
                                               RNG.randn(2, N, 3).astype(
                                                   np.float32)],
     (0, 1, 2), F32)
case("gemm-axis", _f("linalg_gemm", axis=0),
     [M.transpose(1, 0, 2).copy(), M2.transpose(1, 0, 2).copy(),
      M2.transpose(1, 0, 2).copy()], (0, 1), F32)
case("gemm2-short", lambda F, a, b: F.linalg.gemm2(a, b, alpha=3.0),
     [M, M2], (0, 1), F32)
case("potrf", _f("linalg_potrf"), [SPD], (0,))
case("potri", _f("linalg_potri"), [L], (0,))
for kw in ({}, {"transpose": True}, {"rightside": True},
           {"lower": False, "alpha": 2.0},
           {"rightside": True, "transpose": True, "lower": False}):
    tag = "-".join(f"{k}{v}" for k, v in kw.items()) or "plain"
    b = M2 if not kw.get("rightside") else M2.transpose(0, 2, 1).copy()
    tri = L if kw.get("lower", True) else L.transpose(0, 2, 1).copy()
    case(f"trsm-{tag}", _f("linalg_trsm", **kw), [tri + np.triu(
        M, 1) * (kw.get("lower", True)), b], (0, 1))
    case(f"trmm-{tag}", _f("linalg_trmm", **kw), [M, b], (0, 1), F32)
case("syrk", _f("linalg_syrk", alpha=0.7), [WIDE], (0,), F32)
case("syrk-transpose", _f("linalg_syrk", transpose=True), [WIDE], (0,), F32)
case("sumlogdiag", _f("linalg_sumlogdiag"), [SPD], (0,))
for off in (0, 1, -2):
    case(f"extractdiag{off}", _f("linalg_extractdiag", offset=off), [M],
         (0,), EXACT)
    case(f"makediag{off}", _f("linalg_makediag", offset=off), [VEC[:, :4]],
         (0,), EXACT)
    for lower in (True, False):
        case(f"extracttrian{off}-{lower}", _f(
            "linalg_extracttrian", offset=off, lower=lower), [M], (0,),
            EXACT)
        case(f"maketrian{off}-{lower}", _f(
            "linalg_maketrian", offset=off, lower=lower), [VEC], (0,),
            EXACT)
case("potrf-not-positive-definite", _f("linalg_potrf"),
     [np.stack([SPD[0], -SPD[1]])], ())
case("inverse", _f("linalg_inverse"), [SPD + M], (0,))
case("inverse-singular", _f("linalg_inverse"),
     [np.stack([SPD[0], np.ones((N, N), np.float32)])], ())
case("det", _f("linalg_det"), [SPD * 0.5 + M * 0.1], (0,))
case("slogdet", _f("linalg_slogdet"), [M], (0,))
case("gelqf", _f("linalg_gelqf"), [WIDE], ())
case("gelqf-grad", lambda F, a: [x ** 2 for x in F.linalg_gelqf(a)],
     [WIDE], (0,))
# the eigenvectors up to each row's sign (``test_factorizations_
# reconstruct``): torch's and XLA's LAPACK calls pick other signs
case("syevd", lambda F, a: [F.linalg_syevd(a)[0] ** 2,
                            F.linalg_syevd(a)[1]], [SPD], (0,))


@pytest.mark.parametrize("cid", sorted(CASES))
def test_linalg_matches_reference(cid):
    _check(*CASES[cid])


def test_every_function_flat_and_short():
    from mxnet_tpu.ndarray import linalg as jlinalg
    names = [n for n in vars(jlinalg) if n.startswith("linalg_")]
    assert len(names) == 17
    for name in names:
        assert callable(getattr(mx.nd, name)), name
        assert getattr(mx.nd.linalg, name[len("linalg_"):]) is \
            getattr(mx.nd.linalg, name)
    assert mx.nd.linalg.gemm2 is mx.nd.linalg_gemm2


@pytest.mark.parametrize("op", ["gelqf", "syevd"])
def test_factorizations_reconstruct(op):
    """``A = L Q`` with orthonormal rows; ``A = U^T diag(w) U`` with
    orthonormal rows, at 1e-5 of ``A``; the reference's factors agree
    row by row up to sign."""
    a = WIDE if op == "gelqf" else SPD
    with mx.cpu():
        f, g = (x.asnumpy().astype(np.float64) for x in
                getattr(mx.nd, "linalg_" + op)(mx.nd.array(a)))
    jf, jg = (x.asnumpy() for x in getattr(jmx.nd, "linalg_" + op)(
        jmx.nd.array(a)))
    if op == "gelqf":
        rec, rows = f @ g, g
        np.testing.assert_allclose(np.abs(f), np.abs(jf), rtol=FACT,
                                   atol=1e-5)
        np.testing.assert_allclose(np.abs(g), np.abs(jg), rtol=FACT,
                                   atol=1e-5)
    else:
        rec, rows = f.transpose(0, 2, 1) @ (g[..., None] * f), f
        np.testing.assert_allclose(g, jg, rtol=FACT)
        dots = np.abs(np.einsum("bij,bij->bi", f, jf))
        np.testing.assert_allclose(dots, 1.0, atol=1e-4)
    np.testing.assert_allclose(rec, a, atol=1e-5 * np.abs(a).max())
    eye = rows @ rows.transpose(0, 2, 1)
    np.testing.assert_allclose(eye, np.broadcast_to(np.eye(eye.shape[-1]),
                                                    eye.shape), atol=1e-5)
