"""The port's fused LayerNorm (K4) against the JAX package, on the CPU.

Each case feeds the same numpy inputs (made from a seed) to the JAX
function and to ``mxnet_tpu_torch.ops.fused_layer_norm``, which on CPU
tensors runs the plain versions the CUDA kernels are held against on the
card.  Tolerances (float32; the same two-pass f32 statistics, only the
summation order differs): forward 1e-5, backward 2e-5, against the
reference's XLA fallback and against its Pallas kernels run in interpret
mode.  Dropout draws other bits than JAX's keys, so it is checked by its
kept fraction and its scaling, not mask for mask.
"""
import json
import os
import pathlib
import subprocess
import sys

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from mxnet_tpu.ops import fused_layernorm as fln

from mxnet_tpu_torch.ops import fused_layer_norm
from mxnet_tpu_torch.ops.fused_layernorm import (fused_layer_norm_bwd,
                                                 fused_layer_norm_fwd)

REPO = pathlib.Path(__file__).resolve().parents[1]
FWD_TOL = dict(rtol=1e-5, atol=1e-5)
BWD_TOL = dict(rtol=2e-5, atol=2e-5)
SHAPES = [(1, 64), (7, 96), (4, 5, 128), (16, 256)]


def _inputs(shape, seed, residual=True):
    rng = np.random.RandomState(seed)
    d = shape[-1]
    x = (rng.randn(*shape) * 2 + 0.5).astype(np.float32)
    res = rng.randn(*shape).astype(np.float32) if residual else None
    gamma = rng.randn(d).astype(np.float32)
    beta = rng.randn(d).astype(np.float32)
    dy = rng.randn(*shape).astype(np.float32)
    return x, res, gamma, beta, dy


def _t(a):
    return None if a is None else torch.from_numpy(a)


def _j(a):
    return None if a is None else jnp.asarray(a)


@pytest.mark.parametrize("residual", [True, False])
@pytest.mark.parametrize("shape", SHAPES, ids=str)
def test_forward_matches_jax_fallback(shape, residual):
    x, res, gamma, beta, _ = _inputs(shape, 1, residual)
    ref = fln._fallback_forward(_j(x), _j(res), _j(gamma), _j(beta), 1e-5)
    out = fused_layer_norm_fwd(_t(x), _t(res), _t(gamma), _t(beta), 1e-5)
    assert out.shape == shape and out.dtype == torch.float32
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), **FWD_TOL)


@pytest.mark.parametrize("residual", [True, False])
@pytest.mark.parametrize("shape", SHAPES, ids=str)
def test_backward_matches_jax_fallback(shape, residual):
    x, res, gamma, _, dy = _inputs(shape, 2, residual)
    ref = fln._fallback_backward(_j(x), _j(res), _j(gamma), _j(dy), 1e-5)
    got = fused_layer_norm_bwd(_t(x), _t(res), _t(gamma), _t(dy), 1e-5)
    for a, b in zip(got, ref):
        assert a.dtype == torch.float32
        np.testing.assert_allclose(a.numpy(), np.asarray(b), **BWD_TOL)


def test_bf16_forward_and_backward_match_jax_fallback():
    """bf16 rows widen to f32 for the statistics in both packages; the
    outputs round to bf16 (one bf16 ulp, 8e-3 relative)."""
    x, res, gamma, beta, dy = _inputs((8, 128), 3)
    bx, bres, bdy = (torch.from_numpy(a).to(torch.bfloat16)
                     for a in (x, res, dy))
    jx, jres, jdy = (jnp.asarray(a, jnp.bfloat16) for a in (x, res, dy))
    y = fused_layer_norm_fwd(bx, bres, _t(gamma), _t(beta), 1e-5)
    ref = fln._fallback_forward(jx, jres, _j(gamma), _j(beta), 1e-5)
    assert y.dtype == torch.bfloat16
    np.testing.assert_allclose(y.float().numpy(),
                               np.asarray(ref.astype(jnp.float32)),
                               rtol=8e-3, atol=8e-3)
    dx, dg, db = fused_layer_norm_bwd(bx, bres, _t(gamma), bdy, 1e-5)
    rdx, rdg, rdb = fln._fallback_backward(jx, jres, _j(gamma), jdy, 1e-5)
    np.testing.assert_allclose(dx.float().numpy(),
                               np.asarray(rdx.astype(jnp.float32)),
                               rtol=8e-3, atol=8e-3)
    np.testing.assert_allclose(dg.numpy(), np.asarray(rdg), **BWD_TOL)
    np.testing.assert_allclose(db.numpy(), np.asarray(rdb), **BWD_TOL)


# ----------------------------------------------------------------------
# against the Pallas kernels in interpret mode
# ----------------------------------------------------------------------

PALLAS_CASES = [((16, 256), True), ((16, 256), False), ((32, 128), True),
                ((8, 384), True)]

_PALLAS_SCRIPT = r"""
import json, sys
import numpy as np
import jax.numpy as jnp
from mxnet_tpu.ops import fused_layernorm as fln
cases, out_path = json.loads(sys.argv[1]), sys.argv[2]
res = {}
for (rows, d), has_res in cases:
    rng = np.random.RandomState(rows + d)
    x = (rng.randn(rows, d) * 2 + 0.5).astype(np.float32)
    r = rng.randn(rows, d).astype(np.float32)
    gamma = rng.randn(d).astype(np.float32)
    beta = rng.randn(d).astype(np.float32)
    dy = rng.randn(rows, d).astype(np.float32)
    jr = jnp.asarray(r) if has_res else None
    br = fln._pick_rows(rows)
    y = fln._pallas_forward(jnp.asarray(x), jr, jnp.asarray(gamma),
                            jnp.asarray(beta), 1e-5, br, interpret=True)
    dx, dg, db = fln._pallas_backward(jnp.asarray(x), jr, jnp.asarray(gamma),
                                      jnp.asarray(dy), 1e-5, br,
                                      interpret=True)
    key = f"{rows}_{d}_{int(has_res)}"
    for name, val in (("y", y), ("dx", dx), ("dg", dg), ("db", db)):
        res[f"{key}_{name}"] = np.asarray(val)
np.savez(out_path, **res)
"""


@pytest.fixture(scope="module")
def pallas_results(tmp_path_factory):
    """The reference's Pallas K4 kernels run in interpret mode, in a
    child process: this test process pins JAX to the CPU backend, where
    the Pallas TPU lowering rules cannot register."""
    out = tmp_path_factory.mktemp("pallas") / "layernorm.npz"
    env = dict(os.environ, JAX_PLATFORMS="cpu", PYTHONPATH=str(REPO),
               XLA_FLAGS="--xla_cpu_multi_thread_eigen=false")
    proc = subprocess.run(
        [sys.executable, "-W", "ignore", "-c", _PALLAS_SCRIPT,
         json.dumps(PALLAS_CASES), str(out)],
        env=env, cwd=str(REPO), capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-4000:]
    return dict(np.load(out))


@pytest.mark.parametrize("shape,residual", PALLAS_CASES,
                         ids=lambda c: str(c))
def test_matches_pallas_kernels_interpret(pallas_results, shape, residual):
    rows, d = shape
    rng = np.random.RandomState(rows + d)
    x = (rng.randn(rows, d) * 2 + 0.5).astype(np.float32)
    r = rng.randn(rows, d).astype(np.float32)
    gamma = rng.randn(d).astype(np.float32)
    beta = rng.randn(d).astype(np.float32)
    dy = rng.randn(rows, d).astype(np.float32)
    res = _t(r) if residual else None
    key = f"{rows}_{d}_{int(residual)}"
    y = fused_layer_norm_fwd(_t(x), res, _t(gamma), _t(beta), 1e-5)
    np.testing.assert_allclose(y.numpy(), pallas_results[key + "_y"],
                               **FWD_TOL)
    got = fused_layer_norm_bwd(_t(x), res, _t(gamma), _t(dy), 1e-5)
    for a, name in zip(got, ("dx", "dg", "db")):
        np.testing.assert_allclose(a.numpy(), pallas_results[f"{key}_{name}"],
                                   **BWD_TOL)


# ----------------------------------------------------------------------
# the autograd Function and the public op
# ----------------------------------------------------------------------

@pytest.mark.parametrize("residual", [True, False])
@pytest.mark.parametrize("shape", [(6, 64), (2, 3, 128)], ids=str)
def test_grads_match_jax_grad_of_the_custom_vjp(shape, residual):
    """Gradients by torch autograd through ``_FusedLN`` against
    ``jax.grad`` of the reference's ``_fused_ln`` custom VJP."""
    x, res, gamma, beta, w = _inputs(shape, 4, residual)
    eps = 1e-5

    def loss(a, r, g, b):
        return jnp.sum(fln._fused_ln(a, r, g, b, eps) * w)

    argnums = (0, 1, 2, 3) if residual else (0, 2, 3)
    ref = jax.grad(loss, argnums=argnums)(_j(x), _j(res), _j(gamma),
                                          _j(beta))
    leaves = [torch.from_numpy(a).requires_grad_() if a is not None else None
              for a in (x, res, gamma, beta)]
    tx, tres, tg, tb = leaves
    out = fused_layer_norm(tx, tg, tb, residual=tres, eps=eps)
    assert out.grad_fn is not None
    out.backward(torch.from_numpy(w))
    got = [t.grad for t in leaves if t is not None]
    for a, b in zip(got, ref):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), **BWD_TOL)
    if residual:
        assert torch.equal(tres.grad, tx.grad)      # dres == dx


def test_residual_grad_takes_the_residual_dtype():
    x = torch.randn(4, 64, requires_grad=True)
    res = torch.randn(4, 64, dtype=torch.float64)
    g, b = torch.ones(64, requires_grad=True), torch.zeros(64)
    res.requires_grad_()
    out = fused_layer_norm(x, g, b, residual=res.float())
    out.sum().backward()
    assert res.grad.dtype == torch.float64 and g.grad.dtype == torch.float32


@pytest.mark.parametrize("bad", ["gamma", "beta", "scalar_x"])
def test_shape_errors_raise_value_error(bad):
    x, g, b = torch.zeros(4, 8), torch.zeros(8), torch.zeros(8)
    if bad == "gamma":
        g = torch.zeros(7)
    elif bad == "beta":
        b = torch.zeros(8, 1)
    else:
        x = torch.tensor(1.0)
    with pytest.raises(ValueError, match="gamma/beta"):
        fused_layer_norm(x, g, b)


def test_dropout_off_in_eval_mode_is_deterministic():
    x, res, gamma, beta, _ = (_t(a) for a in _inputs((8, 64), 5))
    plain = fused_layer_norm(x, gamma, beta, residual=res)
    with torch.no_grad():                  # training defaults to grad mode
        a = fused_layer_norm(x, gamma, beta, residual=res, dropout=0.5)
        b = fused_layer_norm(x, gamma, beta, residual=res, dropout=0.5)
    c = fused_layer_norm(x, gamma, beta, residual=res, dropout=0.5,
                         training=False)
    assert torch.equal(a, b) and torch.equal(a, c)
    assert torch.equal(a, plain.detach())


def test_dropout_kept_fraction_and_scaling():
    """x = 1 everywhere, gamma = 1, beta = 0: a kept element becomes
    ``1 / keep`` and a dropped one 0.  With eps far above the row
    variance the output keeps the scale, so the gap between the two
    levels gives ``1 / keep`` back; the kept fraction is within 5 sigma
    of ``keep``; one generator seed gives one mask."""
    rows, d, rate, eps = 64, 1024, 0.3, 1e6
    keep = 1.0 - rate
    x = torch.ones(rows, d)
    gamma, beta = torch.ones(d), torch.zeros(d)

    def run(seed):
        gen = torch.Generator().manual_seed(seed)
        return fused_layer_norm(x, gamma, beta, eps=eps, dropout=rate,
                                training=True, generator=gen)

    y = run(7)
    assert torch.equal(y, run(7)) and not torch.equal(y, run(8))
    kept = y > 0
    frac = float(kept.float().mean())
    sigma = (keep * rate / (rows * d)) ** 0.5
    assert abs(frac - keep) < 5 * sigma
    for i in range(4):
        f = float(kept[i].float().mean())
        gap = float(y[i][kept[i]][0] - y[i][~kept[i]][0])
        # gap = s / sqrt(f (1 - f) s^2 + eps): solve for the kept value s
        s = gap * eps ** 0.5 / (1.0 - gap * gap * f * (1.0 - f)) ** 0.5
        np.testing.assert_allclose(s, 1.0 / keep, rtol=1e-4)


def test_dropout_gradient_flows_to_x_through_the_mask():
    """Dropped elements get no gradient; kept ones get LayerNorm's
    gradient through the inverted scaling."""
    rng = np.random.RandomState(6)
    x = torch.from_numpy(rng.randn(16, 64).astype(np.float32))
    x.requires_grad_()
    gamma, beta = torch.ones(64), torch.zeros(64)
    gen = torch.Generator().manual_seed(3)
    y = fused_layer_norm(x, gamma, beta, dropout=0.5, training=True,
                         generator=gen)
    y.backward(torch.from_numpy(rng.randn(16, 64).astype(np.float32)))
    mask = torch.rand(16, 64, generator=torch.Generator().manual_seed(3)) \
        < 0.5
    assert bool((x.grad[~mask] == 0).all())
    assert bool((x.grad[mask] != 0).all())
