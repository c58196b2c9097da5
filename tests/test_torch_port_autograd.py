"""The port's ``autograd`` against ``mxnet_tpu.autograd``, on the CPU.

The same numpy inputs go through both packages; gradients are held to
1e-5 (absolute and relative: f32 sums of a few terms taken in another
order), the flags and the ``grad_req`` rules exactly.
"""
import numpy as np
import pytest

import mxnet_tpu as jmx
from mxnet_tpu import autograd as jag

import mxnet_tpu_torch as mx
from mxnet_tpu_torch import autograd as ag

TOL = 1e-5
RNG = np.random.RandomState(0)
X = RNG.randn(3, 4).astype(np.float32)
Y = RNG.randn(4, 2).astype(np.float32)
HEAD = RNG.randn(3, 2).astype(np.float32)


def _port(a):
    with mx.cpu():
        return mx.nd.array(a)


def test_flags_follow_the_reference():
    for pkg in (ag, jag):
        assert not pkg.is_recording() and not pkg.is_training()
        with pkg.record():
            assert pkg.is_recording() and pkg.is_training()
            with pkg.pause():
                assert not pkg.is_recording() and not pkg.is_training()
                with pkg.train_mode():
                    assert pkg.is_training() and not pkg.is_recording()
            with pkg.predict_mode():
                assert pkg.is_recording() and not pkg.is_training()
        with pkg.record(train_mode=False):
            assert pkg.is_recording() and not pkg.is_training()
        assert not pkg.is_recording() and not pkg.is_training()
        prev = pkg.set_training(True)
        assert pkg.is_training() and prev is False
        pkg.set_training(False)


def test_no_graph_outside_record():
    x = _port(X)
    x.attach_grad()
    y = x * 2 + 1                       # outside record: no graph
    assert y.data.grad_fn is None and not y.data.requires_grad
    with pytest.raises(mx.MXNetError, match="record"):
        y.backward()
    with ag.record():
        z = (x * 2).sum()
        with ag.pause():
            w = x * 3
    assert z.data.grad_fn is not None and w.data.grad_fn is None
    # the reference: the same op outside record builds no tape node
    jx = jmx.nd.array(X)
    jx.attach_grad()
    assert (jx * 2 + 1)._node is None


def _both(fn, grad_req="write", head=None, twice=False):
    """``fn(x, y)`` under record in both packages, backward (twice if
    asked, with ``head`` as head gradient); the gradients of x and y."""
    out = []
    for pkg, arr in ((ag, _port), (jag, jmx.nd.array)):
        x, y = arr(X), arr(Y)
        x.attach_grad(grad_req)
        y.attach_grad(grad_req)
        for _ in range(2 if twice else 1):
            with pkg.record():
                z = fn(x, y)
            z.backward(None if head is None else arr(head))
        out.append((x.grad.asnumpy(), y.grad.asnumpy()))
    return out


@pytest.mark.parametrize("req,twice", [("write", False), ("write", True),
                                       ("add", True)])
def test_gradients_match_jax(req, twice):
    (pg, pyg), (jg, jyg) = _both(_loss, req, twice=twice)
    np.testing.assert_allclose(pg, jg, rtol=TOL, atol=TOL)
    np.testing.assert_allclose(pyg, jyg, rtol=TOL, atol=TOL)
    if req == "add":                    # two backward passes summed
        (sg, _), _ = _both(_loss, "write")
        np.testing.assert_allclose(pg, 2 * sg, rtol=TOL, atol=TOL)


def mx_or_j(x):
    return mx.nd if isinstance(x, mx.nd.NDArray) else jmx.nd


def _loss(x, y):
    F = mx_or_j(x)
    h = F.dot(x, y)
    return F.sum(h * h) + F.mean(F.exp(x) * x) + F.sum(F.tanh(x[1:]))


def test_head_gradients_match_jax():
    (pg, pyg), (jg, jyg) = _both(lambda x, y: mx_or_j(x).dot(x, y),
                                 head=HEAD)
    np.testing.assert_allclose(pg, jg, rtol=TOL, atol=TOL)
    np.testing.assert_allclose(pyg, jyg, rtol=TOL, atol=TOL)
    np.testing.assert_allclose(pg, HEAD @ Y.T, rtol=TOL, atol=TOL)


def test_grad_returns_without_touching_dot_grad():
    got, want = [], []
    for pkg, arr, sink in ((ag, _port, got), (jag, jmx.nd.array, want)):
        x, y = arr(X), arr(Y)
        x.attach_grad()
        y.attach_grad()
        with pkg.record():
            z = _loss(x, y)
        gx, gy = pkg.grad(z, [x, y])
        sink += [gx.asnumpy(), gy.asnumpy(), x.grad.asnumpy()]
    for g, w in zip(got, want):
        np.testing.assert_allclose(g, w, rtol=TOL, atol=TOL)
    assert not got[2].any()             # .grad left alone (zeros)


def test_grad_create_graph_is_differentiable_again():
    x = _port(X)
    x.attach_grad()
    with ag.record():
        y = (x * x * x).sum()
        gx = ag.grad(y, x, create_graph=True)      # 3 x^2
        z = gx.sum()
    z.backward()
    np.testing.assert_allclose(x.grad.asnumpy(), 6 * X, rtol=TOL, atol=TOL)


def test_write_keeps_the_last_backward_and_null_takes_none():
    x = _port(X)
    x.attach_grad("write")
    for scale in (2.0, 5.0):
        with ag.record():
            y = (x * scale).sum()
        y.backward()
    np.testing.assert_array_equal(x.grad.asnumpy(), np.full_like(X, 5.0))
    x.attach_grad("null")
    assert x.grad is None and not x.data.requires_grad
    v = _port(X)
    ag.mark_variables([v], [_port(np.ones_like(X))], "add")
    with ag.record():
        (v * 3).sum().backward()
    np.testing.assert_array_equal(v.grad.asnumpy(), np.full_like(X, 4.0))
    # a variable used twice in one backward sums, under write as well
    u = _port(X)
    u.attach_grad()
    with ag.record():
        (u * 2 + u * 3).sum().backward()
    np.testing.assert_array_equal(u.grad.asnumpy(), np.full_like(X, 5.0))


def test_inplace_on_a_recorded_array_raises():
    x = _port(X)
    x.attach_grad()
    with ag.record():
        y = x * 2
        with pytest.raises(mx.MXNetError, match="in-place"):
            y += 1
    y += 1                              # outside record it writes
    x[0] = 0.0                          # a variable itself may be set


class _ScaledSquare:
    """The same Function in both packages: y = 2 x^2 with a hand-written
    backward."""

    @staticmethod
    def make(base):
        class Fn(base):
            def forward(self, x):
                self.save_for_backward(x)
                return x * x * 2

            def backward(self, dy):
                x, = self.saved_tensors
                return dy * x * 4
        return Fn()


def test_function_matches_jax():
    got = []
    for pkg, arr in ((ag, _port), (jag, jmx.nd.array)):
        x = arr(X)
        x.attach_grad()
        fn = _ScaledSquare.make(pkg.Function)
        with pkg.record():
            y = fn(x)
            z = (y * arr(X)).sum()
        z.backward()
        got.append((y.asnumpy(), x.grad.asnumpy()))
    for a, b in zip(*got):
        np.testing.assert_allclose(a, b, rtol=TOL, atol=TOL)
    np.testing.assert_allclose(got[0][1], 4 * X * X, rtol=TOL, atol=TOL)


def test_remat_recomputes_dropout_with_the_same_mask():
    """A hybridized ``remat=True`` block recomputes its forward in the
    backward: the recomputed Dropout must draw the mask the forward
    drew, so the gradients equal those of the plain block."""
    from mxnet_tpu_torch.gluon import nn
    grads = []
    for remat in (False, True):
        net = nn.HybridSequential(prefix="remat_")
        with net.name_scope():
            net.add(nn.Dense(8, in_units=4, prefix="d0_"),
                    nn.Dropout(0.5), nn.Dense(3, in_units=8, prefix="d1_"))
        mx.random.seed(11)
        net.initialize(ctx=mx.cpu())
        net.hybridize(remat=remat)
        mx.random.seed(5)
        x = _port(X)
        with ag.record():
            y = (net(x) ** 2).sum()
        y.backward()
        grads.append({k: p.grad().asnumpy() for k, p in
                      net.collect_params().items()})
    for k in grads[0]:
        np.testing.assert_array_equal(grads[0][k], grads[1][k])
