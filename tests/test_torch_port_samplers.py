"""The port's samplers, densities and the rest of the initializers against
the JAX package's, on the CPU.

- The ``random_pdf_*`` densities are deterministic: on the same samples
  and parameters, each density and log-density, and the gradient of the
  log-density with respect to the samples and parameters where the
  reference defines one, within 1e-5 relative in the Frobenius norm.
- The samplers draw from each package's own generator, so they are held
  by their moments: 2x10^5 draws of each ``nd.random`` sampler and each
  ``sample_*`` op (per-element parameters, two rows of 10^5), the mean
  within 5 standard errors of the distribution's and the variance within
  5 standard errors (the sample's own fourth moment) of it; the
  multinomial's category frequencies within 5 binomial standard errors;
  ``shuffle`` a permutation.  The same seed draws the same values again.
- ``Orthogonal`` gives ``W W^T = scale^2 I`` (1e-5 absolute); ``Bilinear``,
  ``LSTMBias`` and ``Load`` fill exactly the reference's values.
"""
import numpy as np
import pytest
import torch

import mxnet_tpu as jmx

import mxnet_tpu_torch as mt

RTOL = 1e-5
N = 200_000
SE = 5


@pytest.fixture(autouse=True)
def _keep_the_global_generators():
    """A test here reseeds both packages' global generators; the tests
    after it on the same worker draw from them, so each test leaves them
    as it found them."""
    from mxnet_tpu_torch.ndarray import random as prand
    key = jmx.random.get_key_data()
    seed = prand._SEED[0]
    states = {dev: gen.get_state() for dev, gen in prand._GENERATORS.items()}
    yield
    jmx.random.set_key_data(key)
    prand._SEED[0] = seed
    for dev in list(prand._GENERATORS):
        if dev in states:
            prand._GENERATORS[dev].set_state(states[dev])
        else:
            del prand._GENERATORS[dev]


def _close(got, want, what, rtol=RTOL):
    want = np.asarray(want, np.float64)
    scale = max(float(np.linalg.norm(want)), 1e-30)
    err = float(np.linalg.norm(np.asarray(got, np.float64) - want)) / scale
    assert err <= rtol, f"{what}: {err:.3g} relative to {scale:.3g}"


def _moments(x, mean, var, what):
    x = np.asarray(x, np.float64).reshape(-1)
    n = x.size
    m = x.mean()
    assert abs(m - mean) <= SE * np.sqrt(var / n), \
        f"{what}: mean {m} against {mean}"
    dev2 = (x - m) ** 2
    v = dev2.mean() * n / (n - 1)
    assert abs(v - var) <= SE * np.sqrt(dev2.var() / n), \
        f"{what}: variance {v} against {var}"


# ----------------------------------------------------------------------
# densities
# ----------------------------------------------------------------------

def _pdf_inputs(name, rng):
    """(sample (2, 5) or dirichlet's (2, 5, 3), parameters (2,) each)."""
    pos = lambda *s: (rng.rand(*s) * 2 + 0.5).astype(np.float32)  # noqa
    if name == "uniform":
        return rng.rand(2, 5).astype(np.float32) * 2 - 0.5, [
            np.array([-1.0, 0.0], np.float32), np.array([1.0, 1.2],
                                                         np.float32)]
    if name == "normal":
        return rng.randn(2, 5).astype(np.float32), [
            rng.randn(2).astype(np.float32), pos(2)]
    if name in ("gamma",):
        return pos(2, 5), [pos(2), pos(2)]
    if name == "exponential":
        return pos(2, 5), [pos(2)]
    if name == "poisson":
        return rng.poisson(2.0, (2, 5)).astype(np.float32), [pos(2)]
    if name == "negative_binomial":
        return rng.poisson(2.0, (2, 5)).astype(np.float32), [
            pos(2), np.array([0.3, 0.7], np.float32)]
    if name == "generalized_negative_binomial":
        return rng.poisson(2.0, (2, 5)).astype(np.float32), [pos(2), pos(2)]
    if name == "dirichlet":
        s = rng.rand(2, 5, 3).astype(np.float32) + 0.1
        return (s / s.sum(-1, keepdims=True)).astype(np.float32), [
            pos(2, 3)]
    raise AssertionError(name)


PDFS = ["uniform", "normal", "gamma", "exponential", "poisson",
        "negative_binomial", "generalized_negative_binomial", "dirichlet"]


@pytest.mark.parametrize("is_log", [False, True], ids=["pdf", "log"])
@pytest.mark.parametrize("name", PDFS)
def test_density_matches_jax(name, is_log):
    rng = np.random.RandomState(sum(map(ord, name)))
    sample, params = _pdf_inputs(name, rng)
    op = f"random_pdf_{name}"
    j = getattr(jmx.nd, op)(jmx.nd.array(sample),
                            *[jmx.nd.array(p) for p in params],
                            is_log=is_log)
    with mt.cpu():
        p = getattr(mt.nd, op)(mt.nd.array(sample),
                               *[mt.nd.array(q) for q in params],
                               is_log=is_log)
    assert p.shape == j.shape
    got, want = p.asnumpy(), np.array(j.asnumpy())
    # outside a uniform's support: density 0, log-density -inf in both
    np.testing.assert_array_equal(np.isfinite(got), np.isfinite(want))
    np.testing.assert_array_equal(got[~np.isfinite(got)],
                                  want[~np.isfinite(want)])
    ok = np.isfinite(want)
    _close(got[ok], want[ok], f"{op} is_log={is_log}")


@pytest.mark.parametrize("name", ["normal", "gamma", "exponential"])
def test_log_density_gradients_match_jax(name):
    rng = np.random.RandomState(7)
    sample, params = _pdf_inputs(name, rng)
    op = f"random_pdf_{name}"
    out = []
    for pkg, rec in ((jmx, jmx.autograd), (mt, mt.autograd)):
        with (jmx.cpu() if pkg is jmx else mt.cpu()):
            arrs = [pkg.nd.array(a) for a in [sample] + params]
        for a in arrs:
            a.attach_grad()
        with rec.record():
            y = getattr(pkg.nd, op)(*arrs, is_log=True)
        y.backward()
        out.append([np.array(a.grad.asnumpy()) for a in arrs])
    for i, (a, b) in enumerate(zip(out[1], out[0])):
        _close(a, b, f"{op} gradient {i}")


# ----------------------------------------------------------------------
# samplers, by moments
# ----------------------------------------------------------------------

def _nb(k, p):
    return k * (1 - p) / p, k * (1 - p) / p ** 2


SAMPLERS = {
    "uniform": (lambda r: r.uniform(-1.0, 3.0, shape=(N,)), 1.0, 16 / 12),
    "normal": (lambda r: r.normal(0.5, 2.0, shape=(N,)), 0.5, 4.0),
    "gamma": (lambda r: r.gamma(2.5, 0.8, shape=(N,)), 2.0, 1.6),
    "exponential": (lambda r: r.exponential(1.5, shape=(N,)), 1.5, 2.25),
    "poisson": (lambda r: r.poisson(3.5, shape=(N,)), 3.5, 3.5),
    "negative_binomial": (lambda r: r.negative_binomial(3, 0.4, shape=(N,)),
                          *_nb(3, 0.4)),
    "generalized_negative_binomial": (
        lambda r: r.generalized_negative_binomial(2.0, 0.5, shape=(N,)),
        2.0, 2.0 + 0.5 * 4.0),
    "randn": (lambda r: r.randn(N), 0.0, 1.0),
}


@pytest.mark.parametrize("name", sorted(SAMPLERS))
def test_nd_random_sampler_moments(name):
    draw, mean, var = SAMPLERS[name]
    with mt.cpu():
        mt.random.seed(11)
        x = draw(mt.nd.random).asnumpy()
        mt.random.seed(11)
        again = draw(mt.nd.random).asnumpy()
    assert x.shape == (N,)
    np.testing.assert_array_equal(x, again)
    _moments(x, mean, var, name)
    # the reference's draws hold to the same moments
    jmx.random.seed(11)
    _moments(np.array(draw(jmx.nd.random).asnumpy()), mean, var,
             f"reference {name}")


SAMPLE_OPS = {
    "sample_uniform": ([[0.0, -2.0], [1.0, 2.0]],
                       lambda a, b: ((a + b) / 2, (b - a) ** 2 / 12)),
    "sample_normal": ([[0.0, 3.0], [1.0, 0.5]], lambda m, s: (m, s * s)),
    "sample_gamma": ([[0.7, 4.0], [2.0, 0.5]],
                     lambda a, b: (a * b, a * b * b)),
    "sample_exponential": ([[0.5, 4.0]], lambda lam: (1 / lam, 1 / lam ** 2)),
    "sample_poisson": ([[0.8, 6.0]], lambda lam: (lam, lam)),
    "sample_negative_binomial": ([[2.0, 5.0], [0.3, 0.6]], _nb),
    "sample_generalized_negative_binomial": (
        [[1.5, 4.0], [0.2, 1.0]], lambda mu, a: (mu, mu + a * mu * mu)),
}


@pytest.mark.parametrize("name", sorted(SAMPLE_OPS))
def test_sample_op_moments(name):
    params, moments = SAMPLE_OPS[name]
    params = [np.array(p, np.float32) for p in params]
    with mt.cpu():
        x = getattr(mt.nd, name)(*[mt.nd.array(p) for p in params],
                                 shape=N // 2).asnumpy()
    jx = np.array(getattr(jmx.nd, name)(*[jmx.nd.array(p) for p in params],
                                        shape=N // 2).asnumpy())
    assert x.shape == jx.shape == (2, N // 2)
    for row in range(2):
        mean, var = moments(*[float(p[row]) for p in params])
        _moments(x[row], mean, var, f"{name} row {row}")
        _moments(jx[row], mean, var, f"reference {name} row {row}")


@pytest.mark.parametrize("how", ["nd.random", "sample_multinomial"])
def test_multinomial_frequencies(how):
    probs = np.array([[0.1, 0.2, 0.7], [0.5, 0.25, 0.25]], np.float32)
    with mt.cpu():
        data = mt.nd.array(probs)
        if how == "nd.random":
            draws, logp = mt.nd.random.multinomial(data, shape=N // 2,
                                                   get_prob=True)
            jd, jl = jmx.nd.random.multinomial(jmx.nd.array(probs),
                                               shape=N // 2, get_prob=True)
        else:
            draws, logp = mt.nd.sample_multinomial(data, shape=N // 2,
                                                   get_prob=True)
            jd, jl = jmx.nd.sample_multinomial(jmx.nd.array(probs),
                                               shape=N // 2, get_prob=True)
    d = draws.asnumpy()
    assert d.shape == tuple(jd.shape) == (2, N // 2)
    assert d.dtype == np.int32 and logp.shape == tuple(jl.shape)
    for row in range(2):
        for c in range(3):
            p = probs[row, c]
            freq = (d[row] == c).mean()
            assert abs(freq - p) <= SE * np.sqrt(p * (1 - p) / (N // 2))
        np.testing.assert_allclose(logp.asnumpy()[row],
                                   np.log(probs[row])[d[row]], rtol=1e-6)


def test_shuffle_permutes_rows():
    with mt.cpu():
        x = mt.nd.array(np.arange(40, dtype=np.float32).reshape(10, 4))
        mt.random.seed(3)
        y = mt.nd.random.shuffle(x).asnumpy()
    assert not np.array_equal(y, x.asnumpy())
    assert sorted(map(tuple, y)) == sorted(map(tuple, x.asnumpy()))


def test_random_op_aliases():
    with mt.cpu():
        mt.random.seed(4)
        a = mt.nd.random_uniform(0, 1, shape=(5,)).asnumpy()
        mt.random.seed(4)
        b = mt.nd.random.uniform(0, 1, shape=(5,)).asnumpy()
        assert mt.nd.random_normal(shape=(3,)).shape == (3,)
    np.testing.assert_array_equal(a, b)


def test_every_sampler_op_is_ported():
    names = set(SAMPLE_OPS) | {f"random_pdf_{n}" for n in PDFS} | {
        "sample_multinomial", "random_uniform", "random_normal"}
    assert len(names) == 18
    for n in names:
        assert n in mt.nd.ops._OPS, n


# ----------------------------------------------------------------------
# initializers
# ----------------------------------------------------------------------

@pytest.mark.parametrize("rand_type", ["uniform", "normal"])
def test_orthogonal_rows_are_orthonormal(rand_type):
    with mt.cpu():
        w = mt.nd.zeros((6, 2, 5))
    mt.init.Orthogonal(scale=1.5, rand_type=rand_type)("fc_weight", w)
    m = w.asnumpy().reshape(6, -1)
    np.testing.assert_allclose(m @ m.T, 1.5 ** 2 * np.eye(6), atol=1e-5)
    assert type(mt.init.create("orthogonal")).__name__ == "Orthogonal"


def _fill_both(init_j, init_p, name, shape):
    j = jmx.nd.zeros(shape)
    init_j(name, j)
    with mt.cpu():
        p = mt.nd.zeros(shape)
    init_p(name, p)
    return p.asnumpy(), np.array(j.asnumpy())


def test_bilinear_lstm_bias_and_load_match_jax():
    got, want = _fill_both(jmx.init.Bilinear(), mt.init.Bilinear(),
                           "up_weight", (3, 2, 4, 5))
    np.testing.assert_array_equal(got, want)
    for name in ("lstm_i2h_bias", "lstm_i2h_weight"):
        got, want = _fill_both(jmx.init.LSTMBias(2.0), mt.init.LSTMBias(2.0),
                               name, (12,))
        np.testing.assert_array_equal(got, want)
    src = {"arg:dense_weight": np.arange(6, dtype=np.float32).reshape(2, 3)}
    got, want = _fill_both(jmx.init.Load(src), mt.init.Load(src),
                           "dense_weight", (2, 3))
    np.testing.assert_array_equal(got, want)
    got, want = _fill_both(jmx.init.Load(src, default_init=jmx.init.One()),
                           mt.init.Load(src, default_init=mt.init.One()),
                           "dense_bias_other", (3,))
    np.testing.assert_array_equal(got, want)
    with pytest.raises(mt.MXNetError, match="no value"):
        _fill_both(lambda n, a: None, mt.init.Load(src), "missing", (3,))
    with pytest.raises(mt.MXNetError, match="shape"):
        _fill_both(lambda n, a: None, mt.init.Load(src), "dense_weight",
                   (3, 2))
