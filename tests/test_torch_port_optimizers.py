"""The port's optimizers and optimizer update ops against the JAX
package's, on the CPU.

- Every optimizer of the reference's registry (``create(name)``) updates
  three parameters of different shapes for 5 steps in both packages from
  the same numpy weights and gradients (``RandomState``), with weight
  decay, a gradient clip, a rescale, and per-parameter ``lr_mult`` /
  ``wd_mult``: each weight and each state array within 1e-5 relative in
  the Frobenius norm after every step (float32; LAMB's and LARS's norms
  reduce in another order, and the reference's eager rules take some
  host scalars in double precision where the port takes them in
  float32).  SGLD draws its noise from each package's own generator, so
  it is held by the distribution of its update over 20,000 elements:
  the mean of ``update + lr/2 g`` within 5 standard errors of 0 and its
  variance within 5 standard errors of ``lr``.
- ``Updater.get_states`` pickles load across the packages both ways.
- The update ops of ``nd`` (``sgd_update`` ... ``reset_arrays``): each
  on the same numpy inputs, its returned array and every state argument
  it updates in place within 1e-5 relative (the LAMB norms fed to
  ``lamb_update_phase2`` are the ones ``multi_sum_sq`` returns).
"""
import pickle

import numpy as np
import pytest
import torch

import mxnet_tpu as jmx
from mxnet_tpu import optimizer as jopt

import mxnet_tpu_torch as mt
from mxnet_tpu_torch import optimizer as popt

RTOL = 1e-5
STEPS = 5
SHAPES = [(4, 3), (7,), (2, 3, 2)]

OPTIMIZERS = {
    "sgd": {"momentum": 0.9},
    "nag": {"momentum": 0.9},
    "adam": {"learning_rate": 1e-2},
    "adamw": {"learning_rate": 1e-2},
    "adagrad": {"learning_rate": 0.1},
    "adadelta": {"rho": 0.8},
    "rmsprop": {"learning_rate": 1e-2},
    "rmsprop-centered": {"learning_rate": 1e-2, "centered": True,
                         "clip_weights": 1.5},
    "ftrl": {"lamda1": 0.01, "learning_rate": 0.1},
    "signum": {"learning_rate": 0.01, "momentum": 0.9, "wd_lh": 0.01},
    "signum-nomom": {"learning_rate": 0.01, "momentum": 0.0},
    "lamb": {"learning_rate": 1e-2},
    "lamb-bounded": {"learning_rate": 1e-2, "lower_bound": 0.5,
                     "upper_bound": 2.0, "bias_correction": False},
    "lars": {"learning_rate": 0.1, "momentum": 0.9},
    "lars-nomom": {"learning_rate": 0.1, "eta": 0.01},
    "test": {"learning_rate": 0.1},
}
COMMON = {"wd": 1e-2, "clip_gradient": 0.8, "rescale_grad": 0.5}


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


def _weights():
    rng = np.random.RandomState(0)
    return [rng.randn(*s).astype(np.float32) for s in SHAPES]


def _grads(step):
    rng = np.random.RandomState(100 + step)
    return [rng.randn(*s).astype(np.float32) for s in SHAPES]


def _name(case):
    return case.split("-")[0]


def _leaves(state):
    """The state's arrays, in the reference's order, as numpy."""
    if state is None:
        return []
    if isinstance(state, tuple):
        return [a for s in state for a in _leaves(s)]
    return [np.array(state.asnumpy()) if hasattr(state, "asnumpy")
            else state.detach().numpy().copy()]


def _jax_run(case):
    opt = jopt.create(_name(case), **OPTIMIZERS[case], **COMMON)
    opt.set_lr_mult({1: 0.5})
    opt.set_wd_mult({2: 0.0})
    ws = [jmx.nd.array(w) for w in _weights()]
    states = [opt.create_state_multi_precision(i, w)
              for i, w in enumerate(ws)]
    out = []
    for step in range(STEPS):
        for i, (w, g) in enumerate(zip(ws, _grads(step))):
            opt.update_multi_precision(i, w, jmx.nd.array(g), states[i])
        out.append(([np.array(w.asnumpy()) for w in ws],
                    [_leaves(s) for s in states]))
    return out


def _port_run(case):
    opt = popt.create(_name(case), **OPTIMIZERS[case], **COMMON)
    opt.set_lr_mult({1: 0.5})
    opt.set_wd_mult({2: 0.0})
    ws = [torch.from_numpy(w) for w in _weights()]
    states = [opt.create_state_multi_precision(i, w)
              for i, w in enumerate(ws)]
    out = []
    for step in range(STEPS):
        for i, (w, g) in enumerate(zip(ws, _grads(step))):
            opt.update_multi_precision(i, w, torch.from_numpy(g), states[i])
        out.append(([w.numpy().copy() for w in ws],
                    [_leaves(opt.reference_state(s)) for s in states]))
    return out


@pytest.fixture(scope="module")
def jax_runs():
    return {case: _jax_run(case) for case in OPTIMIZERS}


def _close(got, want, what, rtol=RTOL):
    scale = max(float(np.linalg.norm(want)), 1e-30)
    err = float(np.linalg.norm(np.asarray(got, np.float64) - want)) / scale
    assert err <= rtol, f"{what}: {err:.3g} relative to {scale:.3g}"


@pytest.mark.parametrize("case", sorted(OPTIMIZERS))
def test_optimizer_matches_jax_step_by_step(jax_runs, case):
    want, got = jax_runs[case], _port_run(case)
    for step, ((jw, js), (pw, ps)) in enumerate(zip(want, got)):
        for i in range(len(SHAPES)):
            _close(pw[i], jw[i], f"{case} step {step} weight {i}")
            assert len(ps[i]) == len(js[i]), f"{case} state {i} layout"
            for j, (a, b) in enumerate(zip(ps[i], js[i])):
                _close(a, b, f"{case} step {step} state {i}.{j}")


def test_every_reference_optimizer_is_registered():
    names = {"sgd", "nag", "adam", "adamw", "adagrad", "adadelta",
             "rmsprop", "ftrl", "signum", "lamb", "lars", "sgld", "test"}
    for name in names:
        assert type(popt.create(name)).__name__ == \
            type(jopt.create(name)).__name__
    assert popt.ccSGD is popt.SGD
    with pytest.raises(mt.MXNetError, match="Cannot find optimizer"):
        popt.create("nonesuch")


def test_bucket_kernels_take_only_their_four_rules():
    """K1/K2 update sgd, nag, adam and adamw; the other rules have no
    bucket kernel and the bucket rule refuses them rather than run
    another rule's kernel."""
    from mxnet_tpu_torch.ops.fused_update import (BUCKET_RULES,
                                                  fused_bucket_rule)
    assert BUCKET_RULES == ("sgd", "nag", "adam", "adamw")
    for name in ("lamb", "lars", "rmsprop"):
        with pytest.raises(mt.MXNetError, match="no bucket kernel"):
            fused_bucket_rule(name)
        popt.fused_rule(name)               # the plain rule exists


def test_sgld_update_has_the_reference_distribution():
    """``w' - w = -lr/2 (g + wd w) + N(0, lr)``: the noise's mean and
    variance over 20,000 elements within 5 standard errors, in both
    packages."""
    n, lr, wd = 20000, 0.04, 0.1
    rng = np.random.RandomState(3)
    w0 = rng.randn(n).astype(np.float32)
    g = rng.randn(n).astype(np.float32)
    drift = -lr / 2 * (g + wd * w0)
    mt.random.seed(5)
    opt = popt.create("sgld", learning_rate=lr, wd=wd)
    w = torch.from_numpy(w0.copy())
    opt.update(0, w, torch.from_numpy(g), opt.create_state(0, w))
    jmx.random.seed(5)
    jo = jopt.create("sgld", learning_rate=lr, wd=wd)
    jw = jmx.nd.array(w0)
    jo.update(0, jw, jmx.nd.array(g), jo.create_state(0, jw))
    for what, new in (("port", w.numpy()), ("jax", jw.asnumpy())):
        noise = new.astype(np.float64) - w0 - drift
        se_mean = np.sqrt(lr / n)
        se_var = lr * np.sqrt(2.0 / (n - 1))
        assert abs(noise.mean()) <= 5 * se_mean, what
        assert abs(noise.var(ddof=1) - lr) <= 5 * se_var, what


@pytest.mark.parametrize("name,kw", [
    ("adam", {"learning_rate": 1e-2}),
    ("lamb", {"learning_rate": 1e-2, "wd": 0.01}),
    ("rmsprop", {"centered": True}),
    ("rmsprop", {}),
    ("sgd", {"momentum": 0.9})])
def test_updater_states_cross_the_packages(name, kw):
    """Two updates in one package, its ``get_states`` loaded by the
    other's ``Updater``, one more update on each side from there: the
    same weights."""
    ws = _weights()
    jup = jopt.get_updater(jopt.create(name, **kw))
    pup = popt.get_updater(popt.create(name, **kw))
    jw = [jmx.nd.array(w) for w in ws]
    pw = [torch.from_numpy(w.copy()) for w in ws]
    for step in range(2):
        for i, g in enumerate(_grads(step)):
            jup(i, jmx.nd.array(g), jw[i])
            pup(i, torch.from_numpy(g), pw[i])
    jblob, pblob = jup.get_states(), pup.get_states()
    jserial, _ = pickle.loads(jblob)
    pserial, _ = pickle.loads(pblob)
    assert sorted(jserial) == sorted(pserial)
    # the other package's state, one more update each
    jup2 = jopt.get_updater(jopt.create(name, **kw))
    jup2.set_states(pblob)
    jup2.optimizer._index_update_count = dict(
        pup.optimizer._index_update_count)
    pup2 = popt.get_updater(popt.create(name, **kw))
    pup2.set_states(jblob)
    pup2.optimizer._index_update_count = dict(
        jup.optimizer._index_update_count)
    jw2 = [jmx.nd.array(w.numpy().copy()) for w in pw]
    pw2 = [torch.from_numpy(np.array(w.asnumpy())) for w in jw]
    for i, g in enumerate(_grads(2)):
        jup(i, jmx.nd.array(g), jw[i])
        pup(i, torch.from_numpy(g), pw[i])
        jup2(i, jmx.nd.array(g), jw2[i])
        pup2(i, torch.from_numpy(g), pw2[i])
    for i in range(len(ws)):
        _close(np.array(jw2[i].asnumpy()), pw[i].numpy(), f"port->jax {i}")
        _close(pw2[i].numpy(), np.array(jw[i].asnumpy()), f"jax->port {i}")


# ----------------------------------------------------------------------
# the update ops
# ----------------------------------------------------------------------

def _arrays(n, seed, shape=(5, 3), positive=()):
    rng = np.random.RandomState(seed)
    out = [rng.randn(*shape).astype(np.float32) for _ in range(n)]
    for i in positive:
        out[i] = np.abs(out[i]) + 0.1
    return out


_HP = {"wd": 0.01, "rescale_grad": 0.7, "clip_gradient": 0.9}
# name -> (arrays, positive indices, kwargs, indices of the state
# arguments updated in place); arrays are weight, grad, then state
OPS = {
    "sgd_update": (2, (), dict(lr=0.1, **_HP), ()),
    "sgd_mom_update": (3, (), dict(lr=0.1, momentum=0.9, **_HP), (2,)),
    "sgd_mom_update-nomom": (3, (), dict(lr=0.1, **_HP), (2,)),
    "nag_mom_update": (3, (), dict(lr=0.1, momentum=0.9, **_HP), (2,)),
    "adam_update": (4, (3,), dict(lr=0.01, **_HP), (2, 3)),
    "signsgd_update": (2, (), dict(lr=0.1, **_HP), ()),
    "signum_update": (3, (), dict(lr=0.1, momentum=0.9, wd_lh=0.01, **_HP),
                      (2,)),
    "rmsprop_update": (3, (2,), dict(lr=0.01, clip_weights=1.2, **_HP),
                       (2,)),
    "rmspropalex_update": (5, (2,), dict(lr=0.01, clip_weights=1.2, **_HP),
                           (2, 3, 4)),
    "ftrl_update": (4, (3,), dict(lr=0.1, **_HP), (2, 3)),
    "adagrad_update": (3, (2,), dict(lr=0.1, **_HP), (2,)),
    "ftml_update": (5, (2, 3), dict(lr=0.1, t=3, wd=0.01, rescale_grad=0.7,
                                    clip_grad=0.9), (2, 3, 4)),
    "adamax_update": (4, (3,), dict(lr=0.01, **_HP), (2, 3)),
    "nadam_update": (4, (3,), dict(lr=0.01, t=4, **_HP), (2, 3)),
}
MP_OPS = {
    "mp_sgd_update": (dict(lr=0.1, **_HP), ()),
    "mp_sgd_mom_update": (dict(lr=0.1, momentum=0.9, **_HP), ("mom",)),
    "mp_nag_mom_update": (dict(lr=0.1, momentum=0.9, **_HP), ("mom",)),
}


def _both(arrays, dtype=None):
    j = [jmx.nd.array(a, dtype=dtype or str(a.dtype)) for a in arrays]
    with mt.cpu():
        p = [mt.nd.array(a, dtype=dtype or str(a.dtype)) for a in arrays]
    return j, p


@pytest.mark.parametrize("case", sorted(OPS))
def test_update_op_matches_jax(case):
    name = case.split("-")[0]
    n, positive, kw, states = OPS[case]
    arrays = _arrays(n, sum(map(ord, case)), positive=positive)
    if name == "rmspropalex_update":
        # a running mean square above the running mean's square
        arrays[2] += 1.0
        arrays[3] *= 0.1
    j, p = _both(arrays)
    jout = getattr(jmx.nd, name)(*j, **kw)
    pout = getattr(mt.nd, name)(*p, **kw)
    assert pout is p[0]
    _close(pout.asnumpy(), np.array(jout.asnumpy()), f"{case} weight")
    for i in states:
        _close(p[i].asnumpy(), np.array(j[i].asnumpy()), f"{case} state {i}")
    # out= takes the new weight and leaves the weight alone
    j2, p2 = _both(arrays)
    with mt.cpu():
        out = mt.nd.zeros(arrays[0].shape)
    assert getattr(mt.nd, name)(*p2, out=out, **kw) is out
    _close(out.asnumpy(), np.array(jout.asnumpy()), f"{case} out=")
    np.testing.assert_array_equal(p2[0].asnumpy(), arrays[0])


@pytest.mark.parametrize("name", sorted(MP_OPS))
def test_mixed_precision_update_op_matches_jax(name):
    kw, extra = MP_OPS[name]
    w32, g, mom = _arrays(3, 7)
    arrays16 = [w32.astype(np.float16), g.astype(np.float16)]
    j, p = _both(arrays16)
    js, ps = _both([mom] * len(extra) + [w32])
    getattr(jmx.nd, name)(*j, *js, **kw)
    getattr(mt.nd, name)(*p, *ps, **kw)
    for a, b, what in zip(ps + p[:1], js + j[:1], list(extra) +
                          ["weight32", "weight"]):
        _close(a.asnumpy().astype(np.float32),
               np.array(b.asnumpy()).astype(np.float32), f"{name} {what}")
    assert p[0].dtype == np.float16


@pytest.mark.parametrize("mp", [False, True], ids=["f32", "mp"])
def test_lamb_phases_match_jax(mp):
    w, g, m, v = _arrays(4, 11, positive=(3,))
    kw1 = dict(t=3, beta1=0.9, beta2=0.99, epsilon=1e-6, wd=0.01,
               rescale_grad=0.5, clip_gradient=0.9)
    if mp:
        j, p = _both([w.astype(np.float16), g.astype(np.float16)])
        js, ps = _both([m, v, w])
        jd = jmx.nd.mp_lamb_update_phase1(*j, *js, **kw1)
        pd = mt.nd.mp_lamb_update_phase1(*p, *ps, **kw1)
    else:
        j, p = _both([w, g])
        js, ps = _both([m, v])
        jd = jmx.nd.lamb_update_phase1(*j, *js, **kw1)
        pd = mt.nd.lamb_update_phase1(*p, *ps, **kw1)
    _close(pd.asnumpy(), np.array(jd.asnumpy()), "phase 1 direction")
    for a, b in zip(ps[:2], js[:2]):
        _close(a.asnumpy(), np.array(b.asnumpy()), "phase 1 moments")
    # the norms of the weight and the direction, as multi_sum_sq gives them
    w32 = js[2] if mp else j[0]
    jr = jmx.nd.multi_sum_sq(w32, jd, num_arrays=2)
    pr = mt.nd.multi_sum_sq(ps[2] if mp else p[0], pd, num_arrays=2)
    _close(pr.asnumpy(), np.array(jr.asnumpy()), "multi_sum_sq")
    jr1, jr2 = (jmx.nd.array(np.sqrt(jr.asnumpy()[k:k + 1])) for k in (0, 1))
    with mt.cpu():
        pr1, pr2 = (mt.nd.array(np.sqrt(pr.asnumpy()[k:k + 1]))
                    for k in (0, 1))
    kw2 = dict(lr=0.01, lower_bound=0.5, upper_bound=3.0)
    if mp:
        jmx.nd.mp_lamb_update_phase2(j[0], jd, jr1, jr2, js[2], **kw2)
        mt.nd.mp_lamb_update_phase2(p[0], pd, pr1, pr2, ps[2], **kw2)
        _close(ps[2].asnumpy(), np.array(js[2].asnumpy()), "phase 2 master")
    else:
        jmx.nd.lamb_update_phase2(j[0], jd, jr1, jr2, **kw2)
        mt.nd.lamb_update_phase2(p[0], pd, pr1, pr2, **kw2)
    _close(p[0].asnumpy().astype(np.float32),
           np.array(j[0].asnumpy()).astype(np.float32), "phase 2 weight")


MULTI = {
    "multi_sgd_update": (2, (), {}),
    "multi_sgd_mom_update": (3, (), {"momentum": 0.8}),
    "multi_lamb_update": (4, (3,), {"step": 3, "lower_bound": 0.2,
                                    "upper_bound": 5.0}),
}


@pytest.mark.parametrize("name", sorted(MULTI))
def test_multi_update_op_matches_jax(name):
    per, positive, kw = MULTI[name]
    groups = [_arrays(per, 20 + k, shape=s, positive=positive)
              for k, s in enumerate([(4, 3), (6,)])]
    flat = [a for grp in groups for a in grp]
    j, p = _both(flat)
    hyper = dict(lrs=[0.1, 0.05], wds=[0.01, 0.0], rescale_grad=0.5,
                 clip_gradient=0.9, **kw)
    getattr(jmx.nd, name)(*j, **hyper)
    out = getattr(mt.nd, name)(*p, **hyper)
    assert [o is p[k * per] for k, o in enumerate(out)] == [True, True]
    for i, (a, b) in enumerate(zip(p, j)):
        if i % per != 1:             # the gradients stay as they are
            _close(a.asnumpy(), np.array(b.asnumpy()), f"{name} array {i}")


@pytest.mark.parametrize("name,per,extra", [
    ("multi_mp_sgd_update", 3, {}),
    ("multi_mp_sgd_mom_update", 4, {"momentum": 0.8}),
    ("preloaded_multi_sgd_update", 2, {}),
    ("preloaded_multi_sgd_mom_update", 3, {"momentum": 0.8}),
    ("preloaded_multi_mp_sgd_update", 3, {}),
    ("preloaded_multi_mp_sgd_mom_update", 4, {"momentum": 0.8})])
def test_multi_mixed_precision_and_preloaded_ops_match_jax(name, per, extra):
    mp = "_mp_" in name
    j, p = [], []
    for k in range(2):
        w, g, m = _arrays(3, 30 + k)
        grp = [w.astype(np.float16) if mp else w,
               g.astype(np.float16) if mp else g]
        grp += [m] if per - len(grp) - mp else []
        grp += [w] if mp else []
        jj, pp = _both(grp)
        j += jj
        p += pp
    hyper = dict(rescale_grad=0.5, clip_gradient=0.9, **extra)
    lrs, wds = [0.1, 0.05], [0.01, 0.0]
    if name.startswith("preloaded"):
        jl, pl = _both([np.array(lrs, np.float32), np.array(wds, np.float32)])
        getattr(jmx.nd, name)(*j, *jl, **hyper)
        getattr(mt.nd, name)(*p, *pl, **hyper)
    else:
        getattr(jmx.nd, name)(*j, lrs=lrs, wds=wds, **hyper)
        getattr(mt.nd, name)(*p, lrs=lrs, wds=wds, **hyper)
    for i, (a, b) in enumerate(zip(p, j)):
        if i % per != 1:
            _close(a.asnumpy().astype(np.float32),
                   np.array(b.asnumpy()).astype(np.float32),
                   f"{name} array {i}")


def test_norm_and_finiteness_ops_match_jax():
    a, b = _arrays(2, 40)
    lrs = np.array([0.1, 0.2], np.float32)
    j, p = _both([a, b, lrs])
    _close(mt.nd.multi_sum_sq(p[0], p[1]).asnumpy(),
           np.array(jmx.nd.multi_sum_sq(j[0], j[1]).asnumpy()),
           "multi_sum_sq")
    wss = np.array([4.0, 0.0], np.float32)
    gss = np.array([1.0, 9.0], np.float32)
    wds = np.array([0.01, 0.02], np.float32)
    jx = jmx.nd.multi_lars(j[2], jmx.nd.array(wss), jmx.nd.array(gss),
                           jmx.nd.array(wds), eta=0.01, eps=1e-6,
                           rescale_grad=0.5)
    with mt.cpu():
        px = mt.nd.multi_lars(p[2], mt.nd.array(wss), mt.nd.array(gss),
                              mt.nd.array(wds), eta=0.01, eps=1e-6,
                              rescale_grad=0.5)
    _close(px.asnumpy(), np.array(jx.asnumpy()), "multi_lars")
    bad = a.copy()
    bad[1, 1] = np.inf
    jbad, pbad = _both([bad])
    for arrays_j, arrays_p in (([j[0]], [p[0]]), (jbad, pbad),
                               ([j[0], jbad[0]], [p[0], pbad[0]])):
        want = np.array(jmx.nd.multi_all_finite(*arrays_j).asnumpy())
        np.testing.assert_array_equal(
            mt.nd.multi_all_finite(*arrays_p).asnumpy(), want)
        np.testing.assert_array_equal(
            mt.nd.all_finite(arrays_p[-1]).asnumpy(),
            np.array(jmx.nd.all_finite(arrays_j[-1]).asnumpy()))
    mt.nd.reset_arrays(p[0], p[1], num_arrays=2)
    assert not p[0].asnumpy().any() and not p[1].asnumpy().any()


def test_every_optimizer_op_is_ported():
    names = set(OPS) | set(MP_OPS) | set(MULTI) | {
        "lamb_update_phase1", "lamb_update_phase2", "mp_lamb_update_phase1",
        "mp_lamb_update_phase2", "multi_mp_sgd_update",
        "multi_mp_sgd_mom_update", "preloaded_multi_sgd_update",
        "preloaded_multi_sgd_mom_update", "preloaded_multi_mp_sgd_update",
        "preloaded_multi_mp_sgd_mom_update", "multi_sum_sq", "multi_lars",
        "all_finite", "multi_all_finite", "reset_arrays"}
    names = {n.split("-")[0] for n in names}
    assert len(names) == 34
    for n in names:
        assert n in mt.nd.ops._OPS, n
        assert callable(getattr(mt.nd, n))
