"""Sparse storage and row-sparse gradients (``ndarray/sparse.py``, the
sparse ``Embedding``, ``Parameter(grad_stype=)``, the lazy SGD and Adam,
the Trainer's per-parameter path for them, ``nd.save``/``nd.load``)
against the JAX package, on the CPU.

The reference's ``tests/test_sparse.py`` cases, kvstore's
``row_sparse_pull`` and sparse push included (one process, the local
store; two ranks over the dist store in ``test_torch_port_kvstore.py``),
each run through both packages on the same numpy inputs (fixed
``RandomState`` seeds).  Tolerances:

- exact for storage (indices, values, densified views, retained rows,
  pickles and files), for gathered and summed gradient rows (sums of
  ones or of the same few values in the same order), for rows an update
  does not touch, and for the lazy updates' weights and moments (the
  same f32 operations in the same order: the update of a row is
  elementwise);
- 1e-6 relative (1e-7 absolute) for ``dot(csr, dense)``, a segment sum
  taken in another order;
- 1e-5 of the Frobenius norm for the rules that densify (the reference
  runs them through its jitted kernels, as ``test_torch_port_optimizers``
  holds them) and for whole nets trained with Adam (the Trainer's bucket
  and ``DataParallelTrainer``).

Draws of the reference's global key are seeded (``seeded``), so each
test holds the same values in any order.
"""
import contextlib
import pickle

import numpy as np
import pytest
import torch

import mxnet_tpu as jmx
from mxnet_tpu import autograd as jautograd, gluon as jgluon
from mxnet_tpu import optimizer as jopt
from mxnet_tpu.gluon import nn as jnn
from mxnet_tpu.ndarray import sparse as jsp

import mxnet_tpu_torch as mx
from mxnet_tpu_torch import MXNetError, autograd, gluon, optimizer as opt
from mxnet_tpu_torch.gluon import nn
from mxnet_tpu_torch.ndarray import sparse as sp

RNG = np.random.RandomState(23)
DENSE = np.zeros((4, 3), np.float32)
DENSE[1] = [1, 2, 3]
DENSE[3] = [4, 5, 6]


@contextlib.contextmanager
def seeded(seed):
    """The reference's global key and numpy's global generator seeded,
    both restored after (the amp parity test on the same xdist worker
    depends on them)."""
    key, state = jmx.random.get_key_data(), np.random.get_state()
    jmx.random.seed(seed)
    np.random.seed(seed)
    try:
        yield
    finally:
        jmx.random.set_key_data(key)
        np.random.set_state(state)


@pytest.fixture(autouse=True)
def _keep_the_global_generators():
    """Both packages' global generators as they were after each test
    (initializers draw from them)."""
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


def _rsp(pkg, dense_np):
    nz = np.where(np.abs(dense_np).sum(1) > 0)[0]
    mod = jsp if pkg is jmx else sp
    return mod.row_sparse_array((dense_np[nz], nz), shape=dense_np.shape)


def test_module_surface_matches_reference():
    assert sp.__all__ == jsp.__all__
    assert mx.nd.sparse is sp


def test_row_sparse_create_and_dense():
    with mx.cpu():
        r = _rsp(mx, DENSE)
    j = _rsp(jmx, DENSE)
    assert r.stype == j.stype == "row_sparse"
    assert r.shape == j.shape and str(r.dtype) == str(j.dtype)
    for got, want in ((r, j), (r.indices, j.indices), (r.values, j.values)):
        np.testing.assert_array_equal(got.asnumpy(), want.asnumpy())
    assert str(r.indices.dtype) == str(j.indices.dtype) == "int32"
    with mx.cpu():
        from_dense = sp.row_sparse_array(DENSE)
    np.testing.assert_array_equal(from_dense.indices.asnumpy(), [1, 3])


def test_csr_create_and_dense():
    dense = np.array([[0, 1, 0], [2, 0, 3]], np.float32)
    with mx.cpu():
        c = sp.csr_matrix(dense)
        t = sp.csr_matrix((np.array([1, 2, 3], np.float32),
                           np.array([1, 0, 2]), np.array([0, 1, 3])),
                          shape=(2, 3))
    j = jsp.csr_matrix(dense)
    assert c.stype == "csr"
    for got in (c, t):
        np.testing.assert_array_equal(got.asnumpy(), dense)
        np.testing.assert_array_equal(got.indptr.asnumpy(),
                                      j.indptr.asnumpy())
        np.testing.assert_array_equal(got.indices.asnumpy(),
                                      j.indices.asnumpy())
        np.testing.assert_array_equal(got.values.asnumpy(),
                                      j.values.asnumpy())


def test_cast_storage_roundtrip():
    dense = np.zeros((4, 3), np.float32)
    dense[2] = 7
    with mx.cpu():
        r = _rsp(mx, dense)
        np.testing.assert_array_equal(r.tostype("default").asnumpy(), dense)
        assert r.tostype("row_sparse") is r
        c = sp.csr_matrix(dense)
        np.testing.assert_array_equal(c.tostype("default").asnumpy(), dense)
        d = mx.nd.array(dense)
        for stype in ("row_sparse", "csr", "default"):
            got = sp.cast_storage(d, stype)
            assert got.stype == stype
            np.testing.assert_array_equal(got.asnumpy(), dense)
        with pytest.raises(MXNetError, match="cannot convert"):
            r.tostype("csr")


def test_sparse_retain():
    dense = np.arange(12, dtype=np.float32).reshape(4, 3)
    with mx.cpu():
        kept = sp.retain(_rsp(mx, dense), mx.nd.array([0, 2]))
    want = jsp.retain(_rsp(jmx, dense), jmx.nd.array([0, 2]))
    np.testing.assert_array_equal(kept.asnumpy(), want.asnumpy())
    np.testing.assert_array_equal(kept.indices.asnumpy(),
                                  want.indices.asnumpy())


def test_sparse_dot_csr_dense():
    dense_a = np.array([[0, 1, 0], [2, 0, 3]], np.float32)
    b = RNG.randn(3, 4).astype(np.float32)
    with mx.cpu():
        out = sp.dot(sp.csr_matrix(dense_a), mx.nd.array(b))
        out_t = sp.dot(sp.csr_matrix(dense_a), mx.nd.array(b.T.copy()),
                       transpose_b=True)
        dense_path = sp.dot(mx.nd.array(dense_a), mx.nd.array(b))
    want = jsp.dot(jsp.csr_matrix(dense_a), jmx.nd.array(b)).asnumpy()
    for got in (out, out_t, dense_path):
        np.testing.assert_allclose(got.asnumpy(), want, rtol=1e-6,
                                   atol=1e-7)


def test_sparse_elemwise_add():
    dense = np.zeros((4, 3), np.float32)
    dense[1] = 2
    with mx.cpu():
        out = (_rsp(mx, dense) + mx.nd.array(np.ones((4, 3), np.float32)))
    np.testing.assert_array_equal(out.asnumpy(), dense + 1)
    assert out.stype == "default"


def test_sparse_zeros():
    with mx.cpu():
        z = sp.zeros("row_sparse", (3, 4))
        z2 = sp.zeros("csr", (3, 4))
        z3 = sp.zeros("default", (3, 4))
    assert (z.stype, z2.stype, z3.stype) == ("row_sparse", "csr", "default")
    for a in (z, z2, z3):
        np.testing.assert_array_equal(a.asnumpy(), np.zeros((3, 4)))
    assert z.indices.shape == (0,) and z2.indptr.shape == (4,)


def test_sparse_grad_embedding_pattern():
    """A dense-grad Embedding's weight gradient: only touched rows, the
    repeated id summed (the reference's sparse embedding pattern)."""
    w0 = RNG.rand(10, 4).astype(np.float32)
    grads = []
    for pkg in (jmx, mx):
        with mx.cpu():
            w = pkg.nd.array(w0)
            w.attach_grad()
            idx = pkg.nd.array([1, 3, 3])
            with pkg.autograd.record():
                loss = pkg.nd.Embedding(idx, w, input_dim=10,
                                        output_dim=4).sum()
            loss.backward()
            grads.append(w.grad.asnumpy())
    np.testing.assert_array_equal(grads[1], grads[0])
    assert (grads[1][[0, 2, 4, 5, 6, 7, 8, 9]] == 0).all()
    np.testing.assert_array_equal(grads[1][3], 2)


def test_no_densify_on_construction():
    with mx.cpu():
        big = sp.row_sparse_array(
            (np.ones((3, 64), np.float32), np.array([5, 100, 70000])),
            shape=(100000, 64))
        assert big._dense_cache is None
        np.testing.assert_array_equal(big.values.asnumpy(), 1.0)
        assert big._dense_cache is None and big.shape == (100000, 64)
        kept = sp.retain(big, mx.nd.array([5, 70000]))
        assert big._dense_cache is None and kept._dense_cache is None
    np.testing.assert_array_equal(kept.indices.asnumpy(), [5, 70000])


def test_csr_dot_no_densify():
    dense_a = np.zeros((50000, 8), np.float32)
    dense_a[7] = 1.0
    dense_a[499] = 2.0
    b = RNG.randn(8, 4).astype(np.float32)
    with mx.cpu():
        csr = sp.csr_matrix(dense_a)
        out = sp.dot(csr, mx.nd.array(b)).asnumpy()
    assert csr._dense_cache is None
    np.testing.assert_allclose(out[[7, 499]], dense_a[[7, 499]] @ b,
                               rtol=1e-6)
    assert np.abs(out[[0, 1, 49999]]).max() == 0


def _lazy(name, kwargs, w0, rows, vals, lazy, steps=2):
    """Both packages' optimizer ``name`` on a weight with a row-sparse
    gradient, ``steps`` updates; the port's weight and state against the
    reference's, as numpy.  A lazy update densifies neither gradient
    (the reference densifies for its dense rules, the port never)."""
    j_opt = jopt.create(name, **kwargs)
    jw = jmx.nd.array(w0)
    jstate = j_opt.create_state(0, jw)
    p_opt = opt.create(name, **kwargs)
    pw = torch.from_numpy(w0.copy())
    pstate = p_opt.create_state(0, pw)
    for _ in range(steps):
        jg = jsp.row_sparse_array((vals, rows), shape=w0.shape)
        j_opt.update(0, jw, jg, jstate)
        with mx.cpu():
            pg = sp.row_sparse_array((vals, rows), shape=w0.shape)
        p_opt.update(0, pw, pg, pstate)
        assert pg._dense_cache is None
        assert (jg._dense_cache is None) == lazy
    jstate = [] if jstate is None else \
        [s.asnumpy() for s in (jstate if isinstance(jstate, tuple)
                               else (jstate,))]
    return pw.numpy(), [v.numpy() for v in pstate.values()], \
        jw.asnumpy(), jstate


@pytest.mark.parametrize("name,kwargs", [
    ("sgd", {"learning_rate": 0.1}),
    ("sgd", {"learning_rate": 0.1, "wd": 0.01, "rescale_grad": 0.5,
             "clip_gradient": 0.4}),
    ("adam", {"learning_rate": 0.1}),
    ("adam", {"learning_rate": 0.05, "wd": 0.02, "beta1": 0.8,
              "clip_gradient": 1.5}),
    ("sgd", {"learning_rate": 0.1, "momentum": 0.9}),
    ("nag", {"learning_rate": 0.1, "momentum": 0.9}),
    ("adamw", {"learning_rate": 0.1, "wd": 0.01}),
    ("adam", {"learning_rate": 0.1, "lazy_update": False}),
    ("rmsprop", {"learning_rate": 0.01}),
], ids=["sgd-lazy", "sgd-lazy-wd-clip", "adam-lazy", "adam-lazy-wd-clip",
        "sgd-momentum-dense", "nag-dense", "adamw-dense",
        "adam-not-lazy-dense", "rmsprop-dense"])
def test_optimizer_with_row_sparse_gradient(name, kwargs):
    """Lazy SGD (momentum 0) and lazy Adam touch only the gradient's
    rows, bitwise the reference's weight and moments; every other rule
    densifies as the reference does."""
    w0 = RNG.rand(50, 3).astype(np.float32) + 0.5
    rows = np.array([2, 7, 31])
    vals = RNG.randn(3, 3).astype(np.float32)
    lazy = name in ("sgd", "adam") and not kwargs.get("momentum") and \
        kwargs.get("lazy_update", True)
    pw, ps, jw, js = _lazy(name, kwargs, w0, rows, vals, lazy)
    if lazy:
        np.testing.assert_array_equal(pw, jw)
        for p, j in zip(ps, js):
            np.testing.assert_array_equal(p, j)
        others = np.setdiff1d(np.arange(50), rows)
        np.testing.assert_array_equal(pw[others], w0[others])
        for p in ps:
            assert not p[others].any()
    else:
        for p, j in [(pw, jw)] + list(zip(ps, js)):
            assert np.linalg.norm(p - j) <= 1e-5 * np.linalg.norm(j)


def _emb_nets(vocab, dim, w0, sparse_grad=True):
    jnet = jnn.Embedding(vocab, dim, sparse_grad=sparse_grad)
    jnet.initialize()
    jnet.weight.set_data(jmx.nd.array(w0))
    net = nn.Embedding(vocab, dim, sparse_grad=sparse_grad)
    net.initialize(ctx=mx.cpu())
    net.weight.set_data(w0)
    return jnet, net


@pytest.mark.parametrize("rule,args", [
    ("sgd", {"learning_rate": 0.5}),
    ("adam", {"learning_rate": 0.05, "wd": 0.01}),
])
def test_embedding_sparse_grad_trains_like_reference(rule, args):
    """``nn.Embedding(sparse_grad=True)`` through ``gluon.Trainer``: a
    row-sparse gradient of the touched rows (never densified), the lazy
    update; the weight and Adam's moments bitwise the reference's after
    three steps, untouched rows bitwise unchanged."""
    vocab, dim = 2000, 8
    w0 = RNG.randn(vocab, dim).astype(np.float32)
    jnet, net = _emb_nets(vocab, dim, w0)
    jtr = jgluon.Trainer(jnet.collect_params(), rule, dict(args))
    tr = gluon.Trainer(net.collect_params(), rule, dict(args))
    batches = [np.array([[3, 3, 7], [1999, 0, 3]]),
               np.array([[5, 7, 7], [5, 5, 5]]), np.array([[3, 11, 3]])]
    touched = np.unique(np.concatenate([b.ravel() for b in batches]))
    heads = [RNG.randn(*b.shape, dim).astype(np.float32) for b in batches]
    for b, h in zip(batches, heads):
        with jautograd.record():
            jl = (jnet(jmx.nd.array(b)) * jmx.nd.array(h)).sum()
        jl.backward()
        jtr.step(2)
        with mx.cpu():
            with autograd.record():
                pl = (net(mx.nd.array(b)) * mx.nd.array(h)).sum()
            pl.backward()
            g = net.weight.grad()
            assert g.stype == "row_sparse" and g._dense_cache is None
            np.testing.assert_array_equal(g.indices.asnumpy(), np.unique(b))
            tr.step(2)
    got = net.weight.data().asnumpy()
    np.testing.assert_array_equal(got, jnet.weight.data().asnumpy())
    untouched = np.setdiff1d(np.arange(vocab), touched)
    np.testing.assert_array_equal(got[untouched], w0[untouched])
    if rule == "adam":
        jm, jv = jtr._states[0]
        st = tr._states[0]
        np.testing.assert_array_equal(st["m"].numpy(), jm.asnumpy())
        np.testing.assert_array_equal(st["v"].numpy(), jv.asnumpy())
        assert not st["m"].numpy()[untouched].any()


def test_sparse_param_stays_out_of_the_flat_bucket():
    """A net of a sparse Embedding and two Dense layers: the Embedding's
    weight takes the lazy per-parameter update, the Dense parameters the
    flat bucket (updated in place); the net matches the reference."""
    jnet = jnn.HybridSequential()
    jnet.add(jnn.Embedding(40, 6, sparse_grad=True), jnn.Dense(5),
             jnn.Dense(2))
    with seeded(3):
        jnet.initialize(jmx.init.Xavier())
    ids = np.array([[1, 5, 5, 9], [0, 1, 2, 3]])
    jnet(jmx.nd.array(ids))
    weights = {k: p.data().asnumpy()
               for k, p in jnet._collect_params_with_prefix().items()}
    net = nn.HybridSequential()
    net.add(nn.Embedding(40, 6, sparse_grad=True), nn.Dense(5), nn.Dense(2))
    net.initialize(ctx=mx.cpu())
    with mx.cpu():
        net(mx.nd.array(ids))
    from mxnet_tpu_torch.convert import load_block_weights
    load_block_weights(net, weights)
    args = {"learning_rate": 0.1}
    jtr = jgluon.Trainer(jnet.collect_params(), "adam", dict(args))
    tr = gluon.Trainer(net.collect_params(), "adam", dict(args))
    for _ in range(2):
        with jautograd.record():
            jl = jnet(jmx.nd.array(ids)).sum()
        jl.backward()
        jtr.step(1)
        with mx.cpu(), autograd.record():
            pl = net(mx.nd.array(ids)).sum()
        pl.backward()
        tr.step(1)
    emb = net[0].weight._var
    assert all(emb.data_ptr() != v.data_ptr() for _, v in tr._in_buffer)
    assert len(tr._in_buffer) == 4 and tr._flat_idx == tr._bucketable()
    _match_norms(net, jnet)


def _match_norms(net, jnet):
    """Every parameter within 1e-5 of the reference's in the Frobenius
    norm (Adam maps rounding-noise gradients to steps of up to lr, so not
    element by element; as ``test_torch_port_data_parallel.py``)."""
    jp = jnet._collect_params_with_prefix()
    for k, p in net._collect_params_with_prefix().items():
        got, want = p.data().asnumpy(), jp[k].data().asnumpy()
        assert np.linalg.norm(got - want) <= 1e-5 * np.linalg.norm(want), k


def test_embedding_sparse_grad_matches_dense():
    w0 = np.random.RandomState(0).randn(20, 4).astype(np.float32)
    outs = {}
    for sparse_grad in (False, True):
        net = nn.Embedding(20, 4, sparse_grad=sparse_grad)
        net.initialize(ctx=mx.cpu())
        net.weight.set_data(w0)
        with mx.cpu():
            x = mx.nd.array(np.array([[1, 5], [5, 2]]))
            with autograd.record():
                loss = (net(x) * net(x)).sum()
            loss.backward()
        g = net.weight.grad()
        outs[sparse_grad] = g.asnumpy() if g.stype == "default" else \
            g.tostype("default").asnumpy()
    np.testing.assert_array_equal(outs[False], outs[True])


def test_embedding_sparse_grad_device_side_duplicates():
    """The pullback carries the raw ids; duplicates sum when the gradient
    is read, as in the reference; ``stype="row_sparse"`` gives None
    before a backward; ``autograd.grad`` returns the sparse array."""
    w0 = RNG.rand(10, 4).astype(np.float32)
    ids_np = np.array([[1, 1], [2, 1]], np.float32)
    with mx.cpu():
        w = mx.nd.array(w0)
        w.attach_grad(stype="row_sparse")
        assert w.grad is None
        ids = mx.nd.array(ids_np)
        with autograd.record():
            loss = mx.nd.Embedding(ids, w, input_dim=10, output_dim=4,
                                   sparse_grad=True).sum()
        loss.backward()
        g = w.grad
        with autograd.record():
            loss2 = mx.nd.Embedding(ids, w, input_dim=10, output_dim=4,
                                    sparse_grad=True).sum()
        g2 = autograd.grad(loss2, w)
    jw = jmx.nd.array(w0)
    jw.attach_grad(stype="row_sparse")
    with jautograd.record():
        jl = jmx.nd.Embedding(jmx.nd.array(ids_np), jw, input_dim=10,
                              output_dim=4, sparse_grad=True).sum()
    jl.backward()
    for got in (g, g2):
        assert isinstance(got, sp.RowSparseNDArray)
        np.testing.assert_array_equal(got.indices.asnumpy(),
                                      jw.grad.indices.asnumpy())
        np.testing.assert_array_equal(got.values.asnumpy(),
                                      jw.grad.values.asnumpy())
    np.testing.assert_array_equal(g.values.asnumpy()[0], 3.0)


def test_grad_req_add_and_zero_grad():
    """``grad_req="add"`` sums two backwards: densely on a default
    variable (the reference's dense buffer), row-sparse on a
    ``"row_sparse"`` one; ``zero_grad`` drops a sparse gradient."""
    w0 = RNG.rand(10, 4).astype(np.float32)
    got = {}
    for stype in (None, "row_sparse"):
        with mx.cpu():
            w = mx.nd.array(w0)
            w.attach_grad("add", stype=stype)
            for ids in ([1, 2], [2, 5]):
                with autograd.record():
                    mx.nd.Embedding(mx.nd.array(ids), w, sparse_grad=True) \
                        .sum().backward()
        got[stype] = w.grad
    assert got[None].stype == "default"
    assert got["row_sparse"].stype == "row_sparse"
    np.testing.assert_array_equal(got["row_sparse"].indices.asnumpy(),
                                  [1, 2, 5])
    np.testing.assert_array_equal(got[None].asnumpy(),
                                  got["row_sparse"].asnumpy())
    assert got[None].asnumpy()[2, 0] == 2.0
    net = nn.Embedding(10, 4, sparse_grad=True)
    net.initialize(ctx=mx.cpu())
    with mx.cpu(), autograd.record():
        net(mx.nd.array([1, 2])).sum().backward()
    assert net.weight.grad().stype == "row_sparse"
    net.weight.zero_grad()
    assert net.weight.grad() is None


def test_embedding_sparse_grad_survives_hybridize():
    """A hybridized block keeps the O(nnz) gradient (on the card its
    captured backward carries the raw pair out of the graph)."""
    net = nn.HybridSequential()
    net.add(nn.Embedding(50, 8, sparse_grad=True))
    net.add(nn.Dense(3, flatten=False))
    net.initialize(ctx=mx.cpu())
    net.hybridize()
    with mx.cpu():
        ids = mx.nd.array(np.array([[3, 7, 3]], np.float32))
        for _ in range(2):
            with autograd.record():
                loss = net(ids).sum()
            loss.backward()
            g = net[0].weight.grad()
            assert isinstance(g, sp.RowSparseNDArray)
            assert g.values.shape[0] <= 3
        assert net(ids).shape == (1, 3, 3)


def test_data_parallel_trainer_trains_a_sparse_embedding_densely():
    """``DataParallelTrainer`` with an ``Embedding(sparse_grad=True)``:
    dense gradients and the dense rule, as the reference's functional
    step (its traced ops record no row-sparse pullback)."""
    from mxnet_tpu_torch import parallel
    from mxnet_tpu.parallel import DataParallelTrainer as JTrainer
    from mxnet_tpu.parallel import make_mesh as jmake_mesh
    import jax
    jnet = jnn.HybridSequential()
    jnet.add(jnn.Embedding(30, 6, sparse_grad=True), jnn.Dense(3))
    with seeded(4):
        jnet.initialize(jmx.init.Xavier())
    ids = np.array([[1, 4, 4], [7, 1, 0]], np.float32)
    label = np.array([0, 2], np.float32)
    jnet(jmx.nd.array(ids))
    weights = {k: p.data().asnumpy()
               for k, p in jnet._collect_params_with_prefix().items()}
    net = nn.HybridSequential()
    net.add(nn.Embedding(30, 6, sparse_grad=True), nn.Dense(3))
    net.initialize(ctx=mx.cpu())
    from mxnet_tpu_torch.convert import load_block_weights
    with mx.cpu():
        net(mx.nd.array(ids))
    load_block_weights(net, weights)
    args = {"learning_rate": 0.1}
    jtr = JTrainer(jnet, jgluon.loss.SoftmaxCrossEntropyLoss(), "sgd",
                   dict(args), mesh=jmake_mesh({"dp": 1},
                                               devices=jax.devices()[:1]))
    with mx.cpu():
        mesh = parallel.make_mesh({"dp": 1})
    tr = parallel.DataParallelTrainer(
        net, gluon.loss.SoftmaxCrossEntropyLoss(), "sgd", dict(args),
        mesh=mesh)
    for _ in range(2):
        jl = jtr.step(jmx.nd.array(ids), jmx.nd.array(label))
        pl = tr.step(ids, label)
        np.testing.assert_allclose(pl.asnumpy(), jl.asnumpy(), rtol=1e-5)
    _match_norms(net, jnet)


def test_sparse_pickle_preserves_stype():
    dense = np.array([[0, 1, 0], [2, 0, 3], [0, 0, 4]], np.float32)
    with mx.cpu():
        c2 = pickle.loads(pickle.dumps(sp.csr_matrix(dense)))
        r = sp.row_sparse_array((np.array([[1., 2.], [3., 4.]]),
                                 np.array([0, 2])), shape=(4, 2))
        r2 = pickle.loads(pickle.dumps(r))
    assert isinstance(c2, sp.CSRNDArray) and isinstance(
        r2, sp.RowSparseNDArray)
    np.testing.assert_array_equal(c2.asnumpy(), dense)
    np.testing.assert_array_equal(r2.indices.asnumpy(), [0, 2])
    np.testing.assert_array_equal(r2.asnumpy(), r.asnumpy())
    assert str(r2.dtype) == "float32"


@pytest.mark.parametrize("writer", ["reference", "port"])
def test_nd_save_load_crosses_packages(tmp_path, writer):
    """A container of a row_sparse, a csr and a dense record written by
    either package loads in both, each record with its storage type and
    compressed form."""
    dense = np.array([[0, 1], [2, 0], [0, 0]], np.float32)
    path = str(tmp_path / "mixed.params")
    if writer == "reference":
        jmx.nd.save(path, {"r": jsp.row_sparse_array(dense),
                           "c": jsp.csr_matrix(dense),
                           "w": jmx.nd.ones((2, 2))})
    else:
        with mx.cpu():
            mx.nd.save(path, {"r": sp.row_sparse_array(dense),
                              "c": sp.csr_matrix(dense),
                              "w": mx.nd.ones((2, 2))})
    with mx.cpu():
        out = mx.nd.load(path)
    jout = jmx.nd.load(path)
    for got in (out, jout):
        assert got["r"].stype == "row_sparse" and got["c"].stype == "csr"
        assert got["w"].stype == "default"
        np.testing.assert_array_equal(got["r"].asnumpy(), dense)
        np.testing.assert_array_equal(got["c"].asnumpy(), dense)
        np.testing.assert_array_equal(got["w"].asnumpy(), np.ones((2, 2)))
        np.testing.assert_array_equal(got["r"].indices.asnumpy(), [0, 1])
    assert isinstance(out["r"], sp.RowSparseNDArray)
    assert isinstance(out["c"], sp.CSRNDArray)
    assert type(out["w"]) is mx.nd.NDArray
    np.testing.assert_array_equal(
        mx.nd.utils.load_numpy(open(path, "rb").read())["r"][0], dense)


def test_nd_save_after_dense_write_saves_fresh_values(tmp_path):
    dense = np.array([[0.0, 1.0], [2.0, 0.0]], np.float32)
    path = str(tmp_path / "fresh.params")
    with mx.cpu():
        r = sp.row_sparse_array(dense)
        r += 1.0
        mx.nd.save(path, {"r": r})
        out = mx.nd.load(path)["r"]
    np.testing.assert_array_equal(out.asnumpy(), dense + 1.0)
    np.testing.assert_array_equal(jmx.nd.load(path)["r"].asnumpy(),
                                  dense + 1.0)


def test_kvstore_row_sparse_pull():
    """Reference ``test_kvstore_row_sparse_pull``: the rows asked for,
    sorted and unique, exactly."""
    w = np.random.RandomState(11).rand(20, 4).astype(np.float32)
    got = {}
    for pkg in (jmx, mx):
        with mx.cpu() if pkg is mx else contextlib.nullcontext():
            kv = pkg.kv.create("local")
            kv.init("emb", pkg.nd.array(w))
            out = kv.row_sparse_pull("emb", row_ids=pkg.nd.array([3, 11, 3]))
        assert out.stype == "row_sparse"
        got[pkg] = (out.indices.asnumpy(), out.values.asnumpy())
    np.testing.assert_array_equal(got[mx][0], [3, 11])
    np.testing.assert_array_equal(got[mx][0], got[jmx][0])
    np.testing.assert_array_equal(got[mx][1], got[jmx][1])


def test_kvstore_sparse_push_accumulates():
    """Reference ``test_kvstore_sparse_push_accumulates``: a row-sparse
    push (two copies here, their rows overlapping) replaces the stored
    value with their row sum; the pull is dense, exactly the reference's."""
    rng = np.random.RandomState(12)
    vals = [rng.rand(2, 2).astype(np.float32) for _ in range(2)]
    rows = [np.array([1, 4]), np.array([4, 7])]
    got = {}
    for pkg, mod in ((jmx, jsp), (mx, sp)):
        with mx.cpu() if pkg is mx else contextlib.nullcontext():
            kv = pkg.kv.create("local")
            kv.init("w", pkg.nd.zeros((10, 2)))
            kv.push("w", [mod.row_sparse_array((v, r), shape=(10, 2))
                          for v, r in zip(vals, rows)])
            pulled = pkg.nd.zeros((10, 2))
            kv.pull("w", out=pulled)
        got[pkg] = pulled.asnumpy()
    np.testing.assert_array_equal(got[mx], got[jmx])
    assert np.abs(got[mx][[0, 2, 3, 5, 6, 8, 9]]).max() == 0


def test_sum_duplicate_rows_matches_reference():
    idx = np.array([4, 1, 4, 0, 1, 4], np.int32)
    vals = RNG.randn(6, 3).astype(np.float32)
    ju, js = jsp.sum_duplicate_rows(idx, jmx.nd.array(vals).data)
    pu, ps = sp.sum_duplicate_rows(torch.from_numpy(idx),
                                   torch.from_numpy(vals))
    np.testing.assert_array_equal(pu.numpy(), np.asarray(ju))
    np.testing.assert_allclose(ps.numpy(), np.asarray(js), rtol=1e-6)
    u2, s2 = sp.sum_duplicate_rows(torch.tensor([0, 3], dtype=torch.int32),
                                   torch.ones(2, 3))
    assert u2.tolist() == [0, 3] and s2.shape == (2, 3)
