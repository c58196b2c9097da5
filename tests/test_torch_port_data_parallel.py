"""The port's ``parallel`` (mesh, ``DataParallelTrainer``) against the JAX
package's, on the CPU.

Two nets, each initialized by the reference (deferred shapes resolved by
one forward) and carried into the port by structural name
(``convert.load_block_weights``), train through both packages'
``DataParallelTrainer`` on a one-device CPU mesh with the same numpy
batches (from ``RandomState``), call for call:

- a small Conv/BatchNorm/Dense net, SGD momentum 0.9 at lr 0.1;
- a 2-layer narrow BERT (32 units, 4 heads, vocab 100, L 16, dropout 0,
  ``use_flash=True``), Adam at lr 1e-3, the loss on the sentence head as
  in ``bench.py``'s ``_bench_bert``;
- the rules without a bucket kernel, as the reference's own cases pair
  them (``tests/test_parallel.py:152``): the BERT with LAMB (lr 1e-3, wd
  0.01; its norms per parameter over the flat bucket), the conv net
  with LARS (momentum 0.9, wd 5e-4) and with RMSProp, plain and
  centered (lr 1e-3).

The sequence: three ``step``s, the learning rate halved by
``set_learning_rate`` before the third; ``step_accum(n_micro=2)`` on a
double batch; ``step_multi`` over two batches; ``put_epoch`` and
``step_indexed``.  The reference trains in module fixtures (its jitted
steps compile there), so each test's call stays under the duration
guard.  On the card the same body is captured as a CUDA graph
(``tests/test_torch_port_cuda.py``, ``chip_smoke.py`` phases 16-19).

Tolerances, with their reasons: every loss, and every trainable
parameter after every call, within 1e-5 relative in the Frobenius norm
(f32; the same sums in another order: per-parameter updates in the
reference, one flat bucket here).  Not element by element: Adam maps an
element's gradient of rounding-noise size to a step of up to lr.  The
module runs torch on one thread: on two, the CPU GEMMs (MKL) round by
the buffers' alignment, and two runs of the port in separate processes
then differ by up to 1.25e-5 of a weight's norm after one Adam step; on
one thread the port's result does not move with the alignment.
Parameters whose gradient is zero in exact arithmetic hold only
rounding noise and are held absolutely: BERT's key-projection biases
within 3 lr (Adam's steps on noise, as ``test_torch_port_bert.py``
holds them under AMP), the conv net's conv biases (each feeds a
BatchNorm) within 1e-6 (SGD's).
BatchNorm's running
statistics are not compared to the reference's: its jitted step writes
every parameter back through the update rule, so with a zero gradient
they stay where they were, while the port's advance as the eager loop's
(a standing difference, held by
``test_running_statistics_advance_where_the_reference_keeps_them``).
"""
import ast
import pathlib

import jax
import numpy as np
import pytest
import torch

import mxnet_tpu as jmx
from mxnet_tpu import gluon as jgluon
from mxnet_tpu.gluon.model_zoo.nlp.bert import get_bert_model as jax_bert
from mxnet_tpu.parallel import make_mesh as jmake_mesh
from mxnet_tpu.parallel.data_parallel import DataParallelTrainer as JTrainer

import mxnet_tpu_torch as mx
from mxnet_tpu_torch import gluon, parallel
from mxnet_tpu_torch.base import NotSupportedError
from mxnet_tpu_torch.convert import load_block_weights
from mxnet_tpu_torch.gluon.model_zoo.nlp import get_bert_model

REPO = pathlib.Path(__file__).resolve().parent.parent
RTOL = 1e-5
KEY_BIAS_ATOL = 3 * 1e-3        # BERT's Adam lr, three times
BN_BIAS_ATOL = 1e-6
# RMSProp divides a gradient by the root of its own running square: on
# rounding noise a step moves by up to lr / sqrt(1 - gamma1), whatever
# the noise's size (about 3.2 lr); three calls' worth, as Adam's
RMSPROP_NOISE_ATOL = 3 * 1e-3 / np.sqrt(1 - 0.9)
BN_FED_BIASES = ("0.bias", "4.bias")    # the conv net's convs' biases
B, SIZE, CLASSES = 4, 8, 10
BERT = dict(num_layers=2, units=32, hidden_size=64, num_heads=4,
            vocab_size=100, max_length=16, dropout=0.0, use_flash=True,
            use_decoder=False)
L = 16


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    """The port's CPU GEMMs round alike whatever the buffers' alignment
    (see the module docstring)."""
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


# ----------------------------------------------------------------------
# the nets, the batches and the sequence of calls
# ----------------------------------------------------------------------

def _conv_net(pkg):
    nn = pkg.gluon.nn
    net = nn.HybridSequential(prefix="dpnet_")
    with net.name_scope():
        net.add(nn.Conv2D(8, 3, padding=1), nn.BatchNorm(),
                nn.Activation("relu"), nn.MaxPool2D(2),
                nn.Conv2D(8, 3, padding=1), nn.BatchNorm(),
                nn.Activation("relu"), nn.GlobalAvgPool2D(),
                nn.Dense(CLASSES))
    return net


def _conv_batch(rng, b=B):
    return (rng.rand(b, 3, SIZE, SIZE).astype(np.float32),
            rng.randint(0, CLASSES, (b,)).astype(np.float32))


def _bert_batch(rng, b=B):
    return (rng.randint(0, 100, (b, L)).astype(np.int32),
            rng.randint(0, 2, (b, L)).astype(np.int32),
            rng.randint(0, 2, (b,)).astype(np.int32))


def _bert_loss(pkg):
    ce = pkg.gluon.loss.SoftmaxCrossEntropyLoss()

    def loss_fn(out, label):
        return ce(out[-1], label)
    return loss_fn


CASES = {
    "conv": dict(net=_conv_net, batch=_conv_batch, rule="sgd",
                 params={"learning_rate": 0.1, "momentum": 0.9},
                 loss=lambda pkg: pkg.gluon.loss.SoftmaxCrossEntropyLoss()),
    "bert": dict(net=lambda pkg: (jax_bert if pkg is jmx
                                  else get_bert_model)(**BERT),
                 batch=_bert_batch, rule="adam",
                 params={"learning_rate": 1e-3}, loss=_bert_loss),
}
CASES.update({
    "bert-lamb": dict(CASES["bert"], rule="lamb",
                      params={"learning_rate": 1e-3, "wd": 0.01}),
    "conv-lars": dict(CASES["conv"], rule="lars",
                      params={"learning_rate": 0.1, "momentum": 0.9,
                              "wd": 5e-4}),
    "conv-rmsprop": dict(CASES["conv"], rule="rmsprop",
                         params={"learning_rate": 1e-3},
                         noise_atol=RMSPROP_NOISE_ATOL),
    "conv-rmsprop-centered": dict(CASES["conv"], rule="rmsprop",
                                  params={"learning_rate": 1e-3,
                                          "centered": True},
                                  noise_atol=RMSPROP_NOISE_ATOL),
})


def _batches(case, seed=0):
    rng = np.random.RandomState(seed)
    batch = CASES[case]["batch"]
    return {"b0": batch(rng), "b1": batch(rng), "b2": batch(rng),
            "double": batch(rng, 2 * B), "b4": batch(rng)}


def _params(net, trainable=True):
    return {k: p.data().asnumpy() for k, p in
            net._collect_params_with_prefix().items()
            if (p.grad_req != "null") == trainable}


def _drive(trainer, net, bt):
    """The sequence of calls; ``(losses, trainable parameters)`` after
    each."""
    out = []

    def record(loss):
        out.append((np.asarray(loss.asnumpy(), np.float32).reshape(-1),
                    _params(net)))

    record(trainer.step(*bt["b0"]))
    record(trainer.step(*bt["b1"]))
    trainer.set_learning_rate(trainer.learning_rate / 2)
    record(trainer.step(*bt["b2"]))
    record(trainer.step_accum(*bt["double"], n_micro=2))
    record(trainer.step_multi([bt["b0"], bt["b1"]]))
    if len(bt["b1"]) == 2:   # step_indexed feeds one input and the label
        handle = trainer.put_epoch(*_epoch(bt["b1"], bt["b2"]))
        record(trainer.step_indexed(handle, 1))
    return out


def _epoch(*batches):
    return tuple(np.stack(arrays) for arrays in zip(*batches))


def _jax_net(case, weights=None):
    """The reference's net, initialized, its shapes resolved by one
    forward; ``weights`` (structural name -> numpy) written in."""
    jmx.random.seed(0)
    net = CASES[case]["net"](jmx)
    net.initialize(jmx.init.Xavier(magnitude=2))
    probe = _batches(case, seed=9)["b0"][:-1]
    net(*[jmx.nd.array(x, dtype=str(x.dtype)) for x in probe])
    if weights is not None:
        target = net._collect_params_with_prefix()
        for k, v in weights.items():
            target[k].set_data(jmx.nd.array(v))
    return net


def _port_net(case, weights):
    net = CASES[case]["net"](mx)
    net.initialize(ctx=mx.cpu())
    load_block_weights(net, weights)
    return net


def _jax_trainer(case, net):
    c = CASES[case]
    return JTrainer(net, c["loss"](jmx), c["rule"], dict(c["params"]),
                    mesh=jmake_mesh({"dp": 1}, devices=jax.devices()[:1]))


def _port_trainer(case, net):
    c = CASES[case]
    with mx.cpu():
        mesh = parallel.make_mesh({"dp": 1})
    return parallel.DataParallelTrainer(net, c["loss"](mx), c["rule"],
                                        dict(c["params"]), mesh=mesh)


def _all_weights(net):
    return {k: p.data().asnumpy() for k, p in
            net._collect_params_with_prefix().items()}


@pytest.fixture(scope="module", params=sorted(CASES))
def runs(request):
    """Both packages through the sequence, from the same weights; then
    one more step each on ``b4`` (the resume tests' reference point)."""
    case = request.param
    bt = _batches(case)
    jnet = _jax_net(case)
    w0 = _all_weights(jnet)
    jtr = _jax_trainer(case, jnet)
    jout = _drive(jtr, jnet, bt)
    jstate = _host_state(jtr.state_dict())
    jw = _all_weights(jnet)
    jtr.step(*bt["b4"])
    jnext = _params(jnet)
    pnet = _port_net(case, w0)
    ptr = _port_trainer(case, pnet)
    pout = _drive(ptr, pnet, bt)
    pstate = _host_state(ptr.state_dict())
    pw = _all_weights(pnet)
    ptr.step(*bt["b4"])
    pnext = _params(pnet)
    return dict(case=case, bt=bt, w0=w0, jout=jout, pout=pout,
                jstate=jstate, pstate=pstate, jw=jw, pw=pw, jnext=jnext,
                pnext=pnext, pnet=pnet, jnet=jnet)


def _close(got, want, what, rtol=RTOL):
    """``got`` within ``rtol`` of ``want`` relative, in the Frobenius
    norm."""
    scale = max(float(np.linalg.norm(want)), 1e-30)
    err = float(np.linalg.norm(got - want)) / scale
    assert err <= rtol, f"{what}: {err:.3g} relative to {scale:.3g}"


def _close_params(got, want, what, case):
    assert sorted(got) == sorted(want)
    for k in want:
        if k.endswith("proj_key.bias"):
            # zero gradient in exact arithmetic: Adam (and LAMB, whose
            # ratio is 1 at a zero weight) steps rounding noise by up to
            # about lr a call, in either package
            assert np.abs(got[k] - want[k]).max() <= KEY_BIAS_ATOL, k
        elif k in BN_FED_BIASES:
            # zero gradient in exact arithmetic: rounding noise times lr
            # (SGD, LARS), or RMSProp's step on noise
            atol = CASES[case].get("noise_atol", BN_BIAS_ATOL)
            assert np.abs(got[k] - want[k]).max() <= atol, k
        else:
            _close(got[k], want[k], f"{what} {k}")


# ----------------------------------------------------------------------
# the sequence, call by call
# ----------------------------------------------------------------------

CALLS = ["step1", "step2", "step3_after_set_learning_rate",
         "step_accum_n_micro_2", "step_multi_2", "step_indexed"]


@pytest.mark.parametrize("call", range(len(CALLS)), ids=CALLS)
def test_trainer_matches_jax_call_by_call(runs, call):
    if call >= len(runs["jout"]):
        pytest.skip("the reference's step_indexed feeds one input array; "
                    "BERT takes tokens and types")
    assert len(runs["jout"]) == len(runs["pout"])
    (jl, jp), (pl, pp) = runs["jout"][call], runs["pout"][call]
    assert jl.shape == pl.shape
    _close(pl, jl, f"{runs['case']} {CALLS[call]} loss")
    _close_params(pp, jp, f"{runs['case']} {CALLS[call]}", runs["case"])


def test_step_multi_is_two_steps(runs):
    """K ``step_multi`` steps give the parameters of K ``step`` calls
    (the same body; within the case's tolerance, since the CPU GEMMs'
    rounding follows the buffers' alignment)."""
    case, bt = runs["case"], runs["bt"]
    net = _port_net(case, runs["w0"])
    a = _port_trainer(case, net)
    for b in ("b0", "b1", "b2"):
        a.step(*bt[b])
    multi = _params(net)
    net2 = _port_net(case, runs["w0"])
    b = _port_trainer(case, net2)
    b.step(*bt["b0"])
    losses = b.step_multi([bt["b1"], bt["b2"]])
    assert losses.shape == (2,)
    _close_params(_params(net2), multi, f"{case} step_multi", case)


def test_step_indexed_matches_step_on_the_same_slice(runs):
    case, bt = runs["case"], runs["bt"]
    nets = [_port_net(case, runs["w0"]) for _ in range(2)]
    a, b = (_port_trainer(case, n) for n in nets)
    if len(bt["b1"]) != 2:
        pytest.skip("the reference's step_indexed feeds one input array; "
                    "BERT takes tokens and types")
    la = a.step(*bt["b1"])
    lb = b.step_indexed(b.put_epoch(*_epoch(bt["b0"], bt["b1"])), 1)
    _close(lb.asnumpy(), la.asnumpy(), f"{case} step_indexed loss")
    _close_params(_params(nets[1]), _params(nets[0]), f"{case} step_indexed",
                  case)


# ----------------------------------------------------------------------
# state_dict across the packages
# ----------------------------------------------------------------------

def _host_state(sd):
    """A state_dict with host copies of its arrays (the reference's
    next step donates its device arrays)."""
    return {"arrays": {k: np.array(v.asnumpy())
                       for k, v in sd["arrays"].items()},
            "meta": sd["meta"]}


def _to_jax_state(sd):
    return {"arrays": {k: jmx.nd.array(v, dtype=str(v.dtype))
                       for k, v in sd["arrays"].items()},
            "meta": sd["meta"]}


def _to_port_state(sd):
    with mx.cpu():
        return {"arrays": {k: mx.nd.array(v, dtype=str(v.dtype))
                           for k, v in sd["arrays"].items()},
                "meta": sd["meta"]}


def test_state_dict_has_the_reference_layout(runs):
    js, ps = runs["jstate"], runs["pstate"]
    assert sorted(js["arrays"]) == sorted(ps["arrays"])
    for key in ("kind", "rule", "num_update", "saved_dp", "saved_mesh",
                "zero1", "leaves"):
        assert js["meta"][key] == ps["meta"][key], key
    for k, v in js["arrays"].items():
        assert v.shape == ps["arrays"][k].shape, k


def test_jax_state_dict_resumes_in_the_port(runs):
    case = runs["case"]
    net = _port_net(case, runs["jw"])
    tr = _port_trainer(case, net)
    tr.load_state_dict(_to_port_state(runs["jstate"]))
    tr.set_learning_rate(CASES[case]["params"]["learning_rate"] / 2)
    assert tr._num_update == runs["jstate"]["meta"]["num_update"]
    tr.step(*runs["bt"]["b4"])
    _close_params(_params(net), runs["jnext"], f"{case} resumed in the port",
                  case)


def test_port_state_dict_resumes_in_jax(runs):
    case = runs["case"]
    net = _jax_net(case, runs["pw"])
    tr = _jax_trainer(case, net)
    tr.load_state_dict(_to_jax_state(runs["pstate"]))
    tr.set_learning_rate(CASES[case]["params"]["learning_rate"] / 2)
    tr.step(*runs["bt"]["b4"])
    _close_params(_params(net), runs["pnext"], f"{case} resumed in jax", case)


def test_running_statistics_advance_where_the_reference_keeps_them(runs):
    if runs["case"] != "conv":
        pytest.skip("BERT has no running statistics")
    start = {k: v for k, v in runs["w0"].items() if "running" in k}
    jstats = _params(runs["jnet"], trainable=False)
    pstats = _params(runs["pnet"], trainable=False)
    assert sorted(start) == sorted(jstats) == sorted(pstats)
    for k, v in start.items():
        np.testing.assert_array_equal(jstats[k], v)   # the reference's
        assert not np.array_equal(pstats[k], v), k    # the port's moved
        assert np.all(np.isfinite(pstats[k]))


# ----------------------------------------------------------------------
# the port's own rules
# ----------------------------------------------------------------------

def test_deferred_shapes_resolve_at_the_first_step():
    with mx.cpu():
        net = _conv_net(mx)
        net.initialize(mx.init.Xavier())
        tr = parallel.DataParallelTrainer(
            net, gluon.loss.SoftmaxCrossEntropyLoss(), "sgd",
            {"learning_rate": 0.1}, mesh=parallel.make_mesh({"dp": 1}))
        x, y = _conv_batch(np.random.RandomState(3))
        before = {k: p._nd for k, p in net.collect_params().items()}
        assert any(v is None for v in before.values())
        loss = tr.step(x, y)
    assert np.isfinite(float(loss.asnumpy()))
    flat = tr._flat_p
    for i in tr._train:
        var = tr._param_objs[i]._var
        assert var.untyped_storage().data_ptr() == \
            flat.untyped_storage().data_ptr()


def test_a_parameter_moved_off_the_buffer_raises():
    with mx.cpu():
        net = _conv_net(mx)
        net.initialize(mx.init.Xavier())
        tr = parallel.DataParallelTrainer(
            net, gluon.loss.SoftmaxCrossEntropyLoss(), "sgd",
            {"learning_rate": 0.1}, mesh=parallel.make_mesh({"dp": 1}))
        x, y = _conv_batch(np.random.RandomState(3))
        tr.step(x, y)
        p = next(iter(net.collect_params().values()))
        p.cast("float16")
        with pytest.raises(mx.MXNetError, match="no longer lies"):
            tr.step(x, y)


def test_learning_rate_schedule_and_rules():
    from mxnet_tpu_torch.optimizer.lr_scheduler import FactorScheduler
    with mx.cpu():
        net = _conv_net(mx)
        net.initialize(mx.init.Xavier())
        mesh = parallel.make_mesh({"dp": 1})
        ce = gluon.loss.SoftmaxCrossEntropyLoss()
        tr = parallel.DataParallelTrainer(
            net, ce, "sgd", {"learning_rate": 0.2, "lr_scheduler":
                             FactorScheduler(step=1, factor=0.5)},
            mesh=mesh)
        x, y = _conv_batch(np.random.RandomState(3))
        lrs = []
        for _ in range(3):
            lrs.append(tr.learning_rate)
            tr.step(x, y)
            assert float(tr._lr_buf.item()) == np.float32(lrs[-1])
        fresh = FactorScheduler(step=1, factor=0.5)
        # the schedule's own base_lr, not learning_rate, as the reference
        assert lrs == [fresh(n) for n in range(3)] and lrs[0] > lrs[-1]
        with pytest.raises(mx.MXNetError, match="gluon.Trainer"):
            parallel.DataParallelTrainer(net, ce, "adagrad", mesh=mesh)
        for rule, leaves in (("lamb", {"m", "v", "t"}), ("lars", set()),
                             ("rmsprop", {"n"})):
            other = parallel.DataParallelTrainer(
                net, ce, rule, {"learning_rate": 1e-3}, mesh=mesh)
            assert np.isfinite(float(other.step(x, y).asnumpy()))
            assert set(other.state_dict()["meta"]["leaves"]) == leaves
        # at dp=1 the comm block is the psum path's (nothing measured) and
        # the overlap probe measures nothing, as in the reference
        stats = tr.comm_stats()
        assert not stats["zero1"] and stats["dp"] == 1
        assert stats["collective_ms"] is None and stats["backend"] is None
        assert set(tr.overlap_probe(x, y).values()) == {None}
        grads = [p for p in net.collect_params().values()]
        assert parallel.all_reduce_gradients(grads) is grads
        assert parallel.all_reduce_gradients(
            grads, kvstore=mx.kv.create("device")) is grads
        assert tr.rebuild(parallel.make_mesh({"dp": 1})) is tr
        tr.step(x, y)


def test_constructor_takes_the_reference_arguments():
    """The reference's arguments in its order and defaults, then the
    knobs it reads from the environment, as arguments at the values it
    takes when they are unset (``MXTPU_COMM_BUCKET_MB`` 32,
    ``MXTPU_COMM_DTYPE`` fp32)."""
    import inspect
    ours = inspect.signature(parallel.DataParallelTrainer.__init__)
    ref = inspect.signature(JTrainer.__init__)
    names = list(ours.parameters)
    assert names[:len(ref.parameters)] == list(ref.parameters)
    assert names[len(ref.parameters):] == ["bucket_mb", "comm_dtype"]
    for name, p in ref.parameters.items():
        assert ours.parameters[name].default == p.default, name
    assert parallel.zero.bucket_bound_bytes(
        ours.parameters["bucket_mb"].default) == 32 * 1024 * 1024
    assert ours.parameters["comm_dtype"].default == "fp32"


# ----------------------------------------------------------------------
# meshes, and no environment knobs
# ----------------------------------------------------------------------

def test_meshes_of_one_device_and_more_raise():
    """One device makes a mesh by itself; more than one needs a process
    group (``distributed_init``; the ranks' meshes are held in
    ``test_torch_port_distributed.py``), and tensor and pipeline axes
    raise naming item 10b."""
    cpu = torch.device("cpu")
    mesh = parallel.make_mesh({"dp": 1}, devices=[cpu])
    assert mesh.shape == {"dp": 1} and mesh.device == cpu
    assert parallel.make_mesh({"dp": -1}, devices=[cpu]).shape == {"dp": 1}
    with mx.cpu():
        assert parallel.make_mesh().shape == {"dp": 1}
        assert parallel.local_mesh({"dp": 1}).device == cpu
    with pytest.raises(mx.MXNetError, match="distributed_init"):
        parallel.make_mesh({"dp": 2}, devices=[cpu, cpu])
    with pytest.raises(NotSupportedError, match="item 10b"):
        parallel.make_mesh({"dp": 1, "tp": 2}, devices=[cpu, cpu])
    with pytest.raises(mx.MXNetError, match="!= 2 devices"):
        parallel.make_mesh({"dp": 1}, devices=[cpu, cpu])
    for refused in (lambda: parallel.MeshConfig(dp=2, tp=2, pp=2),
                    lambda: parallel.MeshConfig(dp=1, tp=2),
                    lambda: parallel.MeshConfig.from_spec("dp2tp2pp2"),
                    lambda: parallel.MeshConfig().stage_mesh(0)):
        with pytest.raises(NotSupportedError, match="item 10b"):
            refused()
    with pytest.raises(mx.MXNetError, match="distributed_init"):
        parallel.MeshConfig(dp=-1).build([cpu, cpu])
    assert parallel.MeshConfig(dp=1).build([cpu]).device == cpu
    assert parallel.MeshConfig(dp=-1).build([cpu]).shape == {"dp": 1}
    assert parallel.MeshConfig().describe() == "dp1"
    assert parallel.MeshConfig.from_spec("dp2").describe() == "dp2"
    assert parallel.MeshConfig.for_mesh(mesh) == parallel.MeshConfig()
    with parallel.mesh_scope(mesh):
        assert parallel.current_mesh() is mesh
        with mx.cpu():
            net = _conv_net(mx)
            net.initialize()
            tr = parallel.DataParallelTrainer(
                net, gluon.loss.SoftmaxCrossEntropyLoss())
        assert tr.mesh is mesh
    assert parallel.current_mesh() is None
    # no coordinator: one process, as the reference's
    with mx.cpu():
        assert parallel.distributed_init() is False
    assert not mx.runtime.Features().is_enabled("DIST_KVSTORE")


def test_entry_points_raise_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("the rule is about hosts without a card")
    with pytest.raises(mx.MXNetError, match="mx.cpu"):
        parallel.make_mesh({"dp": 1})
    with mx.cpu():
        net = _conv_net(mx)
        net.initialize()
    with pytest.raises(mx.MXNetError, match="mx.cpu"):
        parallel.DataParallelTrainer(net, gluon.loss.SoftmaxCrossEntropyLoss())


def test_no_environment_knob_is_read(monkeypatch, tmp_path):
    for name, value in (("MXTPU_MESH", "dp2"), ("MXTPU_CKPT_KEEP", "1"),
                        ("MXTPU_CKPT_ASYNC", "0"),
                        ("MXTPU_PP_MICROBATCH", "7"),
                        ("MXTPU_STEPS_PER_CALL", "4"),
                        ("DMLC_PS_ROOT_URI", "localhost"),
                        ("MXTPU_SERVE_REPLICAS", "3"),
                        ("MXTPU_SERVE_DISAGG", "1"),
                        ("MXTPU_FAULT_INJECT", "serving.replica0.step:at=1"),
                        ("MXTPU_RETRACE_WARN", "0"), ("MXTPU_EAGER", "1"),
                        ("MXTPU_COMPUTE_DTYPE", "int8"),
                        ("MXTPU_QUANT_BF16_ALLOW", "fc,mm"),
                        ("MXTPU_DEBUG_NANS", "1"), ("MXTPU_DEBUG_INFS", "1"),
                        ("MXTPU_ENFORCE_DETERMINISM", "1"),
                        ("MXTPU_SEED", "123"), ("MXTPU_TEST_CTX", "gpu"),
                        ("MXNET_TEST_DEVICE", "gpu"),
                        ("MXTPU_TEST_SEED", "5"), ("MXNET_TEST_SEED", "5"),
                        ("MXTPU_SYNTHETIC_DATA", "1"),
                        ("MXTPU_PREFETCH_DEPTH", "5"),
                        ("MXTPU_NO_NATIVE_BUILD", "1"),
                        ("MXTPU_COMM_BUCKET_MB", "1"),
                        ("MXTPU_COMM_DTYPE", "int8"),
                        ("MXTPU_SHARDED_SYNC", "0"),
                        ("MXTPU_OVERLAP_COMM", "0"),
                        ("MXTPU_KVSTORE_BIGARRAY_BOUND", "8"),
                        ("MXTPU_KVSTORE_WIRE", "allgather"),
                        ("MXTPU_COORDINATOR", "localhost:1234"),
                        ("MXTPU_NUM_PROCESSES", "2"),
                        ("MXTPU_PROCESS_ID", "1"),
                        ("MXTPU_COORD_HEARTBEAT_INTERVAL_S", "1"),
                        ("MXTPU_COORD_MAX_MISSING_HEARTBEATS", "1"),
                        ("MXTPU_COORD_INIT_TIMEOUT_S", "1"),
                        ("DMLC_NUM_WORKER", "2"), ("DMLC_WORKER_ID", "1"),
                        ("DMLC_PS_ROOT_PORT", "9000"),
                        ("MXTPU_BENCH_DP", "8")):
        monkeypatch.setenv(name, value)
    with mx.cpu():
        assert parallel.make_mesh().shape == {"dp": 1}
    with pytest.raises(NotSupportedError, match="environment knob"):
        parallel.MeshConfig.from_env()
    with pytest.raises(NotSupportedError, match="environment knob"):
        parallel.mesh_config_from_env()
    mgr = mx.checkpoint.CheckpointManager(tmp_path)
    assert mgr.keep == 3 and mgr._async_save
    # the serving Router: two combined replicas, and no fault armed
    from mxnet_tpu_torch.gluon.model_zoo.nlp.llama import (
        LlamaConfig, LlamaForCausalLM)
    from mxnet_tpu_torch.serving import InferenceEngine, Request, Router
    from mxnet_tpu_torch.testing import faults
    net = LlamaForCausalLM(LlamaConfig(
        vocab_size=32, hidden_size=16, num_layers=1, num_heads=2,
        num_kv_heads=2, intermediate_size=32, max_seq_len=32),
        device="cpu", seed=0)
    router = Router(lambda cc: InferenceEngine(
        net, max_batch=2, block_size=8, max_context=16, device="cpu"))
    assert len(router.replicas) == 2 and not router.disaggregated
    assert [r.role for r in router.replicas] == ["combined"] * 2
    assert faults.active() == []
    req = router.submit(Request([1, 2, 3], 2))
    router.drive()
    assert req.done and router.epoch == 0
    # hybridize() routes through a CachedOp (no MXTPU_EAGER), whose
    # retrace monitor keeps the reference's default threshold
    from mxnet_tpu_torch.gluon import nn
    dense = nn.Dense(2, in_units=3)
    dense.initialize(ctx=mx.cpu())
    dense.hybridize()
    dense(mx.nd.ones((1, 3), ctx=mx.cpu()))
    assert dense._active and dense._cached_op._retrace.threshold == 3
    # no compute dtype and no extra bf16 tag come from the environment:
    # FullyConnected, Dense and quant_matmul stay the plain product
    from mxnet_tpu_torch.ops import quant_matmul as qm
    assert qm.resolve_compute_dtype() is None
    assert qm.bf16_fallback_tags() == {"head", "logits"}
    x = torch.randn(4, 3, generator=torch.Generator().manual_seed(0))
    w = dense.weight.data().data.detach()
    assert torch.equal(qm.quant_matmul(x, w.t(), tag="fc"), x @ w.t())
    assert dense.compute_dtype is None
    assert torch.equal(dense(mx.nd.array(x.numpy(), ctx=mx.cpu())).data,
                       torch.nn.functional.linear(
                           x, w, dense.bias.data().data.detach()))
    # the surface modules: no debug switch, seed, test context or
    # synthetic data comes from the environment, and a step is one call
    from mxnet_tpu_torch import debug, runtime, test_utils
    assert not debug.debug_nans_enabled() and not debug.determinism_enabled()
    deterministic = torch.are_deterministic_algorithms_enabled()
    with mx.cpu():
        assert np.isnan(mx.nd.log(mx.nd.array([-1.0])).asnumpy()).all()
        assert test_utils.default_context() == mx.cpu()
    assert torch.are_deterministic_algorithms_enabled() == deterministic
    if not torch.cuda.is_available():
        with pytest.raises(mx.MXNetError, match="mx.cpu"):
            test_utils.default_context()
    state = np.random.get_state()
    try:
        seeded = test_utils.with_seed(3)(lambda: np.random.rand(2))()
        np.random.seed(3)
        assert np.array_equal(seeded, np.random.rand(2))
    finally:
        np.random.set_state(state)
    assert runtime.steps_per_call() == 1
    with pytest.raises(mx.MXNetError, match="synthetic=True"):
        gluon.data.vision.MNIST(root=str(tmp_path / "no-mnist"))
    # the input pipeline: a prefetch depth of 2, and the native library
    # builds and loads whatever MXTPU_NO_NATIVE_BUILD says
    from mxnet_tpu_torch import io as mio
    from mxnet_tpu_torch.utils import native
    assert mio.DevicePrefetcher(iter([]), to_device=False)._depth == 2
    loader = gluon.data.DataLoader(gluon.data.SimpleDataset([1.0]),
                                   batch_size=1, prefetch_to_device=True)
    assert loader._prefetch_depth == 2
    assert native.available() and native.loaded()
    # the data-parallel knobs: no process group is joined at import or at
    # a store's creation, and the wire, bucket bound and paths are the
    # arguments' defaults
    assert not mx._dist_init.is_initialized()
    store = mx.kv.create("dist_sync")
    assert store.num_workers == 1 and store._wire == "allreduce"
    assert store._bound == mx.kv.kvstore.DEFAULT_BIGARRAY_BOUND
    with mx.cpu():
        dnet = _conv_net(mx)
        dnet.initialize()
        dtr = parallel.DataParallelTrainer(
            dnet, gluon.loss.SoftmaxCrossEntropyLoss(), shard_updates=True)
    assert dtr._comm_dtype == "fp32"
    assert dtr._bucket_bytes == 32 * 1024 * 1024
    # util's getenv/setenv are the user's API, and debug sets only cuBLAS's
    # workspace variable
    for rel, allowed in (("util.py", {None}),
                         ("debug.py", {"CUBLAS_WORKSPACE_CONFIG"})):
        tree = ast.parse((REPO / "mxnet_tpu_torch" / rel).read_text())
        keys = {n.args[0].value if n.args and isinstance(
                    n.args[0], ast.Constant) else None
                for n in ast.walk(tree) if isinstance(n, ast.Call)
                and isinstance(n.func, ast.Attribute)
                and isinstance(n.func.value, ast.Attribute)
                and n.func.value.attr == "environ"}
        assert keys <= allowed, (rel, keys)
    # and no module of the slice touches os.environ or os.getenv
    for rel in ("gluon/utils.py", "gluon/data/dataloader.py",
                "gluon/data/dataset.py", "gluon/data/vision/datasets.py",
                "gluon/data/vision/transforms.py", "test_utils.py",
                "operator.py", "npx.py", "model.py", "callback.py",
                "name.py", "engine.py", "rtc.py", "runtime.py",
                "ndarray/random.py", "_tape.py",
                "parallel/mesh.py", "parallel/data_parallel.py",
                "parallel/__init__.py", "checkpoint.py",
                "serving/frontend/router.py", "testing/faults.py",
                "testing/__init__.py", "serving/scheduler.py",
                "serving/engine.py", "gluon/block.py", "_graphs.py",
                "lint/retrace.py", "lint/__init__.py",
                "ops/quant_matmul.py", "ndarray/ops.py",
                "ndarray/sparse.py", "ndarray/contrib.py",
                "gluon/nn/basic_layers.py", "optimizer/optimizer.py",
                "io/__init__.py", "io/prefetch.py", "recordio.py",
                "image.py", "utils/native.py", "utils/__init__.py",
                "_dist_init.py", "parallel/zero.py", "parallel/overlap.py",
                "kvstore/__init__.py", "kvstore/kvstore.py",
                "kvstore/horovod.py", "gluon/trainer.py",
                # the recurrent layers, gluon.contrib and the zoo
                "gluon/rnn/__init__.py", "gluon/rnn/rnn_cell.py",
                "gluon/rnn/rnn_layer.py", "rnn.py", "initializer.py",
                "convert.py", "gluon/contrib/__init__.py",
                "gluon/contrib/nn.py", "gluon/contrib/rnn.py",
                "gluon/contrib/data/__init__.py",
                "gluon/model_zoo/nlp/language_model.py",
                "gluon/model_zoo/vision/__init__.py",
                "gluon/model_zoo/vision/alexnet.py",
                "gluon/model_zoo/vision/vgg.py",
                "gluon/model_zoo/vision/squeezenet.py",
                "gluon/model_zoo/vision/densenet.py",
                "gluon/model_zoo/vision/inception.py",
                "gluon/model_zoo/vision/mobilenet.py",
                "gluon/model_zoo/vision/resnext.py",
                "gluon/model_zoo/vision/resnest.py",
                "gluon/model_zoo/vision/ssd.py"):
        tree = ast.parse((REPO / "mxnet_tpu_torch" / rel).read_text())
        names = {n.attr for n in ast.walk(tree)
                 if isinstance(n, ast.Attribute)}
        assert not names & {"environ", "getenv"}, rel
