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
  in ``bench.py``'s ``_bench_bert``.

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


def _close_params(got, want, what):
    assert sorted(got) == sorted(want)
    for k in want:
        if k.endswith("proj_key.bias"):
            # zero gradient in exact arithmetic: Adam steps rounding noise
            # by up to about lr a call, in either package
            assert np.abs(got[k] - want[k]).max() <= KEY_BIAS_ATOL, k
        elif k in BN_FED_BIASES:
            # zero gradient in exact arithmetic: rounding noise times lr
            assert np.abs(got[k] - want[k]).max() <= BN_BIAS_ATOL, k
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
    _close_params(pp, jp, f"{runs['case']} {CALLS[call]}")


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
    _close_params(_params(net2), multi, f"{case} step_multi")


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
    _close_params(_params(nets[1]), _params(nets[0]), f"{case} step_indexed")


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
    _close_params(_params(net), runs["jnext"], f"{case} resumed in the port")


def test_port_state_dict_resumes_in_jax(runs):
    case = runs["case"]
    net = _jax_net(case, runs["pw"])
    tr = _jax_trainer(case, net)
    tr.load_state_dict(_to_jax_state(runs["pstate"]))
    tr.set_learning_rate(CASES[case]["params"]["learning_rate"] / 2)
    tr.step(*runs["bt"]["b4"])
    _close_params(_params(net), runs["pnext"], f"{case} resumed in jax")


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
        for rule in ("lamb", "lars", "rmsprop"):
            with pytest.raises(NotSupportedError, match="item 3"):
                parallel.DataParallelTrainer(net, ce, rule, mesh=mesh)
        for probe in (tr.comm_stats, tr.overlap_probe):
            with pytest.raises(NotSupportedError, match="item 10"):
                probe()
        grads = [p for p in net.collect_params().values()]
        assert parallel.all_reduce_gradients(grads) is grads
        with pytest.raises(NotSupportedError, match="item 10"):
            parallel.all_reduce_gradients(grads, kvstore="device")
        assert tr.rebuild(parallel.make_mesh({"dp": 1})) is tr
        tr.step(x, y)


def test_constructor_takes_the_reference_arguments():
    import inspect
    ours = inspect.signature(parallel.DataParallelTrainer.__init__)
    ref = inspect.signature(JTrainer.__init__)
    assert list(ours.parameters) == list(ref.parameters)
    for name, p in ref.parameters.items():
        assert ours.parameters[name].default == p.default, name


# ----------------------------------------------------------------------
# meshes, and no environment knobs
# ----------------------------------------------------------------------

def test_meshes_of_one_device_and_more_raise():
    cpu = torch.device("cpu")
    mesh = parallel.make_mesh({"dp": 1}, devices=[cpu])
    assert mesh.shape == {"dp": 1} and mesh.device == cpu
    assert parallel.make_mesh({"dp": -1}, devices=[cpu]).shape == {"dp": 1}
    with mx.cpu():
        assert parallel.make_mesh().shape == {"dp": 1}
        assert parallel.local_mesh({"dp": 1}).device == cpu
    with pytest.raises(NotSupportedError, match="item 10"):
        parallel.make_mesh({"dp": 2}, devices=[cpu, cpu])
    with pytest.raises(NotSupportedError, match="item 10"):
        parallel.make_mesh({"dp": 1, "tp": 2}, devices=[cpu, cpu])
    with pytest.raises(mx.MXNetError, match="!= 2 devices"):
        parallel.make_mesh({"dp": 1}, devices=[cpu, cpu])
    for refused in (lambda: parallel.MeshConfig(dp=2, tp=2, pp=2),
                    lambda: parallel.MeshConfig(dp=1, tp=2),
                    lambda: parallel.MeshConfig.from_spec("dp2tp2pp2"),
                    lambda: parallel.MeshConfig(dp=-1).build([cpu, cpu]),
                    lambda: parallel.MeshConfig().stage_mesh(0)):
        with pytest.raises(NotSupportedError, match="item 10"):
            refused()
    assert parallel.MeshConfig(dp=1).build([cpu]).device == cpu
    assert parallel.MeshConfig(dp=-1).build([cpu]).shape == {"dp": 1}
    assert parallel.MeshConfig().describe() == "dp1"
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
    with pytest.raises(NotSupportedError, match="item 10"):
        parallel.distributed_init()


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
                        ("MXTPU_FAULT_INJECT", "serving.replica0.step:at=1")):
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
    # and no module of the slice touches os.environ or os.getenv
    for rel in ("parallel/mesh.py", "parallel/data_parallel.py",
                "parallel/__init__.py", "checkpoint.py",
                "serving/frontend/router.py", "testing/faults.py",
                "testing/__init__.py", "serving/scheduler.py",
                "serving/engine.py"):
        tree = ast.parse((REPO / "mxnet_tpu_torch" / rel).read_text())
        names = {n.attr for n in ast.walk(tree)
                 if isinstance(n, ast.Attribute)}
        assert not names & {"environ", "getenv"}, rel
