"""The port's checkpointing (``checkpoint.py``, the Trainers' state
protocol) against the JAX package's, on the CPU.

Files cross between the packages both ways:

- ``gluon.Trainer.save_states`` / ``load_states`` (the reference's
  pickle of per-parameter states and update counters), for SGD momentum,
  Adam, LAMB (a tuple with a step count), LARS, RMSProp (a 1-tuple) and
  Ftrl (a tuple, no learning-rate rule): a file written after two eager
  steps in one package loads in
  the other, and one more step from there gives the parameters the
  writer's next step gives;
- ``CheckpointManager`` directories (``params.ndz``, ``trainer.ndz``,
  ``manifest.json`` with CRC32s) of a ``DataParallelTrainer`` run, the
  same way.  The ``rng`` group is each package's own (JAX PRNG key there,
  ``torch.Generator`` states here): the port refuses a JAX-written one by
  name, and both sides restore the other's checkpoint with
  ``restore_rng=False``.

Tolerance: parameters within 1e-5 relative in the Frobenius norm after
the step that follows the restore (f32; another summation order), and
the restored optimizer state within 1e-6 of the writer's.  The port's own
save/restore is bitwise.
"""
import os
import pickle

import jax
import numpy as np
import pytest
import torch

import mxnet_tpu as jmx
from mxnet_tpu import autograd as jautograd, gluon as jgluon
from mxnet_tpu import checkpoint as jckpt
from mxnet_tpu.parallel import make_mesh as jmake_mesh
from mxnet_tpu.parallel.data_parallel import DataParallelTrainer as JTrainer

import mxnet_tpu_torch as mx
from mxnet_tpu_torch import autograd, checkpoint, gluon, parallel
from mxnet_tpu_torch.base import NotSupportedError
from test_torch_port_amp import seeded

RTOL = 1e-5
STATE_ATOL = 1e-6
B = 4
RULES = {"sgd": {"learning_rate": 0.1, "momentum": 0.9},
         "adam": {"learning_rate": 1e-2},
         "lamb": {"learning_rate": 1e-2, "wd": 0.01},
         "lars": {"learning_rate": 0.1, "momentum": 0.9, "wd": 1e-3},
         "rmsprop": {"learning_rate": 1e-2},
         "ftrl": {"learning_rate": 0.1}}


def _net(pkg):
    nn = pkg.gluon.nn
    net = nn.HybridSequential(prefix="ckpt_")
    with net.name_scope():
        # no bias before the BatchNorm: its gradient is zero in exact
        # arithmetic, so its value would be rounding noise
        net.add(nn.Dense(8, in_units=6, use_bias=False),
                nn.BatchNorm(in_channels=8),
                nn.Activation("relu"), nn.Dense(3, in_units=8))
    return net


def _batch(seed):
    rng = np.random.RandomState(seed)
    return (rng.randn(B, 6).astype(np.float32),
            rng.randint(0, 3, (B,)).astype(np.float32))


def _weights(net):
    return {k: np.array(p.data().asnumpy()) for k, p in
            net._collect_params_with_prefix().items()}


def _trainable(net):
    return {k: np.array(p.data().asnumpy()) for k, p in
            net._collect_params_with_prefix().items()
            if p.grad_req != "null"}


def _jax_net(weights=None):
    net = _net(jmx)
    with seeded(0):
        net.initialize(jmx.init.Xavier())
    if weights is not None:
        target = net._collect_params_with_prefix()
        for k, v in weights.items():
            target[k].set_data(jmx.nd.array(v))
    return net


def _port_net(weights):
    net = _net(mx)
    net.initialize(ctx=mx.cpu())
    target = net._collect_params_with_prefix()
    for k, v in weights.items():
        target[k].set_data(v)
    return net


def _close_params(got, want, what):
    assert sorted(got) == sorted(want)
    for k in want:
        err = np.linalg.norm(got[k] - want[k]) / max(
            np.linalg.norm(want[k]), 1e-30)
        assert err <= RTOL, f"{what} {k}: {err:.3g}"


# ----------------------------------------------------------------------
# gluon.Trainer: save_states / load_states across the packages
# ----------------------------------------------------------------------

def _jax_step(net, trainer, batch):
    x, y = jmx.nd.array(batch[0]), jmx.nd.array(batch[1])
    ce = jgluon.loss.SoftmaxCrossEntropyLoss()
    with jautograd.record():
        loss = ce(net(x), y)
    loss.backward()
    trainer.step(B)


def _port_step(net, trainer, batch):
    with mx.cpu():
        x, y = mx.nd.array(batch[0]), mx.nd.array(batch[1])
    ce = gluon.loss.SoftmaxCrossEntropyLoss()
    with autograd.record():
        loss = ce(net(x), y)
    loss.backward()
    trainer.step(B)


@pytest.fixture(scope="module", params=sorted(RULES))
def eager(request, tmp_path_factory):
    """Two eager steps in each package from the same weights, each
    trainer's ``save_states`` file and ``state_dict``, and each one's
    third step (the reference point of a resume)."""
    rule = request.param
    d = tmp_path_factory.mktemp(f"states-{rule}")
    jnet = _jax_net()
    w0 = _weights(jnet)
    jtr = jgluon.Trainer(jnet.collect_params(), rule, dict(RULES[rule]))
    pnet = _port_net(w0)
    ptr = gluon.Trainer(pnet.collect_params(), rule, dict(RULES[rule]))
    for seed in (1, 2):
        _jax_step(jnet, jtr, _batch(seed))
        _port_step(pnet, ptr, _batch(seed))
    jtr.save_states(str(d / "jax.states"))
    ptr.save_states(str(d / "port.states"))
    out = dict(rule=rule, dir=d, jw=_weights(jnet), pw=_weights(pnet),
               jsd=_host(jtr.state_dict()), psd=_host(ptr.state_dict()),
               jcount=jtr._optimizer.num_update,
               pcount=ptr._optimizer.num_update)
    _jax_step(jnet, jtr, _batch(3))
    _port_step(pnet, ptr, _batch(3))
    out.update(jnext=_trainable(jnet), pnext=_trainable(pnet))
    return out


def _host(sd):
    return {"arrays": {k: np.array(v.asnumpy())
                       for k, v in sd["arrays"].items()},
            "meta": sd["meta"]}


def test_save_states_file_has_the_reference_format(eager):
    with open(eager["dir"] / "port.states", "rb") as f:
        port = pickle.loads(f.read())
    with open(eager["dir"] / "jax.states", "rb") as f:
        ref = pickle.loads(f.read())
    assert sorted(port) == sorted(ref) == ["counters", "states"]
    assert port["counters"] == ref["counters"]
    pserial, _ = pickle.loads(port["states"])
    jserial, _ = pickle.loads(ref["states"])
    assert sorted(pserial) == sorted(jserial)

    def shape(v):
        if v is None:
            return None
        tag, payload = v
        if tag == "tuple":
            return ("tuple", tuple(shape(x) for x in payload))
        return (tag, payload.shape, str(payload.dtype))

    for k in jserial:
        assert shape(pserial[k]) == shape(jserial[k]), k


def test_jax_save_states_loads_in_the_port(eager):
    rule = eager["rule"]
    net = _port_net(eager["jw"])
    tr = gluon.Trainer(net.collect_params(), rule, dict(RULES[rule]))
    tr.load_states(str(eager["dir"] / "jax.states"))
    assert tr._optimizer.num_update == eager["jcount"]
    got = _host(tr.state_dict())["arrays"]
    want = eager["jsd"]["arrays"]
    assert sorted(got) == sorted(want)
    for k, v in want.items():
        np.testing.assert_allclose(got[k], v, rtol=0, atol=STATE_ATOL)
    _port_step(net, tr, _batch(3))
    _close_params(_trainable(net), eager["jnext"], f"{rule} jax->port")


def test_port_save_states_loads_in_jax(eager):
    rule = eager["rule"]
    net = _jax_net(eager["pw"])
    tr = jgluon.Trainer(net.collect_params(), rule, dict(RULES[rule]))
    tr.load_states(str(eager["dir"] / "port.states"))
    assert tr._optimizer.num_update == eager["pcount"]
    _jax_step(net, tr, _batch(3))
    _close_params(_trainable(net), eager["pnext"], f"{rule} port->jax")


def test_trainer_state_dict_crosses_both_ways(eager):
    rule = eager["rule"]
    assert sorted(eager["jsd"]["arrays"]) == sorted(eager["psd"]["arrays"])
    assert eager["jsd"]["meta"]["layout"] == eager["psd"]["meta"]["layout"]
    net = _port_net(eager["jw"])
    tr = gluon.Trainer(net.collect_params(), rule, dict(RULES[rule]))
    with mx.cpu():
        tr.load_state_dict({"arrays": {k: mx.nd.array(v) for k, v in
                                       eager["jsd"]["arrays"].items()},
                            "meta": eager["jsd"]["meta"]})
    _port_step(net, tr, _batch(3))
    _close_params(_trainable(net), eager["jnext"], f"{rule} jax->port")
    jnet = _jax_net(eager["pw"])
    jtr = jgluon.Trainer(jnet.collect_params(), rule, dict(RULES[rule]))
    jtr.load_state_dict({"arrays": {k: jmx.nd.array(v) for k, v in
                                    eager["psd"]["arrays"].items()},
                         "meta": eager["psd"]["meta"]})
    _jax_step(jnet, jtr, _batch(3))
    _close_params(_trainable(jnet), eager["pnext"], f"{rule} port->jax")


def test_load_state_keeps_the_flat_buffer_views(eager):
    rule = eager["rule"]
    net = _port_net(eager["jw"])
    tr = gluon.Trainer(net.collect_params(), rule, dict(RULES[rule]))
    tr.load_states(str(eager["dir"] / "jax.states"))
    storages = {b.untyped_storage().data_ptr()
                for b in tr._flat_state.values()}
    assert storages
    for state in tr._states.values():
        for leaf in state.values():
            assert leaf.untyped_storage().data_ptr() in storages
    flat = tr._flat_param.untyped_storage().data_ptr()
    for p in net.collect_params().values():
        if p.grad_req != "null":
            assert p._var.untyped_storage().data_ptr() == flat


# ----------------------------------------------------------------------
# CheckpointManager across the packages (DataParallelTrainer runs)
# ----------------------------------------------------------------------

def _jax_dp(net, rule="sgd"):
    return JTrainer(net, jgluon.loss.SoftmaxCrossEntropyLoss(), rule,
                    dict(RULES[rule]),
                    mesh=jmake_mesh({"dp": 1}, devices=jax.devices()[:1]))


def _port_dp(net, rule="sgd"):
    with mx.cpu():
        mesh = parallel.make_mesh({"dp": 1})
    return parallel.DataParallelTrainer(
        net, gluon.loss.SoftmaxCrossEntropyLoss(), rule, dict(RULES[rule]),
        mesh=mesh)


@pytest.fixture(scope="module")
def managed(tmp_path_factory):
    """Two DataParallelTrainer steps in each package, a CheckpointManager
    directory from each, and each writer's third step."""
    d = tmp_path_factory.mktemp("managed")
    jnet = _jax_net()
    w0 = _weights(jnet)
    jtr = _jax_dp(jnet)
    pnet = _port_net(w0)
    ptr = _port_dp(pnet)
    for seed in (1, 2):
        jtr.step(*_batch(seed))
        ptr.step(*_batch(seed))
    jckpt.CheckpointManager(str(d / "jax")).save(
        2, params=jnet, trainer=jtr, iterator={"epoch": 0, "batch": 2},
        sync=True)
    checkpoint.CheckpointManager(d / "port").save(
        2, params=pnet, trainer=ptr, iterator={"epoch": 0, "batch": 2},
        sync=True)
    jtr.step(*_batch(3))
    ptr.step(*_batch(3))
    return dict(dir=d, w0=w0, jnext=_trainable(jnet), pnext=_trainable(pnet))


def test_jax_checkpoint_restores_in_the_port(managed):
    mgr = checkpoint.CheckpointManager(managed["dir"] / "jax")
    assert mgr.latest() == 2 and mgr.steps() == [2]
    net = _port_net(managed["w0"])
    tr = _port_dp(net)
    with pytest.raises(NotSupportedError, match="restore_rng=False"):
        mgr.restore(params=net, trainer=tr)
    manifest = mgr.restore(params=net, trainer=tr, restore_rng=False)
    assert manifest["step"] == 2 and manifest["steps_per_call"] == 1
    assert manifest["iterator"] == {"epoch": 0, "batch": 2}
    assert tr._num_update == 2
    tr.step(*_batch(3))
    _close_params(_trainable(net), managed["jnext"], "jax->port")


def test_port_checkpoint_restores_in_jax(managed):
    mgr = jckpt.CheckpointManager(str(managed["dir"] / "port"))
    assert mgr.latest() == 2
    net = _jax_net()
    tr = _jax_dp(net)
    manifest = mgr.restore(params=net, trainer=tr, restore_rng=False)
    assert manifest["step"] == 2 and manifest["trainer_meta"]["rule"] == "sgd"
    tr.step(*_batch(3))
    _close_params(_trainable(net), managed["pnext"], "port->jax")


def test_manifests_agree_on_the_reference_keys(managed):
    pm = checkpoint.CheckpointManager(managed["dir"] / "port").manifest(2)
    jm = checkpoint.CheckpointManager(managed["dir"] / "jax").manifest(2)
    for key in ("format", "step", "dp", "mesh", "steps_per_call",
                "iterator", "files", "array_crc", "trainer_meta",
                "rng_meta"):
        assert key in pm and key in jm, key
    assert sorted(pm["files"]) == sorted(jm["files"])
    assert sorted(pm["array_crc"]["params"]) == \
        sorted(jm["array_crc"]["params"])
    assert sorted(pm["array_crc"]["trainer"]) == \
        sorted(jm["array_crc"]["trainer"])
    assert pm["rng_meta"]["generator"] == "torch"
    assert "generator" not in jm["rng_meta"]


# ----------------------------------------------------------------------
# the port's own: resume bitwise, torn and corrupt, retention, rng
# ----------------------------------------------------------------------

def _dp_run(w0, rule="adam"):
    net = _port_net(w0)
    return net, _port_dp(net, rule)


def test_restore_resumes_bitwise(tmp_path):
    w0 = _weights(_jax_net())
    net, tr = _dp_run(w0)
    mgr = checkpoint.CheckpointManager(tmp_path)
    for seed in (1, 2, 3):
        tr.step(*_batch(seed))
    mgr.save(3, params=net, trainer=tr).wait()
    for seed in (4, 5):
        tr.step(*_batch(seed))
    want = _weights(net)
    net2, tr2 = _dp_run(_weights(_jax_net()))
    assert mgr.restore(params=net2, trainer=tr2)["step"] == 3
    for seed in (4, 5):
        tr2.step(*_batch(seed))
    got = _weights(net2)
    for k in want:
        np.testing.assert_array_equal(got[k], want[k])


def _corrupt(path):
    with open(path, "r+b") as f:
        f.seek(-1, os.SEEK_END)
        b = f.read(1)
        f.seek(-1, os.SEEK_END)
        f.write(bytes([b[0] ^ 0xFF]))


def test_torn_and_corrupt_checkpoints_are_skipped(tmp_path):
    net, tr = _dp_run(_weights(_jax_net()))
    mgr = checkpoint.CheckpointManager(tmp_path, keep=5)
    for step in (1, 2, 3):
        tr.step(*_batch(step))
        mgr.save(step, params=net, trainer=tr, sync=True)
    assert mgr.latest() == 3
    os.remove(tmp_path / "ckpt-00000003" / "manifest.json")       # torn
    assert mgr.latest() == 2
    _corrupt(tmp_path / "ckpt-00000002" / "params.ndz")            # corrupt
    assert mgr.latest() == 1 and mgr.steps() == [1]
    assert mgr.manifest(2) is None
    with pytest.raises(mx.MXNetError, match="torn or corrupt"):
        mgr.restore(2, params=net)
    assert mgr.restore(params=net, trainer=tr)["step"] == 1


def test_keep_n_retention(tmp_path):
    net, tr = _dp_run(_weights(_jax_net()), rule="sgd")
    mgr = checkpoint.CheckpointManager(tmp_path, keep=2)
    tickets = []
    for step in (1, 2, 3, 4):
        tr.step(*_batch(step))
        tickets.append(mgr.save(step, params=net, trainer=tr))
    mgr.wait_until_finished()
    assert tickets[-1].wait() == str(tmp_path / "ckpt-00000004")
    assert mgr.steps() == [3, 4]
    assert sorted(os.listdir(tmp_path)) == ["ckpt-00000003", "ckpt-00000004"]


def test_rng_group_restores_the_port_generators(tmp_path):
    mgr = checkpoint.CheckpointManager(tmp_path)
    with mx.cpu():
        mx.random.seed(7)
        mx.nd.random.uniform(shape=(3,))
        np.random.seed(3)
        mgr.save(1, sync=True)
        want = (mx.nd.random.uniform(shape=(5,)).asnumpy(),
                np.random.rand(4))
        mx.nd.random.uniform(shape=(2,))
        np.random.rand(9)
        mgr.restore(1)
        got = (mx.nd.random.uniform(shape=(5,)).asnumpy(),
               np.random.rand(4))
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)


def test_async_checkpointer_snapshots_before_returning(tmp_path):
    t = torch.ones(4)
    ticket = checkpoint.AsyncCheckpointer().save(
        str(tmp_path / "a.params"), {"w": t})
    t.add_(1)                                   # after the snapshot
    assert ticket.wait() == str(tmp_path / "a.params")
    with mx.cpu():
        loaded = mx.nd.load(str(tmp_path / "a.params"))
    np.testing.assert_array_equal(loaded["w"].asnumpy(), np.ones(4))
    checkpoint.save_checkpoint_async(str(tmp_path / "b.params"),
                                     {"w": t}).wait()
    with pytest.raises(checkpoint.CheckpointTimeout):
        gate = __import__("threading").Event()
        ck = checkpoint.AsyncCheckpointer()
        ck._submit(lambda: gate.wait(), desc="blocked")
        try:
            ck.wait_until_finished(timeout=0.01)
        finally:
            gate.set()
            ck.wait_until_finished()


def test_preemption_handler_and_run_preemptible(tmp_path):
    net, tr = _dp_run(_weights(_jax_net()), rule="sgd")
    mgr = checkpoint.CheckpointManager(tmp_path)

    def loop(handler):
        for step in range(1, 10):
            tr.step(*_batch(step))
            if step == 3:
                handler.request("test")
            if handler.check_step(step):
                mgr.save(step, params=net, trainer=tr)
                return step
        return None

    preempted, last = checkpoint.run_preemptible(loop, manager=mgr)
    assert preempted and last == 3 and mgr.latest() == 3
    assert checkpoint.PreemptionHandler.installed() is None


def test_reshard_raises_naming_the_multi_device_item(tmp_path):
    """The reshards are ported (dp 4 -> 2 -> 1 across ranks is held in
    ``test_torch_port_distributed.py``): on one device each rebuilds the
    trainer onto the new mesh and restores its state bitwise, and each
    refuses a trainer without ``rebuild`` or a missing manager, as the
    reference's do."""
    with pytest.raises(mx.MXNetError, match="rebuild"):
        checkpoint.reshard_in_place(object(), None)
    with pytest.raises(mx.MXNetError, match="rebuild"):
        checkpoint.reshard_from_checkpoint(object(), None, manager=object())
    with pytest.raises(mx.MXNetError, match="CheckpointManager"):
        checkpoint.reshard_from_checkpoint(object(), None)
    net = _port_net(_weights(_jax_net()))
    tr = _port_dp(net, "adam")
    tr.step(*_batch(1))
    before = tr.state_dict()
    with mx.cpu():
        got = checkpoint.reshard_in_place(tr, parallel.make_mesh({"dp": 1}),
                                          params=net)
    assert got == {"source": "peer", "step": None}
    after = tr.state_dict()
    assert sorted(after["arrays"]) == sorted(before["arrays"])
    for k, v in before["arrays"].items():
        np.testing.assert_array_equal(after["arrays"][k].asnumpy(),
                                      v.asnumpy())
    mgr = checkpoint.CheckpointManager(tmp_path)
    mgr.save(1, params=net, trainer=tr, sync=True)
    want = _trainable(net)
    tr.step(*_batch(2))
    with mx.cpu():
        got = checkpoint.reshard_from_checkpoint(
            tr, parallel.MeshConfig(dp=1), params=net, manager=mgr)
    assert got["step"] == 1
    for k, v in want.items():
        np.testing.assert_array_equal(_trainable(net)[k], v)
