"""The port's data parallelism over more than one rank against the JAX
package's dp mesh, on the CPU.

Four ranks run as processes over gloo (``tests/torch_dist_worker.py``,
one job for the module, ``file://`` store under ``tmp_path``, one
thread a rank); the reference runs in this process on the host devices
``tests/conftest.py`` makes (its own multi-process test fails on every
run, so its single-process mesh, which does the same arithmetic, is the
oracle).  The weights are the reference's, drawn once under a seed and
carried to the ranks; every global batch comes from one
``RandomState``, rank r of N taking the r-th contiguous slice (of each
microbatch for the psum path's ``step_accum``, whose reference splits
the global batch; of each chip's rows under ZeRO-1, as the reference's
``shard_map`` does).

What is held, each against the reference at the same dp and path:

- ``DataParallelTrainer`` at dp 4 and dp 2 (ranks 0-1 of the four, a
  subgroup), the psum path and ZeRO-1, through ``step`` twice,
  ``step_accum(n_micro=2)``, ``step_multi`` and ``put_epoch`` /
  ``step_indexed`` (under ZeRO-1 against the reference's ``step`` on the
  same batch: its own ZeRO-1 ``step_indexed`` raises): the losses and every trainable parameter after every
  call within 1e-5 relative in the Frobenius norm (f32; the ranks' mean
  of their gradients against one global backward), the convs' biases
  (each feeds a BatchNorm: zero gradient in exact arithmetic) within
  1e-6 absolute; every rank's parameters bitwise equal;
- the BatchNorm statistics: on the psum path every rank holds the
  running statistics of the global batch (the reference's global view;
  the port's single-device run on the whole batch within 1e-6), under
  ZeRO-1 each rank those of its own rows (the reference's per-device
  body);
- ZeRO-1's bf16 wire against the reference's bf16 wire (updates within
  2e-2 relative: the bf16 sums round in another order), and the int8
  wire against the reference's fp32 run: step 1's update element by
  element within lr times the ranks' mean int8 quantum (their amax over
  127, recorded on each rank) plus 1e-6, the bound of a stochastic
  rounding's error;
- ``reshard_in_place`` dp 4 -> 2 and ``reshard_from_checkpoint`` -> 1
  (Adam, ZeRO-1; the checkpoint written by rank 0 alone) against the
  reference's own reshard functions, 1e-5 relative (the BatchNorm-fed
  biases within 3 lr: Adam steps their rounding noise by up to lr a
  call);
- ``comm_stats``, ``overlap_probe``, ``all_reduce_gradients`` without a
  store, the mesh surface and ``reinit_distributed``.
"""
import os

import jax
import numpy as np
import pytest

import mxnet_tpu as jmx
from mxnet_tpu import checkpoint as jckpt
from mxnet_tpu import gluon as jgluon
from mxnet_tpu.parallel import make_mesh as jmake_mesh
from mxnet_tpu.parallel.data_parallel import DataParallelTrainer as JTrainer

import mxnet_tpu_torch as mx
from mxnet_tpu_torch import gluon, parallel

import torch_dist_worker as worker

RTOL = 1e-5
BN_FED_BIASES = ("0.bias", "4.bias")
BN_BIAS_ATOL = 1e-6
BF16_RTOL = 2e-2
LR = 0.1
ADAM_LR = 1e-2
# Adam maps a gradient of rounding noise (the BatchNorm-fed biases') to a
# step of up to lr a call, in either package: three calls' worth
ADAM_NOISE_ATOL = 3 * ADAM_LR
WORLD = 4
B = 8


def _jax_net(weights=None):
    nn = jgluon.nn
    net = nn.HybridSequential(prefix="ddpnet_")
    with net.name_scope():
        net.add(nn.Conv2D(8, 3, padding=1), nn.BatchNorm(),
                nn.Activation("relu"), nn.MaxPool2D(2),
                nn.Conv2D(8, 3, padding=1), nn.BatchNorm(),
                nn.Activation("relu"), nn.GlobalAvgPool2D(),
                nn.Dense(10))
    key = jmx.random.get_key_data()
    jmx.random.seed(25)
    try:
        net.initialize(jmx.init.Xavier(magnitude=2))
        net(jmx.nd.zeros((2, 3, 8, 8)))
    finally:
        jmx.random.set_key_data(key)
    if weights is not None:
        target = net._collect_params_with_prefix()
        for k, v in weights.items():
            target[k].set_data(jmx.nd.array(v))
    return net


def _weights(net, trainable=None):
    return {k: p.data().asnumpy() for k, p in
            net._collect_params_with_prefix().items()
            if trainable is None or (p.grad_req != "null") == trainable}


def _data():
    rng = np.random.RandomState(25)
    out = {}
    for k in ("0", "1", "2"):
        out["x" + k] = rng.rand(B, 3, 8, 8).astype(np.float32)
        out["y" + k] = rng.randint(0, 10, (B,)).astype(np.float32)
    out["xd"] = rng.rand(2 * B, 3, 8, 8).astype(np.float32)
    out["yd"] = rng.randint(0, 10, (2 * B,)).astype(np.float32)
    return out


class _env:
    """The reference reads its wire dtype from the environment at
    construction (the port takes ``comm_dtype=``)."""

    def __init__(self, **kv):
        self.kv = kv

    def __enter__(self):
        self.prev = {k: os.environ.get(k) for k in self.kv}
        os.environ.update(self.kv)

    def __exit__(self, *exc):
        for k, v in self.prev.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v


def _jax_trainer(net, n, shard, rule="sgd", params=None, comm="fp32"):
    with _env(MXTPU_COMM_DTYPE=comm):
        return JTrainer(net, jgluon.loss.SoftmaxCrossEntropyLoss(), rule,
                        dict(params or {"learning_rate": LR,
                                        "momentum": 0.9}),
                        mesh=jmake_mesh({"dp": n},
                                        devices=jax.devices()[:n]),
                        shard_updates=shard)


def _record(out, tag, loss, net):
    out[f"{tag}/loss"] = np.asarray(loss.asnumpy(), np.float32).reshape(-1)
    for k, v in _weights(net).items():
        out[f"{tag}/{k}"] = v


def _jax_sequence(w0, data, n, shard, comm="fp32", sequence=True):
    out = {}
    net = _jax_net(w0)
    tr = _jax_trainer(net, n, shard, comm=comm)
    _record(out, "step1", tr.step(data["x0"], data["y0"]), net)
    _record(out, "step2", tr.step(data["x1"], data["y1"]), net)
    if sequence:
        _record(out, "accum", tr.step_accum(data["xd"], data["yd"],
                                            n_micro=2), net)
        _record(out, "multi", tr.step_multi([(data["x0"], data["y0"]),
                                             (data["x1"], data["y1"])]), net)
        if shard:
            # the reference's ZeRO-1 step_indexed fails (its
            # _get_zero1_jit takes the epoch's PartitionSpecs for arrays:
            # AttributeError on .ndim); batch 1 of the epoch is step's
            _record(out, "indexed", tr.step(data["x1"], data["y1"]), net)
        else:
            handle = tr.put_epoch(np.stack([data["x0"], data["x1"]]),
                                  np.stack([data["y0"], data["y1"]]))
            _record(out, "indexed", tr.step_indexed(handle, 1), net)
    return out


def _jax_reshard(w0, data, tmp):
    out = {}
    net = _jax_net(w0)
    tr = _jax_trainer(net, 4, True, "adam", {"learning_rate": ADAM_LR})
    tr.step(data["x0"], data["y0"])
    tr.step(data["x1"], data["y1"])
    mgr = jckpt.CheckpointManager(str(tmp), keep=2)
    mgr.save(2, params=net, trainer=tr, sync=True)
    _record(out, "dp4", jmx.nd.zeros((1,)), net)
    jckpt.reshard_in_place(tr, jmake_mesh({"dp": 2},
                                          devices=jax.devices()[:2]),
                           params=net)
    _record(out, "dp2", tr.step(data["x2"], data["y2"]), net)
    got = jckpt.reshard_from_checkpoint(
        tr, jmake_mesh({"dp": 1}, devices=jax.devices()[:1]), params=net,
        manager=mgr)
    out["restored_step"] = got["step"]
    _record(out, "dp1", tr.step(data["x2"], data["y2"]), net)
    return out


@pytest.fixture(scope="module")
def job(tmp_path_factory):
    """The four ranks' results beside the reference's runs (the ranks
    run while the reference compiles)."""
    tmp = tmp_path_factory.mktemp("dist")
    w0 = _weights(_jax_net())
    data = _data()
    pending = {}

    def start():
        pending["outs"] = worker.run_ranks("distributed", WORLD, tmp, w0,
                                           data)
    import threading
    thread = threading.Thread(target=start)
    thread.start()
    ref = {}
    try:
        for n in (4, 2):
            for shard in (False, True):
                ref[f"dp{n}/{'zero1' if shard else 'psum'}"] = \
                    _jax_sequence(w0, data, n, shard)
        ref["wire/bf16"] = _jax_sequence(w0, data, 4, True, "bf16",
                                         sequence=False)
        ref["reshard"] = _jax_reshard(w0, data,
                                      tmp_path_factory.mktemp("jckpt"))
    finally:
        thread.join()
    if "outs" not in pending:
        raise RuntimeError("the ranks did not finish")
    return dict(ranks=pending["outs"], ref=ref, w0=w0, data=data)


def _close(got, want, what, rtol=RTOL):
    scale = max(float(np.linalg.norm(want)), 1e-30)
    err = float(np.linalg.norm(got - want)) / scale
    assert err <= rtol, f"{what}: {err:.3g} relative to {scale:.3g}"


def _hold(rank_out, ref, prefix, call):
    """One call's loss and trainable parameters, a rank's against the
    reference's."""
    _close(rank_out[f"{prefix}/{call}/loss"], ref[f"{call}/loss"],
           f"{prefix} {call} loss")
    for k, v in ref.items():
        if not k.startswith(call + "/") or k.endswith("/loss") or \
                "running_" in k:
            continue
        name = k[len(call) + 1:]
        got = rank_out[f"{prefix}/{k}"]
        if name in BN_FED_BIASES:
            assert np.abs(got - v).max() <= BN_BIAS_ATOL, (prefix, k)
        else:
            _close(got, v, f"{prefix} {k}")


def _ranks_equal(ranks, prefix, n):
    keys = [k for k in ranks[0] if k.startswith(prefix + "/") and
            "/stats/" not in k and "running_" not in k]
    assert keys
    for r in range(1, n):
        for k in keys:
            assert np.array_equal(ranks[r][k], ranks[0][k]), (r, k)


CALLS = ["step1", "step2", "accum", "multi", "indexed"]


@pytest.mark.parametrize("call", CALLS)
@pytest.mark.parametrize("path", ["psum", "zero1"])
@pytest.mark.parametrize("dp", [4, 2])
def test_data_parallel_trainer_matches_the_reference_mesh(job, dp, path,
                                                          call):
    prefix = f"dp{dp}/{path}"
    _hold(job["ranks"][0], job["ref"][prefix], prefix, call)
    _ranks_equal(job["ranks"], f"{prefix}/{call}", dp)


def _port_bn_stats(w0, x, y):
    """The port on one device: one SGD step on ``(x, y)``; its
    BatchNorm statistics."""
    with mx.cpu():
        net = worker.built(worker.conv_net, w0)
        tr = parallel.DataParallelTrainer(
            net, gluon.loss.SoftmaxCrossEntropyLoss(), "sgd",
            {"learning_rate": LR}, mesh=parallel.make_mesh({"dp": 1}))
        tr.step(x, y)
        return _weights(net, trainable=False)


@pytest.mark.parametrize("path", ["psum", "zero1"])
def test_batchnorm_statistics_follow_the_reference_paths(job, path):
    """The psum path normalizes over the global batch (every rank holds
    the global batch's statistics), ZeRO-1 over each rank's rows."""
    x, y = job["data"]["x0"], job["data"]["y0"]
    glob = _port_bn_stats(job["w0"], x, y)
    for r in range(2):
        want = glob if path == "psum" else _port_bn_stats(
            job["w0"], worker.part(x, r, 2), worker.part(y, r, 2))
        for k, v in want.items():
            got = job["ranks"][r][f"bn/{path}/{k}"]
            assert np.abs(got - v).max() <= 1e-6, (r, k)
    moved = any(not np.array_equal(job["ranks"][0][f"bn/{path}/{k}"],
                                   job["ranks"][1][f"bn/{path}/{k}"])
                for k in glob)
    assert moved == (path == "zero1")


@pytest.mark.parametrize("call", ["step1", "step2"])
def test_zero1_bf16_wire_matches_the_reference_bf16_wire(job, call):
    ref, w0 = job["ref"]["wire/bf16"], job["w0"]
    out = job["ranks"][0]
    for k, v in ref.items():
        if not k.startswith(call + "/") or k.endswith("/loss"):
            continue
        name = k[len(call) + 1:]
        if name in BN_FED_BIASES or "running_" in name:
            continue
        _close(out[f"wire/bf16/{k}"] - w0[name], v - w0[name],
               f"bf16 {k} update", rtol=BF16_RTOL)
    _ranks_equal(job["ranks"], f"wire/bf16/{call}", WORLD)


def test_zero1_int8_wire_within_its_rounding_bound(job):
    """Step 1 of the int8 wire against the reference's fp32 wire (its
    dp 4 ZeRO-1 run): every element within lr times the ranks' mean
    quantum."""
    ref = job["ref"]["dp4/zero1"]
    quantum = np.mean([r["wire/int8/amax"][0] for r in job["ranks"]]) / 127
    bound = LR * quantum + 1e-6
    out = job["ranks"][0]
    for k, v in ref.items():
        if not k.startswith("step1/") or k.endswith("/loss"):
            continue
        name = k[len("step1/"):]
        if "running_" in name:
            continue
        err = np.abs(out[f"wire/int8/{k}"] - v).max()
        assert err <= bound, (name, err, bound)
    _ranks_equal(job["ranks"], "wire/int8/step2", WORLD)
    assert np.isfinite(out["wire/int8/step2/loss"]).all()


@pytest.mark.parametrize("stage", ["dp4", "dp2", "dp1"])
def test_reshard_four_to_two_to_one(job, stage):
    ref, ranks = job["ref"]["reshard"], job["ranks"]
    n = {"dp4": 4, "dp2": 2, "dp1": 1}[stage]
    for k, v in ref.items():
        if not k.startswith(stage + "/") or "running_" in k:
            continue
        if k.endswith("/loss") and stage == "dp4":
            continue
        got = ranks[0][f"reshard/{k}"]
        if k[len(stage) + 1:] in BN_FED_BIASES:
            assert np.abs(got - v).max() <= ADAM_NOISE_ATOL, k
        else:
            _close(got, v, f"reshard {k}")
    if n > 1:
        _ranks_equal(ranks, f"reshard/{stage}", n)
    assert all(int(r["reshard/restored_step"]) == ref["restored_step"]
               for r in ranks)
    if stage == "dp1":
        assert all(int(r["reshard/outside_refused"]) == 1 for r in ranks[1:])


def test_comm_stats_and_overlap_probe(job):
    import json
    out = job["ranks"][0]
    stats = json.loads(bytes(out["obs/comm"]).decode())
    lengths = out["obs/bucket_lengths"]
    assert stats["zero1"] and stats["dp"] == WORLD
    assert stats["buckets"] == len(lengths) > 1
    assert all(n % WORLD == 0 for n in lengths)
    assert int(out["obs/shard_len"]) == sum(lengths) // WORLD
    assert stats["bytes_reduced_per_step"] == 4 * sum(lengths)
    assert stats["bytes_gathered_per_step"] == 4 * sum(lengths)
    assert stats["backend"] == "gloo"
    assert stats["collective_ms"] > 0 and stats["est_ici_gb_s"] is not None
    # the step launches its collectives after the backward: no overlap
    assert stats["overlap_efficiency"] is None and not stats["overlap_comm"]
    # Adam: two f32 leaves a rank's shard, the replicated state N times it
    assert stats["state_bytes_per_chip"] == 2 * 4 * sum(lengths) // WORLD + 4
    probe = json.loads(bytes(out["obs/probe"]).decode())
    assert probe["overlap_frac"] is None
    assert probe["monolithic_step_ms"] == probe["overlapped_step_ms"]
    assert all(probe[k] >= 0 for k in probe if k != "overlap_frac")
    carried = json.loads(bytes(out["obs/comm_probe"]).decode())
    assert carried["exposed_comm_ms"] == round(probe["exposed_comm_ms"], 3)
    assert stats["exposed_comm_ms"] is None
    assert bool(out["obs/unchanged"])
    psum = json.loads(bytes(out["obs/psum_comm"]).decode())
    assert not psum["zero1"] and psum["collective_ms"] is None
    assert psum["backend"] == "gloo"


def test_zero1_many_buckets_match_one_bucket(job):
    """ZeRO-1 Adam at dp 4 over buckets of 1e-3 MiB (each padded to a
    multiple of 4, the shards concatenated across buckets) against the
    same step over one 32 MiB bucket: every trainable parameter within
    1e-5 relative, the BatchNorm-fed biases (rounding noise, which Adam
    steps by up to lr) within 2 lr."""
    lengths = job["ranks"][0]["obs/bucket_lengths"]
    assert len(lengths) >= 3
    for out in job["ranks"]:
        keys = [k[len("obs/buckets/"):] for k in out
                if k.startswith("obs/buckets/")]
        assert keys
        for k in keys:
            got, want = out["obs/buckets/" + k], out["obs/one_bucket/" + k]
            if k in BN_FED_BIASES:
                assert np.abs(got - want).max() <= 2 * 1e-3, k
            else:
                _close(got, want, k)


def test_gradients_reduce_once_and_the_mesh_surface(job):
    ranks = job["ranks"]
    n_params = len(ranks[0]["grads/sum"])
    want = np.array([sum(r + 1 + i for r in range(WORLD))
                     for i in range(n_params)], np.float64)
    want_dp2 = np.array([(1 + i) + (2 + i) for i in range(n_params)],
                        np.float64)
    for r in ranks[:2]:
        np.testing.assert_array_equal(r["grads/sum_dp2"], want_dp2)
        assert int(r["grads/bad_axis_refused"]) == 1
    for r in ranks:
        np.testing.assert_array_equal(r["grads/sum"], want)
        assert int(r["mesh/size"]) == WORLD and int(r["mesh/cfg"]) == WORLD
        assert int(r["mesh/local"]) == 1 and bool(r["mesh/dist_kvstore"])
        assert int(r["mesh/refused_10b"]) == 1
        assert not bool(r["after/dist_kvstore"])
    assert [int(r["mesh/rank"]) for r in ranks] == list(range(WORLD))
    for r in ranks[:2]:
        np.testing.assert_array_equal(r["reinit/sum"], [3.0])
        assert int(r["reinit/size"]) == 2


def test_meshes_need_a_process_group():
    import torch
    cpu = torch.device("cpu")
    with pytest.raises(mx.MXNetError, match="distributed_init"):
        parallel.make_mesh({"dp": 2}, devices=[cpu, cpu])
    with pytest.raises(mx.MXNetError, match="distributed_init"):
        parallel.MeshConfig(dp=2).build([cpu, cpu])
    with pytest.raises(mx.NotSupportedError, match="item 10b"):
        parallel.make_mesh({"dp": 1, "tp": 2}, devices=[cpu, cpu])
    assert parallel.MeshConfig.from_spec("dp4") == parallel.MeshConfig(dp=4)
    assert parallel.MeshConfig(dp=-1).resolve(8).dp == 8
    with mx.cpu():
        assert parallel.distributed_init() is False
    with pytest.raises(mx.MXNetError, match="num_processes"):
        parallel.distributed_init("file:///nowhere")
