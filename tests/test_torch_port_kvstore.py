"""The port's ``kv`` stores and the gluon ``Trainer``'s kvstore half,
two ranks over gloo, against the JAX package on the CPU.

The ranks run as processes (``tests/torch_dist_worker.py``, job
``kvstore``, one for the module, ``file://`` store under ``tmp_path``);
the reference runs here in one process, where a push of a list of the
ranks' values is what a push from each rank sums to (its own
multi-process run fails on every run).  Values come from one
``RandomState``; the gluon Trainer's weights are the reference's,
drawn once and carried.  What is held:

- every ``kv.create`` type: ``type``, ``rank``/``num_workers``; ``init``
  (rank 0's value on the dist stores, each rank's own elsewhere), push
  and pull, ``pushpull`` of a key list pushed as two copies a rank:
  the local stores reduce a rank's copies only, ``nccl``/``tpu_sync``
  and the dist stores over the ranks too: within 1e-6 relative of the
  reference's list push (f32 sums in another order), every rank alike;
  ``pushpull_scatter`` (each rank's half of the sum); the all-gather
  wire with a 64-byte bucket bound; ``dist_async`` refused (item 10b);
- gradient compression, 2-bit and int8, two pushes (the residual
  carried): the store's value is the sum over the ranks of the
  reference's ``GradientCompression`` / ``Int8GradientCompression``
  round trip of each rank's gradient, exactly for 2-bit (sums of
  +-threshold) and within 1e-6 relative for int8;
- ``row_sparse_pull`` (each rank its rows) and a row-sparse push from
  each rank, exactly;
- the gluon ``Trainer(kvstore="dist_sync")`` over three SGD-momentum
  steps, each rank on its half of the global batch, ``step(global
  batch)``: with the overlap scheduler (which launches from the
  gradient-ready hooks after the first cycle), without it, and with
  ``update_on_kvstore=True``: every parameter within 1e-5 relative of
  the reference's Trainer on the global batch, the ranks bitwise equal.
"""
import numpy as np
import pytest

import mxnet_tpu as jmx
from mxnet_tpu import autograd as jautograd, gluon as jgluon
from mxnet_tpu.kvstore.kvstore import (GradientCompression as JComp2,
                                       Int8GradientCompression as JComp8)
from mxnet_tpu.ndarray import sparse as jsp

import torch_dist_worker as worker

WORLD = 2
RTOL = 1e-5
KV_TYPES = worker.KV_TYPES
CROSS = ("nccl", "tpu_sync", "dist_sync", "dist_device_sync",
         "dist_tpu_sync", "horovod", "byteps")
DIST = ("dist_sync", "dist_device_sync", "dist_tpu_sync", "horovod",
        "byteps")


def _jax_mlp(weights=None):
    nn = jgluon.nn
    net = nn.HybridSequential(prefix="kvnet_")
    with net.name_scope():
        net.add(nn.Dense(16, activation="relu"), nn.Dense(4))
    key = jmx.random.get_key_data()
    jmx.random.seed(25)
    try:
        net.initialize(jmx.init.Xavier())
        net(jmx.nd.ones((1, 3)))
    finally:
        jmx.random.set_key_data(key)
    if weights is not None:
        target = net._collect_params_with_prefix()
        for k, v in weights.items():
            target[k].set_data(jmx.nd.array(v))
    return net


def _weights(net):
    return {k: p.data().asnumpy() for k, p in
            net._collect_params_with_prefix().items()}


def _data():
    rng = np.random.RandomState(26)
    return {"init": rng.rand(WORLD, 4, 5).astype(np.float32),
            "v": rng.rand(WORLD, 4, 5).astype(np.float32),
            "v2": rng.rand(WORLD, 4, 5).astype(np.float32),
            "w": rng.rand(WORLD, 3).astype(np.float32),
            "flat": rng.rand(WORLD, 8).astype(np.float32),
            "g": rng.randn(2, WORLD, 300).astype(np.float32),
            "emb": rng.rand(20, 4).astype(np.float32),
            "rows": np.array([[3, 11, 3], [0, 19, 5]]),
            "svals": rng.rand(WORLD, 2, 2).astype(np.float32),
            "srows": np.array([[1, 4], [4, 7]]),
            "tx": rng.rand(3, 8, 3).astype(np.float32),
            "ty": rng.randint(0, 4, (3, 8)).astype(np.float32)}


def _jax_trainer_run(w0, data):
    """The reference's Trainer on the global batch: params after each
    step."""
    net = _jax_mlp(w0)
    tr = jgluon.Trainer(net.collect_params(), "sgd",
                        {"learning_rate": 0.1, "momentum": 0.9})
    ce = jgluon.loss.SoftmaxCrossEntropyLoss()
    out = []
    for step in range(3):
        with jautograd.record():
            loss = ce(net(jmx.nd.array(data["tx"][step])),
                      jmx.nd.array(data["ty"][step]))
        loss.backward()
        tr.step(data["tx"].shape[1])
        out.append(_weights(net))
    return out


@pytest.fixture(scope="module")
def job(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("kv")
    w0 = _weights(_jax_mlp())
    data = _data()
    ranks = worker.run_ranks("kvstore", WORLD, tmp, w0, data)
    return dict(ranks=ranks, data=data, w0=w0,
                trainer=_jax_trainer_run(w0, data))


def _close(got, want, what, rtol=1e-6):
    scale = max(float(np.linalg.norm(want)), 1e-30)
    err = float(np.linalg.norm(np.asarray(got) - want)) / scale
    assert err <= rtol, f"{what}: {err:.3g} relative to {scale:.3g}"


def _jax_sum(*values):
    """The reference store's reduce of a list of values (a push of
    several copies), read back by a pull."""
    kv = jmx.kv.create("local")
    kv.init(0, jmx.nd.zeros(values[0].shape))
    kv.push(0, [jmx.nd.array(v) for v in values])
    out = jmx.nd.zeros(values[0].shape)
    kv.pull(0, out=out)
    return out.asnumpy()


@pytest.mark.parametrize("name", KV_TYPES)
def test_every_store_type_against_the_reference(job, name):
    d = job["data"]
    ref = jmx.kv.create(name)
    cross = name in CROSS
    for r, out in enumerate(job["ranks"]):
        assert bytes(out[f"kv/{name}/type"]).decode() == ref.type
        rank, workers = out[f"kv/{name}/meta"]
        assert workers == (WORLD if name in DIST else 1)
        assert rank == (r if name in DIST else 0)
        init = d["init"][0] if name in DIST else d["init"][r]
        np.testing.assert_array_equal(out[f"kv/{name}/init"], init)
        mine = [r] if not cross else list(range(WORLD))
        _close(out[f"kv/{name}/push"], _jax_sum(*d["v"][mine]),
               f"{name} push")
        _close(out[f"kv/{name}/pushpull5"],
               _jax_sum(*d["v"][mine], *d["v2"][mine]), f"{name} key 5")
        _close(out[f"kv/{name}/pushpull7"],
               _jax_sum(*([d["w"][i] for i in mine] * 2)), f"{name} key 7")


def test_pushpull_scatter_and_the_allgather_wire(job):
    d = job["data"]
    total = _jax_sum(*d["flat"])
    for r, out in enumerate(job["ranks"]):
        _close(out["kv/scatter"], total[4 * r:4 * (r + 1)], "scatter")
        _close(out["kv/wire_allgather/1"], _jax_sum(*d["v"]), "allgather 1")
        _close(out["kv/wire_allgather/2"], _jax_sum(*d["w"]), "allgather 2")
        assert int(out["kv/dist_async_refused"]) == 1


@pytest.mark.parametrize("ctype", ["2bit", "int8"])
def test_gradient_compression_against_the_reference(job, ctype):
    d = job["data"]
    comps = [JComp2(threshold=0.5) if ctype == "2bit" else JComp8()
             for _ in range(WORLD)]
    for step in range(2):
        want = 0.0
        for r in range(WORLD):
            packed, shape = comps[r].compress("g", jmx.nd.array(
                d["g"][step][r]).data)
            want = want + np.asarray(comps[r].decompress(packed, shape))
        for out in job["ranks"]:
            got = out[f"comp/{ctype}/{step}"]
            if ctype == "2bit":
                np.testing.assert_array_equal(got, want)
            else:
                _close(got, want, f"int8 step {step}")


def test_sparse_pull_and_push_against_the_reference(job):
    d = job["data"]
    kv = jmx.kv.create("local")
    kv.init("emb", jmx.nd.array(d["emb"]))
    for r, out in enumerate(job["ranks"]):
        want = kv.row_sparse_pull("emb", row_ids=jmx.nd.array(d["rows"][r]))
        np.testing.assert_array_equal(out["sparse/pull_rows"],
                                      want.indices.asnumpy())
        np.testing.assert_array_equal(out["sparse/pull_values"],
                                      want.values.asnumpy())
    kv.init("w", jmx.nd.zeros((10, 2)))
    kv.push("w", [jsp.row_sparse_array((d["svals"][r], d["srows"][r]),
                                       shape=(10, 2)) for r in range(WORLD)])
    dense = jmx.nd.zeros((10, 2))
    kv.pull("w", out=dense)
    for out in job["ranks"]:
        np.testing.assert_array_equal(out["sparse/push"], dense.asnumpy())


@pytest.mark.parametrize("step", range(3))
@pytest.mark.parametrize("tag", ["sgd", "no_overlap", "on_kvstore"])
def test_gluon_trainer_dist_sync_against_the_reference(job, tag, step):
    want = job["trainer"][step]
    ranks = job["ranks"]
    for k, v in want.items():
        _close(ranks[0][f"trainer/{tag}/{step}/{k}"], v,
               f"{tag} step {step} {k}", rtol=RTOL)
        for r in ranks[1:]:
            np.testing.assert_array_equal(
                r[f"trainer/{tag}/{step}/{k}"],
                ranks[0][f"trainer/{tag}/{step}/{k}"])
    if tag == "sgd":
        # cycles 2 and 3 launch from the hooks (the first observes)
        assert int(ranks[0]["trainer/sgd/hook_launches"]) >= 2
    else:
        assert f"trainer/{tag}/hook_launches" not in ranks[0]
