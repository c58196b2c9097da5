"""One rank of the port's multi-process CPU tests (gloo).

``python tests/torch_dist_worker.py SPEC RANK`` joins the gloo process
group ``SPEC`` names (a JSON file: ``store``, ``world``, ``job``,
``weights``, ``data``, ``out``, ``tmp``), inside ``with mx.cpu():``
except for the ``card`` job (its ranks share ``cuda:0``), runs every
scenario of the job (``distributed``, ``kvstore``, ``contrib`` or
``card``) on one
thread, and writes its results as ``<out>/rank<RANK>.npz`` (name ->
array).  The test modules ``test_torch_port_distributed.py`` and
``test_torch_port_kvstore.py`` start the ranks and hold the results
against the JAX package (``test_torch_port_gluon_contrib.py`` the
``contrib`` job's ``SyncBatchNorm``); ``test_torch_port_cuda.py`` runs
the card job.
Imports torch and the port only.
"""
import json
import os
import subprocess
import sys

import numpy as np
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if REPO not in sys.path:
    sys.path.insert(0, REPO)

import mxnet_tpu_torch as mx                     # noqa: E402
from mxnet_tpu_torch import (autograd, checkpoint, gluon, kv,  # noqa: E402
                             parallel, runtime)
from mxnet_tpu_torch.convert import load_block_weights  # noqa: E402
from mxnet_tpu_torch.ndarray import sparse  # noqa: E402

OUT = {}


def put(name, value):
    OUT[name] = np.asarray(value)


def conv_net():
    """The distributed job's net: two convs, each feeding a BatchNorm."""
    nn = gluon.nn
    net = nn.HybridSequential(prefix="ddpnet_")
    with net.name_scope():
        net.add(nn.Conv2D(8, 3, padding=1), nn.BatchNorm(),
                nn.Activation("relu"), nn.MaxPool2D(2),
                nn.Conv2D(8, 3, padding=1), nn.BatchNorm(),
                nn.Activation("relu"), nn.GlobalAvgPool2D(),
                nn.Dense(10))
    return net


def mlp_net():
    """The kvstore job's net for the gluon Trainer."""
    nn = gluon.nn
    net = nn.HybridSequential(prefix="kvnet_")
    with net.name_scope():
        net.add(nn.Dense(16, activation="relu"), nn.Dense(4))
    return net


def weights_of(net, trainable=None):
    return {k: p.data().asnumpy() for k, p in
            net._collect_params_with_prefix().items()
            if trainable is None or (p.grad_req != "null") == trainable}


def built(make, weights):
    net = make()
    net.initialize(ctx=mx.cpu())
    load_block_weights(net, weights)
    return net


def record(tag, loss, net):
    put(f"{tag}/loss", np.asarray(loss.asnumpy(), np.float32).reshape(-1))
    for k, v in weights_of(net).items():
        put(f"{tag}/{k}", v)


def part(a, rank, n):
    """Rank ``rank``'s contiguous slice of ``n`` along axis 0."""
    b = a.shape[0] // n
    return a[rank * b:(rank + 1) * b]


# ----------------------------------------------------------------------
# the distributed job (4 ranks)
# ----------------------------------------------------------------------

def _recording_scales(tag):
    """Record each int8 reduce-scatter's local amax (the bucket's scale
    times 127) under ``<tag>/amax``: the bound of the wire's error."""
    from mxnet_tpu_torch.parallel import zero
    plain = zero.reduce_scatter_bucket
    seen = []

    def spy(flat, dp, mode="fp32", group=None, u=None):
        seen.append(float(flat.abs().max()))
        put(f"{tag}/amax", seen)
        return plain(flat, dp, mode, group, u)
    zero.reduce_scatter_bucket = spy
    return lambda: setattr(zero, "reduce_scatter_bucket", plain)


def dp_sequence(tag, rank, n, w0, data, shard, comm="fp32", sequence=True):
    """``DataParallelTrainer`` on ``make_mesh({"dp": n})`` through the
    reference test's sequence, each rank on its part of each global
    batch (of each microbatch for ``step_accum``, of each epoch batch
    for ``step_indexed``); every rank of the world builds the mesh."""
    mesh = parallel.make_mesh({"dp": n})
    if rank >= n:
        return
    net = built(conv_net, w0)
    ce = gluon.loss.SoftmaxCrossEntropyLoss()
    tr = parallel.DataParallelTrainer(
        net, ce, "sgd", {"learning_rate": 0.1, "momentum": 0.9}, mesh=mesh,
        shard_updates=shard, comm_dtype=comm)
    x0, y0, x1, y1, xd, yd = (data[k] for k in
                              ("x0", "y0", "x1", "y1", "xd", "yd"))
    record(f"{tag}/step1", tr.step(part(x0, rank, n), part(y0, rank, n)),
           net)
    record(f"{tag}/step2", tr.step(part(x1, rank, n), part(y1, rank, n)),
           net)
    if not sequence:
        return tr
    # step_accum: global microbatch m is rows [m B, (m + 1) B); this rank
    # takes its slice of each (the reference's psum path splits the
    # global batch); under ZeRO-1 the reference's shard_map splits each
    # chip's contiguous rows
    if shard:
        xa, ya = part(xd, rank, n), part(yd, rank, n)
    else:
        xa = np.concatenate([part(m, rank, n) for m in np.split(xd, 2)])
        ya = np.concatenate([part(m, rank, n) for m in np.split(yd, 2)])
    record(f"{tag}/accum", tr.step_accum(xa, ya, n_micro=2), net)
    losses = tr.step_multi([(part(x0, rank, n), part(y0, rank, n)),
                            (part(x1, rank, n), part(y1, rank, n))])
    record(f"{tag}/multi", losses, net)
    sd = np.stack([part(x0, rank, n), part(x1, rank, n)])
    sl = np.stack([part(y0, rank, n), part(y1, rank, n)])
    handle = tr.put_epoch(sd, sl)
    record(f"{tag}/indexed", tr.step_indexed(handle, 1), net)
    for k, v in weights_of(net, trainable=False).items():
        put(f"{tag}/stats/{k}", v)
    return tr


def dp_observability(rank, w0, data):
    """comm_stats, overlap_probe and the bucket shapes at dp 4; the
    many-bucket step's parameters beside the one-bucket step's."""
    mesh = parallel.make_mesh({"dp": 4})
    net = built(conv_net, w0)
    tr = parallel.DataParallelTrainer(
        net, gluon.loss.SoftmaxCrossEntropyLoss(), "adam",
        {"learning_rate": 1e-3}, mesh=mesh, shard_updates=True,
        bucket_mb=1e-3)
    x, y = part(data["x0"], rank, 4), part(data["y0"], rank, 4)
    tr.step(x, y)
    for k, v in weights_of(net, trainable=True).items():
        put(f"obs/buckets/{k}", v)
    one = built(conv_net, w0)
    parallel.DataParallelTrainer(
        one, gluon.loss.SoftmaxCrossEntropyLoss(), "adam",
        {"learning_rate": 1e-3}, mesh=mesh, shard_updates=True).step(x, y)
    for k, v in weights_of(one, trainable=True).items():
        put(f"obs/one_bucket/{k}", v)
    stats = tr.comm_stats(measure=True, iters=2)
    before = weights_of(net)
    probe = tr.overlap_probe(x, y, iters=1)
    put("obs/comm_probe", np.frombuffer(json.dumps(
        tr.comm_stats(overlap_stats=probe)).encode(), np.uint8))
    put("obs/comm", np.frombuffer(json.dumps(stats).encode(), np.uint8))
    put("obs/probe", np.frombuffer(json.dumps(probe).encode(), np.uint8))
    put("obs/unchanged", all(np.array_equal(v, weights_of(net)[k])
                             for k, v in before.items()))
    put("obs/shard_len", tr._flat_upd.numel())
    put("obs/bucket_lengths", np.asarray(tr._plan.lengths))
    psum = parallel.DataParallelTrainer(
        net, gluon.loss.SoftmaxCrossEntropyLoss(), "sgd", {}, mesh=mesh)
    psum.step(x, y)
    put("obs/psum_comm", np.frombuffer(
        json.dumps(psum.comm_stats()).encode(), np.uint8))


def bn_statistics(rank, w0, data):
    """One step at dp 2 on each path: the BatchNorm statistics each
    rank holds after it."""
    for shard in (False, True):
        mesh = parallel.make_mesh({"dp": 2})
        if rank >= 2:
            continue
        net = built(conv_net, w0)
        tr = parallel.DataParallelTrainer(
            net, gluon.loss.SoftmaxCrossEntropyLoss(), "sgd",
            {"learning_rate": 0.1}, mesh=mesh, shard_updates=shard)
        tr.step(part(data["x0"], rank, 2), part(data["y0"], rank, 2))
        for k, v in weights_of(net, trainable=False).items():
            put(f"bn/{'zero1' if shard else 'psum'}/{k}", v)


def reshard(rank, w0, data, tmp):
    """ZeRO-1 at dp 4, two steps, a checkpoint; reshard_in_place onto dp
    2 and a step; reshard_from_checkpoint onto dp 1 and a step."""
    mesh4 = parallel.make_mesh({"dp": 4})
    net = built(conv_net, w0)
    tr = parallel.DataParallelTrainer(
        net, gluon.loss.SoftmaxCrossEntropyLoss(), "adam",
        {"learning_rate": 1e-2}, mesh=mesh4, shard_updates=True)
    for b in ("0", "1"):
        tr.step(part(data["x" + b], rank, 4), part(data["y" + b], rank, 4))
    mgr = checkpoint.CheckpointManager(os.path.join(tmp, "ckpt"), keep=2)
    mgr.save(2, params=net, trainer=tr, sync=True)
    record("reshard/dp4", mx.nd.zeros((1,)), net)
    mesh2 = parallel.make_mesh({"dp": 2})
    checkpoint.reshard_in_place(tr, mesh2, params=net)
    if rank < 2:
        loss = tr.step(part(data["x2"], rank, 2), part(data["y2"], rank, 2))
        record("reshard/dp2", loss, net)
    mesh1 = parallel.make_mesh({"dp": 1})
    got = checkpoint.reshard_from_checkpoint(tr, mesh1, params=net,
                                             manager=mgr)
    put("reshard/restored_step", got["step"])
    if rank == 0:
        record("reshard/dp1", tr.step(data["x2"], data["y2"]), net)
    else:
        try:
            tr.step(data["x2"], data["y2"])
            put("reshard/outside_refused", 0)
        except mx.MXNetError:
            put("reshard/outside_refused", 1)


def grads_and_mesh(rank, world, spec):
    """all_reduce_gradients without a store; the mesh and runtime
    surface; reinit_distributed onto two ranks."""
    net = mlp_net()
    net.initialize(ctx=mx.cpu())
    net(mx.nd.ones((1, 3)))
    params = [p for _, p in sorted(net.collect_params().items())]
    for i, p in enumerate(params):
        p._var.grad = torch.full_like(p._var, float(rank + 1 + i))
    parallel.all_reduce_gradients(params)
    parallel.all_reduce_gradients(params)          # once a cycle
    put("grads/sum", np.stack([float(p._var.grad.reshape(-1)[0])
                               for p in params]))
    # over a mesh of ranks 0-1 of the four: its subgroup alone
    mesh2 = parallel.make_mesh({"dp": 2})
    if rank < 2:
        for i, p in enumerate(params):
            p._var.grad = torch.full_like(p._var, float(rank + 1 + i))
        parallel.all_reduce_gradients(params, mesh=mesh2)
        put("grads/sum_dp2", np.stack([float(p._var.grad.reshape(-1)[0])
                                       for p in params]))
        try:
            parallel.all_reduce_gradients(params, mesh=mesh2, axis="tp")
            put("grads/bad_axis_refused", 0)
        except mx.MXNetError:
            put("grads/bad_axis_refused", 1)
    mesh = parallel.make_mesh()
    put("mesh/size", mesh.size)
    put("mesh/rank", mesh.rank)
    put("mesh/cfg", parallel.MeshConfig(dp=-1).build().size)
    put("mesh/local", parallel.local_mesh().size)
    put("mesh/dist_kvstore", runtime.Features().is_enabled("DIST_KVSTORE"))
    for make in (lambda: parallel.make_mesh({"dp": 2, "tp": 2}),
                 lambda: parallel.MeshConfig(dp=2, pp=2),
                 lambda: parallel.MeshConfig().stage_mesh(0)):
        try:
            make()
            put("mesh/refused_10b", 0)
        except mx.NotSupportedError as e:
            put("mesh/refused_10b", int("item 10b" in str(e)))
    secs = parallel.reinit_distributed(
        "file://" + spec["store"] + ".two", 2 if rank < 2 else 1,
        rank if rank < 2 else 0)
    put("reinit/seconds", secs)
    if rank < 2:
        t = torch.tensor([float(rank + 1)])
        torch.distributed.all_reduce(t)
        put("reinit/sum", t.numpy())
        put("reinit/size", torch.distributed.get_world_size())


def job_distributed(rank, world, spec, w0, data):
    for n in (4, 2):
        for shard in (False, True):
            dp_sequence(f"dp{n}/{'zero1' if shard else 'psum'}", rank, n,
                        w0, data, shard)
    for comm in ("bf16", "int8"):
        undo = _recording_scales(f"wire/{comm}")
        try:
            dp_sequence(f"wire/{comm}", rank, 4, w0, data, True, comm=comm,
                        sequence=False)
        finally:
            undo()
    bn_statistics(rank, w0, data)
    dp_observability(rank, w0, data)
    reshard(rank, w0, data, spec["tmp"])
    grads_and_mesh(rank, world, spec)


# ----------------------------------------------------------------------
# the kvstore job (2 ranks)
# ----------------------------------------------------------------------

KV_TYPES = ("local", "device", "nccl", "tpu_sync", "dist_sync",
            "dist_device_sync", "dist_tpu_sync", "horovod", "byteps")


def kv_types(rank, data):
    for name in KV_TYPES:
        store = kv.create(name)
        put(f"kv/{name}/meta", [store.rank, store.num_workers])
        put(f"kv/{name}/type", np.frombuffer(store.type.encode(), np.uint8))
        store.init(3, mx.nd.array(data["init"][rank]))
        out = mx.nd.zeros((4, 5))
        store.pull(3, out=out)
        put(f"kv/{name}/init", out.asnumpy())
        store.push(3, mx.nd.array(data["v"][rank]))
        store.pull(3, out=out)
        put(f"kv/{name}/push", out.asnumpy())
        # a list of keys, each pushed as two copies
        store.init([5, 7], [mx.nd.zeros((4, 5)), mx.nd.zeros((3,))])
        outs = [mx.nd.zeros((4, 5)), mx.nd.zeros((3,))]
        store.pushpull([5, 7], [[mx.nd.array(data["v"][rank]),
                                 mx.nd.array(data["v2"][rank])],
                                [mx.nd.array(data["w"][rank])] * 2],
                       out=outs)
        put(f"kv/{name}/pushpull5", outs[0].asnumpy())
        put(f"kv/{name}/pushpull7", outs[1].asnumpy())
        store.barrier()
    scatter = kv.create("tpu_sync")
    scatter.init("s", mx.nd.zeros((8,)))
    put("kv/scatter", scatter.pushpull_scatter(
        "s", mx.nd.array(data["flat"][rank])).asnumpy())
    for wire in ("allgather",):
        store = kv.create("dist_sync", wire=wire, bigarray_bound=64)
        store.init([1, 2], [mx.nd.zeros((4, 5)), mx.nd.zeros((3,))])
        outs = [mx.nd.zeros((4, 5)), mx.nd.zeros((3,))]
        store.pushpull([1, 2], [mx.nd.array(data["v"][rank]),
                                mx.nd.array(data["w"][rank])], out=outs)
        put(f"kv/wire_{wire}/1", outs[0].asnumpy())
        put(f"kv/wire_{wire}/2", outs[1].asnumpy())
    try:
        kv.create("dist_async")
        put("kv/dist_async_refused", 0)
    except mx.NotSupportedError as e:
        put("kv/dist_async_refused", int("item 10b" in str(e)))


def kv_compression(rank, data):
    for ctype, params in (("2bit", {"type": "2bit", "threshold": 0.5}),
                          ("int8", {"type": "int8"})):
        store = kv.create("dist_sync")
        store.set_gradient_compression(params)
        store.init("g", mx.nd.zeros((300,)))
        out = mx.nd.zeros((300,))
        for step in range(2):
            store.push("g", mx.nd.array(data["g"][step][rank]))
            store.pull("g", out=out)
            put(f"comp/{ctype}/{step}", out.asnumpy())


def kv_sparse(rank, data):
    store = kv.create("dist_sync")
    store.init("emb", mx.nd.array(data["emb"]))
    pulled = store.row_sparse_pull("emb", row_ids=mx.nd.array(
        data["rows"][rank]))
    put("sparse/pull_rows", pulled.indices.asnumpy())
    put("sparse/pull_values", pulled.values.asnumpy())
    store = kv.create("dist_sync")
    store.init("w", mx.nd.zeros((10, 2)))
    g = sparse.row_sparse_array((data["svals"][rank], data["srows"][rank]),
                                shape=(10, 2))
    store.push("w", g)
    dense = mx.nd.zeros((10, 2))
    store.pull("w", out=dense)
    put("sparse/push", dense.asnumpy())


def kv_trainer(rank, world, w0, data):
    """The gluon Trainer over a dist_sync store: plain (the overlap
    scheduler on), without the scheduler, and with the optimizer on the
    store."""
    x, y = data["tx"], data["ty"]
    gb = x.shape[1]
    for tag, kw in (("sgd", {}), ("no_overlap", {"overlap_comm": False}),
                    ("on_kvstore", {"update_on_kvstore": True})):
        net = built(mlp_net, w0)
        tr = gluon.Trainer(net.collect_params(), "sgd",
                           {"learning_rate": 0.1, "momentum": 0.9},
                           kvstore="dist_sync", **kw)
        ce = gluon.loss.SoftmaxCrossEntropyLoss()
        for step in range(3):
            with autograd.record():
                loss = ce(net(mx.nd.array(part(x[step], rank, world))),
                          mx.nd.array(part(y[step], rank, world)))
            loss.backward()
            tr.step(gb)
            for k, v in weights_of(net).items():
                put(f"trainer/{tag}/{step}/{k}", v)
        if tr._overlap is not None:
            put(f"trainer/{tag}/hook_launches",
                tr._overlap.stats["hook_launches"])


def job_kvstore(rank, world, spec, w0, data):
    kv_types(rank, data)
    kv_compression(rank, data)
    kv_sparse(rank, data)
    kv_trainer(rank, world, w0, data)


def job_contrib(rank, world, spec, w0, data):
    """``gluon.contrib.nn.SyncBatchNorm`` on this rank's slice of the
    batch in training mode: output, the input's and gamma's and beta's
    gradients of a weighted square loss, and the running statistics."""
    from mxnet_tpu_torch.gluon.contrib import nn as cnn
    bn = cnn.SyncBatchNorm(in_channels=w0["gamma"].shape[0], prefix="sbn_")
    bn.initialize(ctx=mx.cpu())
    load_block_weights(bn, w0)
    x = mx.nd.array(part(data["x"], rank, world))
    c = mx.nd.array(part(data["c"], rank, world))
    x.attach_grad()
    with autograd.record():
        y = bn(x)
        loss = (y * y * c).sum()
    loss.backward()
    put("sync_bn/y", y.asnumpy())
    put("sync_bn/dx", x.grad.asnumpy())
    for k, p in bn._collect_params_with_prefix().items():
        put(f"sync_bn/{k}", p.data().asnumpy())
        if p.grad_req != "null":
            put(f"sync_bn/grad/{k}", p.grad().asnumpy())


def run_ranks(job, world, tmp, weights, data, timeout=240):
    """Start ``world`` ranks of ``job`` as processes over a ``file://``
    store in ``tmp``, wait for them (each at most ``timeout`` s) and
    return each rank's results (a list of dicts).  Fails with a rank's
    output when it exits with an error."""
    tmp = str(tmp)
    np.savez(os.path.join(tmp, "weights.npz"), **weights)
    np.savez(os.path.join(tmp, "data.npz"), **data)
    spec = {"store": os.path.join(tmp, "store"), "world": world,
            "job": job, "weights": os.path.join(tmp, "weights.npz"),
            "data": os.path.join(tmp, "data.npz"), "out": tmp, "tmp": tmp}
    path = os.path.join(tmp, "spec.json")
    with open(path, "w") as f:
        json.dump(spec, f)
    env = dict(os.environ, OMP_NUM_THREADS="1")
    env.pop("PYTHONPATH", None)
    procs = [subprocess.Popen([sys.executable, os.path.abspath(__file__),
                               path, str(r)], stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, env=env)
             for r in range(world)]
    outs = []
    try:
        for r, p in enumerate(procs):
            out, _ = p.communicate(timeout=timeout)
            if p.returncode:
                raise RuntimeError(f"{job} rank {r} exited {p.returncode}:\n"
                                   + out.decode(errors="replace")[-4000:])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for r in range(world):
        outs.append(dict(np.load(os.path.join(tmp, f"rank{r}.npz"))))
    return outs


# ----------------------------------------------------------------------
# the card job (2 ranks sharing cuda:0 over gloo; test_torch_port_cuda)
# ----------------------------------------------------------------------

def job_card(rank, world, spec, w0, data):
    """Both paths at dp 2 on the card (eager: gloo), two steps; then K1
    on this rank's ZeRO-1 shard against its plain version."""
    from mxnet_tpu_torch.ops.fused_update import fused_bucket_rule
    from mxnet_tpu_torch.optimizer import fused_rule
    torch.backends.cudnn.deterministic = True
    for shard in (False, True):
        tag = "card/" + ("zero1" if shard else "psum")
        mesh = parallel.make_mesh({"dp": 2})
        net = conv_net()
        net.initialize(ctx=mx.gpu(0))
        load_block_weights(net, w0)
        tr = parallel.DataParallelTrainer(
            net, gluon.loss.SoftmaxCrossEntropyLoss(), "sgd",
            {"learning_rate": 0.1, "momentum": 0.9}, mesh=mesh,
            shard_updates=shard)
        put(f"{tag}/use_graphs", tr._use_graphs)
        for b in ("0", "1"):
            loss = tr.step(part(data["x" + b], rank, 2),
                           part(data["y" + b], rank, 2))
        record(tag, loss, net)
        if shard:
            gen = torch.Generator(device="cuda").manual_seed(rank)
            g = torch.randn(tr._flat_upd.shape, device="cuda",
                            generator=gen) * 1e-2
            p, mom = tr._flat_upd.clone(), tr._flat_state["mom"].clone()
            want_p, want_s = fused_rule("sgd", momentum=0.9)[1](
                p.cpu(), g.cpu(), {"mom": mom.cpu()}, 0.1, 0.0)
            lr = torch.full((1,), 0.1, device="cuda")
            got_p, got_s = fused_bucket_rule("sgd", momentum=0.9)[1](
                p, g, {"mom": mom}, lr, 0.0)
            put(f"{tag}/k1_shard", tr._flat_upd.numel())
            put(f"{tag}/k1_err", max(
                float((got_p.cpu() - want_p).abs().max()),
                float((got_s["mom"].cpu() - want_s["mom"]).abs().max())))
            put(f"{tag}/k1_scale", float(want_p.abs().max()))


def main(spec_path, rank):
    import contextlib
    with open(spec_path) as f:
        spec = json.load(f)
    torch.set_num_threads(1)
    rank, world = int(rank), int(spec["world"])
    w0 = dict(np.load(spec["weights"]))
    data = dict(np.load(spec["data"]))
    card = spec["job"] == "card"
    with contextlib.nullcontext() if card else mx.cpu():
        parallel.distributed_init("file://" + spec["store"], world, rank,
                                  backend="gloo")
        {"distributed": job_distributed, "kvstore": job_kvstore,
         "card": job_card, "contrib": job_contrib}[spec["job"]](
            rank, world, spec, w0, data)
        parallel.teardown_distributed()
        put("after/dist_kvstore",
            runtime.Features().is_enabled("DIST_KVSTORE"))
    np.savez(os.path.join(spec["out"], f"rank{rank}.npz"), **OUT)


if __name__ == "__main__":
    main(sys.argv[1], sys.argv[2])
