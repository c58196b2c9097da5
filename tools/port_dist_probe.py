"""Which ``torch.distributed`` collectives this torch runs on the card.

Run on a machine with one CUDA card::

    python3 tools/port_dist_probe.py [--out DIR]

Two parts, each printed as one JSON line:

1. gloo with CUDA tensors: two spawned processes share ``cuda:0`` over a
   ``file://`` store and try ``all_reduce`` (f32, bf16, int8, async),
   ``reduce_scatter_tensor``, ``all_gather_into_tensor`` and
   ``all_to_all_single`` (int8), and the autograd ``all_reduce`` of
   ``torch.distributed.nn``; each result is ``"ok"`` (and right) or the
   error's first line.
2. NCCL at one rank: ``all_reduce``, ``reduce_scatter_tensor`` and
   ``all_gather_into_tensor`` over a 25,575,912-element f32 bucket
   (ResNet-50's), run eagerly, then captured in one CUDA graph on a side
   stream and replayed; whether the replay's outputs equal the eager
   ones bitwise, and the eager and replayed times (CUDA events, median
   of 10).
"""
import argparse
import json
import os
import statistics
import sys
import tempfile
import time

import torch
import torch.distributed as dist
import torch.multiprocessing as mp


def _gloo_rank(rank, store, out):
    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    dist.init_process_group("gloo", init_method=f"file://{store}",
                            world_size=2, rank=rank)
    res = {}
    x = (torch.arange(8, dtype=torch.float32, device=dev) + rank)
    want = torch.arange(8, dtype=torch.float32, device=dev) * 2 + 1

    def check(name, fn):
        try:
            got = fn()
            torch.cuda.synchronize(dev)
            res[name] = "ok" if got else "wrong result"
        except Exception as e:  # noqa: BLE001 -- the probe reports it
            res[name] = f"{type(e).__name__}: {str(e).splitlines()[0][:160]}"

    def ar(dtype, async_op=False):
        y = x.to(dtype, copy=True)
        w = dist.all_reduce(y, async_op=async_op)
        if async_op:
            w.wait()
        return torch.equal(y.float(), want)

    def rs():
        o = torch.empty(4, device=dev)
        dist.reduce_scatter_tensor(o, x.clone())
        return torch.equal(o, want[rank * 4:(rank + 1) * 4])

    def ag():
        o = torch.empty(16, device=dev)
        dist.all_gather_into_tensor(o, x)
        return torch.equal(o[:8], x - rank) and torch.equal(o[8:], x - rank + 1)

    def a2a():
        o = torch.empty(8, dtype=torch.int8, device=dev)
        dist.all_to_all_single(o, x.to(torch.int8))
        base = torch.arange(8, device=dev)
        peer = torch.cat([base[rank * 4:(rank + 1) * 4],
                          base[rank * 4:(rank + 1) * 4] + 1])
        return torch.equal(o, peer.to(torch.int8))

    def ar_grad():
        from torch.distributed.nn.functional import all_reduce
        leaf = x.clone().requires_grad_()   # x + rank, summed: want
        y = all_reduce(leaf * 1.0)
        y.sum().backward()
        return torch.equal(y.detach(), want) and \
            torch.equal(leaf.grad, torch.full_like(x, 2.0))

    check("all_reduce_f32", lambda: ar(torch.float32))
    check("all_reduce_bf16", lambda: ar(torch.bfloat16))
    check("all_reduce_int8", lambda: ar(torch.int8))
    check("all_reduce_async", lambda: ar(torch.float32, True))
    check("reduce_scatter_tensor", rs)
    check("all_gather_into_tensor", ag)
    check("all_to_all_single_int8", a2a)
    check("autograd_all_reduce", ar_grad)
    if rank == 0:
        with open(out, "w") as f:
            json.dump(res, f)
    dist.destroy_process_group()


def _events_ms(fn, reps=10):
    times = []
    for _ in range(reps):
        a, b = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return statistics.median(times)


def _nccl_one_rank(store, n=25_575_912):
    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    dist.init_process_group("nccl", init_method=f"file://{store}",
                            world_size=1, rank=0)
    gen = torch.Generator(device=dev).manual_seed(0)
    src = torch.randn(n, device=dev, generator=gen)
    buf = torch.empty_like(src)
    shard = torch.empty(n, device=dev)
    full = torch.empty(n, device=dev)

    def body():
        buf.copy_(src)
        dist.all_reduce(buf)
        dist.reduce_scatter_tensor(shard, buf)
        shard.mul_(0.5)
        dist.all_gather_into_tensor(full, shard)

    body()                       # the communicator exists before capture
    torch.cuda.synchronize(dev)
    eager = (buf.clone(), shard.clone(), full.clone())
    eager_ms = _events_ms(body)
    for t in (buf, shard, full):
        t.zero_()
    side = torch.cuda.Stream(dev)
    side.wait_stream(torch.cuda.current_stream(dev))
    graph = torch.cuda.CUDAGraph()
    t0 = time.perf_counter()
    with torch.cuda.graph(graph, stream=side):
        body()
    capture_s = time.perf_counter() - t0
    graph.replay()
    torch.cuda.synchronize(dev)
    bitwise = all(torch.equal(a, b) for a, b in zip((buf, shard, full), eager))
    replay_ms = _events_ms(graph.replay)
    dist.destroy_process_group()
    return {"nccl_version": ".".join(map(str, torch.cuda.nccl.version())),
            "elements": n, "replay_bitwise_eager": bitwise,
            "eager_ms": eager_ms, "replay_ms": replay_ms,
            "capture_s": capture_s}


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", default=None, help="also write the lines here")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        sys.exit("no CUDA device: the probe runs on the card")
    with tempfile.TemporaryDirectory() as tmp:
        store, out = os.path.join(tmp, "gloo"), os.path.join(tmp, "gloo.json")
        t0 = time.perf_counter()
        mp.start_processes(_gloo_rank, args=(store, out), nprocs=2,
                           start_method="spawn")
        with open(out) as f:
            gloo = {"gloo_cuda": json.load(f),
                    "spawn_and_run_s": time.perf_counter() - t0}
        nccl = {"nccl_one_rank": _nccl_one_rank(os.path.join(tmp, "nccl"))}
    lines = [json.dumps({"torch": torch.__version__, "cuda": torch.version.cuda,
                         "card": torch.cuda.get_device_name(0)}),
             json.dumps(gloo), json.dumps(nccl)]
    print("\n".join(lines), flush=True)
    if args.out:
        os.makedirs(args.out, exist_ok=True)
        with open(os.path.join(args.out, "dist_probe.json"), "w") as f:
            f.write("\n".join(lines) + "\n")


if __name__ == "__main__":
    main()
