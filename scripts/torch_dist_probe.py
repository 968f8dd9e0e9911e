#!/usr/bin/env python3
"""Which torch.distributed collectives run on CUDA tensors, and exactly,
for the ways the port's multi-GPU tests put ranks on one card.

    python3 scripts/torch_dist_probe.py   # on a machine with a CUDA card

Three launches, each of spawned processes on cuda:0: one NCCL rank, two
gloo ranks, two NCCL ranks. Each rank runs all_reduce (sum, max),
broadcast, all_gather and reduce_scatter (the list forms that
gs_init_tpu_torch/parallel/collectives.py uses) on ~93 MB of random CUDA
data made just after a matmul, and prints per op "ok" with the max error
against the sum computed locally, or the exception. Two NCCL ranks on one
device fail to form a communicator ("Duplicate GPU detected"), which is
why ranks that share a card use gloo.
"""
import socket
import sys
import traceback

import torch
import torch.distributed as dist
import torch.multiprocessing as mp

N = 23_000_000  # f32 elements, about 93 MB: the flagship's flat gradient


def free_port():
    s = socket.socket()
    s.bind(("localhost", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def draw(r, dev, n=N):
    return torch.randn(n, generator=torch.Generator(device=dev).manual_seed(100 + r), device=dev)


def worker(rank, world, port, backend, q):
    out = {}
    try:
        dev = torch.device("cuda", 0)
        torch.cuda.set_device(dev)
        dist.init_process_group(backend, init_method=f"tcp://localhost:{port}", world_size=world, rank=rank,
                                device_id=dev if backend == "nccl" else None)
        a = torch.randn(4096, 4096, device=dev)
        fresh = lambda n=N: (a @ a).sum() * 0 + draw(rank, dev, n)  # made by a kernel just before the op
        want = sum(draw(r, dev) for r in range(world))

        def run(name, fn):
            try:
                out[name] = f"ok, max err {fn():.3e}"
            except Exception as e:
                out[name] = f"{type(e).__name__}: {str(e)[:160]}"

        def all_reduce():
            x = fresh()
            dist.all_reduce(x)
            return float((x - want).abs().max())

        def all_reduce_max():
            x = fresh()
            dist.all_reduce(x, op=dist.ReduceOp.MAX)
            return float((x - torch.stack([draw(r, dev) for r in range(world)]).amax(0)).abs().max())

        def broadcast():
            x = fresh()
            dist.broadcast(x, 0)
            return float((x - draw(0, dev)).abs().max())

        def all_gather():
            x = fresh(2_000_000)
            parts = [torch.empty_like(x) for _ in range(world)]
            dist.all_gather(parts, x)
            return max(float((p - draw(r, dev, 2_000_000)).abs().max()) for r, p in enumerate(parts))

        def reduce_scatter():
            x = fresh(4_000_000)
            chunks = [c.contiguous() for c in x.chunk(world)]
            o = torch.empty_like(chunks[rank])
            dist.reduce_scatter(o, chunks)
            return float((o - sum(draw(r, dev, 4_000_000) for r in range(world)).chunk(world)[rank]).abs().max())

        for name, fn in (("all_reduce", all_reduce), ("all_reduce_max", all_reduce_max),
                         ("broadcast", broadcast), ("all_gather", all_gather),
                         ("reduce_scatter", reduce_scatter)):
            run(name, fn)
        dist.barrier()
        dist.destroy_process_group()
    except Exception:
        out["fatal"] = traceback.format_exc()[-600:]
    q.put((rank, out))


def main():
    if not torch.cuda.is_available():
        print("torch_dist_probe.py needs a CUDA card", file=sys.stderr)
        return 2
    print(sys.version.split()[0], torch.__version__, torch.version.cuda, torch.cuda.get_device_name(0), flush=True)
    ctx = mp.get_context("spawn")
    for backend, world in (("nccl", 1), ("gloo", 2), ("nccl", 2)):
        q = ctx.Queue()
        port = free_port()
        procs = [ctx.Process(target=worker, args=(r, world, port, backend, q)) for r in range(world)]
        for p in procs:
            p.start()
        res = sorted(q.get(timeout=300) for _ in procs)
        for p in procs:
            p.join(timeout=30)
            if p.is_alive():
                p.kill()
        for rank, out in res:
            print(f"{backend}, {world} rank(s), rank {rank}: {out}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
