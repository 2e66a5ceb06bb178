#!/usr/bin/env python3
"""Which ``torch.distributed`` collectives a backend takes on CUDA tensors.

    python3 tools/probe_collectives.py [--backend gloo] [--ranks 2]

For each collective the port uses (``all_reduce``, ``all_gather_into_tensor``,
``batch_isend_irecv``, ``broadcast``), two ranks (processes) started
together, both on card 0 unless there are enough cards, join a process group
over ``tcp://127.0.0.1:<free port>`` and run it once on CUDA tensors. Each
collective runs in a fresh pair of processes, so a refusal or a crash of one
does not hide the others. Prints one JSON line per collective (accepted or
the error it raised, and whether the result was right), then one summary
line. ``parallel/multihost.py``'s table of host-staged collectives is taken
from this output. Exits non-zero without CUDA.
"""

from __future__ import annotations

import argparse
import json
import os
import socket
import sys
import traceback
from datetime import timedelta

OPS = ("all_reduce", "all_gather_into_tensor", "batch_isend_irecv", "broadcast")


def _free_port() -> int:
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def _rank(rank, world, port, backend, op, out_dir):
    import torch
    import torch.distributed as dist

    dev = torch.device("cuda", rank % torch.cuda.device_count())
    torch.cuda.set_device(dev)
    res = {"op": op, "rank": rank, "backend": backend}
    try:
        dist.init_process_group(backend, init_method=f"tcp://127.0.0.1:{port}",
                                world_size=world, rank=rank, timeout=timedelta(seconds=60))
        if op == "all_reduce":
            t = torch.full((1000,), float(rank + 1), device=dev)
            dist.all_reduce(t)
            ok = bool(torch.all(t == world * (world + 1) / 2))
        elif op == "all_gather_into_tensor":
            gather = getattr(dist, "all_gather_single", None) or dist.all_gather_into_tensor
            t = torch.full((8, 3), float(rank), device=dev)
            out = torch.empty((8 * world, 3), device=dev)
            gather(out, t)
            want = torch.arange(world, device=dev).repeat_interleave(8).float()
            ok = bool(torch.all(out == want[:, None]))
        elif op == "batch_isend_irecv":
            s = torch.full((1000,), float(rank), device=dev)
            r = torch.empty(1000, device=dev)
            ops = [dist.P2POp(dist.isend, s, (rank + 1) % world),
                   dist.P2POp(dist.irecv, r, (rank - 1) % world)]
            for w in dist.batch_isend_irecv(ops):
                w.wait()
            ok = bool(torch.all(r == float((rank - 1) % world)))
        else:
            t = torch.full((1000,), float(rank), device=dev)
            dist.broadcast(t, 0)
            ok = bool(torch.all(t == 0.0))
        torch.cuda.synchronize(dev)
        res.update(accepted=True, correct=ok)
    except Exception as exc:  # the probe records the refusal, it does not act on it
        res.update(accepted=False, error=f"{type(exc).__name__}: {exc}"[:400],
                   trace=traceback.format_exc()[-800:])
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()
    with open(os.path.join(out_dir, f"{op}.{rank}.json"), "w") as f:
        json.dump(res, f)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--backend", default="gloo")
    ap.add_argument("--ranks", type=int, default=2)
    args = ap.parse_args(argv)

    import tempfile

    import torch
    import torch.multiprocessing as mp

    if not torch.cuda.is_available():
        sys.exit("probe_collectives: CUDA is not available")
    print(json.dumps({"torch": torch.__version__, "cuda": torch.version.cuda,
                      "cards": torch.cuda.device_count(),
                      "card": torch.cuda.get_device_name(0),
                      "has_all_gather_single": hasattr(torch.distributed,
                                                       "all_gather_single")}), flush=True)
    summary = {}
    with tempfile.TemporaryDirectory() as out_dir:
        for op in OPS:
            ctx = mp.get_context("spawn")
            port = _free_port()
            procs = [ctx.Process(target=_rank, args=(r, args.ranks, port, args.backend, op,
                                                     out_dir))
                     for r in range(args.ranks)]
            for p in procs:
                p.start()
            for p in procs:
                p.join(120)
                if p.is_alive():
                    p.kill()
                    p.join()
            rows = []
            for r, p in enumerate(procs):
                path = os.path.join(out_dir, f"{op}.{r}.json")
                row = json.load(open(path)) if os.path.exists(path) else {
                    "op": op, "rank": r, "accepted": False, "error": "no result"}
                row["exitcode"] = p.exitcode
                rows.append(row)
                print(json.dumps(row), flush=True)
            summary[op] = all(x.get("accepted") and x.get("correct") and x["exitcode"] == 0
                              for x in rows)
    print(json.dumps({"backend": args.backend, "ranks": args.ranks, "cuda_tensors_ok": summary}))


if __name__ == "__main__":
    main()
