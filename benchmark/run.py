#!/usr/bin/env python3
"""Run one cell of the benchmark of ``lio_mapping_tpu_torch`` once.

    python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout. The cell is an entry of ``workloads`` in
``BENCHMARK.json``; its configuration, traffic mix, limits and per-layer
metric readers are files under ``benchmark/`` found by name
(``harness/spec.py``). Set-up makes the sweeps on the card from the seed,
builds the program and runs its bootstrap; the window then drives it for
``--seconds``; the check judges every pose of the window against the
trajectory's own. The last line of standard output is one JSON object
(``correct``, ``attempted``, ``failed``, ``metrics``, ``device``, with
``--trace 1`` the per-layer metrics and ``breakdown``, and last ``checks``:
each number compared with its limit); the last lines of standard error
repeat the checks.

``--control tf32`` runs the program with TF32 matrix products switched on,
the nearest precision below the float32 that its profiles state: the
check's control. ``--fault frozen|altered`` plants a fault into the
window's answers before the check (``harness/cell.plant``), which has to
come out as not correct. ``--check-every n`` keeps every n-th builder step
for the check in place of the traffic's ``check_every``, so that a short
window checks as many steps as a full one. The benchmark's own runs pass
none of these.

Exits with 2 and prints no result without a CUDA card (or with fewer cards
than the cell asks for), and with 3 if the process holds ``jax``,
``jaxlib``, ``flax`` or ``lio_mapping_tpu`` once the window has closed.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

BENCH = Path(__file__).resolve().parent
ROOT = BENCH.parent
FORBIDDEN = ("jax", "jaxlib", "flax", "lio_mapping_tpu")


def forbidden_modules() -> list:
    """Loaded modules whose top-level name (before the first dot) is one of
    ``FORBIDDEN``, compared whole: ``lio_mapping_tpu_torch`` is not
    ``lio_mapping_tpu``."""
    return sorted({m.split(".")[0] for m in sys.modules} & set(FORBIDDEN))


def fixed_caches():
    """Every build and kernel cache inside the checkout, at fixed paths
    (the port's nvcc builds already live in ``lio_mapping_tpu_torch/_build``)."""
    cache = ROOT / ".bench_cache"
    os.environ["TORCH_EXTENSIONS_DIR"] = str(cache / "torch_extensions")
    os.environ["TRITON_CACHE_DIR"] = str(cache / "triton")
    os.environ["USE_FLAX"] = "0"


def card_report() -> str:
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit,clocks.max.sm",
                              "--format=csv,noheader"], capture_output=True, text=True,
                             timeout=20)
        return out.stdout.strip().splitlines()[0] if out.stdout.strip() else "unknown"
    except (OSError, subprocess.TimeoutExpired):
        return "unknown"


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    ap.add_argument("--control", choices=("tf32",), default=None)
    ap.add_argument("--fault", choices=("frozen", "altered"), default=None)
    ap.add_argument("--check-every", type=int, default=None)
    args = ap.parse_args(argv)

    sys.path.insert(0, str(BENCH))
    from harness.spec import load_spec, resolve

    cell = resolve(load_spec(ROOT), ROOT, args.workload)
    fixed_caches()
    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
        print(f"no run: {cell.name} needs {cell.chips} CUDA card(s), this machine has "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT))
    import lio_mapping_tpu_torch  # noqa: F401  (sets the program's own precision)

    if args.control == "tf32":
        torch.backends.cuda.matmul.allow_tf32 = True
        print("control: TF32 matrix products on", file=sys.stderr)
    from harness.cell import run_cell

    if args.check_every:
        cell.traffic = dict(cell.traffic, check_every=args.check_every)
    result = run_cell(cell, args.seed, args.seconds, bool(args.trace), "cuda", T_START,
                      fault=args.fault)
    found = forbidden_modules()
    if found:
        print(f"no result: the process holds {found} after the window", file=sys.stderr)
        return 3
    print(json.dumps({"card": card_report(), "seed": args.seed, "workload": cell.name,
                      "control": args.control, "fault": args.fault}))
    print(json.dumps(result))
    sys.stdout.flush()
    for name, c in result["checks"].items():
        ok = "ok" if c["value"] <= c["limit"] else "FAIL"
        print(f"check {name}: {c['value']!r} against limit {c['limit']!r} {ok}",
              file=sys.stderr)
    return 0


if __name__ == "__main__":
    sys.exit(main())
