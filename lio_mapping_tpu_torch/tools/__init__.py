"""The port's measurement tools, one module per tool of the JAX package
(``bench.py`` at its root and ``tools/``), under the same names:

    python -m lio_mapping_tpu_torch.tools.bench            # steady frames/s
    python -m lio_mapping_tpu_torch.tools.bench_cli        # the CLI's phase B
    python -m lio_mapping_tpu_torch.tools.profile_step     # stage ms, GFLOP, GB/s
    python -m lio_mapping_tpu_torch.tools.ab_flags         # accuracy/cost flags
    python -m lio_mapping_tpu_torch.tools.bench_scaling    # the mesh's BA step
    python -m lio_mapping_tpu_torch.tools.debug_corner     # use_corner x fix_map

Each runs on the card unless given ``--device cpu``; without CUDA it exits
non-zero. Each prints its device as the card's name and power limit
(``nvidia-smi``) or ``cpu``, and its result as a JSON object on its last
line; it writes a file only where asked (``--out``, ``--json``).
"""

from __future__ import annotations

import json
import os
import subprocess
import sys

REPO = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def add_device_arg(ap):
    ap.add_argument("--device", default="cuda",
                    help="torch device to run on (default: the card; `cpu` to run on the CPU)")


def resolve_device(name: str):
    """The torch device ``name``; exits non-zero when it is CUDA and there is
    none (a tool never falls back to the CPU by itself)."""
    from ..models.pipeline import resolve_device as resolve

    try:
        return resolve(name)
    except RuntimeError as e:
        sys.exit(f"error: {e}")


def device_label(device) -> str:
    """``cpu``, or the card's ``name, power limit`` as ``nvidia-smi`` reports
    them (the name alone where ``nvidia-smi`` cannot be run)."""
    import torch

    dev = torch.device(device)
    if dev.type != "cuda":
        return "cpu"
    index = dev.index if dev.index is not None else torch.cuda.current_device()
    try:
        return subprocess.run(["nvidia-smi", f"--id={index}", "--query-gpu=name,power.limit",
                               "--format=csv,noheader"], capture_output=True, text=True,
                              check=True).stdout.strip()
    except (OSError, subprocess.CalledProcessError):
        return torch.cuda.get_device_name(dev)


def run_module(module: str, *args, check: bool = True):
    """``python -m <module> <args>`` with this checkout on the path; returns
    the finished process (stdout and stderr captured). ``check``: exit with
    its error output when it fails."""
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(p for p in (REPO, env.get("PYTHONPATH")) if p)
    proc = subprocess.run([sys.executable, "-m", module, *map(str, args)],
                          capture_output=True, text=True, env=env)
    if check and proc.returncode != 0:
        sys.stderr.write(proc.stdout[-2000:] + "\n" + proc.stderr[-4000:])
        sys.exit(f"{module} {' '.join(map(str, args))} exited {proc.returncode}")
    return proc


def last_json(text: str) -> dict:
    """The JSON object on the last line of ``text`` (``{}`` when there is
    none)."""
    lines = text.strip().splitlines()
    try:
        return json.loads(lines[-1]) if lines else {}
    except json.JSONDecodeError:
        return {}
