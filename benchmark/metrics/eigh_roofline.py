"""Share of the roofline that the ``eigh`` kernel (``csrc/eigh.cu``)
reaches inside the consumed INITED sweeps, in percent: the
least time the card could take for the decompositions a consumed sweep
makes, counted from their orders alone (6: the mini-GN's A^T A; 15: the
marginalised block; 15 x opt_window + 6: the Schur complement; ~9 n^3
flops each, ``harness/roofline.py``), over the kernel's device time. A
sweep whose launches are not these three is not read. Moves the
end-to-end metric of the cell it is listed for (``sweeps_per_s``)."""

import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))
from harness.roofline import eigh_bound_s  # noqa: E402

UNIT = "%"


def read(ctx):
    tr = ctx["trace"]
    if tr is None or tr.empty:
        return None
    orders = (6, 15, ctx["schur_size"])
    bound = spent = 0.0
    for launches in tr.kernels_in("sweep.consumed", r"tridiag_eigh_kernel").values():
        if not launches:
            continue
        if len(launches) != len(orders):
            ctx["log"](f"eigh_roofline: a consumed sweep made {len(launches)} eigh launches")
            return None
        bound += sum(eigh_bound_s(n) for n in orders)
        spent += sum(sec for _, sec in launches)
    return 100.0 * bound / spent if spent > 0 else None
