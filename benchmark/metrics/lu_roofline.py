"""Share of the roofline that the LU solve kernel (``csrc/lu_solve.cu``)
reaches inside the consumed INITED sweeps, in percent: the
least time the card could take for the solves, counted from their orders
alone ((2/3) n^3 + 2 n^2 flops, ``harness/roofline.py``), over the kernel's
device time. A launch's order is the system it solves: the kernel's
template width says which (8: the mini-GN's 6 x 6; 128: the window LM's
15 (opt_window + 1) + 6); a launch of another width is not read. Moves the
end-to-end metric of the cell it is listed for (``sweeps_per_s``)."""

import re
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))
from harness.roofline import solve_bound_s  # noqa: E402

UNIT = "%"
WIDTH = re.compile(r"lu_solve_kernel<\s*float\s*,\s*(\d+)\s*,")


def read(ctx):
    tr = ctx["trace"]
    if tr is None or tr.empty:
        return None
    order = {8: 6, 128: ctx["lm_size"]}
    bound = spent = 0.0
    for launches in tr.kernels_in("sweep.consumed", r"lu_solve_kernel").values():
        for name, sec in launches:
            m = WIDTH.search(name)
            if m is None or int(m.group(1)) not in order:
                ctx["log"](f"lu_roofline: a launch of unknown order: {name}")
                return None
            bound += solve_bound_s(order[int(m.group(1))])
            spent += sec
    return 100.0 * bound / spent if spent > 0 else None
