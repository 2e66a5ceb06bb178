"""The benchmark's harness (``benchmark/README.md``).

A ``--trace 1`` run of ``run.py`` switches the program's own tracer on
before the program is built (``LIO_TRACE=1``, which the program's
pipeline and builder read when they are made:
``lio_mapping_tpu_torch/utils/timing.from_env``), so that the CUDA graphs
it captures in set-up carry its device stamps;
``harness/program.py`` reads the tracer's records once the window has
closed. A ``--trace 0`` run leaves the environment as it is and builds no
tracer, and a program without a tracer takes no notice of the variable.
The switch reads ``run.py``'s arguments while this package is imported
because that is the first of the harness's code a run executes, before
``run.py`` builds the program.
"""

import os
import sys


def traced(argv) -> bool:
    """Does ``argv`` (``run.py``'s arguments) ask for ``--trace 1``?"""
    for i, arg in enumerate(argv):
        if arg == "--trace" and i + 1 < len(argv):
            return argv[i + 1].strip() == "1"
        if arg.startswith("--trace="):
            return arg.split("=", 1)[1].strip() == "1"
    return False


if sys.argv and os.path.basename(sys.argv[0]) == "run.py" and traced(sys.argv[1:]):
    os.environ["LIO_TRACE"] = "1"
