"""``python -m cellbench``: see :mod:`cellbench.run`."""

import time

_T0 = time.perf_counter()   # set-up is timed from here, imports included

import sys  # noqa: E402

from cellbench.run import main  # noqa: E402

sys.exit(main(t0=_T0))
