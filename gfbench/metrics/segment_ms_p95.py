"""segment_ms_p95: the 95th percentile of the window's segment times, in
ms, each from the runner's call to the end of its host check (numpy's
linear interpolation between order statistics). Read in the cells that
BENCHMARK.json lists for it, each of whose window's ``durations`` is one
closed-loop unit of work."""

import numpy as np


def read(run):
    d = np.asarray(run.window["durations"]) * 1e3
    return float(np.percentile(d, 95))
