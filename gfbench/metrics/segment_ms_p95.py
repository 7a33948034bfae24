"""segment_ms_p95: the 95th percentile of the window's segment times, in
ms, each from the runner's call to the end of its host check (numpy's
linear interpolation between order statistics)."""

import numpy as np


def read(run):
    if run.mix["kind"] != "md":
        return None
    d = np.asarray(run.window["durations"]) * 1e3
    return float(np.percentile(d, 95))
