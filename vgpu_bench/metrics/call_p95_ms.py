"""The 95th percentile, in ms, of every call of every tenant in the
window, each from its issue to the end of its ``synchronize()``."""

import numpy as np


def read(run):
    durations = np.concatenate([t["calls"][:, 2] - t["calls"][:, 0]
                                for t in run.tenants])
    return float(np.percentile(durations, 95)) / 1e6
