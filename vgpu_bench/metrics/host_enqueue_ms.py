"""Mean host time, in ms, from a call's issue to its return, before the
synchronize: the runner's path and the shim's launch hooks (a capped
tenant's waits for its bucket among them)."""

import numpy as np


def read(run):
    spans = np.concatenate([t["calls"][:, 1] - t["calls"][:, 0]
                            for t in run.tenants])
    return float(spans.mean()) / 1e6
