"""How unevenly the card's time slicing served the tenants, in %: (max -
min) / mean of the tenants' items/s, each over its own window."""


def read(run):
    if len(run.tenants) < 2:
        return None
    rates = [len(t["calls"]) * t["batch"]
             / ((t["end_ns"] - t["start_ns"]) / 1e9) for t in run.tenants]
    mean = sum(rates) / len(rates)
    return 100.0 * (max(rates) - min(rates)) / mean
