"""How much of its core limit a tenant got, in %, averaged over the
tenants: its device time in the trace (each instant that several tenants'
operations cover split evenly among them) over the window x its limit."""


def read(run):
    limit = run.traffic["core_limit"]
    if run.trace is None or not limit:
        return None
    shares = [s / (run.trace["window_s"] * limit / 100)
              for s in run.trace["attributed_s"]]
    return 100.0 * sum(shares) / len(shares)
