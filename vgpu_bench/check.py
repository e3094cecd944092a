"""The comparison that decides ``correct``.

The logits that the tenants kept from calls inside their windows are held
against the plain fp32 reference on the same seeded weights and inputs:
``logit_err`` is the widest gap over the sampled calls, each call's
largest absolute difference over its reference's largest magnitude. The
guarantees that the configuration states are numbers too (``guarantees``).
Every number is printed beside its limit.
"""

from __future__ import annotations

from . import weights


def logit_err(cfg, seed: int, samples: dict, device,
              control: bool = False) -> tuple[float, int]:
    """(widest gap, calls compared) of the sampled logits ``samples``
    ({tenant: [(pool index, logits or None)]}); with ``control`` the
    reference computed in float8 takes the program's place."""
    import torch
    from .reference import strict_fp32
    ref = weights.reference(cfg)
    strict_fp32()
    w = weights.make(cfg, seed, device)
    worst, compared = 0.0, 0
    with torch.no_grad():
        for i, items in samples.items():
            for j in sorted({j for j, y in items if y is not None}):
                x = weights.inputs(cfg, seed, i, j, device)
                r = ref.forward(w, x, cfg, "fp32")
                if control:
                    program = [ref.forward(w, x, cfg, "fp8")]
                else:
                    program = [y.to(device) for jj, y in items
                               if jj == j and y is not None]
                scale = r.abs().max().item()
                for p in program:
                    gap = (p.float() - r).abs().max().item() / scale
                    worst = max(worst, gap)
                    compared += 1
    return worst, compared


def guarantees(cfg, mix, tenants: list[dict], card_used: int,
               trace: dict | None) -> dict:
    """{name: (value, limit)} of the configuration's guarantees in this
    run. ``mem_over_cap``: a wrapped tenant's largest usage (its region's,
    its allocator's peak) over its cap. ``card_over_region``: the card's
    memory that the tenants took (``card_used``, in use once every window
    closed less in use before any tenant started) over what their regions
    account together, held to 1 + the configuration's ``card_slack``: a
    shim that lets a tenant take memory it does not charge reads above it.
    ``core_over_limit``, in a traced run of a core-limited mix: a tenant's
    device time in the trace over the window x its limit, held to 1 + the
    configuration's slack (an untraced run has no reading of a tenant's
    device time but the shim's own account, and checks no core limit)."""
    out = {}
    if mix["wrapped"]:
        worst = max(max(t["region_used"], t["allocator_peak"]) / t["cap"]
                    for t in tenants)
        out["mem_over_cap"] = (worst, 1.0)
        if card_used:
            out["card_over_region"] = (
                card_used / sum(t["region_used"] for t in tenants),
                1.0 + cfg["guarantees"]["card_slack"])
    if mix["core_limit"] and trace is not None:
        worst = max(s / (trace["window_s"] * mix["core_limit"] / 100)
                    for s in trace["attributed_s"])
        out["core_over_limit"] = (
            worst, 1.0 + cfg["guarantees"]["core_limit_slack"])
    return out
