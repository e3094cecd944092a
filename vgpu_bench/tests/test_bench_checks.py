"""The trace's reduction and the guarantees, on made-up readings."""

import numpy as np

import rehearse  # noqa: F401
from vgpu_bench import check, trace


def tenant(intervals, names, calls):
    return {"intervals": np.asarray(intervals, dtype=np.int64),
            "names": names, "calls": np.asarray(calls, dtype=np.int64)}


def test_a_preempted_kernel_is_charged_its_share():
    """Tenant 0's kernel spans [0, 100] ns while tenant 1 runs [40, 80]:
    the card was busy 100 ns, 20 of them shared by both."""
    a = tenant([[0, 100, 0]], ["k"], [[0, 0, 100]])
    b = tenant([[40, 80, 0], [90, 95, 1]], ["k", "copy"], [[40, 40, 95]])
    merged = trace.merge([a, b], 0, 200)
    assert np.isclose(merged["busy_s"] * 1e9, 100)
    assert np.allclose(np.array(merged["attributed_s"]) * 1e9, [77.5, 22.5])
    assert merged["ops"]["k"][0] == 2
    assert np.isclose(merged["ops"]["k"][1] * 1e9, 77.5 + 20)
    assert np.isclose(merged["ops"]["copy"][1] * 1e9, 2.5)
    assert np.isclose(sum(v[1] for v in merged["ops"].values()),
                      merged["busy_s"])
    assert np.isclose(merged["breakdown"]["idle_gaps"][0][1] * 1e9, 100)


def card_check(card_taken, regions):
    cfg = {"guarantees": {"card_slack": 0.1, "core_limit_slack": 0.1}}
    mix = {"wrapped": True, "core_limit": 0}
    tenants = [{"region_used": r, "allocator_peak": r // 2, "cap": 10 ** 10}
               for r in regions]
    return check.guarantees(cfg, mix, tenants, card_taken, None)


def test_the_card_check_fails_on_memory_no_region_holds():
    value, limit = card_check(4 * 10 ** 9, [10 ** 9] * 4)["card_over_region"]
    assert value <= limit
    value, limit = card_check(6 * 10 ** 9, [10 ** 9] * 4)["card_over_region"]
    assert value > limit
    assert "card_over_region" not in card_check(0, [10 ** 9] * 4)
