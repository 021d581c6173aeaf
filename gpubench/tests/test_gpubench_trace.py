"""Busy time and idle gaps from a hand-made trace."""

from gpubench.trace import summarize, top

US = 1000


def test_busy_is_the_union_and_gaps_take_the_innermost_host_op():
    dev = [(10 * US, 30 * US, "k1"), (20 * US, 40 * US, "k2"),
           (100 * US, 110 * US, "k1"), (200 * US, 300 * US, "k3")]
    host = [(0, 400 * US, "gpubench.query"), (50 * US, 90 * US, "aten::sort"),
            (120 * US, 180 * US, "gpubench.wait_for_arrival")]
    t = summarize(dev, host, (0, 400 * US))
    assert t.window_s == 400e-6
    assert abs(t.busy_s - 140e-6) < 1e-12
    assert abs(t.kernels["k1"] - 30e-6) < 1e-12
    # idle: 0-10 (query), 40-100 (mid 70: sort), 110-200 (mid 155: the
    # wait), 300-400 (query)
    assert abs(t.idle_gaps["aten::sort"] - 60e-6) < 1e-12
    assert abs(t.idle_gaps["gpubench.wait_for_arrival"] - 90e-6) < 1e-12
    assert abs(t.idle_gaps["gpubench.query"] - 110e-6) < 1e-12
    assert top(t.kernels, 1) == [["k3", t.kernels["k3"]]]
