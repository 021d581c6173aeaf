"""Device time by the program's query stage, the retry's share and the
idle time inside query calls, from hand-made traces."""

from gpubench import stages

US = 1000

# two calls; the first retries its pass, the second does not
SPANS = [
    (0, 100 * US, "tinyknn.query"),
    (1 * US, 5 * US, "tinyknn.input"),
    (10 * US, 40 * US, "tinyknn.attempt"),
    (11 * US, 20 * US, "tinyknn.tables"),
    (21 * US, 39 * US, "tinyknn.scan"),
    (41 * US, 42 * US, "tinyknn.drop_check"),
    (50 * US, 90 * US, "tinyknn.retry"),
    (51 * US, 70 * US, "tinyknn.scan"),
    (71 * US, 89 * US, "tinyknn.rescore"),
    (200 * US, 260 * US, "tinyknn.query"),
    (210 * US, 250 * US, "tinyknn.attempt"),
    (211 * US, 249 * US, "tinyknn.rescore"),
]
# (start, end, name, launch)
OPS = [
    (6 * US, 10 * US, "copy", 2 * US),          # input
    (20 * US, 30 * US, "tables", 12 * US),      # tables, attempt
    (30 * US, 45 * US, "k1", 22 * US),          # scan, attempt
    (45 * US, 46 * US, "count", 10 * US),       # the attempt itself
    (55 * US, 75 * US, "k1", 52 * US),          # scan, retry
    (75 * US, 95 * US, "gemv", 72 * US),        # rescore, retry
    (120 * US, 130 * US, "stray", 110 * US),    # launched outside a call
    (140 * US, 150 * US, "lost", None),         # no launch in the trace
    (220 * US, 270 * US, "gemv", 212 * US),     # rescore, attempt
]


def _close(a, b):
    return abs(a - b) < 1e-12


def test_each_op_goes_to_the_innermost_span_of_its_launch():
    st = stages.attribute(SPANS, OPS)
    assert set(st.seconds) == {"input", "tables", "scan", "attempt",
                               "rescore"}
    assert _close(st.seconds["input"], 4e-6)
    assert _close(st.seconds["tables"], 10e-6)
    assert _close(st.seconds["scan"], 35e-6)
    assert _close(st.seconds["rescore"], 70e-6)
    assert _close(st.seconds["attempt"], 1e-6)


def test_the_retry_share_counts_every_op_inside_a_retry():
    st = stages.attribute(SPANS, OPS)
    assert _close(st.passes["attempt"], 10e-6 + 15e-6 + 1e-6 + 50e-6)
    assert _close(st.passes["retry"], 40e-6)
    assert _close(st.passes["retry"] / sum(st.passes.values()), 40 / 116)


def test_idle_inside_query_calls():
    st = stages.attribute(SPANS, OPS)
    # call 1 (0-100): busy 6-10, 20-46, 55-95 -> idle 6 + 10 + 9 + 5;
    # call 2 (200-260): busy 220-260 -> idle 20
    assert _close(st.query_idle_s, 50e-6)


def test_an_op_outside_every_stage_goes_to_none():
    st = stages.attribute(SPANS, OPS)
    total = sum(st.seconds.values())
    assert _close(total, sum(o[1] - o[0] for o in OPS
                             if o[2] not in ("stray", "lost")) / 1e9)
    assert _close(sum(st.passes.values()), total - 4e-6)   # less input
    only = stages.attribute(SPANS, [OPS[6], OPS[7]])
    assert only.seconds == {} and only.passes == {}

