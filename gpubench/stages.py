"""The program's query stages in a profiler trace: which stage enqueued
each device op, how much device time each stage and each retry pass
cost, and how long the device sat idle while the host was inside a
query call.

A device op belongs to the innermost ``tinyknn.*`` span that was open
on the host when the runtime call that enqueued it started (its launch),
and to a retry when one of the spans open then was ``tinyknn.retry``.
The program opens these spans (tinyknn_tpu_torch's ``utils/timing.py``)
only while a profiler records. ``trace.read`` keeps neither the spans
nor each op's launch yet, so no metric reads this module; the inputs
are the profiler's host events named ``tinyknn.*`` and, for each device
op, the start of the runtime call with the same correlation id."""

from __future__ import annotations

from collections import defaultdict
from typing import NamedTuple

PROGRAM = "tinyknn."         # the program's own spans (its stages)
QUERY = PROGRAM + "query"
ATTEMPT = PROGRAM + "attempt"
RETRY = PROGRAM + "retry"


class Stages(NamedTuple):
    seconds: dict       # stage (span name less "tinyknn.") -> device s
    passes: dict        # "attempt", "retry" -> device s of their ops
    query_idle_s: float  # device idle while the host is in tinyknn.query


def attribute(spans, ops) -> Stages:
    """``spans``: the program's host spans, (start, end, name), nested
    or disjoint; ``ops``: device ops, (start, end, name, launch start or
    None), all in ns. An op launched outside every span, or with no
    launch, goes to no stage and to no pass."""
    opened = sorted(spans, key=lambda s: (s[0], -s[1]))   # parents first
    seconds, passes = defaultdict(float), defaultdict(float)
    stack, i = [], 0
    for t0, t1, _, at in sorted((o for o in ops if o[3] is not None),
                                key=lambda o: o[3]):
        while i < len(opened) and opened[i][0] <= at:
            while stack and stack[-1][1] < opened[i][0]:
                stack.pop()
            stack.append(opened[i])
            i += 1
        while stack and stack[-1][1] < at:
            stack.pop()
        if not stack:
            continue
        s = (t1 - t0) / 1e9
        seconds[stack[-1][2][len(PROGRAM):]] += s
        names = {name for _, _, name in stack}
        if RETRY in names:
            passes["retry"] += s
        elif ATTEMPT in names:
            passes["attempt"] += s
    return Stages(dict(seconds), dict(passes), _idle_in(
        [(a, b) for a, b, name in spans if name == QUERY],
        [(o[0], o[1]) for o in ops]))


def _idle_in(calls, busy) -> float:
    """Seconds of the intervals ``calls`` (disjoint) that no interval of
    ``busy`` covers."""
    merged = []
    for t0, t1 in sorted(busy):
        if merged and t0 <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], t1)
        else:
            merged.append([t0, t1])
    idle, j = 0, 0
    for c0, c1 in sorted(calls):
        idle += c1 - c0
        while j < len(merged) and merged[j][1] <= c0:
            j += 1
        k = j
        while k < len(merged) and merged[k][0] < c1:
            idle -= min(c1, merged[k][1]) - max(c0, merged[k][0])
            k += 1
    return idle / 1e9
