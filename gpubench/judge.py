"""The comparison that decides ``correct``: what the program answered and
built, held against the plain reference (reference/ivf.py).

Each number is a share, 0 when the two agree everywhere:

* ``answers_off``: judged queries whose ranked answer lies, at some rank,
  more than ``tau`` (relative) farther from the query by exact f64
  distance than the reference's answer at that rank. An id that is out
  of range, repeated or missing counts as infinitely far. A query is
  judged against each of the reference's answers for its traffic (the
  folded scan, and for small requests the unfolded gather) and is off
  only if it is worse than all of them.
* ``lists_off``: points whose set of lists differs from their
  ``build_probes`` nearest centers.
* ``codes_off``: PQ codes of list slots that are not the nearest
  codebook entry of the point in that slot.
* ``tiles_off``: bf16 entries of the exact engine's vectors that differ
  by more than 2^-20 from the reference's augmented vector of the point
  in that slot.
* ``centers_fit_off``, ``codebooks_fit_off``: the share by which the
  k-means inertia of the program's coarse centers, and of its PQ
  codebooks in their worst block, exceeds that of the reference's own
  k-means of the same data (negative where the program's fit is the
  better one). The reference builds its index from the program's fit,
  so these judge that fit by itself.
"""

from __future__ import annotations

import math

import torch

TILE_TOL = 2.0 ** -20


def answer_gaps(ids, rows, data_n, queries_n, refs, tau: float,
                chunk: int = 16384):
    """(m,) bool: whether each answer (m, k) to test rows ``rows`` is off
    against every reference distance table in ``refs`` ((Q, k) f64)."""
    n = data_n.shape[0]
    out = []
    for i in range(0, ids.shape[0], chunk):
        a, r = ids[i:i + chunk].long(), rows[i:i + chunk]
        valid = (a >= 0) & (a < n)
        s = torch.sort(torch.where(valid, a, -1), dim=1).values
        repeated = ((s[:, 1:] == s[:, :-1]) & (s[:, 1:] >= 0)).any(1)
        x = data_n[a.clamp(0, n - 1)].double()
        d = ((x - queries_n[r].double()[:, None]) ** 2).sum(-1)
        d = torch.where(valid, d, math.inf)
        off = repeated.clone() | ~valid.any(1)
        worse = torch.ones_like(off)
        for ref in refs:
            rd = ref[r]
            worse &= ((d - rd) > tau * rd).any(1)
        out.append(off | worse)
    return torch.cat(out)


def lists_off(slot_ids, slot_centers, assign) -> float:
    """Share of points whose lists are not their nearest centers."""
    n, bp = assign.shape
    ok = (slot_ids >= 0) & (slot_ids < n)
    ids, cen = slot_ids[ok], slot_centers[ok]
    count = torch.bincount(ids, minlength=n)
    bad = count != bp
    order = torch.argsort(ids * (1 << 32) + (cen + 1))
    ids, cen = ids[order], cen[order]
    first = torch.cumsum(count, 0) - count
    claimed = torch.full((n, bp), -2, dtype=torch.int64, device=ids.device)
    rank = torch.arange(ids.shape[0], device=ids.device) - first[ids]
    keep = rank < bp
    claimed[ids[keep], rank[keep]] = cen[keep]
    want = torch.sort(assign, dim=1).values
    bad |= (claimed != want).any(1)
    bad_slots = int((~ok).sum())
    return (float(bad.sum()) + bad_slots) / n


def codes_off(slot_ids, slot_codes, codes) -> float:
    n = codes.shape[0]
    ok = (slot_ids >= 0) & (slot_ids < n)
    want = codes[slot_ids.clamp(0, n - 1)]
    wrong = (slot_codes != want) | ~ok[:, None]
    return float(wrong.float().mean())


def tiles_off(slot_ids, slot_vecs, aug) -> float:
    """An entry is off when it differs from the reference's by more than
    2^-20: the low norm term is f32 rounding of a sum whose order is
    free, while one bf16 step of a coordinate is about 2^-12 or more."""
    n = aug.shape[0]
    ok = (slot_ids >= 0) & (slot_ids < n)
    want = aug[slot_ids.clamp(0, n - 1)].float()
    wrong = ((slot_vecs.float() - want).abs() > TILE_TOL) | ~ok[:, None]
    return float(wrong.float().mean())


def fit_off(theirs, mine) -> float:
    """Share by which the inertia ``theirs`` exceeds ``mine``; of
    per-block inertias, the worst block's."""
    r = (torch.as_tensor(theirs, dtype=torch.float64)
         / torch.as_tensor(mine, dtype=torch.float64)) - 1.0
    return float(r.max())


def recall_hits(ids, rows, truth_ids) -> torch.Tensor:
    """(m,) share of each answer's ids among the true top k."""
    t = truth_ids[rows]
    hit = (ids.long()[:, :, None] == t[:, None, :]).any(-1)
    return hit.float().sum(1) / t.shape[1]


def decide(numbers: dict, limits: dict) -> tuple[bool, dict]:
    """``correct`` and {name: {"value", "limit"}} for every limit."""
    checks = {name: {"value": numbers[name], "limit": limit}
              for name, limit in limits.items()}
    return all(c["value"] <= c["limit"] for c in checks.values()), checks
