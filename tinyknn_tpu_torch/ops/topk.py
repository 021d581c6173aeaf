"""Top-k selection ops (counterpart of tinyknn_tpu/ops/topk.py).

Smaller-is-better semantics throughout. ``smallest_k`` breaks ties
towards the lower index, as ``jax.lax.top_k`` does, so the port selects
the same candidates as the JAX package when encodings or distances tie;
``torch.topk`` promises no order among equal values.
"""

from __future__ import annotations

import torch

INF_SCORE = float("inf")


def smallest_k(vals: torch.Tensor, k: int):
    """(values, indices) of the k smallest entries along the last axis,
    ascending, ties to the lower index."""
    s, idx = torch.sort(vals, dim=-1, stable=True)
    return s[..., :k], idx[..., :k]


def dedup_candidates(ids: torch.Tensor, vals: torch.Tensor):
    """Invalidate duplicate ids, keeping the best-valued occurrence.

    ``ids``/``vals`` have matching shape (..., m). For every group of
    equal non-negative ids, all but the smallest-value occurrence get
    value +inf and id -1; output shapes equal input shapes. torch has
    no lexsort, so the (id, value) order is two stable sorts: by value,
    then by id.
    """
    vals = vals.to(torch.float32)
    by_val = torch.sort(vals, dim=-1, stable=True).indices
    ids_v = torch.gather(ids, -1, by_val)
    by_id = torch.sort(ids_v, dim=-1, stable=True).indices
    order = torch.gather(by_val, -1, by_id)
    s_ids = torch.gather(ids, -1, order)
    s_vals = torch.gather(vals, -1, order)
    prev = torch.cat([torch.full_like(s_ids[..., :1], -1),
                      s_ids[..., :-1]], dim=-1)
    dup = (s_ids == prev) & (s_ids >= 0)
    s_vals = torch.where(dup, torch.full_like(s_vals, INF_SCORE), s_vals)
    s_ids = torch.where(dup, torch.full_like(s_ids, -1), s_ids)
    out_ids = torch.empty_like(ids).scatter_(-1, order, s_ids)
    out_vals = torch.empty_like(vals).scatter_(-1, order, s_vals)
    return out_ids, out_vals


def masked_smallest_k(vals: torch.Tensor, mask: torch.Tensor, k: int):
    """k smallest entries where ``mask`` is True: (values, indices),
    ascending; masked-out entries come back (if at all) at the tail with
    value +inf and index -1."""
    vals = torch.where(mask, vals.to(torch.float32), INF_SCORE)
    best, idx = smallest_k(vals, k)
    return best, torch.where(torch.isfinite(best), idx, -1)


def merge_topk(vals_a, idx_a, vals_b, idx_b):
    """Merge candidate set b into the running state a, keeping the best
    ``vals_a.shape[-1]`` entries (ascending; ties to a, then to the
    lower position): the streaming analogue of heap insertion."""
    k = vals_a.shape[-1]
    vals = torch.cat([vals_a, vals_b], dim=-1)
    idx = torch.cat([idx_a, idx_b], dim=-1)
    best, pos = smallest_k(vals, k)
    return best, torch.gather(idx, -1, pos)


def streaming_topk_init(batch_shape, k: int, id_dtype=torch.int32,
                        device="cuda"):
    """Initial (vals, ids) state for ``merge_topk``: every slot empty
    (+inf / -1), on ``device``."""
    shape = tuple(batch_shape) + (k,)
    return (torch.full(shape, INF_SCORE, dtype=torch.float32, device=device),
            torch.full(shape, -1, dtype=id_dtype, device=device))
