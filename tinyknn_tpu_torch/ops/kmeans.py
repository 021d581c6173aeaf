"""k-means: k-means++ seeding on a row pool + chunked Lloyd iterations
(counterpart of tinyknn_tpu/ops/kmeans.py).

Two users: the IVF coarse clustering (``kmeans_fit``) and the PQ
codebooks, 16 centers per block for all blocks at once
(``blockwise_kmeans``). Randomness comes from an explicit
``torch.Generator`` on the data's device; it draws other numbers than
``jax.random``, so this module is held to the JAX package by fit
quality, not bit equality. Kept from the JAX version: the k-means++
candidate pool, Lloyd iterations over fixed-size row chunks (memory
stays bounded at any n), empty-cluster relocation to far pool points,
and ``n_init`` restarts keeping the lowest inertia. Centroid sums use
``index_add_`` (atomics on the card, so their f32 order varies from
run to run) where the JAX version uses a one-hot matmul.
"""

from __future__ import annotations

import torch

from ..utils.bruteforce import fp32_matmuls

INIT_POOL_FACTOR = 16  # k-means++ candidate pool: INIT_POOL_FACTOR * k rows


def _pairwise_sq(X, C):
    """(n, d), (k, d) -> (n, k) squared distances, matmul form."""
    xn = torch.einsum("ij,ij->i", X, X)
    cn = torch.einsum("ij,ij->i", C, C)
    return xn[:, None] + cn[None, :] - 2.0 * (X @ C.T)


def _init_pool(gen: torch.Generator, n: int, k: int, device):
    """Row indices of the k-means++ candidate pool (None: all rows).

    Seeding on the full dataset costs one full-data pass per center; a
    pool of 16k rows keeps the seeding quality at a fraction of that.
    """
    pool = min(n, max(2048, INIT_POOL_FACTOR * k))
    if pool == n:
        return None
    return torch.randperm(n, generator=gen, device=device)[:pool]


def _sample(gen: torch.Generator, scores: torch.Tensor) -> torch.Tensor:
    """One row index per distribution in ``scores`` (..., n), drawn with
    probability proportional to the score, or uniformly where every
    score is 0 (fewer distinct points than centers)."""
    scores = scores.clamp(min=0.0)
    degenerate = scores.amax(dim=-1, keepdim=True) <= 0
    probs = torch.where(degenerate, torch.ones_like(scores), scores)
    return torch.multinomial(probs.reshape(-1, scores.shape[-1]), 1,
                             generator=gen).reshape(scores.shape[:-1])


def _plus_plus_init(gen, X, k: int):
    """k-means++ seeding of k centers from the rows of X (n, d)."""
    first = _sample(gen, torch.zeros(X.shape[0], device=X.device))
    centers = [X[first]]
    min_d2 = ((X - centers[0]) ** 2).sum(dim=1)
    for _ in range(k - 1):
        c = X[_sample(gen, min_d2)]
        centers.append(c)
        min_d2 = torch.minimum(min_d2, ((X - c) ** 2).sum(dim=1))
    return torch.stack(centers)


def _lloyd_iter(X, C, chunk: int):
    """One Lloyd iteration, assignment and accumulation chunked over rows."""
    k, d = C.shape
    sums = torch.zeros((k, d), dtype=torch.float32, device=X.device)
    counts = torch.zeros((k,), dtype=torch.float32, device=X.device)
    inertia = torch.zeros((), dtype=torch.float32, device=X.device)
    for i in range(0, X.shape[0], chunk):
        Xi = X[i:i + chunk]
        best, assign = _pairwise_sq(Xi, C).min(dim=1)
        sums.index_add_(0, assign, Xi)
        counts.index_add_(0, assign, torch.ones_like(best))
        inertia += best.clamp(min=0.0).sum()
    new_C = torch.where(counts[:, None] > 0,
                        sums / counts.clamp(min=1.0)[:, None], C)
    return new_C, counts, inertia


def _relocate_empty(C, counts, Xp):
    """Re-seed empty clusters at far points: empty cluster #e (in
    cluster order) takes the pool point with the e-th largest distance
    to its nearest center."""
    kf = min(C.shape[0], Xp.shape[0])
    d2 = _pairwise_sq(Xp, C).amin(dim=1)
    far = torch.topk(d2, kf).indices
    empty = counts <= 0
    rank = torch.cumsum(empty.to(torch.int64), dim=0) - 1
    repl = Xp[far[rank.clamp(0, kf - 1)]]
    return torch.where(empty[:, None], repl, C)


def kmeans_fit(X: torch.Tensor, k: int, *, generator: torch.Generator,
               iters: int = 25, n_init: int = 1, chunk: int = 16384):
    """Fit k centers to the rows of X (on X's device). Returns
    ``(centers (k, d) f32, inertia)``; ``n_init`` independent runs keep
    the lowest inertia."""
    fp32_matmuls()
    X = X.to(torch.float32)
    n = X.shape[0]
    if n < 1 or iters < 1:
        raise ValueError("kmeans_fit needs at least one row and one "
                         "iteration")
    best_C, best_inertia = None, None
    for _ in range(n_init):
        pool = _init_pool(generator, n, k, X.device)
        Xp = X if pool is None else X[pool]
        C = _plus_plus_init(generator, Xp, k)
        for _ in range(iters):
            C, counts, inertia = _lloyd_iter(X, C, chunk)
            C = _relocate_empty(C, counts, Xp)
        if best_inertia is None or float(inertia) < best_inertia:
            best_C, best_inertia = C, float(inertia)
    return best_C, best_inertia


def blockwise_kmeans(cols: torch.Tensor, *, generator: torch.Generator,
                     k: int = 16, iters: int = 25, chunk: int = 16384,
                     n_init: int = 2) -> torch.Tensor:
    """Fit k centers independently for each block column.

    ``cols``: (B, n, dpb) f32, the block columns. Returns (B, k, dpb).
    All blocks advance together inside one chunked pass over the rows,
    so the live set is one (B, chunk, k) block at any n. ``n_init``
    restarts keep, per block, the one with the lowest inertia.
    """
    fp32_matmuls()
    B, n, dpb = cols.shape
    dev = cols.device
    barange = torch.arange(B, device=dev)
    pool = _init_pool(generator, n, k, dev)
    cols_i = cols if pool is None else cols[:, pool, :]   # (B, n_i, dpb)
    kf = min(k, cols_i.shape[1])
    xn_i = torch.einsum("bnd,bnd->bn", cols_i, cols_i)

    def ppp_init():
        first = _sample(generator, torch.zeros(cols_i.shape[:2], device=dev))
        centers = [cols_i[barange, first]]                  # (B, dpb)
        min_d2 = ((cols_i - centers[0][:, None, :]) ** 2).sum(dim=-1)
        for _ in range(k - 1):
            cc = cols_i[barange, _sample(generator, min_d2)]
            centers.append(cc)
            min_d2 = torch.minimum(
                min_d2, ((cols_i - cc[:, None, :]) ** 2).sum(dim=-1))
        return torch.stack(centers, dim=1)                  # (B, k, dpb)

    def lloyd_iter(C):
        cn = torch.einsum("bkd,bkd->bk", C, C)
        sums = torch.zeros((B * k, dpb), dtype=torch.float32, device=dev)
        counts = torch.zeros((B * k,), dtype=torch.float32, device=dev)
        inertia = torch.zeros((B,), dtype=torch.float32, device=dev)
        for i in range(0, n, chunk):
            x = cols[:, i:i + chunk]                        # (B, c, dpb)
            d2 = cn[:, None, :] - 2.0 * torch.bmm(x, C.transpose(1, 2))
            best, assign = d2.min(dim=2)                    # + ||x||^2
            best = best + torch.einsum("bcd,bcd->bc", x, x)
            flat = (barange[:, None] * k + assign).reshape(-1)
            sums.index_add_(0, flat, x.reshape(-1, dpb))
            counts.index_add_(0, flat, torch.ones_like(best).reshape(-1))
            inertia += best.clamp(min=0.0).sum(dim=1)
        sums, counts = sums.view(B, k, dpb), counts.view(B, k)
        newC = torch.where(counts[..., None] > 0,
                           sums / counts.clamp(min=1.0)[..., None], C)
        return newC, counts, inertia

    def relocate(C, counts):
        cn = torch.einsum("bkd,bkd->bk", C, C)
        d2 = (xn_i[:, :, None] + cn[:, None, :]
              - 2.0 * torch.bmm(cols_i, C.transpose(1, 2)))
        far = torch.topk(d2.amin(dim=2), kf, dim=1).indices  # (B, kf)
        empty = counts <= 0
        rank = torch.cumsum(empty.to(torch.int64), dim=1) - 1
        sel = torch.gather(far, 1, rank.clamp(0, kf - 1))
        repl = cols_i[barange[:, None], sel]                 # (B, k, dpb)
        return torch.where(empty[..., None], repl, C)

    if iters < 1:
        raise ValueError("blockwise_kmeans needs at least one iteration")
    best_C, best_inertia = None, None
    for _ in range(n_init):
        C = ppp_init()
        for _ in range(iters):
            C, counts, inertia = lloyd_iter(C)
            C = relocate(C, counts)
        if best_C is None:
            best_C, best_inertia = C, inertia
        else:
            take = (inertia < best_inertia)[:, None, None]
            best_C = torch.where(take, C, best_C)
            best_inertia = torch.minimum(inertia, best_inertia)
    return best_C
