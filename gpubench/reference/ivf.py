"""Plain PyTorch reference of an IVF index over 4-bit PQ codes or bf16
vectors, and of its query, written from the configuration's statement of
the algorithm. It imports nothing of the program under test.

The coarse centers and the PQ codebooks are the outcome of a randomized
fit whose float sums the program adds in no fixed order, so no second
implementation can reproduce them bit for bit. They are the one piece of
the program's state the reference takes; ``derive`` works out again from
them and the raw data everything else the build makes (the lists, their
order, the codes, the exact engine's vectors), and ``answers`` every
stage of a query: normalization, distance tables and their int8
quantization, probe selection, the scan, the position-class min-fold,
the pool selection, the exact rescore, dedup and the top k. The fit is
judged by itself: the inertia of the program's centers and codebooks
against that of the reference's own k-means (``kmeans``,
``block_kmeans``) on the same data.

The random projection is the other departure the reference takes over
from the program: FastPQ's published recipe (``projection``), drawn here
from the configuration's ``rotate_dim`` and the PQ's seed, never read
from the program. For a raw dimension other than 100 FastPQ pads the
columns to a multiple of ``BLOCK_PAD * dims_per_block``, draws
``np.random.default_rng(seed)`` standard normals of that square shape,
takes their QR, and keeps the first ``round_up(rotate_dim, BLOCK_PAD *
dims_per_block)`` rows of ``q.T`` in f32 as ``R``. The lists, the probes
and the rescore stay in the raw space; the codes are those of ``x_pad @
R.T``, the tables those of ``q_pad @ R.T`` (``coded``).

``Precision(lower=True)`` is the control: the same computation one step
below the stated precision, f32 products on operands rounded to TF32's
10-bit mantissa and bf16 vectors stored as fp8 (e4m3).
"""

from __future__ import annotations

import math
from typing import NamedTuple

import numpy as np
import torch

LANE = 128
BLOCK_PAD = 8                 # the coded width is a multiple of 8 blocks
LN2 = 0.6931471805599453
POS_BITS = 20                 # key = value << POS_BITS | position in list
INVALID = 1 << 62             # key of an empty slot or fold class


def fp32_products():
    """f32 matrix products in f32, not TF32, as the configurations state."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


class Precision:
    """How the reference rounds. ``lower=False``: as stated (f32 products
    with TF32 off, bf16 vectors). ``lower=True``: the control."""

    def __init__(self, lower: bool = False):
        self.lower = lower

    def mm(self, x: torch.Tensor) -> torch.Tensor:
        """An operand of an f32 product (TF32 rounds it to 10 bits)."""
        if not self.lower:
            return x
        bits = x.float().contiguous().view(torch.int32)
        return ((bits + 0x1000) & -0x2000).view(torch.float32)

    def vec(self, x: torch.Tensor) -> torch.Tensor:
        """f32 -> the exact engine's bf16 vector entries."""
        if self.lower:
            x = x.to(torch.float8_e4m3fn).float()
        return x.to(torch.bfloat16)


def round_up(x: int, m: int) -> int:
    return x + (-x) % m


def normalize(x: torch.Tensor) -> torch.Tensor:
    return x / torch.linalg.norm(x, dim=1, keepdim=True)


def nearest(x, c, m: int, prec: Precision, chunk: int = 32768):
    """(n, m) int64: the m nearest rows of c to each row of x by f32
    squared distance, nearest first."""
    cn = (c * c).sum(1)
    cm = prec.mm(c)
    out = []
    for i in range(0, x.shape[0], chunk):
        xi = x[i:i + chunk]
        d2 = (xi * xi).sum(1)[:, None] + cn[None] - 2.0 * (prec.mm(xi) @ cm.T)
        if m == 1:
            out.append(d2.argmin(1, keepdim=True))
        else:
            out.append(torch.sort(d2, dim=1, stable=True).indices[:, :m])
    return torch.cat(out)


def pad_blocks(x, n_blocks: int, dpb: int):
    """Zero columns up to ``n_blocks * dpb``; (n, n_blocks, dpb). Raises
    on wider input: its columns have to be projected (``coded``) first,
    never cropped."""
    width = n_blocks * dpb
    if x.shape[1] > width:
        raise ValueError(f"{x.shape[1]} columns do not fit {n_blocks} "
                         f"blocks of {dpb}: project them first")
    x = torch.nn.functional.pad(x, (0, width - x.shape[1]))
    return x.reshape(x.shape[0], n_blocks, dpb)


def projection(d: int, dpb: int, rotate_dim, seed: int, device):
    """FastPQ's random projection (rotate_dim, d_pad) f32 of ``d`` raw
    dimensions, or None where it draws none: ``rotate_dim`` None, or d
    100 (the GloVe case)."""
    if rotate_dim is None or d == 100:
        return None
    m = BLOCK_PAD * dpb
    n = round_up(d, m)
    q, _ = np.linalg.qr(np.random.default_rng(seed).standard_normal((n, n)))
    R = np.ascontiguousarray(q.T, dtype=np.float32)[:round_up(rotate_dim, m)]
    return torch.as_tensor(R, device=device)


def coded(x, R, prec: Precision):
    """The columns the PQ codes: ``x`` itself without a projection, else
    ``x`` padded to ``R``'s input width and projected, ``x_pad @ R.T``,
    in one product over all rows as the program makes it."""
    if R is None:
        return x
    x = torch.nn.functional.pad(x, (0, R.shape[1] - x.shape[1]))
    return prec.mm(x) @ prec.mm(R).T


def encode(x, codebooks, prec: Precision, chunk: int = 65536):
    """uint8 (n, B): each block's nearest of its 16 codebook entries,
    of the coded columns ``x`` (``coded``)."""
    B, _, dpb = codebooks.shape
    cn = (codebooks * codebooks).sum(-1)
    cb = prec.mm(codebooks)
    out = []
    for i in range(0, x.shape[0], chunk):
        cols = prec.mm(pad_blocks(x[i:i + chunk], B, dpb))
        d2 = cn[None] - 2.0 * torch.einsum("nbd,bkd->nbk", cols, cb)
        out.append(d2.argmin(2).to(torch.uint8))
    return torch.cat(out)


def int8_tables(q, codebooks, prec: Precision):
    """(Q, B, 16) int32 values of the signed int8 distance tables of the
    coded queries ``q`` (``coded``): squared block distances, shifted by
    ln2 times their mean, scaled so the largest is 128 / sqrt(B), rounded
    half to even, clipped."""
    B, _, dpb = codebooks.shape
    qb = pad_blocks(q, B, dpb)
    qn = (qb * qb).sum(-1)
    cn = (codebooks * codebooks).sum(-1)
    cross = torch.einsum("qbd,bkd->qbk", prec.mm(qb), prec.mm(codebooks))
    dists = torch.clamp(qn[:, :, None] + cn[None] - 2.0 * cross, min=0.0)
    shift = dists.mean(dim=(1, 2)) * LN2
    shifted = dists - shift[:, None, None]
    scale = 128.0 / (shifted.amax(dim=(1, 2)) * torch.tensor(
        math.sqrt(B), dtype=torch.float32, device=q.device))
    t = torch.round(shifted * scale[:, None, None]).clamp(-128, 127)
    return t.to(torch.int32)


def augment(x, prec: Precision):
    """The exact engine's points: [x, hi(|x|^2), lo(|x|^2), 1, 0...] to
    a multiple of 16 entries, so that one dot product with an augmented
    query is the squared distance."""
    d = x.shape[1]
    xn = (x * x).sum(1)
    hi = xn.to(torch.bfloat16).float()
    aug = torch.zeros((x.shape[0], round_up(d + 3, 16)), device=x.device)
    aug[:, :d] = x
    aug[:, d] = hi
    aug[:, d + 1] = xn - hi
    aug[:, d + 2] = 1.0
    return prec.vec(aug)


def augment_queries(q, prec: Precision):
    """[-2q, 1, 1, |q|^2, 0...]."""
    d = q.shape[1]
    aug = torch.zeros((q.shape[0], round_up(d + 3, 16)), device=q.device)
    aug[:, :d] = -2.0 * q
    aug[:, d] = 1.0
    aug[:, d + 1] = 1.0
    aug[:, d + 2] = (q * q).sum(1)
    return prec.vec(aug)


class Index(NamedTuple):
    """What the build makes, worked out again."""
    data: torch.Tensor       # (n, d) f32, normalized for angular
    assign: torch.Tensor     # (n, build_probes) int64 center of each copy
    active: torch.Tensor     # (C,) int64 centers with points, ascending
    members: torch.Tensor    # (C, cap) int64 point ids in list order, -1 pad
    counts: torch.Tensor     # (C,) int64
    max_tiles: int
    codes: torch.Tensor      # (n, B) uint8
    aug: torch.Tensor | None  # (n, d_aug) bf16, exact engine
    centers: torch.Tensor    # (n_clusters, d) f32 (the fit's)
    codebooks: torch.Tensor  # (B, 16, dpb) f32 (the fit's)
    R: torch.Tensor | None   # (B dpb, d_pad) f32, FastPQ's projection


def derive(data_raw, centers, codebooks, cfg: dict, prec: Precision) -> Index:
    """The index the configuration defines over ``data_raw`` from the
    fit's centers and codebooks. A point sits in the lists of its
    ``build_probes`` nearest centers, in ascending id order in each; its
    codes are those of its projection (``projection``, ``coded``)."""
    fp32_products()
    x = normalize(data_raw) if cfg["metric"] == "angular" else data_raw
    bp = cfg["build_probes"]
    assign = nearest(x, centers, bp, prec)
    active = torch.unique(assign)
    remap = torch.full((centers.shape[0],), -1, dtype=torch.int64,
                       device=x.device)
    remap[active] = torch.arange(active.shape[0], device=x.device)
    flat = remap[assign].reshape(-1)
    point = torch.arange(x.shape[0], device=x.device).repeat_interleave(bp)
    order = torch.argsort(flat * x.shape[0] + point)
    counts = torch.bincount(flat, minlength=active.shape[0])
    max_tiles = max(1, -(-int(counts.max()) // LANE))
    starts = torch.cumsum(counts, 0) - counts
    lists = flat[order]
    pos = torch.arange(flat.shape[0], device=x.device) - starts[lists]
    members = torch.full((active.shape[0], max_tiles * LANE), -1,
                         dtype=torch.int64, device=x.device)
    members[lists, pos] = point[order]
    R = projection(x.shape[1], codebooks.shape[2], cfg["rotate_dim"],
                   cfg["pq_seed"], x.device)
    codes = encode(coded(x, R, prec), codebooks, prec)
    aug = augment(x, prec) if cfg["engine"] == "exact" else None
    return Index(x, assign, active, members, counts, max_tiles, codes, aug,
                 centers, codebooks, R)


class Plan(NamedTuple):
    """Fold widths and pool sizes of one query shape."""
    fold0: int      # round 0's fold width in tiles (each query's nearest list)
    fold_tail: int  # the other probes' fold width in tiles
    pass_1: int     # candidates per query before the build-probes factor
    p1: int         # pool entries selected for the rescore


def plan(cfg: dict, index: Index, Q: int) -> Plan:
    """The configuration's candidate depths for a batch of Q queries: a
    per-pair depth r for each query's nearest list and r_tail for its
    other probes, each folded over ``fold_mult * r`` positions (whole
    tiles, never wider than the longest list). The exact engine sizes
    round 0 to the whole longest list while the (lists, slots, width)
    grid stays under 512 MiB, with 2.5x the mean per-list load as slots."""
    k, P, mult = cfg["k"], cfg["n_probes"], cfg["fold_mult"]
    C, mt = index.active.shape[0], index.max_tiles
    cap = mt * LANE
    P = min(P, C)
    if cfg["engine"] == "exact":
        qc0 = max(32, -(-5 * Q // (2 * C)) // 8 * 8 + 8)
        qc = max(8, round_up(5 * Q * P // (2 * C) + 1, 8))
        b0 = max(1, (512 << 20) // (4 * C * qc0 * LANE))
        bt = max(1, (512 << 20) // (4 * C * qc * LANE))
        pass_1 = max(cfg["pass_1"] or 4 * k * P, k)
        w0 = max(min(mt, b0), -(-mult * max(4 * k, 32) // LANE))
        wt = max(min(mt, bt, -(-mult * max(pass_1, 2 * k) // LANE)),
                 -(-mult * 16 // LANE))
        r, r_tail = -(-w0 * LANE // mult), -(-wt * LANE // mult)
    else:
        pass_1 = max(cfg["pass_1"] or (P + 1) * k + 1, k)
        r = min(pass_1, cap)
        r_tail = min(pass_1, cap, max(3 * k, 16))
        pass_1 = min(pass_1, r + (P - 1) * r_tail)
    f0 = max(1, min(mt, -(-mult * r // LANE)))
    ft = max(1, min(mt, -(-mult * r_tail // LANE)))
    width = (f0 + (P - 1) * ft) * LANE
    f = min(cfg["build_probes"], P)
    return Plan(f0, ft, pass_1, min(f * pass_1, width))


def _fold(keys, tiles: int, max_tiles: int):
    """Min of the keys (Qc, cap) over each position class p mod
    tiles * 128: (Qc, tiles * 128)."""
    S = tiles * LANE
    L = round_up(max_tiles, tiles) * LANE
    keys = torch.nn.functional.pad(keys, (0, L - keys.shape[1]),
                                   value=INVALID)
    return keys.reshape(keys.shape[0], L // S, S).amin(1)


def _list_keys(index: Index, cfg, lists, tables_or_q, prec: Precision):
    """Keys (value << POS_BITS | position) of every position of the
    lists (Qc,) for their query, INVALID past a list's end. PQ: the sum
    of the int8 table entries of the point's codes; exact: the bf16 bits
    of the clamped f32 dot product of the augmented rows."""
    ids = index.members[lists]                        # (Qc, cap)
    pos = torch.arange(ids.shape[1], device=ids.device)
    if cfg["engine"] == "exact":
        vecs = index.aug[ids.clamp(min=0)].float()    # (Qc, cap, d_aug)
        dot = torch.bmm(prec.mm(vecs), prec.mm(tables_or_q)[:, :, None])
        dot = dot[:, :, 0].clamp(min=0.0)
        val = dot.to(torch.bfloat16).view(torch.int16).to(torch.int64)
    else:
        t = tables_or_q                                # (Qc, B, 16)
        B = t.shape[1]
        codes = index.codes[ids.clamp(min=0)].long()   # (Qc, cap, B)
        idx = (codes + 16 * torch.arange(B, device=ids.device)).reshape(
            ids.shape[0], -1)
        val = torch.gather(t.reshape(t.shape[0], -1), 1, idx).reshape(
            codes.shape).sum(-1).to(torch.int64) + (1 << 16)
    return torch.where(ids >= 0, (val << POS_BITS) | pos, INVALID)


def answers(index: Index, queries_raw, cfg: dict, prec: Precision,
            Q: int | None = None, chunk: int = 256):
    """Top-k ids (Q', k) int64 (-1 where no candidate) and their f64
    squared distances (inf there) for every row of ``queries_raw``: the
    folded scan of the configuration, round 0 over each query's nearest
    list and the tail over its other probes, then the ``p1`` smallest
    keys of the pooled folds in pool order, ranked by exact distance
    (f64; the control: f32 on TF32 operands), repeated ids dropped, k
    kept. ``Q``: the batch size the query runs at, which sets the exact
    engine's fold widths."""
    fp32_products()
    k, P = cfg["k"], min(cfg["n_probes"], index.active.shape[0])
    pl = plan(cfg, index, Q or queries_raw.shape[0])
    exact = cfg["engine"] == "exact"
    q_all = (normalize(queries_raw) if cfg["metric"] == "angular"
             else queries_raw)
    q_code = None if exact else coded(q_all, index.R, prec)
    act = index.centers[index.active]
    ids_out, d_out = [], []
    for c0 in range(0, q_all.shape[0], chunk):
        q = q_all[c0:c0 + chunk]
        probes = nearest(q, act, P, prec)             # (Qc, P)
        side = (augment_queries(q, prec).float() if exact
                else int8_tables(q_code[c0:c0 + chunk], index.codebooks,
                                 prec))
        keys = [_list_keys(index, cfg, probes[:, j], side, prec)
                for j in range(P)]
        pool = torch.cat([_fold(keys[0], pl.fold0, index.max_tiles)]
                         + [_fold(kk, pl.fold_tail, index.max_tiles)
                            for kk in keys[1:]], dim=1)
        sel = torch.sort(pool, dim=1, stable=True)
        kept, at = sel.values[:, :pl.p1], sel.indices[:, :pl.p1]
        S0 = pl.fold0 * LANE
        probe = torch.where(at < S0, 0,
                            1 + (at - S0) // (pl.fold_tail * LANE))
        lists = torch.gather(probes, 1, probe)
        pos = kept & ((1 << POS_BITS) - 1)
        cand = index.members[lists, pos.clamp(max=index.members.shape[1]
                                              - 1)]
        cand = torch.where(kept < INVALID, cand, -1)
        ids_k, d_k = _rank(index.data, q, cand, k, prec)
        ids_out.append(ids_k)
        d_out.append(d_k)
    return torch.cat(ids_out), torch.cat(d_out)


def _rank(data, q, cand, k: int, prec: Precision):
    """The k nearest distinct candidates (Qc, p1) by exact distance."""
    x = data[cand.clamp(min=0)]                        # (Qc, p1, d)
    if prec.lower:
        xm, qm = prec.mm(x), prec.mm(q)
        d = ((x * x).sum(-1) + (q * q).sum(-1)[:, None]
             - 2.0 * torch.bmm(xm, qm[:, :, None])[:, :, 0]).double()
    else:
        d = ((x.double() - q.double()[:, None]) ** 2).sum(-1)
    d = torch.where(cand >= 0, d, math.inf)
    by_id = torch.sort(cand, dim=1, stable=True).indices
    d1 = torch.gather(d, 1, by_id)
    order = torch.gather(by_id, 1, torch.sort(d1, dim=1, stable=True).indices)
    c, d = torch.gather(cand, 1, order), torch.gather(d, 1, order)
    dup = torch.zeros_like(c, dtype=torch.bool)
    dup[:, 1:] = (c[:, 1:] == c[:, :-1]) & (c[:, 1:] >= 0)
    d = torch.where(dup, math.inf, d)
    best = torch.sort(d, dim=1, stable=True).indices[:, :k]
    c, d = torch.gather(c, 1, best), torch.gather(d, 1, best)
    c = torch.where(torch.isfinite(d), c, -1)
    true = ((data[c.clamp(min=0)].double() - q.double()[:, None]) ** 2
            ).sum(-1)
    return c, torch.where(c >= 0, true, math.inf)


def truth(data_n, queries_n, k: int, chunk: int = 256, margin: int = 64):
    """Exact top-k ids (Q, k) int64 by f64 distance: an f32 prefilter of
    ``margin`` candidates, ranked again in f64."""
    fp32_products()
    xn = (data_n * data_n).sum(1)
    out = []
    for i in range(0, queries_n.shape[0], chunk):
        q = queries_n[i:i + chunk]
        d2 = (q * q).sum(1)[:, None] + xn[None] - 2.0 * (q @ data_n.T)
        cand = torch.topk(d2, min(margin, data_n.shape[0]), dim=1,
                          largest=False).indices
        d = ((data_n[cand].double() - q.double()[:, None]) ** 2).sum(-1)
        best = torch.sort(d, dim=1, stable=True).indices[:, :k]
        out.append(torch.gather(cand, 1, best))
    return torch.cat(out)


def kmeans_inertia(x, centers, chunk: int = 65536) -> float:
    """Mean f64 squared distance of each row of x to its nearest center."""
    total = 0.0
    for i in range(0, x.shape[0], chunk):
        xi = x[i:i + chunk]
        j = nearest(xi, centers, 1, Precision())[:, 0]
        total += float(((xi.double() - centers[j].double()) ** 2).sum())
    return total / x.shape[0]


def kmeans(x, k: int, gen: torch.Generator, iters: int = 30,
           pool: int = 16384):
    """Plain k-means: k-means++ seeding on a random pool of rows, then
    Lloyd iterations with f64 sums; an empty cluster keeps its center."""
    fp32_products()
    p = x[torch.randperm(x.shape[0], generator=gen,
                         device=x.device)[:pool]]
    first = torch.randint(p.shape[0], (1,), generator=gen, device=x.device)
    centers = [p[first[0]]]
    d2 = ((p - centers[0]) ** 2).sum(1)
    for _ in range(k - 1):
        c = p[torch.multinomial(d2.clamp(min=0) + 1e-30, 1, generator=gen)[0]]
        centers.append(c)
        d2 = torch.minimum(d2, ((p - c) ** 2).sum(1))
    c = torch.stack(centers)
    for _ in range(iters):
        j = nearest(x, c, 1, Precision())[:, 0]
        sums = torch.zeros((k, x.shape[1]), dtype=torch.float64,
                           device=x.device).index_add_(0, j, x.double())
        n = torch.bincount(j, minlength=k).double()
        c = torch.where(n[:, None] > 0, sums / n.clamp(min=1)[:, None],
                        c.double()).float()
    return c


def block_kmeans(cols, k: int, gen: torch.Generator, iters: int = 30,
                 pool: int = 16384, chunk: int = 32768):
    """Plain k-means of every block column of ``cols`` (B, n, dpb) at
    once, as ``kmeans`` does it for one: (B, k, dpb)."""
    fp32_products()
    B, n, dpb = cols.shape
    dev = cols.device
    b = torch.arange(B, device=dev)
    p = cols[:, torch.randperm(n, generator=gen, device=dev)[:pool]]
    first = torch.randint(p.shape[1], (B,), generator=gen, device=dev)
    centers = [p[b, first]]
    d2 = ((p - centers[0][:, None]) ** 2).sum(-1)
    for _ in range(k - 1):
        j = torch.multinomial(d2.clamp(min=0) + 1e-30, 1, generator=gen)[:, 0]
        centers.append(p[b, j])
        d2 = torch.minimum(d2, ((p - centers[-1][:, None]) ** 2).sum(-1))
    c = torch.stack(centers, 1)
    for _ in range(iters):
        sums = torch.zeros((B * k, dpb), dtype=torch.float64, device=dev)
        counts = torch.zeros(B * k, dtype=torch.float64, device=dev)
        for i in range(0, n, chunk):
            x = cols[:, i:i + chunk]
            flat = (b[:, None] * k + _block_nearest(x, c)).reshape(-1)
            sums.index_add_(0, flat, x.reshape(-1, dpb).double())
            counts += torch.bincount(flat, minlength=B * k).double()
        counts = counts.view(B, k, 1)
        c = torch.where(counts > 0, sums.view(B, k, dpb)
                        / counts.clamp(min=1), c.double()).float()
    return c


def _block_nearest(x, c):
    """(B, m) int64: each row's nearest of its block's centers by f32
    squared distance."""
    cn = (c * c).sum(-1)
    return (cn[:, None] - 2.0 * torch.bmm(x, c.transpose(1, 2))).argmin(-1)


def block_inertia(cols, c, chunk: int = 32768) -> torch.Tensor:
    """(B,) f64 mean squared distance of each block column's rows to
    their nearest of the block's centers ``c`` (B, k, dpb)."""
    B, n, _ = cols.shape
    total = torch.zeros(B, dtype=torch.float64, device=cols.device)
    b = torch.arange(B, device=cols.device)[:, None]
    for i in range(0, n, chunk):
        x = cols[:, i:i + chunk]
        near = c[b, _block_nearest(x, c)]
        total += ((x.double() - near.double()) ** 2).sum((1, 2))
    return total / n
