#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (tinyknn_tpu_torch) on one GPU.

    python3 chip_smoke.py

Run from the repository root on a machine with a CUDA device and nvcc.
In order, and stopping at the first failure with a non-zero exit:

1. device: prints the card, its power limit and the torch/CUDA versions;
2. build: compiles the three kernels from csrc/ with nvcc, one process
   per source, all started together;
3. kernel checks, each kernel against its plain torch version on skewed
   synthetic inputs (an empty list, one longer than 128 points, fold
   widths 1, 2 and 6, query counts that are not a multiple of the
   kernel's query block): K1 scan_fold_csr for int8 tables (bit-equal),
   bf16 tables with integer values (bit-equal) and random bf16 tables
   (decoded values within 1 bf16 ulp, positions equal where values are
   not tied), with every slot, with the real block count below the
   padded one, and with 0, 1, 7, 8, 9 and all slots occupied; K2
   scan_exact_csr on integer-valued inputs (bit-equal) and random ones
   (the same rule as random bf16 K1), with every slot, with 0, 1, 7, 8,
   9 and all slots occupied, and at widths d_aug of 40 and 45; K3
   estimate_scan_tiled for int8 and f32 tables (bit-equal) and bf16
   tables (rtol 1e-6), 9 to 45 queries;
4. PQ path: fits and builds IVF("angular", 1087, FastPQ(2)) on the
   GloVe-shape clustered dataset (1,183,514 x 100, made from a seed),
   queries its 10,000 queries at three points (int8 p1=84, bf16 p1=17,
   int8 p1=21), grades recall10@10 against the checked-in f64 ground
   truth, checks K1 ran on every query with as many launches in the
   warm batch as in the first, and repeats the K1 check on each K1 shape
   the path gave (round 0 at 32 slots and the retry at 128, with the
   batch's own slot counts), timing K1 against its plain version there;
4b. serving path, on the same index: ``query_stream`` at int8 p1=84 and
   bf16 p1=17 (the 10k queries stacked R = 2 and 7 times, as bench.py
   builds its streams; batch 0 must equal ``query()``'s ids, no pair may
   drop, one K1 launch per batch, and the stream's first K1 call holds
   against the plain version; sustained rates consumed on the device
   and delivered to the host), one warm ``device_out`` call under
   ``torch.cuda.set_sync_debug_mode("error")``, ``rescore_rows`` at the
   three phase-4 points (identical ids, as many K1 launches as with the
   flag off), gather against bucket mode (median times at Q = 1, 8, 64;
   gather recall on 1,024 queries at most 0.02 below bucket's),
   ``scan_impl='xla'`` (recall >= 0.68, no kernel launch),
   ``tune_n_probes`` (recall >= 0.9; each K1 shape it gives, the tail
   round of P=2 included, against the plain version), ``save_ivf`` ->
   ``load_ivf`` (identical ids) and ``Flat`` (recall >= 0.999);
5. exact path: switches that index to the exact engine (build_probes=1,
   P=1), then rebuilds it with build_probes=2 (P=1 and P=2), grades
   recall10@10, checks K2 ran, and holds and times K2 against its plain
   version on each K2 shape of the build_probes=1 query (round 0 at 32
   slots and the retry at 128, with the batch's own slot counts). Its
   serving surface (5b): the stream (R = 2, recall >= 0.96, one K2
   launch per batch, its first K2 call against the plain version), a
   warm ``device_out`` stream call under
   ``set_sync_debug_mode("error")``, ``rescore_rows`` at build_probes 1
   and 2 (identical ids) and exact gather mode (the rule of 4b);
6. full-scan path: FastPQ(2, rotate_dim=None) on the reference's own
   example (random 16,000 x 128, 1,000 queries, seed 10): true-NN rank
   of the full-scan estimates, search recall1@10 for methods 'exact'
   (K3) and 'approx' (K1 through fold_topk_tiled), both gated; checks
   both kernels ran, holds each against its plain version on the call
   the path made (bit-equal, then timed), and times the two wrappers
   (estimate_scan, fold_topk_tiled) against themselves over the plain
   kernel, after checking that their outputs are equal;
7. K3 at real size: the GloVe corpus's codes against 1,000 of its
   queries, K3 against its plain version (bit-equal, then timed), the
   two wrappers timed as in phase 6, one warm FastPQ.search batch with
   its pass-1 sort timed alone, and the same batch with 'approx';
8. sharded path: the phase-4 index's archive placed over meshes of
   logical shards on the one card (``load_sharded_ivf``: 1 shard, 4
   shards with a pad list, a 2 x 2 queries x shards mesh, and 2 shards
   to compare the 2 x 2 mesh with), ``ShardedIVF.query`` at int8 p1=84
   and bf16 p1=17, and the build_probes=2 exact index's archive at P=2:
   recall10@10 no lower than the single-device index's less 0.001, no
   dropped pair, K1 (K2) launched once per shard, round and attempt and
   no plain version on the path, the first K1 (K2) call of a shard held
   against the plain version, timed and given its bound; the 1-shard
   ids beside the single-device ``rescore_rows`` ids, the 2 x 2 ids
   beside the 2-shard ones (overlap >= 0.99), a 9,999-query batch equal
   to the 10,000-query one's first rows; ``query_stream`` on 4 shards
   (batch 0 equal to ``query()``, a warm ``device_out`` call under
   ``set_sync_debug_mode("error")``, one exact-engine stream);
   ``ShardedFastPQ.search`` on the GloVe corpus over 4 shards (K3 once
   per shard, its first call bit-equal to the plain version and timed);
   ``lloyd_step_dp`` over 4 shards against 1; and ``save_ivf`` of the
   placed index read back by ``load_ivf`` (identical ids). With more
   than one card visible it also runs one shard per card;
9. examples: each module of ``tinyknn_tpu_torch.examples`` through its
   ``main``, as a user runs it, at its own full-width defaults or on the
   phase-4 archive and the phase-5 build_probes=2 archive (the GloVe
   shape), with the counts reset before each: ``example`` (K3, its call
   bit-equal to the plain version, rank median <= 3 and q90 <= 25),
   ``ivf_example`` (K1 in every query() call at n_probes 1 to 10, round
   0 at P=1 and the tail round at P=2 held, recall at P=10 no lower than
   at P=1), ``multiprobes`` (K1 in every query() call), ``flat_baseline``
   (no kernel, recall 1.0 on 1,000 queries against an f64 brute force),
   ``bench`` on ``clustered-1183514-100`` reading the phase-4 archive and
   the checked-in truth from its cache directory (P=1 recall within
   0.001 of phase 4's), ``serving_pipeline`` on its small default and
   with ``--glove`` (pooled blocks equal, the warm ``device_out`` calls
   under ``set_sync_debug_mode("error")``), ``latency`` at Q = 1 to 256
   (gather launches no K1, bucket does; per-call medians printed),
   ``stream_guidance`` (no dropped pair under the adaptive default),
   ``p1_frontier`` at pass_1 21 and 84 and ``exact_frontier`` at P = 1
   and 2 (recall within 0.001 of phases 4 and 5; the first K2 call held),
   ``coverage_ceiling`` (the ceiling at P=1 no lower than any recall
   measured there) and ``sift_convert``.

Every path is driven with the launch counts set to 0 just before it and
read just after; it fails if its kernel did not launch (gather mode,
'xla' and ``Flat`` run none) or a plain version ran on a CUDA tensor.
The calls a path is compared with (``query()`` beside the stream, the
flag-off runs beside ``rescore_rows``, the original index beside the
loaded one) run outside its window.
Times are host clock ending in a synchronize, or CUDA events for
kernels (in turns: plain, kernel, kernel, plain). Every
timed IVF query and the reference example's search calls also get a
torch.profiler stage profile: device time per kernel.

Each timed kernel call also gets its bound: the larger of the bytes it
must move over 3.35 TB/s and its tensor-core operations (one-hot, or
K2's dot products) over the int8 or bf16 peak, counting only occupied
slots and real blocks (``k1_bound``, ``k2_bound``, ``k3_bound``). K3
is also timed against ``torch._int_mm`` over the one-hot of the same
codes (``k3_library``), a yardstick the port never calls; K1 and K2
have no such call.

Phase 8's shards are logical: they run in turn on one card, so its
times say what sharding costs there, not what several cards would give.

The last three lines are the card's name and power limit as nvidia-smi
reports them, a JSON object describing each kernel, and the result
object ``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import json
import subprocess
import sys
import time
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent
TRUTH = ROOT / "trus64_clustered-1183514-100_k10_nq10000_angular.npy"
GLOVE = dict(size=1183514, dim=100, n_queries=10000, n_clusters=1087)
# recall10@10 gates: the JAX package measured 0.6997 (int8, p1=84) and
# the reference publishes 0.374 (bf16 point, p1=17)
POINTS = (("int8", 84, 0.68), ("bf16", 17, 0.374), ("int8", 21, None))
# exact engine recall10@10 gates (JAX package: 0.9685 at build_probes=1
# and 0.9933 at build_probes=2, both P=1; bench.py gates the latter at
# 0.97); P=2 at build_probes=2 may fall at most 0.005 below P=1
EXACT_GATES = (0.96, 0.97, 0.005)
# full scan of the reference example: true-NN rank median / q90 (JAX on
# the CPU 2.0 / 19.0; the reference publishes 1.0 / 19.0) and search
# recall1@10 (JAX on the CPU 0.943)
FULL_SCAN = dict(n=16000, d=128, n_queries=1000, seed=10)
FULL_SCAN_GATES = (3.0, 25.0, 0.90)
K3_QUERIES = 1000
# serving surface (phases 4b and 5b): query_stream at the north-star
# points, stacked R times as bench.py does; gather against bucket mode
# (the JAX package's tests allow gather 0.02 below bucket); the 'xla'
# engine gated like the fused path; tune_n_probes; Flat against the f64
# truth
STREAM_POINTS = (("int8", 84), ("bf16", 17))
STREAM_REPS = (2, 7)
GATHER_QS = (1, 8, 64)
GATHER_TIMED_CALLS = 20
GATHER_RECALL_QUERIES = 1024
GATHER_SLACK = 0.02
XLA_GATE = 0.68
TUNE_QUERIES = 1000
TUNE_TARGET = 0.9
FLAT_GATE = 0.999
# sharded path (phase 8): a sharded recall may fall this far below the
# single-device one (per-shard rescore pools are a superset of the
# single-device cut); the 2 x 2 mesh against 2 shards, tests/test_sharded.py's
# rule; ShardedFastPQ's recall1@10 against FastPQ's; lloyd_step_dp over 4
# shards against 1 (centers absolute, inertia relative)
SHARDED_SLACK = 0.001
MESH_2D_OVERLAP = 0.99
SHARDED_PQ_SLACK = 0.005
LLOYD_TOL = (1e-4, 1e-5)
KERNEL_TIMED_LAUNCHES = 50
K3_TIMED_LAUNCHES = 5
PLAIN_TIMED_LAUNCHES = 3
# K1's slot counts held against the plain version: empty, one, around a
# group of 8, and every slot (None: qc)
SLOT_COUNT_CASES = (0, 1, 7, 8, 9, None)
# published H100 SXM peaks (NVIDIA's data sheet, dense): device memory
# bytes/s and tensor-core int8 / bf16 operations/s, f32 outside them
HBM_BYTES_PER_S = 3.35e12
PEAK_OPS_PER_S = {"int8": 1979e12, "bf16": 989e12, "f32": 67e12}
NO_LIBRARY = {
    "scan_fold_csr": "no single PyTorch call computes the encoded "
                     "position min-fold",
    "scan_exact_csr": "no single PyTorch call computes the fold; "
                      "torch.bmm gives the products only",
}
# the examples (phase 9): a recall an example measures on the phase-4 or
# phase-5 archive may differ from that phase's by this much; latency's
# batch sizes (gather against bucket) and its repeats (10 calls a point,
# stream lengths 4 and 12, against the script's 30 and 16 / 48)
EXAMPLE_SLACK = 0.001
LATENCY_BATCHES = (1, 8, 32, 64, 128, 256)
LATENCY_REPEATS = ("--calls", "10", "--stream-reps", "4", "12")


def fold_case(seed: int, kind: str, n: int = 900, B: int = 8, C: int = 4,
              qc: int = 20):
    """A skewed scan_fold_csr input as NumPy arrays: ``(tables, codes,
    assign)``. Lists get 70/25/5/0 % of the n points (one list longer
    than 128, one empty); codes uint8[n, B]; tables [C, qc, 16B]
    block-major: int8 for 'int8', small non-negative integers as f32
    for 'bf16_int' (every sum exact in bf16), random f32 in [0, 10) for
    'bf16'."""
    rng = np.random.default_rng(seed)
    p = np.array([0.7, 0.25, 0.05, 0.0][:C])
    assign = rng.choice(C, size=(n, 1), p=p / p.sum())
    codes = rng.integers(0, 16, size=(n, B), dtype=np.uint8)
    shape = (C, qc, B * 16)
    if kind == "int8":
        tables = rng.integers(-128, 128, size=shape).astype(np.int8)
    elif kind == "bf16_int":
        tables = rng.integers(0, 32, size=shape).astype(np.float32)
    else:
        tables = (10 * rng.random(size=shape)).astype(np.float32)
    return tables, codes, assign


def fold_inputs(tables, codes, assign, device):
    """The port's scan_fold_csr arguments for a ``fold_case``."""
    import torch
    from tinyknn_tpu_torch.ops.kernels import (
        pack_codes_tiled, permute_tables_csr)
    from tinyknn_tpu_torch.ops.packing import pack_codes
    from tinyknn_tpu_torch.utils.grouping import invert_assignments_csr_tiled
    C, _, M = tables.shape
    flat_ids, toff, counts = invert_assignments_csr_tiled(assign, C)
    codes_tiled = pack_codes_tiled(pack_codes(torch.as_tensor(codes)),
                                   torch.as_tensor(flat_ids))
    t = permute_tables_csr(torch.as_tensor(tables), M // 16)
    if t.dtype != torch.int8:
        t = t.to(torch.bfloat16)
    max_tiles = max(1, int(-(-counts.max() // 128)))
    return (t.to(device), codes_tiled.to(device),
            torch.as_tensor(toff, device=device),
            torch.as_tensor(counts, device=device), max_tiles)


def decode(enc, bf16: bool, B_pad: int, max_tiles: int):
    """(values f64, positions) of a fold buffer (NumPy); NaN/-1 where
    the slot is empty."""
    enc = np.asarray(enc).astype(np.int64)
    valid = enc < 2**31 - 1
    if bf16:
        bits = ((enc >> 16) << 16).astype(np.uint32)
        val = bits.view(np.float32).astype(np.float64)
        pos = enc & 0xFFFF
    else:
        col_bits = max(1, (max_tiles * 128 - 1).bit_length())
        val = ((enc >> col_bits) - 128 * B_pad).astype(np.float64)
        pos = enc & ((1 << col_bits) - 1)
    return np.where(valid, val, np.nan), np.where(valid, pos, -1)


def compare_fold(got, want, bf16: bool, exact: bool, B_pad: int,
                 max_tiles: int, moved_ok=None) -> float:
    """Check a kernel fold buffer against the plain version's; returns
    the largest absolute difference of the decoded values. ``exact``:
    bit equality; otherwise values within 1 bf16 ulp and equal
    positions wherever the values are equal. ``moved_ok(where,
    positions, values)`` may accept the entries whose position differs
    at an equal value (see ``k2_near_ties``); without it they fail.
    The buffers are compared where they lie, and only the entries whose
    bits differ are decoded (on the host), so a fold of 10^8 entries
    costs one pass on its device."""
    import torch
    if got.shape != want.shape or got.dtype != want.dtype:
        raise AssertionError(f"fold {got.dtype}{tuple(got.shape)} vs "
                             f"{want.dtype}{tuple(want.shape)}")
    where = torch.nonzero(got != want, as_tuple=True)
    vg, pg = decode(got[where].cpu().numpy(), bf16, B_pad, max_tiles)
    vw, pw = decode(want[where].cpu().numpy(), bf16, B_pad, max_tiles)
    diff = np.nan_to_num(np.abs(vg - vw))
    err = float(diff.max(initial=0.0))
    if exact:
        if len(vg):
            raise AssertionError(
                f"fold not bit-equal: {len(vg)} of {got.numel()} entries "
                f"differ, max value error {err}")
        return err
    if not np.array_equal(np.isnan(vg), np.isnan(vw)):
        raise AssertionError("kernel and plain fold disagree on empty slots")
    # one bf16 ulp of v = m * 2^e (m in [0.5, 1)): 2^(e - 8)
    _, exp = np.frexp(np.nan_to_num(vw))
    if (diff > np.ldexp(1.0, exp - 8)).any():
        raise AssertionError(f"bf16 fold beyond 1 ulp: max error {err}")
    moved = (diff == 0) & (pg != pw)
    if moved.any():
        at = torch.as_tensor(moved, device=got.device)
        if moved_ok is None or not moved_ok(tuple(w[at] for w in where),
                                            pg[moved], vw[moved]):
            raise AssertionError(f"bf16 fold positions differ at equal "
                                 f"values in {int(moved.sum())} of "
                                 f"{got.numel()} entries")
    return err


def exact_case(seed: int, kind: str, n: int = 900, d: int = 12, C: int = 4,
               qc: int = 20, d_aug: int | None = None):
    """A skewed scan_exact_csr input as NumPy arrays: ``(q_aug, x_aug,
    assign)``, q_aug f32[C, qc, d_aug], x_aug f32[n, d_aug] (values
    exact in bf16), lists as in ``fold_case``. 'int': small integers, so
    every dot product is exact in f32 (some negative, clamped to 0);
    'random': the exact engine's own augmentation of Gaussian points
    and queries. ``d_aug`` (default: the engine's width, a multiple of
    16) may be any width >= d + 3; the extra columns are zeros."""
    import torch
    from tinyknn_tpu_torch.models.ivf import (
        _augment_queries, _aug_dim)
    rng = np.random.default_rng(seed)
    p = np.array([0.7, 0.25, 0.05, 0.0][:C])
    assign = rng.choice(C, size=(n, 1), p=p / p.sum())
    d_aug = _aug_dim(d) if d_aug is None else d_aug
    if kind == "int":
        q_aug = rng.integers(-3, 8, size=(C, qc, d_aug)).astype(np.float32)
        x_aug = rng.integers(0, 8, size=(n, d_aug)).astype(np.float32)
        return q_aug, x_aug, assign
    x = rng.standard_normal((n, d)).astype(np.float32)
    xn = (x.astype(np.float64) ** 2).sum(1)
    hi = torch.as_tensor(xn, dtype=torch.float32).to(torch.bfloat16).float()
    x_aug = np.zeros((n, d_aug), np.float32)
    x_aug[:, :d] = x
    x_aug[:, d] = hi.numpy()
    x_aug[:, d + 1] = xn - hi.numpy()
    x_aug[:, d + 2] = 1.0
    q = torch.as_tensor(rng.standard_normal((C * qc, d)).astype(np.float32))
    q_aug = np.zeros((C * qc, d_aug), np.float32)
    q_aug[:, :d + 3] = _augment_queries(q).float().numpy()[:, :d + 3]
    q_aug = q_aug.reshape(C, qc, d_aug)
    x_aug = torch.as_tensor(x_aug).to(torch.bfloat16).float().numpy()
    return q_aug, x_aug, assign


NEAR_TIES = {"classes": 0, "within_1_ulp": 0}   # what k2_near_ties judged


def k2_near_ties(args, kw):
    """``compare_fold``'s ``moved_ok`` for one K2 call. Where a fold class
    holds several points (a fold narrower than the longest list), two of
    them can lie within 1 bf16 ulp of the class minimum, and the kernel,
    whose f32 sums run in the tensor cores' order, may keep the other one
    at the same rounded value. Such an entry is right if the point the
    kernel kept lies in the list and, by the plain version's own
    arithmetic (f32 products added in dimension order, rounded to bf16),
    is within 1 bf16 ulp of the plain version's minimum. Every entry it
    judges is counted in ``NEAR_TIES``."""
    import torch
    q_sel, vecs, toff, counts = args[:4]
    dev = q_sel.device

    def moved_ok(where, positions, values) -> bool:
        c, q, _ = (torch.as_tensor(w, device=dev) for w in where)
        pos = torch.as_tensor(positions, device=dev)
        tile = toff[c].long() + pos // 128
        x = vecs[tile, :, pos % 128].float()           # (n, d_aug)
        qv = q_sel[c, q].float()
        est = torch.zeros(len(pos), dtype=torch.float32, device=dev)
        for j in range(x.shape[1]):                    # dimension order
            est += qv[:, j] * x[:, j]
        val = torch.where(est > 0, est, 0.0).to(torch.bfloat16).double()
        want = torch.as_tensor(values, device=dev)
        ulp = torch.ldexp(torch.ones_like(want), torch.frexp(want)[1] - 8)
        ok = ((val - want).abs() <= ulp) & (pos < counts[c])
        NEAR_TIES["classes"] += len(pos)
        NEAR_TIES["within_1_ulp"] += int(ok.sum())
        print(f"    {len(pos)} fold classes keep another point at an equal "
              f"value; by the plain version's arithmetic {int(ok.sum())} of "
              f"those points are within 1 bf16 ulp of the class minimum")
        return bool(ok.all())

    return moved_ok


def exact_inputs(q_aug, x_aug, assign, device):
    """The port's scan_exact_csr arguments for an ``exact_case``:
    (q_sel, vecs_tiled, tile_offsets, counts, max_tiles)."""
    import torch
    from tinyknn_tpu_torch.utils.grouping import invert_assignments_csr_tiled
    C = q_aug.shape[0]
    flat_ids, toff, counts = invert_assignments_csr_tiled(assign, C)
    rows = x_aug[np.maximum(flat_ids, 0)]
    vecs = rows.reshape(-1, 128, x_aug.shape[1]).transpose(0, 2, 1)
    max_tiles = max(1, int(-(-counts.max() // 128)))
    bf16 = torch.bfloat16
    return (torch.as_tensor(q_aug).to(bf16).to(device),
            torch.as_tensor(np.ascontiguousarray(vecs)).to(bf16).to(device),
            torch.as_tensor(toff, device=device),
            torch.as_tensor(counts, device=device), max_tiles)


def estimate_case(seed: int, kind: str, n: int = 1000, B: int = 8,
                  Q: int = 20):
    """A full-scan estimate input as NumPy arrays: ``(codes uint8[n, B],
    tables[Q, B, 16])``, int8 tables for 'int8', random f32 in [0, 10)
    for 'bf16' and 'f32' (cast by ``estimate_inputs``)."""
    rng = np.random.default_rng(seed)
    codes = rng.integers(0, 16, size=(n, B), dtype=np.uint8)
    if kind == "int8":
        tables = rng.integers(-128, 128, size=(Q, B, 16)).astype(np.int8)
    else:
        tables = (10 * rng.random(size=(Q, B, 16))).astype(np.float32)
    return codes, tables


def estimate_inputs(codes, tables, kind: str, device):
    """The port's estimate_scan_tiled arguments (code tiles, tables)."""
    import torch
    from tinyknn_tpu_torch.ops.kernels import tile_codes
    from tinyknn_tpu_torch.ops.packing import pack_codes
    t = torch.as_tensor(tables)
    if kind == "bf16":
        t = t.to(torch.bfloat16)
    return (tile_codes(pack_codes(torch.as_tensor(codes))).to(device),
            t.to(device))


def compare_estimates(got, want, floating: bool, exact=None) -> float:
    """Check K3's output against its plain version's; returns the largest
    absolute difference. Bit equality for int8 tables, and for float
    tables with ``exact``; else rtol 1e-6. On the card f32 tables and
    bf16 tables (whose tensor-core products are added in f32 in the
    plain version's order) are both designed bit-equal; bf16 is held to
    rtol 1e-6."""
    exact = not floating if exact is None else exact
    got, want = got.cpu().numpy(), want.cpu().numpy()
    if got.dtype != want.dtype or got.shape != want.shape:
        raise AssertionError(f"estimate {got.dtype}{got.shape} vs "
                             f"{want.dtype}{want.shape}")
    err = float(np.abs(got.astype(np.float64) - want).max(initial=0.0))
    if exact and not np.array_equal(got, want):
        raise AssertionError(f"estimates not bit-equal: max error {err}")
    if floating and not np.allclose(got, want, rtol=1e-6, atol=0):
        raise AssertionError(f"float estimates beyond rtol 1e-6: max error "
                             f"{err}")
    return err


def slot_counts_for(s, counts, qc: int):
    """A slot-count case of SLOT_COUNT_CASES as int32[C] beside the list
    counts: every list gets s occupied slots (None: qc)."""
    import torch
    return torch.full_like(counts, qc if s is None else s)


def check_kernel_small(device) -> float:
    """Phase 3, K1: kernel vs plain version on skewed synthetic lists,
    with every slot and with the real block count (n_blocks = B < B_pad),
    then at each slot count of SLOT_COUNT_CASES."""
    from tinyknn_tpu_torch.ops.kernels import (
        scan_fold_csr, scan_fold_csr_reference)
    err = 0.0
    for B, qc in ((8, 20), (56, 40)):
        for kind in ("int8", "bf16_int", "bf16"):
            cases = [(W, None, n_blocks) for W in (1, 2, 6)
                     for n_blocks in (None, B)]
            cases += [(2, s, B) for s in SLOT_COUNT_CASES]
            for W, s, n_blocks in cases:
                args = fold_inputs(*fold_case(W + B, kind, B=B, qc=qc),
                                   device)
                t, codes_tiled, toff, counts, max_tiles = args
                kw = dict(fold_tiles=W, max_tiles=max_tiles,
                          n_blocks=n_blocks)
                if s is not None or n_blocks is not None:
                    kw["slot_counts"] = slot_counts_for(s, counts, qc)
                got = scan_fold_csr(t, codes_tiled, toff, counts, **kw)
                want = scan_fold_csr_reference(t, codes_tiled, toff, counts,
                                               **kw)
                torch_sync()
                e = compare_fold(got, want, kind != "int8", kind != "bf16",
                                 t.shape[2] // 16, max_tiles)
                err = max(err, e)
                print(f"  K1 B={B} qc={qc} {kind:8s} W={W} slots {s} "
                      f"n_blocks {n_blocks}: ok (max value error {e}, "
                      f"bit-equal {bool((got == want).all())})")
    return err


def check_exact_small(device) -> float:
    """Phase 3, K2: kernel vs plain version on skewed synthetic lists,
    with every slot at fold widths 1, 2 and 6, at each slot count of
    SLOT_COUNT_CASES, and at widths d_aug of 40 and 45 (not a multiple
    of 16, zero-padded in the kernel; 45 not of 8 either)."""
    from tinyknn_tpu_torch.ops.kernels import (
        scan_exact_csr, scan_exact_csr_reference)
    cases = [(d, qc, None, W, None) for d, qc in ((12, 20), (100, 40))
             for W in (1, 2, 6)]
    cases += [(d, qc, None, 2, s) for d, qc in ((12, 20), (100, 40))
              for s in SLOT_COUNT_CASES]
    cases += [(30, 20, d_aug, W, None) for d_aug in (40, 45) for W in (1, 6)]
    err = 0.0
    for d, qc, d_aug, W, s in cases:
        for kind in ("int", "random"):
            args = exact_inputs(
                *exact_case(W + d, kind, d=d, qc=qc, d_aug=d_aug), device)
            max_tiles = args[4]
            args = args[:4]
            kw = dict(fold_tiles=W, max_tiles=max_tiles)
            if s is not None:
                kw["slot_counts"] = slot_counts_for(s, args[3], qc)
            got = scan_exact_csr(*args, **kw)
            want = scan_exact_csr_reference(*args, **kw)
            torch_sync()
            e = compare_fold(got, want, True, kind == "int", 0, max_tiles)
            err = max(err, e)
            print(f"  K2 d={d} d_aug={args[0].shape[2]} qc={qc} {kind:6s} "
                  f"W={W} slots {s}: ok (max value error {e}, bit-equal "
                  f"{bool((got == want).all())})")
    return err


def check_estimate_small(device) -> float:
    """Phase 3, K3: kernel vs plain version on random codes."""
    import torch
    from tinyknn_tpu_torch.ops.kernels import (
        estimate_scan_tiled, estimate_scan_tiled_reference)
    err = 0.0
    # B = 232: code rows too wide for the int8 wgmma staging, which take
    # the mma.sync path
    for n, B, Q in ((1000, 8, 20), (700, 50, 23), (5000, 64, 45),
                    (300, 232, 9)):
        for kind in ("int8", "bf16", "f32"):
            codes_tiled, t = estimate_inputs(
                *estimate_case(n + B, kind, n=n, B=B, Q=Q), kind, device)
            got = estimate_scan_tiled(codes_tiled, t)
            want = estimate_scan_tiled_reference(codes_tiled, t)
            torch_sync()
            e = compare_estimates(got, want, kind != "int8", kind != "bf16")
            err = max(err, e)
            print(f"  K3 n={n} B={B} Q={Q} {kind:4s}: ok (max error {e}, "
                  f"bit-equal {torch.equal(got, want)})")
    return err


def torch_sync():
    import torch
    torch.cuda.synchronize()


def timed(fn):
    """(result, seconds) of fn() on the host clock, ending in a sync."""
    torch_sync()
    t0 = time.perf_counter()
    out = fn()
    torch_sync()
    return out, time.perf_counter() - t0


def event_ms(fn, n: int) -> float:
    """Mean device milliseconds of ``fn`` over n back-to-back calls."""
    import torch
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(n):
        fn()
    stop.record()
    stop.synchronize()
    return start.elapsed_time(stop) / n


def in_turns(kern, plain, n_kernel: int, n_plain: int = PLAIN_TIMED_LAUNCHES):
    """(kernel ms, plain ms, the four readings) timed with CUDA events in
    turns plain, kernel, kernel, plain after one warm-up call each."""
    kern(), plain()
    p_a = event_ms(plain, n_plain)
    k_a = event_ms(kern, n_kernel)
    k_b = event_ms(kern, n_kernel)
    p_b = event_ms(plain, n_plain)
    return (k_a + k_b) / 2, (p_a + p_b) / 2, (k_a, k_b, p_a, p_b)


def stage_profile(label: str, fn, card: str, reps: int = 3) -> None:
    """torch.profiler over ``reps`` calls of fn after one warm-up; prints
    the device busy time and the 15 device activities (kernels, copies)
    with the most time, per call. Only device rows are summed: a torch
    operator's row repeats the time of the kernels it launched."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch_sync()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch_sync()

    def device_us(e):
        if e.device_type != torch.autograd.DeviceType.CUDA:
            return 0
        return (getattr(e, "self_device_time_total", 0)
                or getattr(e, "self_cuda_time_total", 0))

    rows = sorted(((device_us(e) / reps / 1e3, e.count / reps, e.key)
                   for e in prof.key_averages() if device_us(e) > 0),
                  reverse=True)
    print(f"  profile, {label}: device busy "
          f"{sum(r[0] for r in rows):.3f} ms per call ({reps} calls) {card}")
    for ms, n, key in rows[:15]:
        print(f"    {ms:9.3f} ms x{n:<5g} {key[:100]}")


def recall_at_10(ids, truth) -> float:
    ids = ids.cpu().numpy()
    return float(np.mean([len(set(a.tolist()) & set(t.tolist())) / 10
                          for a, t in zip(ids, truth)]))


def bound_ms(moved: float, ops: float, kind: str):
    """The least time the card could take: the larger of ``moved`` bytes
    over the memory rate and ``ops`` over the peak of ``kind``. Returns
    (ms, "bytes" or "operations"), the side that binds."""
    t_bytes = moved / HBM_BYTES_PER_S
    t_ops = ops / PEAK_OPS_PER_S[kind]
    return (max(t_bytes, t_ops) * 1e3,
            "bytes" if t_bytes >= t_ops else "operations")


def k1_bound(args, kw):
    """K1's bound for one call, from what its inputs need: the table rows
    of the occupied slots (real blocks), the real code bytes of every
    tile of a list with an occupied slot, the three per-list int32
    arrays, the fold written in full; the one-hot products (2 x 16
    operations per real block) of every occupied (slot, point) pair at
    the int8 or bf16 peak."""
    import torch
    tables, _, _, counts = args[:4]
    C, qc, M = tables.shape
    n_blocks = kw.get("n_blocks") or M // 16
    sc = kw.get("slot_counts")
    occ = (torch.full((C,), qc, device=tables.device) if sc is None
           else sc.clamp(0, qc)).long()
    pts = counts.long().clamp(max=kw["max_tiles"] * 128)
    tiles = torch.where(occ > 0, (pts + 127) // 128, 0)
    moved = (int(occ.sum()) * 16 * n_blocks * tables.element_size()
             + int(tiles.sum()) * 128 * -(-n_blocks // 2) + 3 * C * 4
             + C * qc * kw["fold_tiles"] * 128 * 4)
    ops = 2 * 16 * n_blocks * int((occ * pts).sum())
    return bound_ms(moved, ops,
                    "int8" if tables.dtype == torch.int8 else "bf16")


def k2_bound(args, kw):
    """K2's bound for one call, from what its inputs need: the augmented
    query rows of the occupied slots, the vector tiles of every list
    with an occupied slot, the three per-list int32 arrays, the fold
    written in full; 2 x d_aug operations per occupied (slot, point)
    pair at the bf16 peak."""
    import torch
    q_sel, _, _, counts = args[:4]
    C, qc, d_aug = q_sel.shape
    sc = kw.get("slot_counts")
    occ = (torch.full((C,), qc, device=q_sel.device) if sc is None
           else sc.clamp(0, qc)).long()
    pts = counts.long().clamp(max=kw["max_tiles"] * 128)
    tiles = torch.where(occ > 0, (pts + 127) // 128, 0)
    moved = (int(occ.sum()) * d_aug * 2 + int(tiles.sum()) * d_aug * 128 * 2
             + 3 * C * 4 + C * qc * kw["fold_tiles"] * 128 * 4)
    return bound_ms(moved, 2 * d_aug * int((occ * pts).sum()), "bf16")


def k3_bound(codes_tiled, tables):
    """K3's bound for one call: the tables, the real code bytes of every
    tile, the (Q, T * 128) output; the one-hot products (2 x 16 per
    block) at the int8 or bf16 peak, or one f32 add per block."""
    import torch
    T, _, _ = codes_tiled.shape
    Q, B, _ = tables.shape
    N = T * 128
    moved = tables.numel() * tables.element_size() + N * -(-B // 2) + Q * N * 4
    if tables.dtype == torch.float32:
        return bound_ms(moved, Q * N * B, "f32")
    return bound_ms(moved, 2 * 16 * B * Q * N,
                    "int8" if tables.dtype == torch.int8 else "bf16")


def k3_library(codes_tiled, tables, got, n: int):
    """K3's yardstick: one PyTorch call computing its function,
    ``torch._int_mm`` of the int8 tables [Q, 16B] with the int8 one-hot
    [16B, N] of the same codes (built outside the timed window); where
    ``_int_mm`` refuses the shape, a bf16 ``torch.matmul`` of the same
    operands. The port never calls it. Returns (ms, the call, whether it
    equals K3's output ``got``)."""
    import torch
    from tinyknn_tpu_torch.ops.packing import unpack_codes
    T, Bs_pad, _ = codes_tiled.shape
    Q, B, _ = tables.shape
    N = T * 128
    dev = tables.device
    codes = unpack_codes(codes_tiled.permute(0, 2, 1).reshape(N, Bs_pad))
    onehot = torch.zeros((N, 16 * B), dtype=torch.int8, device=dev)
    onehot.scatter_(1, codes[:, :B].long() + 16 * torch.arange(B, device=dev),
                    1)
    del codes
    a = tables.reshape(Q, 16 * B)
    call = "torch._int_mm(int8 tables [Q, 16B], int8 one-hot [16B, N])"
    fn = lambda: torch._int_mm(a, onehot.t())  # noqa: E731
    try:
        out = fn()
    except RuntimeError as e:
        print(f"  torch._int_mm refused the shape ({e}); timing a bf16 "
              f"torch.matmul of the same operands instead")
        a16, b16 = a.to(torch.bfloat16), onehot.t().to(torch.bfloat16)
        call = "torch.matmul(bf16 tables [Q, 16B], bf16 one-hot [16B, N])"
        fn = lambda: torch.matmul(a16, b16)  # noqa: E731
        out = fn()
    same = torch.equal(out.to(got.dtype), got)
    del out
    return event_ms(fn, n), call, same


def kernel_table():
    """(name, wrapper, plain version, source, TPU kernel) of every
    kernel, K1 to K3."""
    from tinyknn_tpu_torch.ops import kernels as k
    return (
        ("scan_fold_csr", k.scan_fold_csr, k.scan_fold_csr_reference,
         "tinyknn_tpu/ops/kernels.py:413"),
        ("scan_exact_csr", k.scan_exact_csr, k.scan_exact_csr_reference,
         "tinyknn_tpu/ops/kernels.py:527"),
        ("estimate_scan_tiled", k.estimate_scan_tiled,
         k.estimate_scan_tiled_reference, "tinyknn_tpu/ops/kernels.py:162"),
    )


def reset_counts():
    for _, wrapper, plain, _ in kernel_table():
        wrapper.launches = 0
        plain.cuda_calls = 0


def read_counts(path: str) -> dict:
    """Launch counts since ``reset_counts``; fails if a plain version ran
    on a CUDA tensor."""
    counts = {name: wrapper.launches for name, wrapper, _, _ in
              kernel_table()}
    plain = {name: plain.cuda_calls for name, _, plain, _ in kernel_table()}
    print(f"  {path}: kernel launches {counts}; plain versions on CUDA "
          f"tensors {plain}")
    if any(plain.values()):
        raise AssertionError(f"a plain version ran on the card in {path}")
    return counts


def by_dtype(args, kw):
    return args[0].dtype


def by_shape(args, kw):
    """A scan call's table type, query slots and fold width: round 0,
    the tail round and each retry capacity are told apart."""
    return args[0].dtype, tuple(args[0].shape), kw["fold_tiles"]


def capture_first(module, name: str, store: dict, key=by_dtype):
    """Wrap ``module.<name>`` so that the first call's arguments of each
    ``key(args, kw)`` are kept in ``store``; returns a function that
    undoes the wrap."""
    original = getattr(module, name)

    def wrapped(*args, **kw):
        store.setdefault(key(args, kw), (args, kw))
        return original(*args, **kw)

    def undo():
        setattr(module, name, original)
        if hasattr(original, "launches"):
            original.launches += wrapped.launches

    # a kernel wrapper counts its launches on the function its own module
    # names, which is ``wrapped`` while the wrap is on in that module;
    # ``undo`` moves those launches back
    wrapped.launches = 0
    setattr(module, name, wrapped)
    return undo


def pq_path(ivf, data, queries, truth, card):
    """Phase 4: the IVF query over 4-bit PQ codes through K1. Every K1
    shape the path gives (round 0 and the retry at 128 slots, per table
    type and fold width) is held against the plain version with the
    batch's own slot counts, timed, and given its bound."""
    import torch
    import tinyknn_tpu_torch.models.ivf as ivf_module
    from tinyknn_tpu_torch.ops.kernels import (
        scan_fold_csr, scan_fold_csr_reference)
    captured = {}                       # first K1 call of each shape
    undo = capture_first(ivf_module, "scan_fold_csr", captured, by_shape)
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    _, t_fit = timed(lambda: ivf.fit(data))
    _, t_build = timed(lambda: ivf.build(data, n_probes=1))
    counts = ivf.list_counts.cpu().numpy()
    print(f"PQ path: fit {t_fit:.3f} s, build {t_build:.3f} s {card}; "
          f"{len(counts)} lists, max_tiles {ivf.max_tiles}, list length "
          f"min {counts.min()} / median {int(np.median(counts))} / "
          f"max {counts.max()}")
    results = []
    for table_dtype, p1, gate in POINTS:
        ivf.pq.table_dtype = table_dtype
        run = lambda: ivf.query(queries, k=10, n_probes=1, pass_1=p1,  # noqa
                                mode="bucket", with_stats=True)
        n0 = scan_fold_csr.launches     # the kernel module's own count
        (ids, stats), t_cold = timed(run)
        n1 = scan_fold_csr.launches
        (ids, stats), t_warm = timed(run)
        per_batch = (n1 - n0, scan_fold_csr.launches - n1)
        if per_batch[0] != per_batch[1] or not per_batch[0]:
            raise AssertionError(f"K1 launches per batch {per_batch} at "
                                 f"{table_dtype} p1={p1}")
        if ids.shape != (GLOVE["n_queries"], 10):
            raise AssertionError(f"query returned shape {tuple(ids.shape)}")
        rec = recall_at_10(ids, truth)
        print(f"  {table_dtype} p1={p1}: recall10@10 {rec:.4f}, query "
              f"{t_warm:.4f} s warm ({GLOVE['n_queries'] / t_warm:.0f} "
              f"QPS), {t_cold:.4f} s first {card}; dropped pairs "
              f"{stats['dropped_probe_pairs']}, qc0 "
              f"{stats['queries_per_cluster_cap_round0']}; K1 launches per "
              f"batch {per_batch[1]}")
        if gate is not None and rec < gate:
            raise AssertionError(f"recall {rec:.4f} < {gate} at "
                                 f"{table_dtype} p1={p1}")
        results.append(dict(table_dtype=table_dtype, pass_1=p1, recall=rec,
                            query_s=t_warm, first_query_s=t_cold,
                            k1_launches_per_batch=per_batch[1]))
        stage_profile(f"PQ path {table_dtype} p1={p1}", run, card)
    launches = read_counts("PQ path")["scan_fold_csr"]
    undo()
    peak_gb = torch.cuda.max_memory_allocated() / 2**30
    print(f"  peak device memory {peak_gb:.2f} GiB {card}")
    if launches == 0:
        raise AssertionError("the PQ path did not run on K1")

    print("K1 check, PQ path inputs (each shape's first call):")
    err, calls = 0.0, {}
    for key, (args, kw) in captured.items():
        dtype = key[0]
        got = scan_fold_csr(*args, **kw)
        want = scan_fold_csr_reference(*args, **kw)
        torch_sync()
        bf16 = dtype == torch.bfloat16
        t = args[0]
        e = compare_fold(got, want, bf16, not bf16, t.shape[2] // 16,
                         kw["max_tiles"])
        same = bool(torch.equal(got, want))
        del got, want
        err = max(err, e)
        sc = kw.get("slot_counts")
        occupied = "all" if sc is None else int(sc.clamp(max=t.shape[1]).sum())
        b_ms, b_by = k1_bound(args, kw)
        k_ms, p_ms, four = in_turns(lambda: scan_fold_csr(*args, **kw),
                                    lambda: scan_fold_csr_reference(*args,
                                                                    **kw),
                                    KERNEL_TIMED_LAUNCHES)
        calls[key] = dict(ms=k_ms, plain_ms=p_ms, bound_ms=b_ms,
                          bound_by=b_by, bit_equal=same)
        print(f"  {dtype} tables {tuple(t.shape)}, fold_tiles "
              f"{kw['fold_tiles']}, n_blocks {kw.get('n_blocks')}, "
              f"occupied slots {occupied}: ok (max value error {e}, "
              f"bit-equal {same}); kernel {four[0]:.4f} / {four[1]:.4f} ms, "
              f"plain {four[2]:.4f} / {four[3]:.4f} ms per call, bound "
              f"{b_ms:.4f} ms ({b_by}) {card}")
    summary = {"fit_s": t_fit, "build_s": t_build, "queries": results,
               "peak_gib": peak_gb}
    return summary, launches, err, calls


def best_of(fn, reps: int = 3) -> float:
    """Best host-clock seconds of ``reps`` calls, each ending in a sync."""
    best = float("inf")
    for _ in range(reps):
        _, t = timed(fn)
        best = min(best, t)
    return best


def median_ms(fn, n: int) -> float:
    """Median host-clock milliseconds of n warm calls, each ending in a
    sync."""
    fn()
    return float(np.median([timed(fn)[1] for _ in range(n)])) * 1e3


def stream_of(qd, R: int):
    """bench.py's stream: the queries stacked R times, batch r offset by
    r * 1e-6 (batch 0 is the queries themselves)."""
    import torch
    return qd[None] + (torch.arange(R, dtype=torch.float32, device=qd.device)
                       * 1e-6)[:, None, None]


def hold_captured(label, calls: dict, exact_engine: bool = False) -> float:
    """Each captured K1 call (K2 with ``exact_engine``) of a path against
    the plain version on the same inputs, by the rule of phases 4 and 5:
    int8 tables bit-equal; bf16 tables and K2 values within 1 bf16 ulp,
    positions equal where the values are (K2: or the kept point a near
    tie by the plain version's arithmetic, ``k2_near_ties``). Returns the
    largest value error."""
    import torch
    from tinyknn_tpu_torch.ops import kernels as k
    kernel, plain, name = (
        (k.scan_exact_csr, k.scan_exact_csr_reference, "K2") if exact_engine
        else (k.scan_fold_csr, k.scan_fold_csr_reference, "K1"))
    if not calls:
        raise AssertionError(f"{label}: no {name} call was captured")
    err = 0.0
    for args, kw in calls.values():
        got = kernel(*args, **kw)
        want = plain(*args, **kw)
        torch_sync()
        t = args[0]
        bf16 = exact_engine or t.dtype == torch.bfloat16
        e = compare_fold(got, want, bf16, not bf16,
                         0 if exact_engine else t.shape[2] // 16,
                         kw["max_tiles"],
                         k2_near_ties(args, kw) if exact_engine else None)
        del got, want
        err = max(err, e)
        print(f"  {name} check, {label}: {t.dtype} {tuple(t.shape)}, "
              f"fold_tiles {kw['fold_tiles']}: ok (max value error {e})")
    return err


def stream_point(ivf, qd, truth, p1, card):
    """query_stream at one operating point, P=1: batch 0 against query()
    on the same queries, the floors against query()'s retry, and
    bench.py's sustained rates (marginal between R=2 and R=7), consumed
    on the device and delivered to the host. Only the stream's own calls
    are counted: one K1 launch per batch (P=1 scans round 0 only), and
    its first K1 call is held against the plain version. Returns
    (summary, launches, max value error)."""
    import torch
    import tinyknn_tpu_torch.models.ivf as ivf_module
    kw = dict(k=10, n_probes=1, pass_1=p1)
    # the reference answer, outside the counted window
    ids_q, st_q = ivf.query(qd, mode="bucket", with_stats=True, **kw)
    dev_s, host_s, out = {}, {}, {}
    batches, captured = [0], {}

    def call(stream, **extra):
        batches[0] += stream.shape[0]
        return ivf.query_stream(stream, **kw, **extra)

    label = f"query_stream {ivf.pq.table_dtype} p1={p1}"
    reset_counts()
    undo = capture_first(ivf_module, "scan_fold_csr", captured)
    for R in STREAM_REPS:
        stream = stream_of(qd, R)
        out[R] = call(stream, with_stats=True)
        dev = lambda: int(call(stream, device_out=True)[0].sum())  # noqa
        host = lambda: call(stream).cpu()  # noqa: E731
        dev()
        dev_s[R], host_s[R] = best_of(dev), best_of(host)
    undo()
    launches = read_counts(label)["scan_fold_csr"]
    if launches != batches[0]:
        raise AssertionError(f"{label}: {launches} K1 launches for "
                             f"{batches[0]} batches at P=1")
    err = hold_captured(label, captured)
    ids, st = out[STREAM_REPS[0]]
    lo, hi = STREAM_REPS

    def rate(t):
        marg = (t[hi] - t[lo]) / (hi - lo) if t[hi] > t[lo] else t[hi] / hi
        return GLOVE["n_queries"] / marg

    rec = recall_at_10(ids[0], truth)
    drops = (st["dropped_probe_pairs"], st_q["dropped_probe_pairs"],
             out[hi][1]["dropped_probe_pairs"])
    print(f"  {ivf.pq.table_dtype} p1={p1}: floors (qc0, qc) "
          f"{st['adaptive_qc_floors']}, stream qc0/qc "
          f"{st['queries_per_cluster_cap_round0']}/"
          f"{st['queries_per_cluster_cap']} vs query()'s "
          f"{st_q['queries_per_cluster_cap_round0']}/"
          f"{st_q['queries_per_cluster_cap']} after its retry; dropped "
          f"pairs stream R={lo} {drops[0]}, R={hi} {drops[2]}, query() "
          f"{drops[1]}; batch-0 recall10@10 {rec:.4f}")
    print(f"    best of 3, R={lo} / R={hi}: device_out {dev_s[lo]:.4f} / "
          f"{dev_s[hi]:.4f} s, host {host_s[lo]:.4f} / {host_s[hi]:.4f} s; "
          f"sustained {rate(dev_s):.0f} QPS consumed on the device, "
          f"{rate(host_s):.0f} QPS delivered to the host {card}")
    if any(drops):
        raise AssertionError(f"dropped pairs at p1={p1}: {drops}")
    if not torch.equal(ids[0], ids_q):
        raise AssertionError(f"stream batch 0 differs from query() at "
                             f"p1={p1}")
    return dict(table_dtype=ivf.pq.table_dtype, pass_1=p1,
                floors=list(st["adaptive_qc_floors"]),
                qc0=st["queries_per_cluster_cap_round0"],
                qc=st["queries_per_cluster_cap"],
                query_qc0=st_q["queries_per_cluster_cap_round0"],
                recall=rec, device_s=dev_s, host_s=host_s,
                device_qps=rate(dev_s),
                delivered_qps=rate(host_s)), launches, err


def rescore_rows_check(ivf, qd, card, label, kernel, **kw):
    """Warm bucket batches with rescore_rows off and on: identical ids.
    Off and on are counted in windows of their own; the flag-on calls
    must launch ``kernel`` as often as the flag-off ones (the same
    scans). Returns (summary, flag-on launches)."""
    import torch
    run = lambda: ivf.query(qd, k=10, n_probes=1,  # noqa: E731
                            mode="bucket", **kw)
    reset_counts()
    timed(run)
    off, t_off = timed(run)
    n_off = read_counts(f"rescore_rows off, {label}")[kernel]
    _, t_switch = timed(lambda: ivf.set_rescore_rows(True))
    raw_mb = ivf.csr_raw.numel() * ivf.csr_raw.element_size() / 1e6
    reset_counts()
    timed(run)
    on, t_on = timed(run)
    n_on = read_counts(f"rescore_rows on, {label}")[kernel]
    ivf.set_rescore_rows(False)
    same = torch.equal(on, off)
    print(f"  rescore_rows {label}: ids identical {same}; csr_raw "
          f"{raw_mb:.0f} MB built in {t_switch:.3f} s; warm batch "
          f"{t_off * 1e3:.3f} ms off, {t_on * 1e3:.3f} ms on {card}")
    if not same:
        raise AssertionError(f"rescore_rows changed the ids at {label}")
    if n_on == 0 or n_on != n_off:
        raise AssertionError(f"rescore_rows {label}: {n_on} {kernel} "
                             f"launches on, {n_off} off")
    return dict(label=label, csr_raw_mb=raw_mb, off_ms=t_off * 1e3,
                on_ms=t_on * 1e3), n_on


def gather_recall(ivf, qd, truth, label, **kw):
    """recall10@10 of gather and bucket mode on the first queries, in
    calls of 64; gather may fall at most GATHER_SLACK below bucket.
    Gather runs no kernel; bucket runs K1 or K2."""
    import torch
    n, step = GATHER_RECALL_QUERIES, 64
    rec, launches = {}, {}
    for mode in ("gather", "bucket"):
        reset_counts()
        ids = [ivf.query(qd[i:i + step], k=10, n_probes=1, mode=mode, **kw)
               for i in range(0, n, step)]
        launches[mode] = read_counts(f"{label}, {mode} mode")
        rec[mode] = recall_at_10(torch.cat(ids), truth[:n])
    print(f"  {label}: recall10@10 over {n} queries in calls of {step}: "
          f"gather {rec['gather']:.4f}, bucket {rec['bucket']:.4f}")
    if rec["gather"] < rec["bucket"] - GATHER_SLACK:
        raise AssertionError(f"{label}: gather recall {rec['gather']:.4f} "
                             f"more than {GATHER_SLACK} below bucket's")
    if any(launches["gather"].values()):
        raise AssertionError(f"{label}: gather mode launched a kernel")
    return rec, launches


def serving_path(ivf, data, queries, truth, card, archive):
    """Phase 4b: the serving surface on the phase-4 index (PQ engine,
    build_probes=1): query_stream, device_out under sync-debug,
    rescore_rows, gather against bucket, the 'xla' engine,
    tune_n_probes, a save/load round trip through ``archive`` (kept for
    the sharded path), and Flat."""
    import torch
    from tinyknn_tpu_torch import Flat, load_ivf, save_ivf
    from tinyknn_tpu_torch.models.ivf import tune_n_probes
    import tinyknn_tpu_torch.models.ivf as ivf_module
    qd = torch.as_tensor(queries, device=ivf.device)
    out, launches, err = {}, {}, 0.0

    print("serving path, query_stream (P=1):")
    out["stream"], launches["stream"] = [], 0
    for table_dtype, p1 in STREAM_POINTS:
        ivf.pq.table_dtype = table_dtype
        summary, n, e = stream_point(ivf, qd, truth, p1, card)
        out["stream"].append(summary)
        launches["stream"] += n
        err = max(err, e)

    # a warm device_out call, floors cached: no host sync may happen
    p1 = STREAM_POINTS[-1][1]
    stream = stream_of(qd, STREAM_REPS[0])
    reset_counts()
    torch.cuda.set_sync_debug_mode("error")
    try:
        ids, dropped = ivf.query_stream(stream, k=10, n_probes=1, pass_1=p1,
                                        device_out=True)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    launches["device_out"] = read_counts("device_out")["scan_fold_csr"]
    if ids.device.type != ivf.device.type or ids.dtype != torch.int32:
        raise AssertionError(f"device_out gave {ids.dtype} on {ids.device}")
    if launches["device_out"] != STREAM_REPS[0]:
        raise AssertionError(f"device_out: {launches['device_out']} K1 "
                             f"launches for {STREAM_REPS[0]} batches")
    print(f"  device_out under set_sync_debug_mode('error'): no sync; "
          f"{tuple(ids.shape)} int32 on {ids.device}, dropped {int(dropped)}")

    print("serving path, rescore_rows:")
    out["rescore_rows"], launches["rescore_rows"] = [], 0
    for table_dtype, p1, _ in POINTS:
        ivf.pq.table_dtype = table_dtype
        summary, n = rescore_rows_check(ivf, qd, card,
                                        f"{table_dtype} p1={p1}",
                                        "scan_fold_csr", pass_1=p1)
        out["rescore_rows"].append(summary)
        launches["rescore_rows"] += n

    print("serving path, gather against bucket (int8 p1=84, P=1):")
    ivf.pq.table_dtype, p1 = "int8", 84
    times = {}
    for Q in GATHER_QS:
        for mode in ("gather", "bucket"):
            times[Q, mode] = median_ms(lambda: ivf.query(
                qd[:Q], k=10, n_probes=1, pass_1=p1, mode=mode),
                GATHER_TIMED_CALLS)
        faster = min(("gather", "bucket"), key=lambda m: times[Q, m])
        print(f"  Q={Q}: gather {times[Q, 'gather']:.3f} ms, bucket "
              f"{times[Q, 'bucket']:.3f} ms (median of "
              f"{GATHER_TIMED_CALLS}); {faster} faster {card}")
    rec, gl = gather_recall(ivf, qd, truth, "PQ gather", pass_1=p1)
    launches["gather_bucket"] = gl["bucket"]["scan_fold_csr"]
    if launches["gather_bucket"] == 0:
        raise AssertionError("bucket mode did not run on K1")
    out["gather"] = dict(ms={f"{Q}/{m}": t for (Q, m), t in times.items()},
                         recall=rec)

    print("serving path, scan_impl='xla' (int8 p1=84):")
    ivf.set_scan_impl("xla")
    reset_counts()
    run = lambda: ivf.query(qd, k=10, n_probes=1, pass_1=p1,  # noqa: E731
                            mode="bucket", with_stats=True)
    timed(run)
    (ids, st), t_xla = timed(run)
    xla = read_counts("'xla' engine")
    ivf.set_scan_impl("auto")
    rec = recall_at_10(ids, truth)
    _, t_fused = timed(lambda: ivf.query(qd, k=10, n_probes=1, pass_1=p1,
                                         mode="bucket"))
    print(f"  recall10@10 {rec:.4f}; warm batch {t_xla * 1e3:.3f} ms "
          f"('fused' {t_fused * 1e3:.3f} ms) {card}; dropped pairs "
          f"{st['dropped_probe_pairs']}, qc0 "
          f"{st['queries_per_cluster_cap_round0']}")
    if rec < XLA_GATE:
        raise AssertionError(f"'xla' recall {rec:.4f} < {XLA_GATE}")
    if any(xla.values()):
        raise AssertionError("the 'xla' engine launched a kernel")
    out["xla"] = dict(recall=rec, ms=t_xla * 1e3, fused_ms=t_fused * 1e3)

    n_tune = TUNE_QUERIES
    print(f"serving path, tune_n_probes ({n_tune} queries, k=10, target "
          f"{TUNE_TARGET}):")
    # every distinct K1 shape the tuner gives (round 0 at each capacity,
    # and the tail round of its P > 1 points) is held against the plain
    # version; the tail round's slot count is _query_params' qc at P=2
    tune_calls = {}
    reset_counts()
    undo = capture_first(ivf_module, "scan_fold_csr", tune_calls, by_shape)
    res, t_tune = timed(lambda: tune_n_probes(ivf, qd[:n_tune],
                                              truth[:n_tune], k=10,
                                              target_recall=TUNE_TARGET))
    undo()
    launches["tune"] = read_counts("tune_n_probes")["scan_fold_csr"]
    print(f"  {res.n_probes=} {res.pass_1=} {res.recall=:.4f} in "
          f"{t_tune:.2f} s; measured {res.recalls}")
    if res.recall < TUNE_TARGET:
        raise AssertionError(f"tune_n_probes recall {res.recall} < "
                             f"{TUNE_TARGET}")
    rounds = sum(1 if P == 1 else 2 for P, _ in res.recalls)
    if launches["tune"] < rounds:
        raise AssertionError(f"tune_n_probes: {launches['tune']} K1 "
                             f"launches for {rounds} scan rounds")
    if max(P for P, _ in res.recalls) > 1:
        qc_tail = ivf_module._query_params(ivf, n_tune, 10, 2, None)[5]
        if not any(key[1][1] == qc_tail for key in tune_calls):
            raise AssertionError(f"tune_n_probes: no tail-round K1 call "
                                 f"({qc_tail} slots) was captured")
    err = max(err, hold_captured("tune_n_probes", tune_calls))
    out["tune"] = dict(n_probes=res.n_probes, pass_1=res.pass_1,
                       recall=res.recall, seconds=t_tune)

    print("serving path, save_ivf -> load_ivf:")
    q1k = qd[:TUNE_QUERIES]
    reset_counts()
    want = ivf.query(q1k, k=10, n_probes=1, pass_1=p1)
    n_want = read_counts("round trip, original index")["scan_fold_csr"]
    _, t_save = timed(lambda: save_ivf(archive, ivf))
    size_mb = archive.stat().st_size / 1e6
    back, t_load = timed(lambda: load_ivf(archive, ivf.device))
    reset_counts()
    got = back.query(q1k, k=10, n_probes=1, pass_1=p1)
    launches["round_trip"] = read_counts(
        "round trip, loaded index")["scan_fold_csr"]
    del back
    same = torch.equal(got, want)
    print(f"  archive {size_mb:.1f} MB, save {t_save:.2f} s, load "
          f"{t_load:.2f} s {card}; ids on {TUNE_QUERIES} queries identical "
          f"{same}")
    if not same:
        raise AssertionError("the round trip changed the ids")
    if launches["round_trip"] == 0 or launches["round_trip"] != n_want:
        raise AssertionError(f"round trip: {launches['round_trip']} K1 "
                             f"launches on the loaded index, {n_want} on "
                             f"the original")
    out["round_trip"] = dict(mb=size_mb, save_s=t_save, load_s=t_load)

    print("serving path, Flat('angular'):")
    reset_counts()
    flat = Flat("angular", device=ivf.device).build(data)
    ids, t_flat = timed(lambda: flat.query(qd, k=10))
    del flat
    read_counts("Flat")
    rec = recall_at_10(ids, truth)
    print(f"  recall10@10 {rec:.4f} against the f64 truth; "
          f"{GLOVE['n_queries']} queries in {t_flat:.3f} s {card}")
    if rec < FLAT_GATE:
        raise AssertionError(f"Flat recall {rec:.4f} < {FLAT_GATE}")
    out["flat"] = dict(recall=rec, seconds=t_flat)
    ivf.pq.table_dtype = "int8"
    return out, launches, err


def exact_query(ivf, queries, truth, P: int, card: str, label: str):
    run = lambda: ivf.query(queries, k=10, n_probes=P, mode="bucket",  # noqa
                            with_stats=True)
    (ids, stats), t_cold = timed(run)
    (ids, stats), t_warm = timed(run)
    if ids.shape != (GLOVE["n_queries"], 10):
        raise AssertionError(f"query returned shape {tuple(ids.shape)}")
    rec = recall_at_10(ids, truth)
    print(f"  {label} P={P}: recall10@10 {rec:.4f}, query {t_warm:.4f} s "
          f"warm ({GLOVE['n_queries'] / t_warm:.0f} QPS), {t_cold:.4f} s "
          f"first {card}; dropped pairs {stats['dropped_probe_pairs']}, "
          f"qc0 {stats['queries_per_cluster_cap_round0']}, qc "
          f"{stats['queries_per_cluster_cap']}, pass_1 {stats['pass_1']}, "
          f"(r, r_tail) {stats['per_pair_candidates']}")
    stage_profile(f"exact path {label} P={P}", run, card)
    return dict(label=label, n_probes=P, recall=rec, query_s=t_warm,
                first_query_s=t_cold,
                dropped=stats["dropped_probe_pairs"],
                qc0=stats["queries_per_cluster_cap_round0"])


def exact_path(ivf, data, queries, truth, card):
    """Phase 5: the exact engine through K2, build_probes 1 and 2. Each
    K2 shape of the build_probes=1 query (round 0 at 32 slots and the
    retry at 128) is held against the plain version with the batch's
    own slot counts, timed, and given its bound."""
    import torch
    import tinyknn_tpu_torch.models.ivf as ivf_module
    from tinyknn_tpu_torch.ops.kernels import (
        scan_exact_csr, scan_exact_csr_reference)
    g1, g2, slack = EXACT_GATES
    captured = {}                       # first K2 call of each shape
    undo = capture_first(ivf_module, "scan_exact_csr", captured, by_shape)
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    _, t_switch = timed(lambda: ivf.set_scan_impl("exact"))
    vecs = ivf.csr_vecs
    print(f"exact path: set_scan_impl('exact') {t_switch:.3f} s {card}; "
          f"csr_vecs {tuple(vecs.shape)} "
          f"({vecs.numel() * vecs.element_size() / 1e6:.0f} MB)")
    bp1 = exact_query(ivf, queries, truth, 1, card, "build_probes=1")
    launches = read_counts("exact path, build_probes=1")["scan_exact_csr"]
    undo()
    if bp1["recall"] < g1:
        raise AssertionError(f"exact recall {bp1['recall']:.4f} < {g1}")
    if launches == 0:
        raise AssertionError("the exact path did not run on K2")

    # phase 5b: the serving surface on the exact engine
    qd = torch.as_tensor(queries, device=ivf.device)
    serving, serving_launches = {}, {}
    stream_calls = {}
    stream = stream_of(qd, STREAM_REPS[0])
    run = lambda: ivf.query_stream(stream, k=10, n_probes=1,  # noqa: E731
                                   with_stats=True)
    reset_counts()
    undo = capture_first(ivf_module, "scan_exact_csr", stream_calls)
    timed(run)
    (ids, st), t_stream = timed(run)
    undo()
    serving_launches["stream"] = read_counts(
        "exact path, query_stream")["scan_exact_csr"]
    # two calls of R batches, one K2 launch per batch at P=1
    if serving_launches["stream"] != 2 * STREAM_REPS[0]:
        raise AssertionError(f"the exact stream made "
                             f"{serving_launches['stream']} K2 launches "
                             f"for {2 * STREAM_REPS[0]} batches")
    e_stream = hold_captured("exact query_stream", stream_calls, True)
    rec = recall_at_10(ids[0], truth)
    print(f"  query_stream R={STREAM_REPS[0]}, P=1: batch-0 recall10@10 "
          f"{rec:.4f}, batch 1 {recall_at_10(ids[1], truth):.4f}; warm "
          f"{t_stream:.4f} s {card}; floors {st['adaptive_qc_floors']}, "
          f"qc0 {st['queries_per_cluster_cap_round0']}, dropped pairs "
          f"{st['dropped_probe_pairs']}")
    if rec < g1:
        raise AssertionError(f"exact stream recall {rec:.4f} < {g1}")
    serving["stream"] = dict(recall=rec, seconds=t_stream,
                             floors=list(st["adaptive_qc_floors"]))
    # a warm device_out call, floors cached: K2's slot counts are
    # counted on the device, so no host sync may happen
    reset_counts()
    torch.cuda.set_sync_debug_mode("error")
    try:
        ivf.query_stream(stream, k=10, n_probes=1, device_out=True)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    serving_launches["device_out"] = read_counts(
        "exact path, device_out")["scan_exact_csr"]
    if serving_launches["device_out"] != STREAM_REPS[0]:
        raise AssertionError(f"exact device_out: "
                             f"{serving_launches['device_out']} K2 launches "
                             f"for {STREAM_REPS[0]} batches")
    print("  device_out under set_sync_debug_mode('error'): no sync")
    summary, serving_launches["rescore_rows"] = rescore_rows_check(
        ivf, qd, card, "exact, build_probes=1 P=1", "scan_exact_csr")
    serving["rescore_rows"] = [summary]
    serving["gather"], gl = gather_recall(ivf, qd, truth, "exact gather")
    serving_launches["gather_bucket"] = gl["bucket"]["scan_exact_csr"]
    if not serving_launches["gather_bucket"]:
        raise AssertionError("exact bucket mode did not run on K2")

    reset_counts()
    _, t_build = timed(lambda: ivf.build(data, n_probes=2))
    counts = ivf.list_counts.cpu().numpy()
    print(f"  rebuilt with build_probes=2: {t_build:.3f} s {card}; "
          f"max_tiles {ivf.max_tiles}, list length max {counts.max()}")
    bp2 = [exact_query(ivf, queries, truth, P, card, "build_probes=2")
           for P in (1, 2)]
    launches2 = read_counts("exact path, build_probes=2")["scan_exact_csr"]
    peak_gb = torch.cuda.max_memory_allocated() / 2**30
    print(f"  peak device memory {peak_gb:.2f} GiB {card}")
    if bp2[0]["recall"] < g2:
        raise AssertionError(f"build_probes=2 P=1 recall "
                             f"{bp2[0]['recall']:.4f} < {g2}")
    if bp2[1]["recall"] < bp2[0]["recall"] - slack:
        raise AssertionError(f"build_probes=2 P=2 recall "
                             f"{bp2[1]['recall']:.4f} more than {slack} "
                             f"below P=1")
    if launches2 == 0:
        raise AssertionError("the build_probes=2 exact path did not run K2")
    summary, serving_launches["rescore_rows_bp2"] = rescore_rows_check(
        ivf, qd, card, "exact, build_probes=2 P=1", "scan_exact_csr")
    serving["rescore_rows"].append(summary)

    print("K2 check, exact path inputs (each shape's first call):")
    err, calls = e_stream, {}
    for key, (args, kw) in captured.items():
        got = scan_exact_csr(*args, **kw)
        want = scan_exact_csr_reference(*args, **kw)
        torch_sync()
        e = compare_fold(got, want, True, False, 0, kw["max_tiles"])
        same = bool(torch.equal(got, want))
        del got, want
        err = max(err, e)
        occupied = int(kw["slot_counts"].clamp(max=args[0].shape[1]).sum())
        b_ms, b_by = k2_bound(args, kw)
        k_ms, p_ms, four = in_turns(lambda: scan_exact_csr(*args, **kw),
                                    lambda: scan_exact_csr_reference(*args,
                                                                     **kw),
                                    KERNEL_TIMED_LAUNCHES)
        calls[key] = dict(ms=k_ms, plain_ms=p_ms, bound_ms=b_ms,
                          bound_by=b_by, bit_equal=same,
                          shape=f"q_sel {tuple(args[0].shape)}, fold_tiles "
                                f"{kw['fold_tiles']}, {occupied} occupied "
                                f"slots")
        print(f"  q_sel {tuple(args[0].shape)}, fold_tiles "
              f"{kw['fold_tiles']}, occupied slots {occupied}: ok (max value "
              f"error {e}, bit-equal {same}); kernel {four[0]:.4f} / "
              f"{four[1]:.4f} ms, plain {four[2]:.4f} / {four[3]:.4f} ms per "
              f"call, bound {b_ms:.4f} ms ({b_by}) {card}")
    summary = {"set_scan_impl_s": t_switch, "build_bp2_s": t_build,
               "queries": [bp1] + bp2, "peak_gib": peak_gb,
               "serving": serving}
    return summary, launches, err, calls, serving_launches


def true_nn_ranks(est, truth):
    """Mid-rank of each query's true nearest neighbour among the
    estimates (bench.py's rank)."""
    import torch
    tru = torch.gather(est, 1, truth[:, None])
    less = (est < tru).sum(1)
    ties = (est == tru).sum(1) - 1
    return (less + ties // 2).cpu().numpy()


def over_plain(module, name: str, plain, fn):
    """fn() with ``module.<name>`` swapped for its plain version."""
    kernel = getattr(module, name)
    setattr(module, name, plain)
    try:
        return fn()
    finally:
        setattr(module, name, kernel)


def time_wrappers(codes, tables, true_n: int, rescore: int, n_kernel: int,
                  n_plain: int, card: str) -> dict:
    """The two wrappers, ``estimate_scan`` (K3) and ``fold_topk_tiled``
    (K1), against the same wrappers over the plain kernel: equal outputs,
    one kernel launch per kernel-arm call and none in the plain arm, then
    times in turns. Returns {wrapper: (kernel ms, plain ms)}."""
    import torch
    import tinyknn_tpu_torch.ops.kernels as km
    import tinyknn_tpu_torch.ops.scan as sm
    tiled = km.tile_codes(codes)
    est = lambda: sm.estimate_scan(codes, tables, packed=True)  # noqa: E731
    fold = lambda: km.fold_topk_tiled(tiled, tables, true_n,  # noqa: E731
                                      rescore)
    arms = (("estimate_scan", est, sm, "estimate_scan_tiled",
             km.estimate_scan_tiled, km.estimate_scan_tiled_reference),
            ("fold_topk_tiled", fold, km, "scan_fold_csr", km.scan_fold_csr,
             km.scan_fold_csr_reference))
    out = {}
    for wname, run, module, kname, kernel, plain in arms:
        plain_run = lambda: over_plain(module, kname, plain, run)  # noqa
        before = kernel.launches
        got, want = run(), plain_run()
        torch_sync()
        got = got if isinstance(got, tuple) else (got,)
        want = want if isinstance(want, tuple) else (want,)
        if not all(torch.equal(a, b) for a, b in zip(got, want)):
            raise AssertionError(f"{wname} over K differs from {wname} over "
                                 f"the plain version")
        del got, want
        k_ms, p_ms, four = in_turns(run, plain_run, n_kernel, n_plain)
        launched = kernel.launches - before
        if launched != 2 * n_kernel + 2:
            raise AssertionError(f"{wname}: {launched} {kname} launches in "
                                 f"the timing, expected {2 * n_kernel + 2}")
        out[wname] = (k_ms, p_ms)
        print(f"  wrapper {wname}: output equal to the plain swap; kernel "
              f"{four[0]:.4f} / {four[1]:.4f} ms, plain {four[2]:.4f} / "
              f"{four[3]:.4f} ms per call {card}")
    return out


def full_scan_path(device, card):
    """Phase 6: FastPQ's full scan on the reference's example."""
    import torch
    import tinyknn_tpu_torch.ops.kernels as kernels_module
    import tinyknn_tpu_torch.ops.scan as scan_module
    from tinyknn_tpu_torch import FastPQ, knn_brute
    from tinyknn_tpu_torch.ops.kernels import (
        estimate_scan_tiled, estimate_scan_tiled_reference, scan_fold_csr,
        scan_fold_csr_reference)
    med_gate, q90_gate, rec_gate = FULL_SCAN_GATES
    np.random.seed(FULL_SCAN["seed"])
    X = np.random.randn(FULL_SCAN["n"], FULL_SCAN["d"]).astype(np.float32)
    qs = np.random.randn(FULL_SCAN["n_queries"],
                         FULL_SCAN["d"]).astype(np.float32)
    Xd, qd = torch.as_tensor(X, device=device), torch.as_tensor(qs,
                                                               device=device)
    truth = knn_brute(qd, Xd, k=1)[:, 0]
    # the wraps go on after the reset: the counts live on the wrappers
    reset_counts()
    k3_calls = {}
    undo = capture_first(scan_module, "estimate_scan_tiled", k3_calls)
    pq = FastPQ(2, rotate_dim=None, device=device)
    data, t_fit = timed(lambda: pq.fit_transform(Xd))
    est, t_est = timed(lambda: pq.distance_table(qd).estimate_distances(data))
    ranks = true_nn_ranks(est, truth)
    med, q90 = float(np.median(ranks)), float(np.quantile(ranks, 0.9))
    ids, t_search = timed(lambda: pq.search(qd, data, Xd, k=10))
    _, t_search = timed(lambda: pq.search(qd, data, Xd, k=10))
    rec = float((ids == truth[:, None]).any(1).float().mean())
    stage_profile("full scan, search 'exact'",
                  lambda: pq.search(qd, data, Xd, k=10), card, reps=5)
    undo()
    print(f"full-scan path: fit+transform {t_fit:.3f} s; true-NN rank "
          f"median {med} / q90 {q90} (JAX on the CPU 2.0 / 19.0); "
          f"search recall1@10 {rec:.4f} (JAX 0.943); tables+estimate "
          f"{t_est * 1e3:.3f} ms first, search {t_search * 1e3:.3f} ms warm "
          f"{card}")
    launches = read_counts("full-scan path, method='exact'")
    if med > med_gate or q90 > q90_gate:
        raise AssertionError(f"true-NN rank {med} / {q90} above the gates "
                             f"{med_gate} / {q90_gate}")
    if rec < rec_gate:
        raise AssertionError(f"search recall1@10 {rec:.4f} < {rec_gate}")
    if launches["estimate_scan_tiled"] == 0:
        raise AssertionError("the full-scan path did not run on K3")

    reset_counts()
    k1_calls = {}
    undo = capture_first(kernels_module, "scan_fold_csr", k1_calls)
    ids_a, t_a = timed(lambda: pq.search(qd, data, Xd, k=10,
                                         method="approx"))
    _, t_a = timed(lambda: pq.search(qd, data, Xd, k=10, method="approx"))
    stage_profile("full scan, search 'approx'",
                  lambda: pq.search(qd, data, Xd, k=10, method="approx"),
                  card, reps=5)
    undo()
    rec_a = float((ids_a == truth[:, None]).any(1).float().mean())
    print(f"  method='approx' (K1 via fold_topk_tiled): recall1@10 "
          f"{rec_a:.4f}, search {t_a * 1e3:.3f} ms warm {card}")
    approx = read_counts("full-scan path, method='approx'")
    if rec_a < rec_gate:
        raise AssertionError(f"approx search recall1@10 {rec_a:.4f} < "
                             f"{rec_gate}")
    if approx["scan_fold_csr"] == 0:
        raise AssertionError("the approx route did not run on K1")

    print("K3 and K1 checks, full-scan path inputs:")
    (args, kw), = k3_calls.values()
    got = estimate_scan_tiled(*args, **kw)
    e3 = compare_estimates(got, estimate_scan_tiled_reference(*args, **kw),
                           False)
    k3 = in_turns(lambda: estimate_scan_tiled(*args, **kw),
                  lambda: estimate_scan_tiled_reference(*args, **kw),
                  KERNEL_TIMED_LAUNCHES)
    b3 = k3_bound(*args)
    lib3 = k3_library(*args, got, KERNEL_TIMED_LAUNCHES)
    print(f"  K3 codes {tuple(args[0].shape)}, tables {tuple(args[1].shape)}"
          f": bit-equal; kernel {k3[2][0]:.4f} / {k3[2][1]:.4f} ms, plain "
          f"{k3[2][2]:.4f} / {k3[2][3]:.4f} ms per call, bound {b3[0]:.4f} "
          f"ms ({b3[1]}); {lib3[1]} {lib3[0]:.4f} ms (equal to K3's output "
          f"{lib3[2]}) {card}")
    (args, kw), = k1_calls.values()
    got = scan_fold_csr(*args, **kw)
    e1 = compare_fold(got, scan_fold_csr_reference(*args, **kw), False, True,
                      args[0].shape[2] // 16, kw["max_tiles"])
    k1 = in_turns(lambda: scan_fold_csr(*args, **kw),
                  lambda: scan_fold_csr_reference(*args, **kw),
                  KERNEL_TIMED_LAUNCHES)
    b1 = k1_bound(args, kw)
    print(f"  K1 tables {tuple(args[0].shape)}, fold_tiles "
          f"{kw['fold_tiles']}, max_tiles {kw['max_tiles']}, n_blocks "
          f"{kw.get('n_blocks')}: bit-equal; kernel {k1[2][0]:.4f} / "
          f"{k1[2][1]:.4f} ms, plain {k1[2][2]:.4f} / {k1[2][3]:.4f} ms per "
          f"call, bound {b1[0]:.4f} ms ({b1[1]}) {card}")
    del got
    wrappers = time_wrappers(data.packed, pq.distance_table(qd).tables,
                             data.size, 30, 20, PLAIN_TIMED_LAUNCHES, card)
    summary = {"rank_median": med, "rank_q90": q90, "recall1_at_10": rec,
               "search_ms": t_search * 1e3, "approx_recall1_at_10": rec_a,
               "approx_search_ms": t_a * 1e3, "wrappers_ms": wrappers}
    return (summary, launches["estimate_scan_tiled"], approx["scan_fold_csr"],
            (e1, k1[:2] + b1), (e3, k3[:2] + b3 + lib3[:1]))


def k3_real_size(ivf, queries, truth, card):
    """Phase 7: K3 on the GloVe corpus's codes with 1,000 queries."""
    import torch
    from tinyknn_tpu_torch.ops.kernels import (
        estimate_scan_tiled, estimate_scan_tiled_reference, tile_codes)
    from tinyknn_tpu_torch.ops.scan import estimate_scan
    from tinyknn_tpu_torch.ops.topk import smallest_k
    ivf.pq.table_dtype = "int8"
    qn = torch.nn.functional.normalize(
        torch.as_tensor(queries[:K3_QUERIES], device=ivf.device), dim=1)
    codes = ivf.pq.transform(ivf.data)
    codes_tiled = tile_codes(codes.packed)
    tables = ivf.pq.distance_table(qn).tables
    got = estimate_scan_tiled(codes_tiled, tables)
    want = estimate_scan_tiled_reference(codes_tiled, tables)
    torch_sync()
    same = torch.equal(got, want)
    err = float((got - want).abs().max())
    print(f"K3 at real size: codes {tuple(codes_tiled.shape)}, tables "
          f"{tuple(tables.shape)} -> {tuple(got.shape)}: bit-equal {same} "
          f"(max error {err})")
    if not same:
        raise AssertionError("K3 disagrees with its plain version")
    del want
    lib_ms, lib_call, lib_same = k3_library(codes_tiled, tables, got,
                                            K3_TIMED_LAUNCHES)
    del got
    k_ms, p_ms, four = in_turns(
        lambda: estimate_scan_tiled(codes_tiled, tables),
        lambda: estimate_scan_tiled_reference(codes_tiled, tables),
        K3_TIMED_LAUNCHES)
    b_ms, b_by = k3_bound(codes_tiled, tables)
    T = codes_tiled.shape[0]
    ops = 2 * 16 * tables.shape[1] * K3_QUERIES * T * 128
    print(f"  times: kernel {four[0]:.3f} / {four[1]:.3f} ms, plain "
          f"{four[2]:.3f} / {four[3]:.3f} ms per call, bound {b_ms:.3f} ms "
          f"({b_by}) {card}; {ops / (k_ms * 1e-3):.3e} one-hot ops/s; "
          f"library {lib_call}: {lib_ms:.3f} ms (equal to K3's output "
          f"{lib_same})")
    wrappers = time_wrappers(codes.packed, tables, codes.size, 30,
                             K3_TIMED_LAUNCHES, 1, card)
    run = lambda: ivf.pq.search(qn, codes, ivf.data, k=10)  # noqa: E731
    timed(run)
    ids, t_search = timed(run)
    rec = recall_at_10(ids, truth[:K3_QUERIES])
    est = estimate_scan(codes.packed, tables, packed=True)
    sort_ms = event_ms(lambda: smallest_k(est, 30), 2)
    del est
    print(f"  FastPQ.search of {K3_QUERIES} queries over the corpus: "
          f"{t_search * 1e3:.3f} ms warm {card}; recall10@10 {rec:.4f}; "
          f"its pass-1 pick (stable sort of the {K3_QUERIES} x "
          f"{codes.packed.shape[0]} estimates) {sort_ms:.3f} ms")
    run_a = lambda: ivf.pq.search(qn, codes, ivf.data, k=10,  # noqa: E731
                                  method="approx")
    timed(run_a)
    ids_a, t_a = timed(run_a)
    rec_a = recall_at_10(ids_a, truth[:K3_QUERIES])
    print(f"  the same with method='approx': {t_a * 1e3:.3f} ms warm "
          f"{card}; recall10@10 {rec_a:.4f}")
    return err, (k_ms, p_ms, b_ms, b_by, lib_ms, lib_call), {
        "search_ms": t_search * 1e3, "recall10_at_10": rec,
        "pass1_sort_ms": sort_ms, "approx_search_ms": t_a * 1e3,
        "approx_recall10_at_10": rec_a, "wrappers_ms": wrappers}


def counted(sivf, kernel: str, rounds: int, label: str, fn):
    """fn() on a sharded index with the launch counts reset: ``kernel``
    must launch exactly once per mesh position, scan round and batch
    the index sent over the mesh (an attempt of ``query()``'s retries, a
    batch of a stream), and no plain version may run. Returns (fn's
    result, launches, batches over the mesh)."""
    sent = [0]
    over_mesh = sivf._mesh_query

    def counting(*args, **kw):
        sent[0] += 1
        return over_mesh(*args, **kw)

    sivf._mesh_query = counting
    reset_counts()
    try:
        out = fn()
    finally:
        del sivf._mesh_query            # back to the class's method
    n = read_counts(label)[kernel]
    positions = sum(len(row) for row in sivf._grid)
    if n == 0 or n != positions * rounds * sent[0]:
        raise AssertionError(
            f"{label}: {n} {kernel} launches for {positions} mesh positions "
            f"x {rounds} rounds x {sent[0]} batches over the mesh")
    return out, n, sent[0]


def time_captured(name: str, call, card: str) -> dict:
    """One captured K1 or K2 call (``name``: the wrapper's) timed in turns
    against its plain version, with its bound over the occupied slots."""
    from tinyknn_tpu_torch.ops import kernels as k
    args, kw = call
    kernel, plain, bound = {
        "scan_fold_csr": (k.scan_fold_csr, k.scan_fold_csr_reference,
                          k1_bound),
        "scan_exact_csr": (k.scan_exact_csr, k.scan_exact_csr_reference,
                           k2_bound)}[name]
    b_ms, b_by = bound(args, kw)
    k_ms, p_ms, four = in_turns(lambda: kernel(*args, **kw),
                                lambda: plain(*args, **kw),
                                KERNEL_TIMED_LAUNCHES)
    t = args[0]
    occupied = int(kw["slot_counts"].clamp(max=t.shape[1]).sum())
    shape = (f"{str(t.dtype).replace('torch.', '')} {tuple(t.shape)}, "
             f"fold_tiles {kw['fold_tiles']}, {occupied} occupied slots, "
             f"{int((kw['slot_counts'] == 0).sum())} of {t.shape[0]} lists "
             f"with none")
    print(f"  {name} of one shard, {shape}: kernel {four[0]:.4f} / "
          f"{four[1]:.4f} ms, plain {four[2]:.4f} / {four[3]:.4f} ms per "
          f"call, bound {b_ms:.4f} ms ({b_by}) {card}")
    return dict(ms=k_ms, plain_ms=p_ms, bound_ms=b_ms, bound_by=b_by,
                shape=shape)


def identical_rows(a, b) -> float:
    """Share of queries whose id rows are equal."""
    return float((a == b).all(dim=1).float().mean())


def sharded_path(ivf, archive, archive_bp2, queries, truth, exact_recall,
                 card):
    """Phase 8: the sharded indexes on logical shards of the one card.
    ``ivf``: the phase-5 index (its quantizer, data and centers serve
    ShardedFastPQ and lloyd_step_dp); ``archive``: the phase-4 index
    (PQ engine, build_probes=1); ``archive_bp2``: the build_probes=2
    exact index; ``exact_recall``: its single-device recall at P=2.
    Returns (summary, {kernel: launches}, {kernel: max value error},
    {kernel: timed first call of a shard})."""
    import torch
    import tinyknn_tpu_torch.models.ivf as ivf_module
    import tinyknn_tpu_torch.ops.scan as scan_module
    from tinyknn_tpu_torch import (
        load_ivf, load_sharded_ivf, save_ivf, sharded_ivf_from_state)
    from tinyknn_tpu_torch.ops.kernels import (
        estimate_scan_tiled, estimate_scan_tiled_reference)
    from tinyknn_tpu_torch.parallel import (
        ShardedFastPQ, lloyd_step_dp, make_mesh, make_mesh_2d)
    t_start = time.perf_counter()
    dev = ivf.device
    qd = torch.as_tensor(queries, device=dev)
    note = "logical shards run in turn on one card"
    meshes = {"S=1": (make_mesh(devices=[dev]), None),
              "S=4": (make_mesh(devices=[dev] * 4), None),
              "2x2": (make_mesh_2d((2, 2), devices=[dev] * 4), "queries"),
              "S=2": (make_mesh(devices=[dev] * 2), None)}
    launches = {"scan_fold_csr": 0, "scan_exact_csr": 0,
                "estimate_scan_tiled": 0}
    err = dict.fromkeys(launches, 0.0)
    timed_calls, summary = {}, {"note": note, "points": [], "laps": {}}
    lap_start = [t_start]

    def lap(name):
        now = time.perf_counter()
        summary["laps"][name] = now - lap_start[0]
        print(f"  [{name}: {now - lap_start[0]:.1f} s]")
        lap_start[0] = now

    # -- the single-device answers to hold the shards against
    single, t_load = timed(lambda: load_ivf(archive, dev))
    single.set_rescore_rows(True)
    ref = {}
    for table_dtype, p1, gate in POINTS[:2]:
        single.pq.table_dtype = table_dtype
        run = lambda: single.query(qd, k=10, n_probes=1,  # noqa: E731
                                   pass_1=p1, mode="bucket")
        ids = run()
        ref[table_dtype] = dict(ids=ids, recall=recall_at_10(ids, truth),
                                seconds=best_of(run), pass_1=p1, gate=gate)
    del single
    print(f"sharded path ({note}): single-device index loaded in "
          f"{t_load:.2f} s; its recall10@10 / best-of-3 batch: " + ", ".join(
              f"{name} p1={r['pass_1']} {r['recall']:.4f} / "
              f"{r['seconds'] * 1e3:.2f} ms" for name, r in ref.items())
          + f" {card}")

    # -- ShardedIVF.query on the PQ engine, mesh by mesh
    with np.load(archive) as z:
        state = {key: z[key] for key in z.files}
    ids_of, s4 = {}, None
    for label, (mesh, query_axis) in meshes.items():
        captured = {}                   # this mesh's first K1 call per shape
        if label == "S=4":              # the archive path, once
            sivf, t_place = timed(lambda: load_sharded_ivf(archive,
                                                           mesh=mesh))
        else:
            sivf, t_place = timed(lambda: sharded_ivf_from_state(
                state, mesh, query_axis=query_axis))
        starts, stops, Cl, C = sivf._shard_meta
        print(f"  {label}: placed in {t_place:.2f} s; {Cl} lists a shard "
              f"({Cl * len(starts) - C} pad), {sivf._shard_tiles} tiles a "
              f"shard, shard tiles {(stops - starts).tolist()}")
        for table_dtype, r in ref.items():
            if label == "S=2" and table_dtype != "int8":
                continue
            sivf.pq.table_dtype = table_dtype
            run = lambda: sivf.query(qd, k=10, n_probes=1,  # noqa: E731
                                     pass_1=r["pass_1"], with_stats=True)
            name = f"sharded {label} {table_dtype} p1={r['pass_1']}"
            undo = capture_first(ivf_module, "scan_fold_csr", captured,
                                 by_shape)
            (ids, st), n, attempts = counted(sivf, "scan_fold_csr", 1, name,
                                             run)
            undo()
            launches["scan_fold_csr"] += n
            rec = recall_at_10(ids, truth)
            t_batch = best_of(run)
            ids_of[label, table_dtype] = ids
            print(f"  {name}: recall10@10 {rec:.4f} (single-device "
                  f"{r['recall']:.4f}), dropped pairs "
                  f"{st['dropped_probe_pairs']}, qc0 "
                  f"{st['queries_per_cluster_cap_round0']}, {attempts} "
                  f"attempts, {n} K1 launches; batch {t_batch * 1e3:.2f} ms "
                  f"best of 3 (single-device {r['seconds'] * 1e3:.2f} ms; "
                  f"{note}) {card}")
            if rec < r["recall"] - SHARDED_SLACK or rec < r["gate"]:
                raise AssertionError(f"{name}: recall {rec:.4f} below the "
                                     f"single-device {r['recall']:.4f} less "
                                     f"{SHARDED_SLACK}, or {r['gate']}")
            if st["dropped_probe_pairs"]:
                raise AssertionError(f"{name}: dropped pairs {st}")
            summary["points"].append(dict(
                mesh=label, table_dtype=table_dtype, pass_1=r["pass_1"],
                recall=rec, batch_ms=t_batch * 1e3, attempts=attempts,
                qc0=st["queries_per_cluster_cap_round0"]))
        if label == "2x2":
            # the padding path: 9,999 queries are the first 9,999 rows
            sivf.pq.table_dtype = "int8"
            short = sivf.query(qd[:-1], k=10, n_probes=1, pass_1=84)
            if not torch.equal(short, ids_of["2x2", "int8"][:-1]):
                raise AssertionError("2x2: a 9,999-query batch differs from "
                                     "the 10,000-query batch's first rows")
            print("  2x2: a 9,999-query batch equals the first 9,999 rows of "
                  "the 10,000-query one")
        # every K1 shape this mesh's shards gave (the first call of a
        # shard, per table type and capacity) against the plain version; on
        # 4 shards the first of each table type is timed
        err["scan_fold_csr"] = max(err["scan_fold_csr"], hold_captured(
            f"sharded {label}", captured))
        if label == "S=4":
            s4 = sivf
            for key, call in captured.items():
                name = "int8" if key[0] == torch.int8 else "bf16"
                if name not in timed_calls:
                    timed_calls[name] = time_captured("scan_fold_csr", call,
                                                      card)
        del sivf, captured
    share = {t: identical_rows(ids_of["S=1", t], ref[t]["ids"]) for t in ref}
    print(f"  S=1 against the single-device rescore_rows ids, share of "
          f"identical rows: {share}")
    a, b = ids_of["2x2", "int8"].cpu().numpy(), ids_of["S=2", "int8"].cpu(
        ).numpy()
    overlap = float(np.mean([len(set(x.tolist()) & set(y.tolist())) / 10
                             for x, y in zip(a, b)]))
    same = identical_rows(ids_of["2x2", "int8"], ids_of["S=2", "int8"])
    print(f"  2x2 against S=2 (int8 p1=84): overlap {overlap:.4f}, identical "
          f"rows {same:.4f}")
    if overlap < MESH_2D_OVERLAP:
        raise AssertionError(f"2x2 vs S=2 overlap {overlap:.4f} < "
                             f"{MESH_2D_OVERLAP}")
    summary["s1_identical_rows"] = share
    summary["mesh_2d_overlap"] = overlap

    lap("ShardedIVF.query, PQ engine, 4 meshes, each K1 shape held")

    # -- query_stream on 4 shards, int8 p1=84
    s4.pq.table_dtype = "int8"
    kw = dict(k=10, n_probes=1, pass_1=84)
    stream = stream_of(qd, STREAM_REPS[0])
    stream_calls = {}
    undo = capture_first(ivf_module, "scan_fold_csr", stream_calls, by_shape)
    (out, st), n, _ = counted(
        s4, "scan_fold_csr", 1, "sharded S=4 query_stream",
        lambda: s4.query_stream(stream, with_stats=True, **kw))
    undo()
    launches["scan_fold_csr"] += n
    err["scan_fold_csr"] = max(err["scan_fold_csr"], hold_captured(
        "sharded S=4 query_stream", stream_calls))
    t_stream = best_of(lambda: s4.query_stream(stream, **kw))
    print(f"  S=4 query_stream R={STREAM_REPS[0]}: floors (qc0, qc) "
          f"{st['adaptive_qc_floors']}, qc0 "
          f"{st['queries_per_cluster_cap_round0']}, dropped pairs "
          f"{st['dropped_probe_pairs']}, {n} K1 launches; "
          f"{t_stream * 1e3:.2f} ms best of 3 ({note}) {card}")
    if st["dropped_probe_pairs"]:
        raise AssertionError(f"the sharded stream dropped pairs: {st}")
    if not torch.equal(out[0], ids_of["S=4", "int8"]):
        raise AssertionError("sharded stream batch 0 differs from query()")
    torch.cuda.set_sync_debug_mode("error")
    try:
        (ids, dropped), n, _ = counted(
            s4, "scan_fold_csr", 1, "sharded S=4 device_out",
            lambda: s4.query_stream(stream, device_out=True, **kw))
    finally:
        torch.cuda.set_sync_debug_mode("default")
    launches["scan_fold_csr"] += n
    if ids.dtype != torch.int32 or not torch.equal(ids, out):
        raise AssertionError("sharded device_out differs from the host path")
    print(f"  S=4 device_out under set_sync_debug_mode('error'): no sync; "
          f"{tuple(ids.shape)} int32 on {ids.device}, dropped {int(dropped)}")
    stage_profile("sharded S=4 int8 p1=84 query()",
                  lambda: s4.query(qd, **kw), card)
    summary["stream"] = dict(floors=list(st["adaptive_qc_floors"]),
                             ms=t_stream * 1e3)
    lap("query_stream, device_out, profile")

    # -- save from the placed index, read back on one device
    back_path = archive.with_name("placed.npz")
    _, t_save = timed(lambda: save_ivf(back_path, s4))
    del s4
    back = load_ivf(back_path, dev)
    back_path.unlink()
    reset_counts()
    got = back.query(qd, mode="bucket", **kw)
    launches["scan_fold_csr"] += read_counts(
        "placed index's archive on one device")["scan_fold_csr"]
    del back
    if not torch.equal(got, ref["int8"]["ids"]):
        raise AssertionError("the placed index's archive answers unlike the "
                             "phase-4 index")
    print(f"  save_ivf of the S=4 index ({t_save:.2f} s) -> load_ivf: ids "
          f"identical to the single-device index's")
    lap("archive of the placed index")

    # -- the exact engine, build_probes=2, P=2 (tail round, both dedups)
    with np.load(archive_bp2) as z:
        state = {key: z[key] for key in z.files}
    x4 = None
    for label in ("S=1", "S=4", "2x2"):
        exact_calls = {}                # this mesh's first K2 call per shape
        mesh, query_axis = meshes[label]
        sx, t_place = timed(lambda: sharded_ivf_from_state(
            state, mesh, query_axis=query_axis))
        name = f"sharded {label} exact build_probes=2 P=2"
        undo = capture_first(ivf_module, "scan_exact_csr", exact_calls,
                             by_shape)
        run = lambda: sx.query(qd, k=10, n_probes=2,  # noqa: E731
                               with_stats=True)
        (ids, st), n, attempts = counted(sx, "scan_exact_csr", 2, name, run)
        undo()
        launches["scan_exact_csr"] += n
        rec = recall_at_10(ids, truth)
        t_batch = best_of(run)
        print(f"  {name}: placed in {t_place:.2f} s; recall10@10 {rec:.4f} "
              f"(single-device {exact_recall:.4f}), dropped pairs "
              f"{st['dropped_probe_pairs']}, qc0/qc "
              f"{st['queries_per_cluster_cap_round0']}/"
              f"{st['queries_per_cluster_cap']}, {attempts} attempts, {n} K2 "
              f"launches; batch {t_batch * 1e3:.2f} ms best of 3 ({note}) "
              f"{card}")
        if rec < exact_recall - SHARDED_SLACK or rec < EXACT_GATES[0]:
            raise AssertionError(f"{name}: recall {rec:.4f} below the "
                                 f"single-device {exact_recall:.4f} less "
                                 f"{SHARDED_SLACK}, or {EXACT_GATES[0]}")
        if st["dropped_probe_pairs"]:
            raise AssertionError(f"{name}: dropped pairs {st}")
        summary["points"].append(dict(mesh=label, engine="exact", n_probes=2,
                                      recall=rec, batch_ms=t_batch * 1e3,
                                      attempts=attempts))
        # every K2 shape of this mesh (round 0 and the tail round, and the
        # retry capacities where the escalation ran); 1 shard gives the
        # fold narrower than the longest list that ``k2_near_ties`` is for
        err["scan_exact_csr"] = max(err["scan_exact_csr"], hold_captured(
            f"sharded {label} exact", exact_calls, True))
        if label == "S=4":
            x4 = sx
            timed_calls["exact"] = time_captured(
                "scan_exact_csr", next(iter(exact_calls.values())), card)
        del sx, exact_calls
    lap("ShardedIVF.query, exact engine, 3 meshes, each K2 shape held")
    stream_calls = {}
    undo = capture_first(ivf_module, "scan_exact_csr", stream_calls, by_shape)
    (out, st), n, _ = counted(
        x4, "scan_exact_csr", 1, "sharded S=4 exact query_stream",
        lambda: x4.query_stream(stream, k=10, n_probes=1, with_stats=True))
    undo()
    launches["scan_exact_csr"] += n
    err["scan_exact_csr"] = max(err["scan_exact_csr"], hold_captured(
        "sharded S=4 exact query_stream", stream_calls, True))
    del x4, stream_calls
    rec = recall_at_10(out[0], truth)
    print(f"  S=4 exact query_stream R={STREAM_REPS[0]}, P=1: batch-0 "
          f"recall10@10 {rec:.4f}, floors {st['adaptive_qc_floors']}, "
          f"dropped pairs {st['dropped_probe_pairs']}, {n} K2 launches")
    if rec < EXACT_GATES[1] or st["dropped_probe_pairs"]:
        raise AssertionError(f"sharded exact stream: recall {rec:.4f}, {st}")
    lap("exact stream, its K2 shape held")

    # -- ShardedFastPQ.search over 4 shards of the GloVe corpus
    qn = torch.nn.functional.normalize(qd[:K3_QUERIES], dim=1)
    nn1 = torch.as_tensor(truth[:K3_QUERIES, :1].astype(np.int64),
                          device=dev)
    ivf.pq.table_dtype = "int8"
    codes = ivf.pq.transform(ivf.data)
    want = ivf.pq.search(qn, codes, ivf.data, k=10)
    rec_single = float((want == nn1).any(1).float().mean())
    spq, t_build = timed(lambda: ShardedFastPQ(
        ivf.pq, mesh=meshes["S=4"][0]).build(ivf.data))
    k3_calls = {}
    reset_counts()
    undo = capture_first(scan_module, "estimate_scan_tiled", k3_calls)
    got = spq.search(qn, k=10)
    undo()
    n = read_counts("ShardedFastPQ.search S=4")["estimate_scan_tiled"]
    launches["estimate_scan_tiled"] += n
    if n != 4:
        raise AssertionError(f"ShardedFastPQ.search: {n} K3 launches for 4 "
                             f"shards")
    t_search = best_of(lambda: spq.search(qn, k=10))
    t_one = best_of(lambda: ivf.pq.search(qn, codes, ivf.data, k=10))
    rec = float((got == nn1).any(1).float().mean())
    local_n = spq.codes.shape[0] // 4
    print(f"  ShardedFastPQ S=4 over {spq.true_n} codes ({local_n} a shard, "
          f"built in {t_build:.2f} s), {K3_QUERIES} queries, rescore "
          f"{min(30, local_n)} a shard: recall1@10 {rec:.4f} (single-device "
          f"{rec_single:.4f}), identical rows "
          f"{identical_rows(got, want):.4f}; "
          f"search {t_search * 1e3:.2f} ms best of 3 (single-device "
          f"{t_one * 1e3:.2f} ms; {note}) {card}")
    if rec < rec_single - SHARDED_PQ_SLACK:
        raise AssertionError(f"ShardedFastPQ recall1@10 {rec:.4f} below "
                             f"FastPQ's {rec_single:.4f} less "
                             f"{SHARDED_PQ_SLACK}")
    del spq, codes
    (args, kw3), = k3_calls.values()
    k3_got = estimate_scan_tiled(*args, **kw3)
    err["estimate_scan_tiled"] = compare_estimates(
        k3_got, estimate_scan_tiled_reference(*args, **kw3), False)
    del k3_got
    k_ms, p_ms, four = in_turns(
        lambda: estimate_scan_tiled(*args, **kw3),
        lambda: estimate_scan_tiled_reference(*args, **kw3),
        K3_TIMED_LAUNCHES)
    b_ms, b_by = k3_bound(*args)
    shape = (f"int8, {args[1].shape[0]} queries x {args[0].shape[0] * 128} "
             f"codes of one shard")
    print(f"  estimate_scan_tiled of one shard, {shape}: bit-equal; kernel "
          f"{four[0]:.4f} / {four[1]:.4f} ms, plain {four[2]:.4f} / "
          f"{four[3]:.4f} ms per call, bound {b_ms:.4f} ms ({b_by}) {card}")
    timed_calls["k3"] = dict(ms=k_ms, plain_ms=p_ms, bound_ms=b_ms,
                             bound_by=b_by, shape=shape)
    k3_calls.clear()
    summary["sharded_pq"] = dict(recall1_at_10=rec, single=rec_single,
                                 search_ms=t_search * 1e3)
    lap("ShardedFastPQ, K3 of one shard held and timed")

    # -- lloyd_step_dp over 4 shards against the same step on 1 (the rows
    # that divide over 4 shards)
    rows = ivf.data[:ivf.data.shape[0] // 4 * 4]
    (c4, i4), t_lloyd = timed(lambda: lloyd_step_dp(
        rows, ivf.all_centers, meshes["S=4"][0]))
    c1, i1 = lloyd_step_dp(rows, ivf.all_centers, meshes["S=1"][0])
    d_c = float((c4 - c1).abs().max())
    d_i = abs(float(i4) - float(i1)) / float(i1)
    print(f"  lloyd_step_dp S=4 against S=1 on {tuple(rows.shape)} and "
          f"{ivf.all_centers.shape[0]} centers: centers differ by at most "
          f"{d_c:.2e}, inertia {float(i4):.6g} by {d_i:.2e} relative; "
          f"{t_lloyd:.3f} s ({note}) {card}")
    if d_c > LLOYD_TOL[0] or d_i > LLOYD_TOL[1]:
        raise AssertionError(f"lloyd_step_dp: {d_c} / {d_i} beyond "
                             f"{LLOYD_TOL}")

    # -- one shard per card, where there is more than one
    n_cards = torch.cuda.device_count()
    if n_cards > 1:
        sivf = load_sharded_ivf(archive, mesh=make_mesh())
        (ids, st), n, _ = counted(
            sivf, "scan_fold_csr", 1, f"one shard per card, {n_cards} cards",
            lambda: sivf.query(qd, k=10, n_probes=1, pass_1=84,
                               with_stats=True))
        launches["scan_fold_csr"] += n
        rec = recall_at_10(ids, truth)
        print(f"  one shard on each of {n_cards} cards: recall10@10 "
              f"{rec:.4f}, dropped pairs {st['dropped_probe_pairs']}")
        if (rec < ref["int8"]["recall"] - SHARDED_SLACK
                or st["dropped_probe_pairs"]):
            raise AssertionError(f"mesh of {n_cards} cards: recall "
                                 f"{rec:.4f}, {st}")
    else:
        print("  a mesh of distinct cards was not run: one card is visible")
    lap("lloyd_step_dp")
    summary["k2_near_ties"] = dict(NEAR_TIES)
    print(f"  K2 fold classes that kept another point at an equal value, all "
          f"phases: {NEAR_TIES['classes']}, of which within 1 bf16 ulp by the "
          f"plain version's arithmetic: {NEAR_TIES['within_1_ulp']}")
    summary["seconds"] = time.perf_counter() - t_start
    print(f"  sharded path: {summary['seconds']:.1f} s")
    return summary, launches, err, timed_calls


def record_calls(cls, name: str, kernel, log: list, before=None):
    """Wrap ``cls.<name>`` (a method) so that each call appends (its
    keyword arguments, the launches of ``kernel`` during it) to ``log``;
    ``before(kw)``, if given, runs first. Returns a function that undoes
    the wrap."""
    original = getattr(cls, name)

    def wrapped(self, *args, **kw):
        if before is not None:
            before(kw)
        n0 = kernel.launches
        out = original(self, *args, **kw)
        log.append((kw, kernel.launches - n0))
        return out

    setattr(cls, name, wrapped)
    return lambda: setattr(cls, name, original)


def run_example(name: str, argv: list, card: str):
    """``tinyknn_tpu_torch.examples.<name>.main(argv)`` with the launch
    counts set to 0 just before and read just after (which fails if a
    plain version ran on a CUDA tensor). Returns (result, launches,
    seconds)."""
    import importlib
    module = importlib.import_module(f"tinyknn_tpu_torch.examples.{name}")
    print(f"example {name} {' '.join(argv)}:", flush=True)
    reset_counts()
    out, seconds = timed(lambda: module.main(argv))
    launches = read_counts(f"example {name}")
    print(f"  example {name}: {seconds:.2f} s {card}")
    return out, launches, seconds


def need_launched(name: str, launches: dict, *kernels):
    for kname in kernels:
        if not launches[kname]:
            raise AssertionError(f"example {name} did not launch {kname}")


def near(name: str, label: str, got: float, want: float):
    print(f"  {name} {label}: recall10@10 {got:.4f} against {want:.4f}")
    if abs(got - want) > EXAMPLE_SLACK:
        raise AssertionError(f"example {name} {label}: recall {got:.4f} "
                             f"differs from {want:.4f} by more than "
                             f"{EXAMPLE_SLACK}")


def examples_path(tmp: Path, archive: Path, archive_bp2: Path, pq_sum: dict,
                  exact_sum: dict, card: str):
    """Phase 9: the user examples (``tinyknn_tpu_torch.examples``), each
    through its ``main`` as a user runs it: at its own full-width
    defaults, or on the phase-4 archive (build_probes=1) and the phase-5
    build_probes=2 archive, the GloVe shape. Returns (summary, {kernel:
    {example: launches}}, {kernel: max value error})."""
    import os

    import torch
    import tinyknn_tpu_torch.models.ivf as ivf_module
    import tinyknn_tpu_torch.ops.scan as scan_module
    from tinyknn_tpu_torch import IVF
    from tinyknn_tpu_torch.examples import _glove
    from tinyknn_tpu_torch.ops import kernels as k
    t_start = time.perf_counter()
    summary, err = {}, {"scan_fold_csr": 0.0, "scan_exact_csr": 0.0,
                        "estimate_scan_tiled": 0.0}
    launched = {kname: {} for kname in err}

    def keep(name, launches):
        for kname, n in launches.items():
            if n:
                launched[kname][name] = n

    recall_pq = {q["pass_1"]: q["recall"] for q in pq_sum["queries"]
                 if q["table_dtype"] == "int8"}
    # bench's cache directory: the phase-4 archive and the checked-in f64
    # truth under the names bench reads (the truth is checked in as trus64_)
    cache = tmp / "examples"
    cache.mkdir()
    glove_index = str(cache / _glove.index_name(1))
    os.symlink(archive, glove_index)
    os.symlink(TRUTH, cache / os.path.basename(_glove.truth_file()))
    c = ["--cache-dir", str(cache)]
    # the sweeps' repeats are cut, never their widths: the stream examples
    # time R = 2 and 7 (phase 4b's streams)
    reps = ["--reps", *map(str, STREAM_REPS)]

    # -- example: the reference's full scan (K3), the phase-6 data
    k3_calls = {}
    undo = capture_first(scan_module, "estimate_scan_tiled", k3_calls)
    np.random.seed(FULL_SCAN["seed"])
    try:
        out, launches, secs = run_example("example", [], card)
    finally:
        undo()
    keep("example", launches)
    need_launched("example", launches, "estimate_scan_tiled")
    (args, kw), = k3_calls.values()
    e = compare_estimates(k.estimate_scan_tiled(*args, **kw),
                          k.estimate_scan_tiled_reference(*args, **kw), False)
    err["estimate_scan_tiled"] = e
    med, q90 = out["median"], out["quantiles"][0.9]
    print(f"  example: K3 call held, bit-equal; true-NN rank {med} / {q90}")
    if med > FULL_SCAN_GATES[0] or q90 > FULL_SCAN_GATES[1]:
        raise AssertionError(f"example: true-NN rank {med} / {q90} above "
                             f"{FULL_SCAN_GATES[:2]}")
    summary["example"] = dict(rank_median=med, rank_q90=q90, qps=out["qps"],
                              seconds=secs)

    # -- ivf_example: K1 at every n_probes, the P=2 tail round held
    state, per_query, k1_calls = {"P": 0, "i": 0}, [], {}

    def new_query(kw):
        state["P"], state["i"] = kw.get("n_probes", 1), 0

    def by_query(args, kw):
        state["i"] += 1
        return state["P"], state["i"] - 1

    undo_q = record_calls(IVF, "query", k.scan_fold_csr, per_query, new_query)
    undo_k = capture_first(ivf_module, "scan_fold_csr", k1_calls, by_query)
    try:
        out, launches, secs = run_example("ivf_example", [], card)
    finally:
        undo_k()
        undo_q()
    keep("ivf_example", launches)
    by_p = {}
    for kw, n in per_query:
        by_p.setdefault(kw["n_probes"], []).append(n)
    print(f"  ivf_example: K1 launches per query() call by n_probes {by_p}")
    if sorted(by_p) != list(range(1, 11)) or not all(
            n for ns in by_p.values() for n in ns):
        raise AssertionError(f"ivf_example: K1 did not launch in every "
                             f"query() call: {by_p}")
    held = {key: k1_calls[key] for key in ((1, 0), (2, 1))}
    err["scan_fold_csr"] = hold_captured("ivf_example round 0 at P=1 and "
                                         "the tail round at P=2", held)
    rows = out["rows"]
    if rows[-1]["recall"] < rows[0]["recall"]:
        raise AssertionError("ivf_example: recall at P=10 below P=1")
    summary["ivf_example"] = dict(rows=rows, seconds=secs)

    # -- multiprobes: one index per build_probes, K1 in every query
    per_query = []
    undo_q = record_calls(IVF, "query", k.scan_fold_csr, per_query)
    try:
        out, launches, secs = run_example("multiprobes", [], card)
    finally:
        undo_q()
    keep("multiprobes", launches)
    grid = out["recall"]
    if not per_query or not all(n for _, n in per_query):
        raise AssertionError("multiprobes: a query() call launched no K1")
    if grid[-1][-1] < grid[0][0]:
        raise AssertionError("multiprobes: recall at (8, 8) below (1, 1)")
    summary["multiprobes"] = dict(recall=grid, seconds=secs)

    # -- flat_baseline: exact, no kernel
    out, launches, secs = run_example("flat_baseline", [], card)
    if any(launches.values()):
        raise AssertionError("flat_baseline launched a kernel")
    from tinyknn_tpu_torch.examples.flat_baseline import dataset
    X, qs = dataset("random-100000-100", 10000)
    n_check = 1000
    x64 = torch.nn.functional.normalize(
        torch.as_tensor(X, dtype=torch.float64, device="cuda"), dim=1)
    q64 = torch.nn.functional.normalize(
        torch.as_tensor(qs[:n_check], dtype=torch.float64, device="cuda"),
        dim=1)
    truth64 = (q64 @ x64.T).topk(10, dim=1).indices
    rec = recall_at_10(torch.as_tensor(out["ids"][:n_check]),
                       truth64.cpu().numpy())
    del x64, q64, truth64
    print(f"  flat_baseline: recall10@10 {rec:.4f} on {n_check} queries "
          f"against an f64 brute force; {out['qps']:.0f} QPS {card}")
    if rec != 1.0:
        raise AssertionError(f"flat_baseline recall {rec} != 1.0")
    summary["flat_baseline"] = dict(recall=rec, qps=out["qps"], seconds=secs)

    # -- bench at the GloVe shape on the cached phase-4 index (K1)
    out, launches, secs = run_example(
        "bench", ["clustered-1183514-100", "--metric", "angular",
                  "--n-queries", "10000", "--max-build-probes", "2", *c],
        card)
    keep("bench", launches)
    need_launched("bench", launches, "scan_fold_csr")
    build, = out["builds"]
    first = build["points"][0]
    if (first["n_probes"], first["pass_1"]) != (1, 84):
        raise AssertionError(f"bench's first point is {first}")
    near("bench", "P=1 pass_1=84 vs phase 4", first["recall"], recall_pq[84])
    summary["bench"] = dict(points=build["points"], auc=build["auc"],
                            seconds=secs)

    # -- serving_pipeline, small default shape and --glove: the warm
    # device_out calls (floors cached) run under sync debug mode "error"
    for label, argv in (("small", []), ("glove", ["--glove", *c])):
        seen, strict = set(), [0]
        original = IVF.query_stream

        def query_stream(self, batches, *a, **kw):
            key = (batches.shape[1], kw.get("n_probes", 1))
            if not kw.get("device_out") or key not in seen:
                seen.add(key)
                return original(self, batches, *a, **kw)
            strict[0] += 1
            torch.cuda.set_sync_debug_mode("error")
            try:
                return original(self, batches, *a, **kw)
            finally:
                torch.cuda.set_sync_debug_mode("default")

        IVF.query_stream = query_stream
        try:
            out, launches, secs = run_example("serving_pipeline", argv, card)
        finally:
            IVF.query_stream = original
        keep(f"serving_pipeline {label}", launches)
        need_launched("serving_pipeline", launches, "scan_fold_csr")
        print(f"  serving_pipeline {label}: pooled blocks equal "
              f"{out['pooled_equal']}; {strict[0]} warm device_out calls "
              f"under set_sync_debug_mode('error')")
        if not out["pooled_equal"] or not strict[0]:
            raise AssertionError(f"serving_pipeline {label}: {out}")
        summary[f"serving_pipeline_{label}"] = dict(
            device_out_ms=out["device_out_s"] * 1e3,
            host_hop_ms=out["host_hop_s"] * 1e3, seconds=secs)

    # -- latency: gather (no kernel) against bucket (K1) per call
    per_query = []
    undo_q = record_calls(IVF, "query", k.scan_fold_csr, per_query)
    try:
        out, launches, secs = run_example(
            "latency", ["--index", glove_index, "--batch",
                        *map(str, LATENCY_BATCHES), *LATENCY_REPEATS], card)
    finally:
        undo_q()
    keep("latency", launches)
    by_mode = {}
    for kw, n in per_query:
        by_mode.setdefault(kw["mode"], []).append(n)
    if any(by_mode["gather"]) or not all(by_mode["bucket"]):
        raise AssertionError(f"latency: K1 launches by mode "
                             f"{ {m: sum(v) for m, v in by_mode.items()} }")
    print(f"  latency: gather launched no K1 in {len(by_mode['gather'])} "
          f"calls, bucket launched K1 in all {len(by_mode['bucket'])}")
    summary["latency"] = dict(rows=out["rows"], seconds=secs)

    # -- stream_guidance at one P: no drop under the adaptive default
    out, launches, secs = run_example(
        "stream_guidance", ["--index", glove_index, "--probes", "3", *reps,
                            *c],
        card)
    keep("stream_guidance", launches)
    need_launched("stream_guidance", launches, "scan_fold_csr")
    auto = out["rows"][0]
    if auto["qc"] != "auto" or auto["dropped"]:
        raise AssertionError(f"stream_guidance: {auto}")
    summary["stream_guidance"] = dict(rows=out["rows"], seconds=secs)

    # -- p1_frontier: recall of phase 4 at pass_1 21 and 84
    out, launches, secs = run_example(
        "p1_frontier", ["--index", glove_index, "--pass1", "21", "84", *reps,
                        *c],
        card)
    keep("p1_frontier", launches)
    need_launched("p1_frontier", launches, "scan_fold_csr")
    for row in out["rows"]:
        near("p1_frontier", f"pass_1={row['pass_1']} rr={row['rescore_rows']}"
             " vs phase 4", row["recall"], recall_pq[row["pass_1"]])
    summary["p1_frontier"] = dict(rows=out["rows"], seconds=secs)

    # -- exact_frontier on the build_probes=2 archive (K2), its first K2
    # call held
    k2_calls = {}
    undo = capture_first(ivf_module, "scan_exact_csr", k2_calls)
    try:
        out, launches, secs = run_example(
            "exact_frontier", ["--index", str(archive_bp2), "--probes", "1",
                               "2", *reps, *c], card)
    finally:
        undo()
    keep("exact_frontier", launches)
    need_launched("exact_frontier", launches, "scan_exact_csr")
    err["scan_exact_csr"] = hold_captured("exact_frontier", k2_calls, True)
    exact_p = {q["n_probes"]: q["recall"] for q in exact_sum["queries"][1:]}
    for row in out["rows"]:
        near("exact_frontier", f"P={row['n_probes']} vs phase 5",
             row["recall"], exact_p[row["n_probes"]])
    summary["exact_frontier"] = dict(rows=out["rows"], seconds=secs)

    # -- coverage_ceiling (NumPy): above every recall measured at P=1
    out, launches, secs = run_example(
        "coverage_ceiling", ["--index", glove_index, "--probes", "1", *c],
        card)
    if any(launches.values()):
        raise AssertionError("coverage_ceiling launched a kernel")
    ceiling = out["rows"][0]
    measured = max([q["recall"] for q in pq_sum["queries"]]
                   + [exact_sum["queries"][0]["recall"]])
    print(f"  coverage_ceiling P=1: membership {ceiling['membership']:.4f}, "
          f"union brute force {ceiling['recall']:.4f} >= measured "
          f"{measured:.4f}")
    # a recall is a whole number of neighbours out of 10 x 10,000; the two
    # sides sum it in different orders, so an equal one may differ in the
    # last bit: half a neighbour of slack
    if min(ceiling["membership"], ceiling["recall"]) < measured - 0.5e-5:
        raise AssertionError("coverage_ceiling below a measured recall")
    summary["coverage_ceiling"] = dict(rows=out["rows"], seconds=secs)

    # -- sift_convert on a file this run writes
    mat = np.random.default_rng(0).standard_normal((1000, 128)).astype(
        np.float32)
    records = np.empty((1000, 129), np.int32)
    records[:, 0] = 128
    records[:, 1:] = mat.view(np.int32)
    records.tofile(cache / "sift_base.fvecs")
    run_example("sift_convert", [str(cache / "sift_base.fvecs"),
                                 str(cache / "sift.npy")], card)
    if not np.array_equal(np.load(cache / "sift.npy"), mat):
        raise AssertionError("sift_convert changed the vectors")

    summary["seconds"] = time.perf_counter() - t_start
    print(f"  examples path: {summary['seconds']:.1f} s {card}")
    return summary, launched, err


def first_timed(calls: dict, name: str, dtype, qc=None):
    """The reading of the first timed shape of ``dtype`` (and ``qc``
    slots, unless None) among a path's ``by_shape`` calls."""
    for (dt, shape, _), row in calls.items():
        if dt == dtype and qc in (None, shape[1]):
            return row
    raise AssertionError(f"no {dtype} {name} call with {qc} slots was timed")


def main() -> int:
    import tempfile

    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false; this run "
              "needs a CUDA device", file=sys.stderr)
        return 1
    with tempfile.TemporaryDirectory() as tmp:
        return run(Path(tmp))


def run(tmp: Path) -> int:
    """Every phase in order; ``tmp`` holds the archives that phases 4b
    and 5 write for the sharded path and the examples."""
    import torch
    from tinyknn_tpu_torch import IVF, FastPQ, make_clustered, save_ivf
    from tinyknn_tpu_torch.ops import _build
    from tinyknn_tpu_torch.utils.bruteforce import fp32_matmuls

    t_run = time.perf_counter()
    # -- 1. device
    device = torch.device("cuda")
    name = torch.cuda.get_device_name(0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    card = f"[{smi}]"
    print(f"device: {name}; nvidia-smi: {smi}; torch {torch.__version__}, "
          f"CUDA {torch.version.cuda}; devices: {torch.cuda.device_count()}")
    fp32_matmuls()
    print("TF32 off: matmul", torch.backends.cuda.matmul.allow_tf32,
          "cudnn", torch.backends.cudnn.allow_tf32)

    # -- 2. build, one nvcc per source, all at once
    t0 = time.perf_counter()
    builds = _build.build_all()
    print(f"build: {time.perf_counter() - t0:.2f} s wall")
    for build in builds.values():
        how = (f"{build.seconds:.2f} s" if build.seconds
               else "reused an earlier build")
        print(f"  {build.path.name} ({how})")
        for line in build.log.splitlines():
            if "ptxas" in line:
                print("    " + line.strip())

    # -- 3. kernels against their plain versions
    print("kernel checks, synthetic inputs:")
    err = {"scan_fold_csr": check_kernel_small(device),
           "scan_exact_csr": check_exact_small(device),
           "estimate_scan_tiled": check_estimate_small(device)}

    # -- 4. PQ path at the GloVe shape (K1)
    data, queries = make_clustered(GLOVE["size"], GLOVE["dim"],
                                   GLOVE["n_queries"])
    truth = np.load(TRUTH)
    ivf = IVF("angular", GLOVE["n_clusters"], FastPQ(2, device=device),
              device=device)
    pq_sum, k1_launches, e1, k1_calls = pq_path(ivf, data, queries, truth,
                                                card)
    err["scan_fold_csr"] = max(err["scan_fold_csr"], e1)

    # -- 4b. serving surface on the same index (K1; gather, 'xla', Flat
    # run no kernel)
    archive = tmp / "index.npz"
    serving_sum, k1_serving, e1 = serving_path(ivf, data, queries, truth,
                                               card, archive)
    err["scan_fold_csr"] = max(err["scan_fold_csr"], e1)

    # -- 5. exact path (K2), with its serving surface (5b)
    exact_sum, k2_launches, e2, k2_calls, k2_serving = exact_path(
        ivf, data, queries, truth, card)
    err["scan_exact_csr"] = max(err["scan_exact_csr"], e2)
    archive_bp2 = tmp / "index_bp2.npz"
    save_ivf(archive_bp2, ivf)

    # -- 6. full-scan path (K3, and K1 through fold_topk_tiled)
    (fs_sum, k3_launches, k1_approx_launches, (e1, k1_fs_times),
     (e3, k3_fs_times)) = full_scan_path(device, card)
    err["scan_fold_csr"] = max(err["scan_fold_csr"], e1)
    err["estimate_scan_tiled"] = max(err["estimate_scan_tiled"], e3)

    # -- 7. K3 on the GloVe corpus's codes
    e3, k3_times, k3_sum = k3_real_size(ivf, queries, truth, card)
    err["estimate_scan_tiled"] = max(err["estimate_scan_tiled"], e3)

    # -- 8. the sharded indexes, on logical shards of this card
    sharded_sum, sharded_launches, e8, sharded_calls = sharded_path(
        ivf, archive, archive_bp2, queries, truth,
        exact_sum["queries"][2]["recall"], card)
    for kname, e in e8.items():
        err[kname] = max(err[kname], e)
    del ivf

    # -- 9. the user examples, each through its main
    examples_sum, examples_launches, e9 = examples_path(
        tmp, archive, archive_bp2, pq_sum, exact_sum, card)
    for kname, e in e9.items():
        err[kname] = max(err[kname], e)

    r0 = first_timed(k1_calls, "K1", torch.int8, 32)
    retry = first_timed(k1_calls, "K1", torch.int8, 128)
    bf = first_timed(k1_calls, "K1", torch.bfloat16)
    e_r0 = first_timed(k2_calls, "K2", torch.bfloat16, 32)
    e_retry = first_timed(k2_calls, "K2", torch.bfloat16, 128)
    print(f"all phases: {time.perf_counter() - t_run:.1f} s {card}")
    print(json.dumps({"pq_path": pq_sum, "serving_path": serving_sum,
                      "exact_path": exact_sum,
                      "full_scan": fs_sum, "k3_real_size": k3_sum,
                      "sharded_path": sharded_sum,
                      "examples_path": examples_sum, "card": smi}))
    print(smi)
    rows = {
        "scan_fold_csr": dict(
            launches=k1_launches, **r0, library_ms=None,
            library_reason=NO_LIBRARY["scan_fold_csr"],
            shape="int8 (1087, 32, 1024) round 0 of int8 p1=84, the "
                  "batch's slot counts",
            retry_ms=retry["ms"], retry_plain_ms=retry["plain_ms"],
            retry_bound_ms=retry["bound_ms"],
            bf16_ms=bf["ms"], bf16_plain_ms=bf["plain_ms"],
            bf16_bound_ms=bf["bound_ms"],
            approx_route_launches=k1_approx_launches,
            approx_route_ms=k1_fs_times[0],
            approx_route_plain_ms=k1_fs_times[1],
            approx_route_bound_ms=k1_fs_times[2],
            serving_launches=k1_serving,
            sharded_launches=sharded_launches["scan_fold_csr"],
            sharded_shape=sharded_calls["int8"]["shape"],
            sharded_ms=sharded_calls["int8"]["ms"],
            sharded_plain_ms=sharded_calls["int8"]["plain_ms"],
            sharded_bound_ms=sharded_calls["int8"]["bound_ms"],
            sharded_bf16_shape=sharded_calls["bf16"]["shape"],
            sharded_bf16_ms=sharded_calls["bf16"]["ms"],
            sharded_bf16_plain_ms=sharded_calls["bf16"]["plain_ms"],
            sharded_bf16_bound_ms=sharded_calls["bf16"]["bound_ms"]),
        "scan_exact_csr": dict(
            launches=k2_launches, **e_r0, library_ms=None,
            library_reason=NO_LIBRARY["scan_exact_csr"],
            retry_shape=e_retry["shape"], retry_ms=e_retry["ms"], retry_plain_ms=e_retry["plain_ms"],
            retry_bound_ms=e_retry["bound_ms"],
            retry_bound_by=e_retry["bound_by"],
            serving_launches=k2_serving,
            sharded_launches=sharded_launches["scan_exact_csr"],
            sharded_shape=sharded_calls["exact"]["shape"],
            sharded_ms=sharded_calls["exact"]["ms"],
            sharded_plain_ms=sharded_calls["exact"]["plain_ms"],
            sharded_bound_ms=sharded_calls["exact"]["bound_ms"],
            near_tie_classes=NEAR_TIES["classes"],
            near_ties_within_1_ulp=NEAR_TIES["within_1_ulp"]),
        "estimate_scan_tiled": dict(
            launches=k3_launches, ms=k3_times[0], plain_ms=k3_times[1],
            bound_ms=k3_times[2], bound_by=k3_times[3],
            library_ms=k3_times[4], library_call=k3_times[5],
            shape="int8, 1,000 queries x 1,183,616 GloVe codes",
            full_scan_ms=k3_fs_times[0], full_scan_plain_ms=k3_fs_times[1],
            full_scan_bound_ms=k3_fs_times[2],
            full_scan_library_ms=k3_fs_times[4],
            sharded_launches=sharded_launches["estimate_scan_tiled"],
            sharded_shape=sharded_calls["k3"]["shape"],
            sharded_ms=sharded_calls["k3"]["ms"],
            sharded_plain_ms=sharded_calls["k3"]["plain_ms"],
            sharded_bound_ms=sharded_calls["k3"]["bound_ms"]),
    }
    print(json.dumps({"kernels": [{
        "name": kname, "route": "cuda",
        "source": f"tinyknn_tpu_torch/csrc/{kname}.cu",
        "replaces": replaces, "launches": rows[kname].pop("launches"),
        "max_abs_err": err[kname], **rows[kname],
        "examples_launches": examples_launches[kname]}
        for kname, _, _, replaces in kernel_table()]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
