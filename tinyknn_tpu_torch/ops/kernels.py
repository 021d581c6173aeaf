"""The hand-written kernels and the layouts around them (counterpart of
tinyknn_tpu/ops/kernels.py).

Three kernels, each a CUDA C++ source under ``csrc/`` built on first use
(see ``_build``) and each with a plain torch version beside it:

  * ``scan_fold_csr`` (K1): the IVF inner loop over 4-bit PQ codes. For
    every (list, query slot) it scans the list's nibble-packed code tiles
    against the query's distance tables and min-folds the encoded
    estimates into a fixed-width buffer;
  * ``scan_exact_csr`` (K2): the exact engine's inner loop, the same
    ragged walk and fold over augmented bf16 vector tiles, whose dot
    product with an augmented query is the true squared distance;
  * ``estimate_scan_tiled`` (K3): the FastPQ full-scan estimate of every
    code tile for every query, with no fold.

``fold_topk_tiled`` runs K1 over pseudo-lists that cover the whole
corpus. On a CUDA tensor a wrapper launches its kernel (and adds one to
its ``launches`` count); on a CPU tensor it runs the plain version
(``*_reference``). There is no fallback from one to the other.

Layouts (identical to the JAX package's, so its archives load as is):
  * code tiles ``uint8[T, Bs_pad, 128]``: points on the last axis,
    packed bytes (two 4-bit blocks each) on the middle one, padded to a
    multiple of 8 bytes;
  * tables ``[..., 16 * B_pad]`` with B_pad = 2 * Bs_pad: value v of
    storage block s at column ``v * B_pad + s``, storage order being the
    even blocks (low nibbles) then the odd blocks (high nibbles); the
    phantom pad blocks have zero rows;
  * vector tiles ``bf16[T, d_aug, 128]``: augmented dimensions on the
    middle axis, points on the last.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from ..utils.padding import round_up
from .topk import smallest_k

LANE_TILE = 128
ENC_INVALID = 2**31 - 1  # empty-slot sentinel of the encoded fold domain
REFERENCE_LISTS_PER_CHUNK = 64  # lists the plain fold versions scan at once
REFERENCE_ESTIMATES_PER_CHUNK = 1 << 26  # (Q, n) entries K3's plain version
                                         # sums at once (256 MB of int32)
EXACT_MAX_POSITIONS = 1 << 16  # K2's 16-bit fold positions

_vp, _int = ctypes.c_void_p, ctypes.c_int
_LAUNCH_ARGTYPES = {
    "scan_fold_csr": [_vp, _int] + [_vp] * 5 + [_int] * 8 + [_vp],
    "scan_exact_csr": [_vp] * 6 + [_int] * 5 + [_vp],
    "estimate_scan_tiled": [_vp, _int, _vp, _vp] + [_int] * 4 + [_vp],
}


@functools.cache
def _library(name: str):
    from . import _build
    lib = _build.build(name).lib
    launch = getattr(lib, f"{name}_launch")
    launch.argtypes = _LAUNCH_ARGTYPES[name]
    launch.restype = _int
    err_str = getattr(lib, f"{name}_error_string")
    err_str.argtypes = [_int]
    err_str.restype = ctypes.c_char_p
    return lib


def _launch(name: str, device: torch.device, *args) -> None:
    """Call ``csrc/<name>.cu``'s launch function on the current stream of
    ``device`` and raise if the launch was refused."""
    lib = _library(name)
    stream = torch.cuda.current_stream(device).cuda_stream
    err = getattr(lib, f"{name}_launch")(*args, stream)
    if err:
        raise RuntimeError(f"{name} launch failed: " + getattr(
            lib, f"{name}_error_string")(err).decode())


def _cuda_inputs(name: str, *tensors, aligned: bool = False) -> None:
    """Raise unless the kernel can take these tensors: on a CUDA device
    and contiguous (CPU tensors never get here); with ``aligned``, also
    starting on a 16-byte boundary (the kernels read their operands in
    16-byte pieces)."""
    dev = tensors[0].device
    if dev.type != "cuda":
        raise ValueError(f"no {name} for {dev}")
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError(f"{name} needs contiguous inputs")
    if aligned and any(t.data_ptr() % 16 for t in tensors):
        raise ValueError(f"{name} needs inputs on a 16-byte boundary")


def pack_codes_tiled(codes_packed: torch.Tensor,
                     flat_ids: torch.Tensor) -> torch.Tensor:
    """Gather nibble-packed codes into the CSR tile layout.

    codes_packed: uint8[n, Bs]; flat_ids: int32[T * 128] from
    invert_assignments_csr_tiled (-1 padding reuses row 0; list counts
    mask it at query time). Returns uint8[T, Bs_pad, 128], Bs padded to
    a multiple of 8 with zero bytes.
    """
    rows = codes_packed[flat_ids.clamp(min=0).long()]     # (T*128, Bs)
    Bs = rows.shape[1]
    rows = torch.nn.functional.pad(rows, (0, round_up(Bs, 8) - Bs))
    T = flat_ids.shape[0] // LANE_TILE
    return rows.reshape(T, LANE_TILE, -1).transpose(1, 2).contiguous()


def permute_tables_csr(tables_flat: torch.Tensor, B: int) -> torch.Tensor:
    """(..., 16B) block-major tables -> the scan's (..., 16 * B_pad)
    layout: storage (evens-then-odds) block order over the 8-byte-padded
    packed width, zero rows for phantom pad blocks."""
    Bs_pad = round_up(B // 2, 8)
    B_pad = 2 * Bs_pad
    # made on the tables' device: a host-to-device copy would wait for
    # the host, which a stream of queries must never do
    perm = torch.arange(B_pad, device=tables_flat.device).reshape(
        Bs_pad, 2).T.reshape(-1)                      # evens, then odds
    shape = tables_flat.shape[:-1]
    t = tables_flat.reshape(shape + (B, 16))
    if B_pad != B:
        t = torch.nn.functional.pad(t, (0, 0, 0, B_pad - B))
    t = t[..., perm, :]
    return t.transpose(-1, -2).reshape(shape + (16 * B_pad,))


def fold_encoding(tables_dtype: torch.dtype, B_pad: int,
                  max_tiles: int) -> tuple[int, int]:
    """``(col_bits, enc_bias)`` of the fold encoding.

    int8 tables: ``(est + 128 * B_pad) << col_bits | pos`` with
    col_bits = bit_length(max_tiles * 128 - 1). bf16 tables:
    ``bf16_bits(est) << 16 | pos``. Raises ValueError when the longest
    list does not fit the int32 encoding.
    """
    if tables_dtype == torch.int8:
        col_bits = max(1, (max_tiles * LANE_TILE - 1).bit_length())
        if (255 * B_pad + 1) << col_bits > 2**31 - 1:
            raise ValueError(
                f"list too long for the int32 encoding: max_tiles="
                f"{max_tiles}, B_pad={B_pad}")
        return col_bits, 128 * B_pad
    if tables_dtype == torch.bfloat16:
        if max_tiles * LANE_TILE > 1 << 16:
            raise ValueError(
                f"list too long for the bf16 encoding's 16-bit positions: "
                f"max_tiles={max_tiles}")
        return 16, 0
    raise TypeError(f"tables must be int8 or bfloat16, not {tables_dtype}")


def _check_lists(rows, tiles, tile_offsets, counts, fold_tiles, max_tiles,
                 slot_counts):
    """The checks K1 and K2 share: ``rows`` [C, qc, ...] per-list query
    rows, ``tiles`` [T, ..., 128] list tiles, int32[C] offsets, counts
    and (unless ``None``) slot counts on one device, positive widths."""
    C = rows.shape[0]
    if tiles.ndim != 3 or tiles.shape[2] != LANE_TILE:
        raise ValueError(f"tiles must be [T, ..., {LANE_TILE}], not "
                         f"{tuple(tiles.shape)}")
    for name, t in (("tile_offsets", tile_offsets), ("counts", counts),
                    ("slot_counts", slot_counts)):
        if t is not None and (t.dtype != torch.int32 or t.shape != (C,)):
            raise ValueError(f"{name} must be int32[{C}]")
    for t in (tiles, tile_offsets, counts, slot_counts):
        if t is not None and t.device != rows.device:
            raise ValueError("all inputs must be on one device")
    if fold_tiles < 1 or max_tiles < 1 or tiles.shape[0] < 1:
        raise ValueError("fold_tiles, max_tiles and the tile count must "
                         "be positive")


def _mask_empty_slots(enc, slot_counts):
    """The plain versions' empty slots: rows q >= slot_counts[c] of the
    (C, qc, S) fold get the sentinel (``None``: every slot occupied)."""
    if slot_counts is None:
        return enc
    empty = (torch.arange(enc.shape[1], device=enc.device)[None, :]
             >= slot_counts[:, None])                 # (C, qc)
    return enc.masked_fill_(empty[:, :, None], ENC_INVALID)


def _check_args(tables_sel, codes_tiled, tile_offsets, counts, fold_tiles,
                max_tiles, slot_counts, n_blocks):
    """K1's checks; returns ``(col_bits, enc_bias, n_blocks)``."""
    _check_lists(tables_sel, codes_tiled, tile_offsets, counts, fold_tiles,
                 max_tiles, slot_counts)
    M = tables_sel.shape[2]
    Bs_pad = codes_tiled.shape[1]
    if M != 32 * Bs_pad:
        raise ValueError(f"tables (..., {M}) do not match code tiles "
                         f"{tuple(codes_tiled.shape)}")
    if codes_tiled.dtype != torch.uint8:
        raise TypeError("code tiles must be uint8")
    return (*fold_encoding(tables_sel.dtype, 2 * Bs_pad, max_tiles),
            _n_blocks(n_blocks, 2 * Bs_pad))


def _n_blocks(n_blocks, B_pad: int) -> int:
    """The real table block count (``None``: ``B_pad``), checked."""
    n = B_pad if n_blocks is None else int(n_blocks)
    if not 1 <= n <= B_pad:
        raise ValueError(f"n_blocks={n_blocks} outside 1..{B_pad}")
    return n


def scan_fold_csr(tables_sel: torch.Tensor, codes_tiled: torch.Tensor,
                  tile_offsets: torch.Tensor, counts: torch.Tensor, *,
                  fold_tiles: int, max_tiles: int,
                  slot_counts: torch.Tensor | None = None,
                  n_blocks: int | None = None) -> torch.Tensor:
    """Ragged scan over CSR-tiled lists, emitting the encoded fold.

    tables_sel: int8 or bf16 [C, qc, 16 * B_pad], list c's query slots
    (permute_tables_csr layout); codes_tiled: uint8[T, B_pad / 2, 128];
    tile_offsets, counts: int32[C]. Returns enc int32[C, qc, S] with
    S = fold_tiles * 128: entry [c, q, j] is the minimum encoding (see
    ``fold_encoding``) over list c's positions p < min(counts[c],
    max_tiles * 128) with (p // 128 mod fold_tiles) * 128 + p % 128 = j,
    or 2^31 - 1 where there is none.

    ``slot_counts`` int32[C] (``None``: every slot): list c's first
    slot_counts[c] slots are occupied; the rest are not scanned and hold
    2^31 - 1. ``n_blocks``: the real table block count (``None``:
    B_pad); the code bytes past ceil(n_blocks / 2) are skipped, so the
    table rows of blocks >= n_blocks must be zero, as
    ``permute_tables_csr`` makes them.

    Where the JAX kernel takes csr_scan_map's four step maps, this one
    takes ``tile_offsets``: each CUDA block finds its own tiles.

    CUDA tensors launch the kernel (and add one to
    ``scan_fold_csr.launches``); CPU tensors run the plain version.
    """
    col_bits, enc_bias, n_blocks = _check_args(
        tables_sel, codes_tiled, tile_offsets, counts, fold_tiles, max_tiles,
        slot_counts, n_blocks)
    if tables_sel.device.type == "cpu":
        return scan_fold_csr_reference(
            tables_sel, codes_tiled, tile_offsets, counts,
            fold_tiles=fold_tiles, max_tiles=max_tiles,
            slot_counts=slot_counts, n_blocks=n_blocks)
    _cuda_inputs("scan_fold_csr", tables_sel, codes_tiled, tile_offsets,
                 counts, *([] if slot_counts is None else [slot_counts]),
                 aligned=True)
    C, qc, _ = tables_sel.shape
    Bs_pad = codes_tiled.shape[1]
    bf16 = int(tables_sel.dtype == torch.bfloat16)
    enc = torch.empty((C, qc, fold_tiles * LANE_TILE), dtype=torch.int32,
                      device=tables_sel.device)
    if enc.numel() == 0:
        return enc
    _launch("scan_fold_csr", tables_sel.device, tables_sel.data_ptr(), bf16,
            codes_tiled.data_ptr(), tile_offsets.data_ptr(),
            counts.data_ptr(),
            None if slot_counts is None else slot_counts.data_ptr(),
            enc.data_ptr(), C, qc, Bs_pad, n_blocks, fold_tiles, max_tiles,
            col_bits, enc_bias)
    scan_fold_csr.launches += 1
    return enc


scan_fold_csr.launches = 0


def scan_fold_csr_reference(tables_sel: torch.Tensor,
                            codes_tiled: torch.Tensor,
                            tile_offsets: torch.Tensor, counts: torch.Tensor,
                            *, fold_tiles: int, max_tiles: int,
                            slot_counts: torch.Tensor | None = None,
                            n_blocks: int | None = None) -> torch.Tensor:
    """Plain torch version of ``scan_fold_csr`` (same arguments, same
    result on any device).

    Per chunk of lists it gathers ``max_tiles`` tiles densely, sums the
    table entries of the first ceil(n_blocks / 2) code bytes in int32
    (f32 for bf16 tables) in logical block order (the kernel's order),
    encodes, masks positions past each list's end, and min-folds tile ti
    into segment ti mod fold_tiles; slots past ``slot_counts`` get the
    sentinel. Calls on CUDA tensors add one to
    ``scan_fold_csr_reference.cuda_calls``.
    """
    col_bits, enc_bias, n_blocks = _check_args(
        tables_sel, codes_tiled, tile_offsets, counts, fold_tiles, max_tiles,
        slot_counts, n_blocks)
    if tables_sel.device.type == "cuda":
        scan_fold_csr_reference.cuda_calls += 1
    C, qc, _ = tables_sel.shape
    Bs_pad = codes_tiled.shape[1]
    floating = tables_sel.dtype != torch.int8
    acc_dtype = torch.float32 if floating else torch.int32

    def value(tb, codes):
        # tb (n, qc, 16, B_pad): [..., v, s] is value v of storage block s
        codes = codes.long()
        lo, hi = codes & 15, codes >> 4
        n, _, L = codes.shape
        est = torch.zeros((n, qc, L), dtype=acc_dtype, device=tb.device)
        for sb in range((n_blocks + 1) // 2):         # blocks 2sb, 2sb + 1
            est += torch.gather(tb[:, :, :, sb], 2,
                                lo[:, None, sb].expand(n, qc, L))
            est += torch.gather(tb[:, :, :, Bs_pad + sb], 2,
                                hi[:, None, sb].expand(n, qc, L))
        if floating:
            return _bf16_bits(est) << 16
        return (est + enc_bias) << col_bits

    tables = tables_sel.to(acc_dtype).reshape(C, qc, 16, 2 * Bs_pad)
    enc = _fold_reference(tables, codes_tiled, tile_offsets, counts,
                          fold_tiles, max_tiles, value)
    return _mask_empty_slots(enc, slot_counts)


scan_fold_csr_reference.cuda_calls = 0


def _bf16_bits(x: torch.Tensor) -> torch.Tensor:
    """int32 bit pattern of f32 ``x`` rounded to bf16 (nearest even)."""
    return x.to(torch.bfloat16).view(torch.int16).to(torch.int32)


def _fold_reference(rows, tiles_all, tile_offsets, counts, fold_tiles: int,
                    max_tiles: int, value):
    """The walk both plain fold versions share.

    Per chunk of lists it gathers ``max_tiles`` tiles of each list
    densely as (n, X, L), X the tiles' middle axis and L = max_tiles *
    128, and calls ``value(rows[c0:c1], tiles)`` for the int32 (n, qc, L)
    encodings with zero position bits. It then adds the positions, masks
    those past each list's end and min-folds tile ti into segment ti mod
    fold_tiles: int32[C, qc, fold_tiles * 128].
    """
    dev = rows.device
    C, qc = rows.shape[:2]
    T, X, _ = tiles_all.shape
    S = fold_tiles * LANE_TILE
    L = max_tiles * LANE_TILE
    L_pad = round_up(max_tiles, fold_tiles) * LANE_TILE
    pos = torch.arange(L, dtype=torch.int32, device=dev)
    out = torch.empty((C, qc, S), dtype=torch.int32, device=dev)
    tile_idx = torch.arange(max_tiles, dtype=torch.int64, device=dev)
    for c0 in range(0, C, REFERENCE_LISTS_PER_CHUNK):
        c1 = min(C, c0 + REFERENCE_LISTS_PER_CHUNK)
        n = c1 - c0
        tiles = (tile_offsets[c0:c1, None].long() + tile_idx).clamp(max=T - 1)
        chunk = tiles_all[tiles]                      # (n, mt, X, 128)
        chunk = chunk.permute(0, 2, 1, 3).reshape(n, X, L)
        enc = torch.where(pos < counts[c0:c1, None, None],
                          value(rows[c0:c1], chunk) | pos, ENC_INVALID)
        enc = torch.nn.functional.pad(enc, (0, L_pad - L), value=ENC_INVALID)
        out[c0:c1] = enc.reshape(n, qc, L_pad // S, S).amin(dim=2)
    return out


# ------------------------------------------------------------------ K2


def _check_exact_args(q_sel, vecs_tiled, tile_offsets, counts, fold_tiles,
                      max_tiles, slot_counts):
    _check_lists(q_sel, vecs_tiled, tile_offsets, counts, fold_tiles,
                 max_tiles, slot_counts)
    if q_sel.dtype != torch.bfloat16 or vecs_tiled.dtype != torch.bfloat16:
        raise TypeError("q_sel and vector tiles must be bfloat16")
    if vecs_tiled.shape[1] != q_sel.shape[2]:
        raise ValueError(f"queries (..., {q_sel.shape[2]}) do not match "
                         f"vector tiles {tuple(vecs_tiled.shape)}")
    if max_tiles * LANE_TILE > EXACT_MAX_POSITIONS:
        raise ValueError(f"list too long for 16-bit fold positions: "
                         f"max_tiles={max_tiles}; raise n_clusters")


def scan_exact_csr(q_sel: torch.Tensor, vecs_tiled: torch.Tensor,
                   tile_offsets: torch.Tensor, counts: torch.Tensor, *,
                   fold_tiles: int, max_tiles: int,
                   slot_counts: torch.Tensor | None = None) -> torch.Tensor:
    """Ragged exact-distance scan over CSR-tiled augmented vectors.

    q_sel: bf16[C, qc, d_aug], list c's augmented query slots
    ([-2q, 1, 1, |q|^2, 0...]); vecs_tiled: bf16[T, d_aug, 128]
    ([x, hi(|x|^2), lo(|x|^2), 1, 0...] per point); tile_offsets,
    counts: int32[C]. Returns enc int32[C, qc, S], S = fold_tiles * 128:
    entry [c, q, j] is the minimum of ``bf16_bits(max(d, 0)) << 16 |
    pos`` over list c's positions pos < min(counts[c], max_tiles * 128)
    in fold class j, d the dot product of the two augmented rows, or
    2^31 - 1 where the class is empty.

    ``slot_counts`` int32[C] (``None``: every slot): list c's first
    slot_counts[c] slots are occupied; the rest are not scanned and hold
    2^31 - 1.

    The kernel adds the exact f32 products on the tensor cores in an
    order of its own, so its fold is bit-equal to the plain version's
    where every partial sum is exact in f32 (integer-valued inputs); on
    real inputs a decoded distance may differ by the rounding of the f32
    sums, within 1 bf16 ulp on the inputs chip_smoke.py holds.

    CUDA tensors launch the kernel (and add one to
    ``scan_exact_csr.launches``); CPU tensors run the plain version.
    """
    _check_exact_args(q_sel, vecs_tiled, tile_offsets, counts, fold_tiles,
                      max_tiles, slot_counts)
    if q_sel.device.type == "cpu":
        return scan_exact_csr_reference(q_sel, vecs_tiled, tile_offsets,
                                        counts, fold_tiles=fold_tiles,
                                        max_tiles=max_tiles,
                                        slot_counts=slot_counts)
    _cuda_inputs("scan_exact_csr", q_sel, vecs_tiled, tile_offsets, counts,
                 *([] if slot_counts is None else [slot_counts]),
                 aligned=True)
    C, qc, d_aug = q_sel.shape
    enc = torch.empty((C, qc, fold_tiles * LANE_TILE), dtype=torch.int32,
                      device=q_sel.device)
    if enc.numel() == 0:
        return enc
    _launch("scan_exact_csr", q_sel.device, q_sel.data_ptr(),
            vecs_tiled.data_ptr(), tile_offsets.data_ptr(), counts.data_ptr(),
            None if slot_counts is None else slot_counts.data_ptr(),
            enc.data_ptr(), C, qc, d_aug, fold_tiles, max_tiles)
    scan_exact_csr.launches += 1
    return enc


scan_exact_csr.launches = 0


def scan_exact_csr_reference(q_sel: torch.Tensor, vecs_tiled: torch.Tensor,
                             tile_offsets: torch.Tensor,
                             counts: torch.Tensor, *, fold_tiles: int,
                             max_tiles: int,
                             slot_counts: torch.Tensor | None = None
                             ) -> torch.Tensor:
    """Plain torch version of ``scan_exact_csr`` (same arguments, same
    result on any device, up to the kernel's summation order).

    Per chunk of lists it gathers ``max_tiles`` tiles densely and sums
    the products of the two augmented rows in f32 one dimension at a
    time (each bf16 x bf16 product is exact in f32; the kernel adds the
    same products in its tensor cores' order). Then it clamps, encodes,
    masks positions past each list's end, min-folds tile ti into
    segment ti mod fold_tiles and gives slots past ``slot_counts`` the
    sentinel. Calls on CUDA tensors add one to
    ``scan_exact_csr_reference.cuda_calls``.
    """
    _check_exact_args(q_sel, vecs_tiled, tile_offsets, counts, fold_tiles,
                      max_tiles, slot_counts)
    if q_sel.device.type == "cuda":
        scan_exact_csr_reference.cuda_calls += 1

    def value(q, vecs):
        vecs = vecs.float()
        n, d_aug, L = vecs.shape
        est = torch.zeros((n, q.shape[1], L), dtype=torch.float32,
                          device=q.device)
        for j in range(d_aug):                        # dimension order
            est += q[:, :, j, None] * vecs[:, None, j, :]
        return _bf16_bits(torch.where(est > 0, est, 0.0)) << 16

    enc = _fold_reference(q_sel.float(), vecs_tiled, tile_offsets, counts,
                          fold_tiles, max_tiles, value)
    return _mask_empty_slots(enc, slot_counts)


scan_exact_csr_reference.cuda_calls = 0


# ------------------------------------------------------------------ K3


def tile_codes(codes_packed: torch.Tensor) -> torch.Tensor:
    """uint8[n, Bs] packed codes -> the (T, Bs_pad, 128) tile layout that
    ``estimate_scan_tiled`` reads (rows padded to a multiple of 128 with
    zeros, Bs padded to a multiple of 8 as in ``pack_codes_tiled``)."""
    n, Bs = codes_packed.shape
    n_pad = round_up(max(n, LANE_TILE), LANE_TILE)
    rows = torch.nn.functional.pad(codes_packed,
                                   (0, round_up(Bs, 8) - Bs, 0, n_pad - n))
    return rows.reshape(n_pad // LANE_TILE, LANE_TILE, -1).transpose(
        1, 2).contiguous()


_ESTIMATE_KINDS = {torch.int8: 0, torch.bfloat16: 1, torch.float32: 2}


def _check_estimate_args(codes_tiled, tables):
    T, Bs_pad, lanes = codes_tiled.shape
    Q, B, values = tables.shape
    if lanes != LANE_TILE or values != 16:
        raise ValueError(f"code tiles {tuple(codes_tiled.shape)} or tables "
                         f"{tuple(tables.shape)} have the wrong layout")
    if B % 2 or round_up(B // 2, 8) != Bs_pad:
        raise ValueError(f"{B} table blocks do not match code tiles of "
                         f"{Bs_pad} packed bytes")
    if codes_tiled.dtype != torch.uint8:
        raise TypeError("code tiles must be uint8")
    if tables.dtype not in _ESTIMATE_KINDS:
        raise TypeError(f"tables must be int8, bfloat16 or float32, not "
                        f"{tables.dtype}")
    if codes_tiled.device != tables.device:
        raise ValueError("all inputs must be on one device")


def estimate_scan_tiled(codes_tiled: torch.Tensor,
                        tables: torch.Tensor) -> torch.Tensor:
    """Full-scan PQ estimate over pre-tiled packed codes.

    codes_tiled: uint8[T, Bs_pad, 128] (``tile_codes`` /
    ``pack_codes_tiled`` layout); tables: [Q, B, 16] int8, bf16 or f32
    with B even and Bs_pad = round_up(B / 2, 8). Returns ``est[q, p] =
    sum_b tables[q, b, code(p, b)]`` over every tile position p,
    [Q, T * 128]: int32 for int8 tables, f32 (summed in logical block
    order) for float ones. The JAX kernel's ``kt`` (code tiles per TPU
    grid step) has no counterpart.

    CUDA tensors launch the kernel (and add one to
    ``estimate_scan_tiled.launches``); CPU tensors run the plain version.
    """
    _check_estimate_args(codes_tiled, tables)
    if tables.device.type == "cpu":
        return estimate_scan_tiled_reference(codes_tiled, tables)
    Q, B, _ = tables.shape
    T, Bs_pad, _ = codes_tiled.shape
    tsel = permute_tables_csr(tables.reshape(Q, 16 * B), B).contiguous()
    _cuda_inputs("estimate_scan_tiled", tsel, codes_tiled, aligned=True)
    out = torch.empty((Q, T * LANE_TILE), device=tables.device,
                      dtype=(torch.int32 if tables.dtype == torch.int8
                             else torch.float32))
    if out.numel() == 0:
        return out
    _launch("estimate_scan_tiled", tables.device, tsel.data_ptr(),
            _ESTIMATE_KINDS[tables.dtype], codes_tiled.data_ptr(),
            out.data_ptr(), Q, T, Bs_pad, B)
    estimate_scan_tiled.launches += 1
    return out


estimate_scan_tiled.launches = 0


def estimate_scan_tiled_reference(codes_tiled: torch.Tensor,
                                  tables: torch.Tensor) -> torch.Tensor:
    """Plain torch version of ``estimate_scan_tiled`` (same arguments,
    same result on any device).

    Per chunk of queries (``REFERENCE_ESTIMATES_PER_CHUNK`` entries of
    the output at a time) it adds the looked-up table entries in int32,
    or f32 for float tables, in logical block order (the kernel's
    order, so float sums agree bit for bit). Calls on CUDA tensors add
    one to ``estimate_scan_tiled_reference.cuda_calls``.
    """
    _check_estimate_args(codes_tiled, tables)
    if tables.device.type == "cuda":
        estimate_scan_tiled_reference.cuda_calls += 1
    Q, B, _ = tables.shape
    T, Bs_pad, _ = codes_tiled.shape
    N = T * LANE_TILE
    acc_dtype = torch.int32 if tables.dtype == torch.int8 else torch.float32
    # (Q, 16, B_pad): [q, v, s] is value v of storage block s
    tsel = permute_tables_csr(tables.reshape(Q, 16 * B), B).to(
        acc_dtype).reshape(Q, 16, 2 * Bs_pad)
    codes = codes_tiled.permute(1, 0, 2).reshape(Bs_pad, N)
    out = torch.empty((Q, N), dtype=acc_dtype, device=tables.device)
    step = max(1, REFERENCE_ESTIMATES_PER_CHUNK // max(N, 1))
    for q0 in range(0, Q, step):
        tb = tsel[q0:q0 + step]
        est = torch.zeros((tb.shape[0], N), dtype=acc_dtype,
                          device=tables.device)
        for sb in range(Bs_pad):                      # blocks 2sb, 2sb + 1
            byte = codes[sb].long()
            est += tb[:, :, sb][:, byte & 15]
            est += tb[:, :, Bs_pad + sb][:, byte >> 4]
        out[q0:q0 + step] = est
    return out


estimate_scan_tiled_reference.cuda_calls = 0


# -------------------------------------------------- fold_topk_tiled (K1)


def fold_topk_tiled(codes_tiled: torch.Tensor, tables: torch.Tensor,
                    true_n: int, rescore: int):
    """Full scan + approximate top-``rescore`` candidates through K1.

    Runs ``scan_fold_csr`` over the whole corpus, cut into pseudo-lists
    sized to the int32 encoding's headroom with the int8 tables
    [Q, B, 16] broadcast to each, so the (Q, n) estimate matrix is never
    written: only the (Q, lists * S) fold pool is. The fold's position
    classes are the approximation (a class keeps only its best point;
    S is ~8x rescore), as in the JAX package; where the JAX package
    picks from the pool with ``approx_max_k``, this picks the exact
    ``smallest_k``. Returns ``(rows int32[Q, rescore], valid
    bool[Q, rescore])``, rows of the code matrix (0 where not valid).
    """
    T, Bs_pad, _ = codes_tiled.shape
    Q, B, _ = tables.shape
    B_pad = 2 * Bs_pad
    if tables.dtype != torch.int8:
        raise TypeError("fold_topk_tiled needs int8 tables")
    if not 1 <= true_n <= T * LANE_TILE:
        raise ValueError(f"true_n={true_n} outside the {T} code tiles")
    dev = tables.device
    # largest pseudo-list (in tiles) whose positions fit the encoding
    bits = 1
    while (255 * B_pad + 1) << (bits + 1) <= 2**31 - 1:
        bits += 1
    seg_tiles = min(T, max(1, (1 << bits) // LANE_TILE))
    C = -(-T // seg_tiles)
    toff = torch.arange(C, dtype=torch.int64, device=dev) * seg_tiles
    counts = (true_n - toff * LANE_TILE).clamp(0, seg_tiles * LANE_TILE)
    W = max(1, min(seg_tiles, -(-8 * rescore // LANE_TILE)))
    tsel = permute_tables_csr(tables.reshape(Q, 16 * B), B)
    tsel_b = tsel[None].expand(C, Q, tsel.shape[1]).contiguous()
    enc = scan_fold_csr(tsel_b, codes_tiled, toff.to(torch.int32),
                        counts.to(torch.int32), fold_tiles=W,
                        max_tiles=seg_tiles, n_blocks=B)  # (C, Q, S)
    S = enc.shape[2]
    pool = enc.permute(1, 0, 2).reshape(Q, C * S)
    if C * S < rescore:                               # tiny corpus
        pool = torch.nn.functional.pad(pool, (0, rescore - C * S),
                                       value=ENC_INVALID)
    enc_sel, idx = smallest_k(pool, rescore)
    col_bits = max(1, (seg_tiles * LANE_TILE - 1).bit_length())
    pos = enc_sel & ((1 << col_bits) - 1)
    rows = (idx // S) * (seg_tiles * LANE_TILE) + pos
    valid = enc_sel < ENC_INVALID
    return torch.where(valid, rows, 0).to(torch.int32), valid
