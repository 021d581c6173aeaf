"""The list-scan kernel and the layouts around it (counterpart of
tinyknn_tpu/ops/kernels.py).

``scan_fold_csr`` is the IVF inner loop: for every (list, query slot)
it scans the list's nibble-packed code tiles against the query's
distance tables and min-folds the encoded estimates into a fixed-width
buffer. On a CUDA tensor it launches the hand-written kernel
``csrc/scan_fold_csr.cu`` (built on first use, see ``_build``); on a
CPU tensor it runs ``scan_fold_csr_reference``, the plain torch version
of the same function. There is no fallback from one to the other.

Layouts (identical to the JAX package's, so its archives load as is):
  * code tiles ``uint8[T, Bs_pad, 128]``: points on the last axis,
    packed bytes (two 4-bit blocks each) on the middle one, padded to a
    multiple of 8 bytes;
  * tables ``[..., 16 * B_pad]`` with B_pad = 2 * Bs_pad: value v of
    storage block s at column ``v * B_pad + s``, storage order being the
    even blocks (low nibbles) then the odd blocks (high nibbles); the
    phantom pad blocks have zero rows.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from ..utils.padding import round_up

LANE_TILE = 128
ENC_INVALID = 2**31 - 1  # empty-slot sentinel of the encoded fold domain
REFERENCE_LISTS_PER_CHUNK = 64  # lists the plain version scans at once


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
    perm = torch.cat([torch.arange(0, B_pad, 2), torch.arange(1, B_pad, 2)])
    shape = tables_flat.shape[:-1]
    t = tables_flat.reshape(shape + (B, 16))
    if B_pad != B:
        t = torch.nn.functional.pad(t, (0, 0, 0, B_pad - B))
    t = t[..., perm.to(t.device), :]
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


def _check_args(tables_sel, codes_tiled, tile_offsets, counts, fold_tiles,
                max_tiles):
    C, qc, M = tables_sel.shape
    T, Bs_pad, lanes = codes_tiled.shape
    if lanes != LANE_TILE or M != 32 * Bs_pad:
        raise ValueError(f"tables (..., {M}) do not match code tiles "
                         f"{tuple(codes_tiled.shape)}")
    if codes_tiled.dtype != torch.uint8:
        raise TypeError("code tiles must be uint8")
    for name, t in (("tile_offsets", tile_offsets), ("counts", counts)):
        if t.dtype != torch.int32 or t.shape != (C,):
            raise ValueError(f"{name} must be int32[{C}]")
    for t in (codes_tiled, tile_offsets, counts):
        if t.device != tables_sel.device:
            raise ValueError("all inputs must be on one device")
    if fold_tiles < 1 or max_tiles < 1 or T < 1:
        raise ValueError("fold_tiles, max_tiles and the tile count must "
                         "be positive")
    return fold_encoding(tables_sel.dtype, 2 * Bs_pad, max_tiles)


@functools.cache
def _library():
    from . import _build
    lib = _build.build("scan_fold_csr").lib
    vp, i = ctypes.c_void_p, ctypes.c_int
    lib.scan_fold_csr_launch.argtypes = [vp, i, vp, vp, vp, vp, i, i, i,
                                         i, i, i, i, vp]
    lib.scan_fold_csr_launch.restype = i
    lib.scan_fold_csr_error_string.argtypes = [i]
    lib.scan_fold_csr_error_string.restype = ctypes.c_char_p
    return lib


def scan_fold_csr(tables_sel: torch.Tensor, codes_tiled: torch.Tensor,
                  tile_offsets: torch.Tensor, counts: torch.Tensor, *,
                  fold_tiles: int, max_tiles: int) -> torch.Tensor:
    """Ragged scan over CSR-tiled lists, emitting the encoded fold.

    tables_sel: int8 or bf16 [C, qc, 16 * B_pad], list c's query slots
    (permute_tables_csr layout); codes_tiled: uint8[T, B_pad / 2, 128];
    tile_offsets, counts: int32[C]. Returns enc int32[C, qc, S] with
    S = fold_tiles * 128: entry [c, q, j] is the minimum encoding (see
    ``fold_encoding``) over list c's positions p < min(counts[c],
    max_tiles * 128) with (p // 128 mod fold_tiles) * 128 + p % 128 = j,
    or 2^31 - 1 where there is none.

    Where the JAX kernel takes csr_scan_map's four step maps, this one
    takes ``tile_offsets``: each CUDA block finds its own tiles.

    CUDA tensors launch the kernel (and add one to
    ``scan_fold_csr.launches``); CPU tensors run the plain version.
    """
    col_bits, enc_bias = _check_args(tables_sel, codes_tiled, tile_offsets,
                                     counts, fold_tiles, max_tiles)
    if tables_sel.device.type == "cpu":
        return scan_fold_csr_reference(tables_sel, codes_tiled, tile_offsets,
                                       counts, fold_tiles=fold_tiles,
                                       max_tiles=max_tiles)
    if tables_sel.device.type != "cuda":
        raise ValueError(f"no scan_fold_csr for {tables_sel.device}")
    for t in (tables_sel, codes_tiled, tile_offsets, counts):
        if not t.is_contiguous():
            raise ValueError("scan_fold_csr needs contiguous inputs")
    C, qc, _ = tables_sel.shape
    Bs_pad = codes_tiled.shape[1]
    bf16 = int(tables_sel.dtype == torch.bfloat16)
    lib = _library()
    enc = torch.empty((C, qc, fold_tiles * LANE_TILE), dtype=torch.int32,
                      device=tables_sel.device)
    if enc.numel() == 0:
        return enc
    stream = torch.cuda.current_stream(tables_sel.device).cuda_stream
    err = lib.scan_fold_csr_launch(
        tables_sel.data_ptr(), bf16, codes_tiled.data_ptr(),
        tile_offsets.data_ptr(), counts.data_ptr(), enc.data_ptr(), C, qc,
        Bs_pad, fold_tiles, max_tiles, col_bits, enc_bias, stream)
    if err:
        raise RuntimeError("scan_fold_csr launch failed: "
                           + lib.scan_fold_csr_error_string(err).decode())
    scan_fold_csr.launches += 1
    return enc


scan_fold_csr.launches = 0


def scan_fold_csr_reference(tables_sel: torch.Tensor,
                            codes_tiled: torch.Tensor,
                            tile_offsets: torch.Tensor, counts: torch.Tensor,
                            *, fold_tiles: int,
                            max_tiles: int) -> torch.Tensor:
    """Plain torch version of ``scan_fold_csr`` (same arguments, same
    result on any device).

    Per chunk of lists it gathers ``max_tiles`` tiles densely, sums the
    table entries in int32 (f32 for bf16 tables) in logical block order
    (the kernel's order, so bf16 sums agree bit for bit), encodes, masks
    positions past each list's end, and min-folds tile ti into segment
    ti mod fold_tiles. Calls on CUDA tensors add one to
    ``scan_fold_csr_reference.cuda_calls``.
    """
    col_bits, enc_bias = _check_args(tables_sel, codes_tiled, tile_offsets,
                                     counts, fold_tiles, max_tiles)
    if tables_sel.device.type == "cuda":
        scan_fold_csr_reference.cuda_calls += 1
    dev = tables_sel.device
    C, qc, M = tables_sel.shape
    T, Bs_pad, _ = codes_tiled.shape
    W = fold_tiles
    S = W * LANE_TILE
    L = max_tiles * LANE_TILE
    L_pad = round_up(max_tiles, W) * LANE_TILE
    floating = tables_sel.dtype != torch.int8
    acc_dtype = torch.float32 if floating else torch.int32
    # (C, qc, 16, B_pad): [..., v, s] is value v of storage block s
    tables = tables_sel.to(acc_dtype).reshape(C, qc, 16, 2 * Bs_pad)
    pos = torch.arange(L, dtype=torch.int32, device=dev)
    out = torch.empty((C, qc, S), dtype=torch.int32, device=dev)
    tile_idx = torch.arange(max_tiles, dtype=torch.int64, device=dev)
    for c0 in range(0, C, REFERENCE_LISTS_PER_CHUNK):
        c1 = min(C, c0 + REFERENCE_LISTS_PER_CHUNK)
        n = c1 - c0
        tiles = (tile_offsets[c0:c1, None].long() + tile_idx).clamp(max=T - 1)
        codes = codes_tiled[tiles]                    # (n, mt, Bs_pad, 128)
        codes = codes.permute(0, 2, 1, 3).reshape(n, Bs_pad, L).long()
        lo, hi = codes & 15, codes >> 4
        tb = tables[c0:c1]
        est = torch.zeros((n, qc, L), dtype=acc_dtype, device=dev)
        for sb in range(Bs_pad):                      # blocks 2sb, 2sb + 1
            est += torch.gather(tb[:, :, :, sb], 2,
                                lo[:, None, sb].expand(n, qc, L))
            est += torch.gather(tb[:, :, :, Bs_pad + sb], 2,
                                hi[:, None, sb].expand(n, qc, L))
        if floating:
            bits = est.to(torch.bfloat16).view(torch.int16).to(torch.int32)
            val = bits << 16
        else:
            val = (est + enc_bias) << col_bits
        enc = torch.where(pos < counts[c0:c1, None, None], val | pos,
                          ENC_INVALID)
        enc = torch.nn.functional.pad(enc, (0, L_pad - L), value=ENC_INVALID)
        out[c0:c1] = enc.reshape(n, qc, L_pad // S, S).amin(dim=2)
    return out


scan_fold_csr_reference.cuda_calls = 0
