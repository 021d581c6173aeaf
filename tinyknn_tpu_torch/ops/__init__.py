from .kernels import (
    LANE_TILE,
    estimate_scan_tiled,
    estimate_scan_tiled_reference,
    fold_topk_tiled,
    pack_codes_tiled,
    permute_tables_csr,
    scan_exact_csr,
    scan_exact_csr_reference,
    scan_fold_csr,
    scan_fold_csr_reference,
    tile_codes,
)
from .kmeans import blockwise_kmeans, kmeans_fit
from .packing import pack_codes, unpack_codes
from .quantization import (
    QuantizedTables,
    block_dists_blocked,
    dequantize_estimates,
    quantize_tables_signed,
    quantize_tables_unsigned,
    tables_bf16,
)
from .scan import estimate_scan
from .topk import (
    dedup_candidates,
    masked_smallest_k,
    merge_topk,
    smallest_k,
    streaming_topk_init,
)

__all__ = [
    "LANE_TILE", "estimate_scan_tiled", "estimate_scan_tiled_reference",
    "fold_topk_tiled", "pack_codes_tiled", "permute_tables_csr",
    "scan_exact_csr", "scan_exact_csr_reference", "scan_fold_csr",
    "scan_fold_csr_reference", "tile_codes", "blockwise_kmeans",
    "kmeans_fit", "pack_codes", "unpack_codes", "QuantizedTables",
    "block_dists_blocked", "dequantize_estimates", "quantize_tables_signed",
    "quantize_tables_unsigned", "tables_bf16", "estimate_scan",
    "dedup_candidates", "masked_smallest_k", "merge_topk", "smallest_k",
    "streaming_topk_init",
]
