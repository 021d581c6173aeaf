from .kernels import (
    LANE_TILE,
    pack_codes_tiled,
    permute_tables_csr,
    scan_fold_csr,
    scan_fold_csr_reference,
)
from .kmeans import blockwise_kmeans, kmeans_fit
from .packing import pack_codes, unpack_codes
from .quantization import (
    QuantizedTables,
    block_dists_blocked,
    quantize_tables_signed,
    quantize_tables_unsigned,
    tables_bf16,
)
from .topk import dedup_candidates, smallest_k

__all__ = [
    "LANE_TILE", "pack_codes_tiled", "permute_tables_csr", "scan_fold_csr",
    "scan_fold_csr_reference", "blockwise_kmeans", "kmeans_fit",
    "pack_codes", "unpack_codes", "QuantizedTables", "block_dists_blocked",
    "quantize_tables_signed", "quantize_tables_unsigned", "tables_bf16",
    "dedup_candidates", "smallest_k",
]
