"""Published peaks of one NVIDIA H100 SXM (NVIDIA's data sheet, dense,
at the 700 W power limit)."""

HBM_BYTES_PER_S = 3.35e12
OPS_PER_S = {"int8": 1.979e15, "bf16": 0.989e15}


def least_seconds(moved_bytes: float, ops: float, kind: str):
    """(seconds, "bytes" or "operations"): the larger of the bytes over
    the memory rate and the operations over the peak of ``kind``."""
    t_bytes = moved_bytes / HBM_BYTES_PER_S
    t_ops = ops / OPS_PER_S[kind]
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else
                                 "operations")
