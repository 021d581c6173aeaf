"""Exact (brute-force) distance math (counterpart of
tinyknn_tpu/utils/bruteforce.py): library code and test oracle.

Every matrix product here runs in full fp32. On the card a float32
``matmul`` may run in TF32, which keeps about three decimal digits and
swaps near-tie neighbours (the JAX package lost three rounds to
bf16-truncated truth), so ``fp32_matmuls()`` switches TF32 off and the
port's computing entry points call it.
"""

from __future__ import annotations

import numpy as np
import torch

from ..ops.topk import smallest_k


def fp32_matmuls():
    """Run float32 matrix products in full fp32 on the card (no TF32).

    Sets PyTorch's process-wide flags; it touches no device."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def _f32_on(device, *xs):
    """``xs`` as float32 tensors on one device: that of the first tensor
    among them, else ``device``, else the card. A NumPy argument is never
    left on the CPU by default: without CUDA it raises."""
    held = [a.device for a in xs if isinstance(a, torch.Tensor)]
    device = held[0] if held else ("cuda" if device is None else device)
    return [torch.as_tensor(a if isinstance(a, torch.Tensor)
                            else np.asarray(a), dtype=torch.float32,
                            device=device) for a in xs]


def sq_dists(X: torch.Tensor, Y: torch.Tensor) -> torch.Tensor:
    """Squared Euclidean distances R[i, j] = ||X_i - Y_j||^2 in fp32,
    as ||x||^2 + ||y||^2 - 2<x, y>."""
    nx = torch.einsum("ij,ij->i", X, X)
    ny = torch.einsum("ij,ij->i", Y, Y)
    return nx[:, None] + ny[None, :] - 2.0 * (X @ Y.T)


def l2_normalize(X: torch.Tensor) -> torch.Tensor:
    return X / torch.linalg.norm(X, dim=-1, keepdim=True)


def knn_brute(X, Y, k: int, metric: str = "euclidean",
              chunk: int = 65536, device=None) -> torch.Tensor:
    """Exact kNN of each row of X among the rows of Y: an (n, k) int64
    index tensor, nearest first, ties to the lower index.

    It runs on the device of X, or of Y when only Y is a tensor; NumPy
    inputs alone go to ``device``, the card when that is None (the
    constructors' default), so a default call on NumPy input raises on a
    machine without CUDA.

    ``chunk`` bounds the live (chunk, m) distance block; it is also
    capped so that block stays near 1 GB.
    """
    if metric not in ("euclidean", "angular"):
        raise ValueError(f"Metric not supported: {metric}")
    if k > Y.shape[0]:
        raise ValueError(f"Can't find knn with {k=} and {Y.shape[0]} "
                         f"targets.")
    fp32_matmuls()
    X, Y = _f32_on(device, X, Y)
    if metric == "angular":
        X = l2_normalize(X)
        Y = l2_normalize(Y)
    m = Y.shape[0]
    budget_rows = max(8, (1 << 28) // max(m, 1))
    chunk = min(chunk, budget_rows - budget_rows % 8 or 8)
    # clone: the k columns are a view of the chunk's whole (chunk, m)
    # sort, which would otherwise stay alive until the end
    out = [smallest_k(sq_dists(X[i:i + chunk], Y), k)[1].clone()
           for i in range(0, X.shape[0], chunk)]
    return torch.cat(out) if out else torch.zeros(
        (0, k), dtype=torch.int64, device=X.device)


def cdist(X, Y, chunk: int | None = None, device=None) -> torch.Tensor:
    """Squared Euclidean distances (n, m) in fp32, on the device
    ``knn_brute`` picks. ``chunk`` is accepted for API parity and
    ignored."""
    del chunk
    fp32_matmuls()
    return sq_dists(*_f32_on(device, X, Y))


def bottom_k(arr: torch.Tensor, k: int) -> torch.Tensor:
    """Indices of the k smallest entries of a 1-D tensor, ascending,
    ties to the lower index; all indices in order when k >= len."""
    if k >= arr.shape[0]:
        return torch.arange(arr.shape[0], device=arr.device)
    return smallest_k(arr, k)[1]


def bottom_k_2d(arr: torch.Tensor, k: int) -> torch.Tensor:
    """Row-wise ``bottom_k`` of a 2-D tensor; when k >= the row length,
    every row gets all indices in order."""
    n, m = arr.shape
    if k >= m:
        return torch.arange(m, device=arr.device).expand(n, m)
    return smallest_k(arr, k)[1]


def knn_brute1(x, Y, k: int, device=None) -> torch.Tensor:
    """Exact kNN of one query (d,) among the rows of Y: ``bottom_k`` of
    the fp32 squared distances, on the device of Y, or of x when only x
    is a tensor, else on ``device`` (the card when None)."""
    Y, x = _f32_on(device, Y, x)
    diff = Y - x
    return bottom_k(torch.einsum("ij,ij->i", diff, diff), k)
