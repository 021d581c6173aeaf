"""The plain reference against NumPy and against the program on the
CPU, and the fit that it takes from the program, checked by itself."""

import numpy as np
import pytest
import torch

from gpubench.data import make_clustered
from gpubench.reference import ivf as ref


def test_truth_equals_a_numpy_f64_brute_force():
    data, queries = make_clustered(5000, 100, 40, seed=3)
    X = ref.normalize(torch.from_numpy(data))
    Q = ref.normalize(torch.from_numpy(queries))
    got = ref.truth(X, Q, 10, chunk=16).numpy()
    x, q = X.double().numpy(), Q.double().numpy()
    d = ((q[:, None, :] - x[None]) ** 2).sum(-1)
    want = np.argsort(d, axis=1, kind="stable")[:, :10]
    np.testing.assert_array_equal(got, want)


def test_the_control_rounds_to_tf32_and_fp8():
    x = torch.tensor([1.0 + 2.0 ** -12, 0.1])
    low = ref.Precision(lower=True)
    assert low.mm(x)[0] == 1.0 and ref.Precision().mm(x)[0] != 1.0
    assert low.vec(torch.tensor([0.1])).item() == 0.1015625


def test_the_programs_fit_is_a_k_means_fit():
    from tinyknn_tpu_torch import IVF, FastPQ
    data, _ = make_clustered(30000, 100, 10, seed=4)
    X = torch.from_numpy(data)
    ivf = IVF("angular", 96, FastPQ(2, device="cpu"), device="cpu").fit(X)
    x = ref.normalize(X)
    own = ref.normalize(ref.kmeans(x, 96, torch.Generator().manual_seed(0)))
    ratio = (ref.kmeans_inertia(x, ivf.all_centers)
             / ref.kmeans_inertia(x, own))
    assert 0.9 < ratio < 1.05
    codes = ref.encode(x, ivf.pq.center_blocks, ref.Precision())
    # the codebooks are each block's k-means of its column: every code
    # value is used and no codebook entry lies far from its points
    assert codes.unique().numel() == 16


def test_pad_blocks_pads_and_never_crops():
    assert ref.pad_blocks(torch.ones(3, 100), 56, 2).shape == (3, 56, 2)
    with pytest.raises(ValueError, match="project"):
        ref.pad_blocks(torch.ones(3, 128), 32, 2)
