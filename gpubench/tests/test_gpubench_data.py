"""The benchmark's frozen data, traffic and work counts."""

import numpy as np
import pytest
import torch

from gpubench.data import make_clustered
from gpubench.work import scan_exact_csr, scan_fold_csr
from gpubench.work.peaks import HBM_BYTES_PER_S, OPS_PER_S


@pytest.mark.parametrize("seed", [10, 2**31 + 7])
def test_generator_copy_equals_the_programs(seed):
    from tinyknn_tpu_torch.utils import make_clustered as program
    for a, b in zip(make_clustered(3000, 100, 50, seed),
                    program(3000, 100, 50, seed)):
        np.testing.assert_array_equal(a, b)


def closed_batch():
    from gpubench import core
    return core.part("traffic", "closed_batch")


MIX = {"kind": "closed_batch", "batch": 500, "orders": 3, "mode": "bucket"}


def test_every_batch_is_the_whole_set_in_an_order_of_the_seed():
    kind = closed_batch()
    queries = np.arange(500 * 4, dtype=np.float32).reshape(500, 4)
    p = kind.plan(MIX, 2**31 + 11, 1.0, queries, 10)
    assert len(p.batches) == 3
    for rows, batch in zip(p.rows, p.batches):
        assert sorted(rows.tolist()) == list(range(500))
        np.testing.assert_array_equal(batch, queries[rows])
    assert not np.array_equal(p.rows[0], p.rows[1])
    again = kind.plan(MIX, 2**31 + 11, 1.0, queries, 10)
    assert all(np.array_equal(a, b) for a, b in zip(p.rows, again.rows))


def test_the_loop_keeps_each_distinct_answer_once_with_its_rows():
    import contextlib
    kind = closed_batch()
    queries = np.random.default_rng(0).standard_normal((50, 4)).astype(
        np.float32)
    p = kind.plan(dict(MIX, batch=50), 3, 0.05, queries, 2)

    def query(q, mode):          # an answer that depends on the query only
        return torch.from_numpy(np.round(q[:, :2] * 1000).astype(np.int64))
    out = kind.serve(query, p, 0.05, lambda name: contextlib.nullcontext())
    assert out.attempted >= 3 and len(out.ids) == 3
    assert sum(w[0] for w in out.weights) == out.attempted == len(out.calls)
    for rows, ids in zip(out.rows, out.ids):
        np.testing.assert_array_equal(
            ids, np.round(queries[rows, :2] * 1000).astype(np.int64))


class View:
    # two lists of 100 and 300 points; query 0 probes both, query 1 the
    # second twice over (the count is per probe pair)
    counts = torch.tensor([100, 300, 7])
    probes = torch.tensor([[0, 1], [1, 1]])
    dim = 100
    code_dim = 100
    dims_per_block = 2
    pass_1 = 20


def test_k1_work_of_a_hand_made_batch():
    seconds, bound = scan_fold_csr.least_seconds(View)
    # codes of the two probed lists once (25 bytes: 50 blocks), int8
    # tables of 2 queries, 20 int32 candidates per pair
    moved = 400 * 25 + 2 * 16 * 50 + 4 * 20 * 4
    ops = 2 * 16 * 50 * (100 + 300 + 300 + 300)
    assert seconds == max(moved / HBM_BYTES_PER_S, ops / OPS_PER_S["int8"])
    assert bound == "bytes"


def test_k2_work_of_a_hand_made_batch():
    seconds, bound = scan_exact_csr.least_seconds(View)
    moved = 400 * 103 * 2 + 2 * 103 * 2 + 4 * 20 * 4
    ops = 2 * 103 * 1000
    assert seconds == max(moved / HBM_BYTES_PER_S, ops / OPS_PER_S["bf16"])
    assert bound == "bytes"
