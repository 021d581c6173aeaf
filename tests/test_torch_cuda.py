"""The kernels on the card against their plain torch versions.

Needs a CUDA device and nvcc; skipped elsewhere. On the card:

    python -m pytest tests/test_torch_cuda.py -m cuda --noconftest

(``--noconftest``: tests/conftest.py sets up JAX, which the card
machine need not have.)

K1 ``scan_fold_csr`` (one-hot tensor-core products): int8 tables and
bf16 tables with integer values must give bit-equal fold buffers;
random bf16 tables agree within 1 bf16 ulp (the kernel adds each
product in f32 in the plain version's order, so they are designed
bit-equal too); also with the real block count below the padded one
and at 0, 1, 7, 8, 9 and all occupied slots. K2 ``scan_exact_csr``
(bf16 tensor-core products): bit-equal on integer-valued inputs, within
1 bf16 ulp (positions equal where the values are) on random ones; also
at 0, 1, 7, 8, 9 and all occupied slots, at widths d_aug that are not a
multiple of 16, and at d_aug = 1024, which walks many K chunks. K3
``estimate_scan_tiled``:
bit-equal for int8 and f32 tables, rtol 1e-6 for bf16 tables, at query
counts that are not a multiple of 16, and with 232 blocks, too wide for
the int8 wgmma staging.

The serving surface on the card: the stream and ``rescore_rows`` give
``query()``'s ids through K1/K2; gather mode and the 'xla' engine run
no kernel and no plain kernel version; a warm ``device_out`` stream
call makes no host sync, on either engine.

The rest of the surface on the card: ``estimate_scan(backend="pallas")``
launches K3 and equals 'xla' bit for bit on int8 tables, the saturating
oracle equals its CPU run, ``knn_brute`` on NumPy input runs on the
card, ``utils.block`` waits for it, and an example's ``main`` at a toy
size launches its kernel.

The sharded indexes on the card, on meshes that name the one card
several times (1 shard, 3 shards with a pad list, a 2 x 2 queries x
shards mesh): the kernel arm (K1, K2 or K3 once per shard and round)
against the same query over the plain versions, and a warm sharded
``device_out`` stream call without a host sync.
"""

import pytest
import torch

from chip_smoke import (
    SLOT_COUNT_CASES,
    over_plain,
    compare_estimates,
    compare_fold,
    estimate_case,
    estimate_inputs,
    exact_case,
    exact_inputs,
    fold_case,
    fold_inputs,
    slot_counts_for,
)
from tinyknn_tpu_torch.ops.kernels import (
    estimate_scan_tiled,
    estimate_scan_tiled_reference,
    scan_exact_csr,
    scan_exact_csr_reference,
    scan_fold_csr,
    scan_fold_csr_reference,
)

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


@pytest.mark.parametrize("B, qc", [(8, 20), (56, 32), (56, 40)])
@pytest.mark.parametrize("kind", ["int8", "bf16_int", "bf16"])
@pytest.mark.parametrize("W", [1, 2, 6])
def test_kernel_matches_plain(cuda, W, kind, B, qc):
    t, codes_tiled, toff, counts, max_tiles = fold_inputs(
        *fold_case(W + B, kind, B=B, qc=qc), cuda)
    kw = dict(fold_tiles=W, max_tiles=max_tiles)
    launches = scan_fold_csr.launches
    got = scan_fold_csr(t, codes_tiled, toff, counts, **kw)
    want = scan_fold_csr_reference(t, codes_tiled, toff, counts, **kw)
    torch.cuda.synchronize()
    assert scan_fold_csr.launches == launches + 1
    compare_fold(got, want, kind != "int8", kind != "bf16",
                 t.shape[2] // 16, max_tiles)


@pytest.mark.parametrize("B, qc", [(8, 20), (56, 40)])
@pytest.mark.parametrize("kind", ["int8", "bf16_int", "bf16"])
@pytest.mark.parametrize("s", SLOT_COUNT_CASES)
def test_kernel_slot_counts_match_plain(cuda, s, kind, B, qc):
    t, codes_tiled, toff, counts, max_tiles = fold_inputs(
        *fold_case(3 + B, kind, B=B, qc=qc), cuda)
    kw = dict(fold_tiles=2, max_tiles=max_tiles, n_blocks=B,
              slot_counts=slot_counts_for(s, counts, qc))
    launches = scan_fold_csr.launches
    got = scan_fold_csr(t, codes_tiled, toff, counts, **kw)
    want = scan_fold_csr_reference(t, codes_tiled, toff, counts, **kw)
    torch.cuda.synchronize()
    assert scan_fold_csr.launches == launches + 1
    compare_fold(got, want, kind != "int8", kind != "bf16",
                 t.shape[2] // 16, max_tiles)


def test_kernel_rejects_bad_input(cuda):
    t, codes_tiled, toff, counts, max_tiles = fold_inputs(
        *fold_case(0, "int8"), cuda)
    with pytest.raises(ValueError):
        scan_fold_csr(t[:, :, :-16], codes_tiled, toff, counts,
                      fold_tiles=1, max_tiles=max_tiles)
    with pytest.raises(ValueError):
        scan_fold_csr(t, codes_tiled, toff.cpu(), counts, fold_tiles=1,
                      max_tiles=max_tiles)
    # the kernel stages code rows padded to a multiple of 8 bytes
    with pytest.raises(RuntimeError, match="launch failed"):
        scan_fold_csr(t[:, :, :-128].contiguous(),
                      codes_tiled[:, :-4].contiguous(), toff, counts,
                      fold_tiles=1, max_tiles=max_tiles)


def _hold_exact(cuda, case, exact: bool, **kw):
    """K2 against its plain version on an ``exact_case``: one launch,
    then ``compare_fold``'s rule (bit equality with ``exact``)."""
    *args, max_tiles = exact_inputs(*case, cuda)
    kw["max_tiles"] = max_tiles
    if "slot_counts" in kw:
        kw["slot_counts"] = slot_counts_for(kw["slot_counts"], args[3],
                                            args[0].shape[1])
    launches = scan_exact_csr.launches
    got = scan_exact_csr(*args, **kw)
    want = scan_exact_csr_reference(*args, **kw)
    torch.cuda.synchronize()
    assert scan_exact_csr.launches == launches + 1
    compare_fold(got, want, True, exact, 0, max_tiles)


@pytest.mark.parametrize("d, qc", [(12, 20), (100, 40), (30, 8)])
@pytest.mark.parametrize("kind", ["int", "random"])
@pytest.mark.parametrize("W", [1, 2, 6])
def test_exact_kernel_matches_plain(cuda, W, kind, d, qc):
    _hold_exact(cuda, exact_case(W + d, kind, d=d, qc=qc), kind == "int",
                fold_tiles=W)


@pytest.mark.parametrize("d, qc", [(12, 20), (100, 40)])
@pytest.mark.parametrize("kind", ["int", "random"])
@pytest.mark.parametrize("s", SLOT_COUNT_CASES)
def test_exact_kernel_slot_counts_match_plain(cuda, s, kind, d, qc):
    _hold_exact(cuda, exact_case(5 + d, kind, d=d, qc=qc), kind == "int",
                fold_tiles=2, slot_counts=s)


@pytest.mark.parametrize("d_aug", [48, 40, 45])
@pytest.mark.parametrize("kind", ["int", "random"])
@pytest.mark.parametrize("W", [1, 6])
def test_exact_kernel_any_width(cuda, W, kind, d_aug):
    """Widths that are a multiple of 16 (48), of 8 only (40; zero pad
    rows in the kernel) and of neither (45; 2-byte query staging)."""
    _hold_exact(cuda, exact_case(W + d_aug, kind, d=30, qc=20, d_aug=d_aug),
                kind == "int", fold_tiles=W)


@pytest.mark.parametrize("kind", ["int", "random"])
def test_exact_kernel_wide_vectors(cuda, kind):
    """d_aug = 1024 walks 32 K chunks of the vector tiles with the same
    kernel; 40 slots take two slot blocks."""
    _hold_exact(cuda, exact_case(7, kind, n=600, d=1000, qc=40, d_aug=1024),
                kind == "int", fold_tiles=2, slot_counts=33)


def test_exact_kernel_rejects_bad_input(cuda):
    q_sel, vecs, toff, counts, max_tiles = exact_inputs(
        *exact_case(0, "int"), cuda)
    with pytest.raises(ValueError):
        scan_exact_csr(q_sel[:, :, :-1], vecs, toff, counts, fold_tiles=1,
                       max_tiles=max_tiles)
    with pytest.raises(ValueError):
        scan_exact_csr(q_sel, vecs, toff.cpu(), counts, fold_tiles=1,
                       max_tiles=max_tiles)
    with pytest.raises(ValueError):
        scan_exact_csr(q_sel[:, ::2], vecs, toff, counts, fold_tiles=1,
                       max_tiles=max_tiles)           # not contiguous
    for sc in (counts.long(), counts[:2], counts.cpu()):
        with pytest.raises(ValueError):
            scan_exact_csr(q_sel, vecs, toff, counts, fold_tiles=1,
                           max_tiles=max_tiles, slot_counts=sc)
    with pytest.raises(ValueError):                   # not contiguous
        scan_exact_csr(q_sel, vecs, toff, counts, fold_tiles=1,
                       max_tiles=max_tiles,
                       slot_counts=torch.stack([counts, counts], 1)[:, 0])


@pytest.mark.parametrize("n, B, Q", [(1000, 8, 20), (300, 56, 9),
                                     (700, 50, 23), (5000, 64, 45),
                                     (300, 232, 9)])
@pytest.mark.parametrize("kind", ["int8", "bf16", "f32"])
def test_estimate_kernel_matches_plain(cuda, kind, n, B, Q):
    codes_tiled, t = estimate_inputs(*estimate_case(n + B, kind, n=n, B=B,
                                                    Q=Q), kind, cuda)
    launches = estimate_scan_tiled.launches
    got = estimate_scan_tiled(codes_tiled, t)
    want = estimate_scan_tiled_reference(codes_tiled, t)
    torch.cuda.synchronize()
    assert estimate_scan_tiled.launches == launches + 1
    compare_estimates(got, want, kind != "int8", kind != "bf16")


def test_estimate_kernel_rejects_bad_input(cuda):
    codes_tiled, t = estimate_inputs(*estimate_case(0, "int8"), "int8", cuda)
    with pytest.raises(ValueError):
        estimate_scan_tiled(codes_tiled, t[:, :7])
    with pytest.raises(ValueError):
        estimate_scan_tiled(codes_tiled.cpu(), t)
    with pytest.raises(TypeError):
        estimate_scan_tiled(codes_tiled, t.double())


# ------------------------------------------------- serving surface


def _cuda_index(cuda, scan_impl="auto", bp=2, metric="angular"):
    from tinyknn_tpu_torch import IVF, FastPQ, make_clustered
    X, qs = make_clustered(3000, 16, 128, seed=41)
    ivf = IVF(metric, 24, FastPQ(2, device=cuda), scan_impl=scan_impl,
              device=cuda).fit(X).build(X, n_probes=bp)
    return ivf, torch.as_tensor(qs, device=cuda)


def _plain_calls():
    return (scan_fold_csr_reference.cuda_calls,
            scan_exact_csr_reference.cuda_calls,
            estimate_scan_tiled_reference.cuda_calls)


@pytest.mark.parametrize("scan_impl", ["fused", "exact"])
def test_stream_and_rescore_rows_match_query(cuda, scan_impl):
    """On the card the stream's batches and the rescore_rows path give
    query()'s ids, through K1 or K2 and never a plain version."""
    ivf, qs = _cuda_index(cuda, scan_impl)
    kernel = scan_exact_csr if scan_impl == "exact" else scan_fold_csr
    plain, launches = _plain_calls(), kernel.launches
    want, st = ivf.query(qs, k=8, n_probes=1, mode="bucket", with_stats=True)
    stream = torch.stack([qs, qs])
    got, sst = ivf.query_stream(stream, k=8, n_probes=1, with_stats=True)
    assert st["dropped_probe_pairs"] == sst["dropped_probe_pairs"] == 0
    if scan_impl == "fused":     # exact fold widths follow the capacities
        assert torch.equal(got[0], want) and torch.equal(got[1], want)
    for P in (1, 3):
        ivf.set_rescore_rows(False)
        off = ivf.query(qs, k=8, n_probes=P, mode="bucket")
        ivf.set_rescore_rows(True)
        assert torch.equal(ivf.query(qs, k=8, n_probes=P, mode="bucket"), off)
    assert kernel.launches > launches and _plain_calls() == plain


@pytest.mark.parametrize("scan_impl, table_dtype",
                         [("fused", "int8"), ("fused", "bf16"),
                          ("exact", "int8")])
def test_overflow_grid_answers_as_the_caps_do(cuda, scan_impl, table_dtype):
    """On the card a batch that overflows its buckets by less than a
    bucket in both rounds answers in one pass: each round launches its
    kernel twice (its buckets, its overflow grid) and no plain version,
    and the ids are those of the same batch at the can't-drop caps."""
    import numpy as np
    from tinyknn_tpu_torch.models import ivf as ivf_module
    from tinyknn_tpu_torch.utils import timing
    ivf, qs = _cuda_index(cuda, scan_impl, bp=1)
    ivf.pq.table_dtype = table_dtype
    rng = np.random.default_rng(0)
    near = ivf.data[5].cpu().numpy() + 0.01 * rng.standard_normal(
        (50, qs.shape[1]))
    qb = torch.cat([qs, torch.as_tensor(near, dtype=torch.float32,
                                        device=cuda)])
    kernel = scan_exact_csr if scan_impl == "exact" else scan_fold_csr
    before, plain, launches = (dict(timing.counters), _plain_calls(),
                               kernel.launches)
    ids, st = ivf.query(qb, k=8, n_probes=3, mode="bucket", with_stats=True)
    delta = {k: timing.counters[k] - before[k] for k in before}
    assert delta["query.attempts"] == 1 and st["dropped_probe_pairs"] == 0
    assert delta["query.rescued_pairs"] > 0
    assert kernel.launches - launches == 4 and _plain_calls() == plain
    k, P, p1, r, r_tail, qc, qc0 = ivf_module._query_params(ivf, len(qb),
                                                            8, 3, None)
    caps = ivf_module._qc_caps(ivf, len(qb), P, r, r_tail, qc, qc0)
    want, drops = ivf._bucket_query(qb, (k, P, p1, r, r_tail, *caps),
                                    ivf._scan_engine())
    assert int(drops) == 0 and torch.equal(ids, want)


@pytest.mark.parametrize("scan_impl", ["fused", "xla", "exact"])
def test_gather_and_xla_run_no_plain_kernel(cuda, scan_impl):
    """Gather mode and the 'xla' engine are plain torch by design: on
    CUDA tensors they launch no kernel and no plain kernel version."""
    ivf, qs = _cuda_index(cuda, scan_impl)
    counts = (scan_fold_csr.launches, scan_exact_csr.launches,
              estimate_scan_tiled.launches)
    plain = _plain_calls()
    ids, st = ivf.query(qs[:16], k=8, n_probes=3, mode="gather",
                        with_stats=True)
    assert st["mode"] == "gather" and ids.device.type == "cuda"
    if scan_impl == "xla":
        ids = ivf.query(qs, k=8, n_probes=3, mode="bucket")
        assert ids.device.type == "cuda" and (ids >= 0).all()
    assert (scan_fold_csr.launches, scan_exact_csr.launches,
            estimate_scan_tiled.launches) == counts
    assert _plain_calls() == plain


def test_device_out_stream_never_syncs(cuda):
    """With the floors cached, a device_out stream call waits for
    nothing on the host."""
    ivf, qs = _cuda_index(cuda)
    stream = torch.stack([qs, qs + 1e-6])
    ivf.query_stream(stream, k=8, n_probes=2)          # measures the floors
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        out, dropped = ivf.query_stream(stream, k=8, n_probes=2,
                                        device_out=True)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    assert out.device.type == "cuda" and out.dtype == torch.int32
    assert dropped.device.type == "cuda" and int(dropped) == 0


def test_exact_device_out_stream_never_syncs(cuda):
    """The exact engine's stream counts K2's slot counts on the device:
    a warm device_out call waits for nothing on the host."""
    ivf, qs = _cuda_index(cuda, "exact")
    stream = torch.stack([qs, qs + 1e-6])
    ivf.query_stream(stream, k=8, n_probes=2)          # measures the floors
    torch.cuda.synchronize()
    launches = scan_exact_csr.launches
    torch.cuda.set_sync_debug_mode("error")
    try:
        out, dropped = ivf.query_stream(stream, k=8, n_probes=2,
                                        device_out=True)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    assert out.device.type == "cuda" and int(dropped) == 0
    assert scan_exact_csr.launches > launches


# ------------------------------------------------- sharded indexes

SHARDED_MESHES = {"S=1": (1, None), "S=3": (3, None), "2x2": ((2, 2),
                                                              "queries")}


def _sharded_index(cuda, mesh_name, scan_impl="auto", bp=2):
    """A ShardedIVF of 23 lists over logical shards of the one card (3
    shards: 8 lists each, one of them a pad list) and 128 queries."""
    from tinyknn_tpu_torch import FastPQ, make_clustered
    from tinyknn_tpu_torch.parallel import ShardedIVF, make_mesh, make_mesh_2d
    shape, query_axis = SHARDED_MESHES[mesh_name]
    mesh = (make_mesh(devices=[cuda] * shape) if query_axis is None
            else make_mesh_2d(shape, devices=[cuda] * 4))
    X, qs = make_clustered(3000, 16, 128, seed=41)
    sivf = ShardedIVF("angular", 23, FastPQ(2, device=cuda), mesh=mesh,
                      query_axis=query_axis, scan_impl=scan_impl)
    sivf.fit(X).build(X, n_probes=bp)
    return sivf, torch.as_tensor(qs, device=cuda)


@pytest.mark.parametrize("scan_impl", ["fused", "exact"])
@pytest.mark.parametrize("mesh_name", list(SHARDED_MESHES))
def test_sharded_kernel_arm_matches_plain_arm(cuda, mesh_name, scan_impl):
    """A sharded query through K1 (K2) against the same query over the
    plain version: one launch per mesh position and scan round and no
    plain call in the kernel arm; equal ids for int8 tables, and for the
    exact engine (decoded distances within 1 bf16 ulp) an overlap of at
    least 0.99."""
    import tinyknn_tpu_torch.models.ivf as ivf_module
    sivf, qs = _sharded_index(cuda, mesh_name, scan_impl)
    kernel, plain, name = (
        (scan_exact_csr, scan_exact_csr_reference, "scan_exact_csr")
        if scan_impl == "exact"
        else (scan_fold_csr, scan_fold_csr_reference, "scan_fold_csr"))
    sivf.queries_per_cluster = 128        # one attempt: counts are exact
    positions = sum(len(row) for row in sivf._grid)
    for P in (1, 3):
        launches, plain_calls = kernel.launches, _plain_calls()
        got, st = sivf.query(qs, k=8, n_probes=P, with_stats=True)
        assert st["dropped_probe_pairs"] == 0
        assert kernel.launches - launches == positions * min(P, 2)
        assert _plain_calls() == plain_calls
        before = plain.cuda_calls
        want = over_plain(ivf_module, name, plain,
                          lambda: sivf.query(qs, k=8, n_probes=P))
        assert plain.cuda_calls - before == positions * min(P, 2)
        if scan_impl == "fused":
            assert torch.equal(got, want)
        else:
            same = [len(set(a) & set(b)) / 8
                    for a, b in zip(got.tolist(), want.tolist())]
            assert sum(same) / len(same) >= 0.99
    stream = torch.stack([qs, qs])
    out = sivf.query_stream(stream, k=8, n_probes=3)
    assert torch.equal(out[0], got) and torch.equal(out[1], got)


def test_sharded_fastpq_kernel_arm_matches_plain_arm(cuda):
    """ShardedFastPQ.search launches K3 once per shard and answers like
    the same search over the plain version (int8: bit-equal estimates)."""
    import tinyknn_tpu_torch.ops.scan as scan_module
    from tinyknn_tpu_torch import FastPQ, make_clustered
    from tinyknn_tpu_torch.parallel import ShardedFastPQ, make_mesh
    X, qs = make_clustered(3001, 16, 50, seed=42)
    spq = ShardedFastPQ(FastPQ(2, device=cuda),
                        mesh=make_mesh(devices=[cuda] * 3)).fit(X).build(X)
    launches, plain_calls = estimate_scan_tiled.launches, _plain_calls()
    got = spq.search(qs, k=7)
    assert estimate_scan_tiled.launches - launches == 3
    assert _plain_calls() == plain_calls
    want = over_plain(scan_module, "estimate_scan_tiled",
                      estimate_scan_tiled_reference,
                      lambda: spq.search(qs, k=7))
    assert estimate_scan_tiled_reference.cuda_calls == plain_calls[2] + 3
    assert torch.equal(got, want)
    assert got.device.type == "cuda"
    assert ((got >= 0) & (got < 3001)).all()


def test_sharded_device_out_stream_never_syncs(cuda):
    """With the floors cached, a sharded device_out stream call waits for
    nothing on the host: the shards' drops are added on the device."""
    sivf, qs = _sharded_index(cuda, "2x2")
    stream = torch.stack([qs, qs + 1e-6])
    host = sivf.query_stream(stream, k=8, n_probes=2)  # measures the floors
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        out, dropped = sivf.query_stream(stream, k=8, n_probes=2,
                                         device_out=True)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    assert out.device.type == "cuda" and out.dtype == torch.int32
    assert torch.equal(out, host) and int(dropped) == 0


def test_lloyd_step_dp_on_the_card(cuda):
    """Four logical shards against one: the same centers (atol 1e-5; the
    sums are atomics, so their order varies) and inertia (rtol 1e-5)."""
    from tinyknn_tpu_torch import make_clustered
    from tinyknn_tpu_torch.parallel import lloyd_step_dp, make_mesh
    X, _ = make_clustered(4096, 16, 4, seed=43)
    c4, i4 = lloyd_step_dp(X, X[:20], make_mesh(devices=[cuda] * 4))
    c1, i1 = lloyd_step_dp(X, X[:20], make_mesh(devices=[cuda]))
    assert c4.device.type == "cuda"
    torch.testing.assert_close(c4, c1, atol=1e-5, rtol=0)
    torch.testing.assert_close(i4, i1, rtol=1e-5, atol=0)


def test_scan_backends_on_the_card(cuda):
    import numpy as np
    from tinyknn_tpu_torch import ops
    rng = np.random.default_rng(5)
    codes = torch.as_tensor(rng.integers(0, 16, (700, 10), dtype=np.uint8))
    tables = torch.as_tensor(rng.integers(-128, 128, (9, 10, 16)).astype(
        np.int8))
    c, t = codes.to(cuda), tables.to(cuda)
    n0 = estimate_scan_tiled.launches
    got = ops.estimate_scan(c, t, backend="pallas")
    assert estimate_scan_tiled.launches == n0 + 1
    assert torch.equal(got, ops.estimate_scan(c, t, backend="xla"))
    u8 = tables.view(torch.uint8)
    for signed, lanes in ((True, 1), (False, 2)):
        assert torch.equal(
            ops.estimate_scan_saturating(c, u8.to(cuda), signed, lanes).cpu(),
            ops.estimate_scan_saturating(codes, u8, signed, lanes))


def test_knn_brute_numpy_runs_on_the_card(cuda):
    import numpy as np
    from tinyknn_tpu_torch import utils
    rng = np.random.default_rng(6)
    X = rng.standard_normal((50, 8)).astype(np.float32)
    Y = rng.standard_normal((900, 8)).astype(np.float32)
    ids = utils.block(utils.knn_brute(X, Y, 10))
    assert ids.device.type == "cuda"
    want = utils.knn_brute(X, Y, 10, device="cpu").numpy()

    def d2(rows):    # each query's sorted distances to its ids (ties may swap)
        return np.sort(((Y[rows] - X[:, None]) ** 2).sum(-1), axis=1)

    np.testing.assert_allclose(d2(ids.cpu().numpy()), d2(want), rtol=1e-5)


def test_an_example_launches_its_kernel(cuda):
    from tinyknn_tpu_torch.examples import ivf_example
    n0 = scan_fold_csr.launches
    rows = ivf_example.main(["--n", "3000", "--d", "32", "--n-queries",
                             "200", "--n-clusters", "30", "--max-probes",
                             "2"])["rows"]
    assert scan_fold_csr.launches > n0
    assert [r["n_probes"] for r in rows] == [1, 2]
