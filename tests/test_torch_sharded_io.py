"""The sharded archives of the port against the JAX package, on the CPU.

An archive of a sharded index is the single-device v3 archive: the
writer strips each shard's tile padding and re-bases the offsets, so
the file does not depend on the mesh. Held here: a JAX
``save_ivf(ShardedIVF)`` archive placed by the port's
``load_sharded_ivf`` and read by its ``load_ivf``; the port's archive
of a placed index read by the JAX ``load_sharded_ivf`` and ``load_ivf``;
equal CSR arrays both ways; re-sharding 8 -> 4 (identical ids); and
``skip_derived``. Set-up and tolerances are those of
tests/test_torch_sharded.py.
"""

import numpy as np
import pytest
import torch

from test_torch_sharded import CPU8, _assert_same_distances, _pair
from tinyknn_tpu import io as jax_io
from tinyknn_tpu.parallel import make_mesh as jax_make_mesh
from tinyknn_tpu_torch import load_ivf, load_sharded_ivf, save_ivf
from tinyknn_tpu_torch.parallel import ShardedIVF, make_mesh

CSR_KEYS = ("csr_codes", "csr_ids", "tile_offsets", "list_counts",
            "active_centers", "all_centers", "data", "pq_center_blocks")


def _arrays(path):
    with np.load(path) as z:
        return {key: z[key] for key in z.files}


@pytest.mark.parametrize("metric, scan_impl, C", [("angular", "fused", 12),
                                                  ("euclidean", "exact", 13)])
def test_jax_sharded_archive_serves_from_the_port(tmp_path, metric,
                                                  scan_impl, C):
    """A JAX sharded index's archive, placed by the port on 8 and on 4
    shards (identical ids: the archive does not depend on the mesh) and
    read as a single-device index; the port's archive of the placed index
    holds the JAX writer's arrays, byte for byte."""
    jax_sivf, port8, _, qs = _pair(tmp_path, metric, C, n=500, d=10, nq=12,
                                   scan_impl=scan_impl, seed=1)
    path = tmp_path / "index.npz"
    a = np.asarray(jax_sivf.query(qs, k=5, n_probes=3))
    b8 = port8.query(qs, k=5, n_probes=3)
    _assert_same_distances(jax_sivf, a, b8.numpy(), qs)
    port4 = load_sharded_ivf(path, mesh=make_mesh(devices=CPU8[:4]))
    assert isinstance(port4, ShardedIVF) and port4.csr_raw is None
    assert port4.mesh.shape == {"shards": 4}
    torch.testing.assert_close(port4.query(qs, k=5, n_probes=3), b8)
    single = load_ivf(path, "cpu")
    c = single.query(qs, k=5, n_probes=3, mode="bucket").numpy()
    overlap = np.mean([len(set(x) & set(y)) / 5
                       for x, y in zip(b8.numpy().tolist(), c.tolist())])
    assert overlap > 0.9, overlap

    back = tmp_path / "port.npz"
    save_ivf(back, port4)
    want, got = _arrays(path), _arrays(back)
    assert set(got) == set(want)
    for key in want:
        assert got[key].dtype == want[key].dtype, key
        np.testing.assert_array_equal(got[key], want[key], err_msg=key)


@pytest.mark.parametrize("n_dev", [8, 3])
def test_port_sharded_archive_serves_from_jax(tmp_path, n_dev):
    """The port's archive of a placed index (8 shards, and 3 with a pad
    list), read by the JAX ``load_sharded_ivf`` on another mesh and by
    its ``load_ivf``: equal CSR arrays, and the port's answers."""
    _, port, _, qs = _pair(tmp_path, "euclidean", 13, n=500, d=10, nq=12,
                           n_dev=n_dev, seed=1)
    back = tmp_path / "port.npz"
    save_ivf(back, port)
    single = load_ivf(tmp_path / "index.npz", "cpu")
    got = _arrays(back)
    for key in ("csr_codes", "csr_ids", "tile_offsets", "list_counts",
                "active_centers"):
        np.testing.assert_array_equal(
            got[key], getattr(single, key).numpy(), err_msg=key)
    jax_again = jax_io.load_sharded_ivf(back, mesh=jax_make_mesh(4))
    b = port.query(qs, k=5, n_probes=3)
    _assert_same_distances(
        jax_again, np.asarray(jax_again.query(qs, k=5, n_probes=3)),
        b.numpy(), qs)
    jax_single = jax_io.load_ivf(back)
    for key in ("csr_codes", "csr_ids", "tile_offsets", "list_counts"):
        np.testing.assert_array_equal(np.asarray(getattr(jax_single, key)),
                                      got[key], err_msg=key)


def test_load_skips_single_device_derived(tmp_path):
    """``load_sharded_ivf`` builds neither the single-device exact tiles
    nor the rescore_rows copy (placing derives each shard's own), and
    ``load_ivf(skip_derived=True)`` leaves both out on request."""
    jax_sivf, port, _, qs = _pair(tmp_path, "euclidean", 12, n=500, d=10,
                                  nq=12, scan_impl="exact", seed=12,
                                  rescore_rows=True)
    path = tmp_path / "index.npz"
    assert port.rescore_rows and port.csr_raw is None
    assert port.csr_vecs.shape[0] == 8 * port._shard_tiles
    a = np.asarray(jax_sivf.query(qs, k=5, n_probes=3))
    _assert_same_distances(jax_sivf, a,
                           port.query(qs, k=5, n_probes=3).numpy(), qs)
    bare = load_ivf(path, "cpu", skip_derived=True)
    assert bare.scan_impl == "exact" and bare.rescore_rows
    assert bare.csr_vecs is None and bare.csr_raw is None
    with pytest.raises(RuntimeError, match="set_scan_impl"):
        bare.query(qs, k=5, mode="bucket")
    full = load_ivf(path, "cpu")
    assert full.csr_vecs is not None and full.csr_raw is not None
    bare.set_scan_impl("exact").set_rescore_rows(True)
    torch.testing.assert_close(bare.query(qs, k=5, n_probes=3, mode="bucket"),
                               full.query(qs, k=5, n_probes=3, mode="bucket"))


def test_labels_cross_the_sharded_archive(tmp_path):
    """User labels ride the archive: the port's placed index answers with
    the JAX sharded index's labels."""
    labels = np.arange(500, dtype=np.int64) * 1000 + 7
    from tinyknn_tpu import FastPQ as JaxFastPQ
    from tinyknn_tpu.parallel import ShardedIVF as JaxShardedIVF
    from tinyknn_tpu_torch import make_clustered
    X, qs = make_clustered(500, 10, 12, seed=6)
    jax_sivf = JaxShardedIVF("euclidean", 12, JaxFastPQ(2),
                             mesh=jax_make_mesh(8), scan_impl="fused",
                             pass1_method="exact")
    jax_sivf.fit(X).build(X, n_probes=1, labels=labels)
    path = tmp_path / "labelled.npz"
    jax_io.save_ivf(path, jax_sivf)
    port = load_sharded_ivf(path, mesh=make_mesh(devices=CPU8[:2]))
    got = port.query(qs, k=5, n_probes=2)
    assert got.dtype == torch.int64
    np.testing.assert_array_equal(
        got.numpy(), np.asarray(jax_sivf.query(qs, k=5, n_probes=2)))
