"""The rest of the JAX package's surface in the port, against the JAX
package on the CPU: timing (``timer``, ``block``, ``profile_trace``,
``enable_compilation_cache``), the scan backends and the saturating
oracle of ``ops.scan``, the dense inverted lists, the .fvecs reader, the
top-level names, and the brute-force helpers' device on NumPy input.

Integer outputs must be equal bit for bit; float estimates within rtol
1e-6 (the f32 sums run in another order than XLA's).
"""

from itertools import product
from typing import NamedTuple

import numpy as np
import pytest
import torch

import tinyknn_tpu
import tinyknn_tpu_torch
from tinyknn_tpu import native as jax_native
from tinyknn_tpu import utils as jax_utils
from tinyknn_tpu.ops import estimate_scan_saturating as jax_saturating
from tinyknn_tpu.ops.packing import pack_codes as jax_pack_codes
from tinyknn_tpu.ops.scan import estimate_scan_xla as jax_scan_xla
from tinyknn_tpu.utils import bruteforce as jax_bf
from tinyknn_tpu_torch import ops, utils
from tinyknn_tpu_torch.ops import _build
from tinyknn_tpu_torch.ops import scan
from tinyknn_tpu_torch.utils import bruteforce


def _no_card():
    return not torch.cuda.is_available()


# ---------------------------------------------------------------- timing


@pytest.mark.parametrize("verbose", [True, False])
def test_timer_prints_the_jax_lines(capsys, verbose):
    with jax_utils.timer(verbose, "Fitting PQ"):
        pass
    want = capsys.readouterr().out
    with utils.timer(verbose, "Fitting PQ"):
        pass
    assert capsys.readouterr().out == want
    assert want == ("Fitting PQ\nTook 0.0s\n" if verbose else "")


class _Pair(NamedTuple):
    a: torch.Tensor
    b: list


def test_block_returns_its_argument():
    t = torch.arange(3)
    tree = {"x": [t, (t, 2)], "y": _Pair(t, [t, None]), "z": "text"}
    assert utils.block(tree) is tree
    assert utils.block(t) is t
    assert utils.block(None) is None


def test_profile_trace_writes_a_trace(tmp_path):
    with utils.profile_trace(tmp_path / "trace"):
        torch.ones(64).cumsum(0)
    assert list((tmp_path / "trace").glob("*.pt.trace.json"))
    with utils.profile_trace(None):            # a no-op scope
        torch.ones(4).sum()


def test_enable_compilation_cache_moves_the_build_dir(tmp_path, monkeypatch):
    monkeypatch.setattr(_build, "BUILD_DIR", _build.BUILD_DIR)
    utils.enable_compilation_cache(tmp_path, min_compile_secs=5.0)
    assert _build.BUILD_DIR == tmp_path
    utils.enable_compilation_cache()
    assert _build.BUILD_DIR == _build.DEFAULT_BUILD_DIR
    assert _build.DEFAULT_BUILD_DIR.parent.name == "tinyknn_tpu_torch"


# ------------------------------------------------------------ ops.scan


def _codes_tables(seed, n, B, Q, kind):
    rng = np.random.default_rng(seed)
    codes = rng.integers(0, 16, size=(n, B), dtype=np.uint8)
    if kind == "int8":
        tables = rng.integers(-128, 128, size=(Q, B, 16)).astype(np.int8)
    else:
        tables = (10 * rng.random((Q, B, 16))).astype(np.float32)
    return codes, tables


@pytest.mark.parametrize("kind, packed", product(["int8", "f32", "bf16"],
                                                 [False, True]))
def test_estimate_scan_xla_matches_jax(kind, packed):
    codes, tables = _codes_tables(7, 40, 8, 3, kind)
    jt = tables if kind != "bf16" else tables.astype("bfloat16")
    pt = torch.as_tensor(tables)
    if kind == "bf16":
        pt = pt.to(torch.bfloat16)
    c = np.array(jax_pack_codes(codes)) if packed else codes
    want = np.asarray(jax_scan_xla(c, jt, packed=packed))
    got = ops.estimate_scan_xla(torch.as_tensor(c), pt, packed=packed)
    assert str(got.dtype).split(".")[-1] == str(want.dtype)
    if kind == "int8":
        np.testing.assert_array_equal(got.numpy(), want)
    else:
        np.testing.assert_allclose(got.numpy(), want, rtol=1e-6)


@pytest.mark.parametrize(
    "n, b, signed, lanes", product([16, 32], [4, 8], [True, False], [1, 2]))
def test_saturating_matches_jax(n, b, signed, lanes):
    """The cases of tests/test_scan.py::test_saturating_parity."""
    rng = np.random.default_rng(n * 100 + b * 10 + lanes)
    codes = rng.integers(0, 16, size=(n, b), dtype=np.uint8)
    tables = rng.integers(0, 256, size=(2, b, 16), dtype=np.uint8)
    want = np.asarray(jax_saturating(codes, tables, signed, lanes))
    got = ops.estimate_scan_saturating(torch.as_tensor(codes),
                                       torch.as_tensor(tables), signed, lanes)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)


def test_estimate_scan_backends_on_the_cpu():
    """'auto' runs K3's plain version on CPU tensors, 'xla' the one-hot
    product, both equal; 'pallas' launches the kernel and raises on CPU
    tensors rather than fall back."""
    codes, tables = _codes_tables(3, 50, 6, 2, "int8")
    c, t = torch.as_tensor(codes), torch.as_tensor(tables)
    auto = ops.estimate_scan(c, t)
    torch.testing.assert_close(auto, ops.estimate_scan(c, t, backend="xla"))
    np.testing.assert_array_equal(auto.numpy(),
                                  np.asarray(jax_scan_xla(codes, tables)))
    with pytest.raises(ValueError, match="CUDA"):
        ops.estimate_scan(c, t, backend="pallas")
    with pytest.raises(ValueError, match="backend"):
        ops.estimate_scan(c, t, backend="triton")


def test_register_pallas_impl_routes():
    calls = []

    def fake(codes, tables, packed):
        calls.append(packed)
        return torch.zeros((tables.shape[0], codes.shape[0]))

    codes, tables = _codes_tables(4, 20, 4, 2, "int8")
    try:
        ops.register_pallas_impl(fake)
        out = ops.estimate_scan(torch.as_tensor(codes),
                                torch.as_tensor(tables), backend="pallas")
        assert calls == [False] and tuple(out.shape) == (2, 20)
        ops.estimate_scan(torch.as_tensor(codes), torch.as_tensor(tables))
        assert calls == [False]                 # 'auto' does not route
    finally:
        ops.register_pallas_impl(scan._kernel_route)


# ------------------------------------------------------ inverted lists


@pytest.mark.parametrize("bp, pad_to", [(1, 8), (2, 8), (2, 4)])
def test_invert_assignments_matches_jax(bp, pad_to):
    rng = np.random.default_rng(bp + pad_to)
    n_lists = 9
    assign = rng.integers(0, n_lists - 1, size=(300, bp))  # list 8 empty
    for use_native in (True, False):
        want = jax_utils.invert_assignments(assign, n_lists, pad_to,
                                            use_native=use_native)
        got = utils.invert_assignments(assign, n_lists, pad_to,
                                       use_native=use_native)
        for g, w in zip(got, want):
            assert g.dtype == w.dtype
            np.testing.assert_array_equal(g, w)
    assert got[1][-1] == 0 and (got[0][-1] == -1).all()
    with pytest.raises(ValueError, match="range"):
        utils.invert_assignments(assign, 4)


# ----------------------------------------------------------- read_fvecs


def _write_fvecs(path, mat):
    n, d = mat.shape
    rec = np.empty((n, d + 1), np.int32)
    rec[:, 0] = d
    rec[:, 1:] = mat.view(np.int32)
    rec.tofile(path)


def test_read_fvecs_matches_jax(tmp_path):
    mat = np.random.default_rng(0).standard_normal((13, 7)).astype(
        np.float32)
    path = tmp_path / "x.fvecs"
    _write_fvecs(path, mat)
    got = utils.read_fvecs(path)
    assert got.dtype == np.float32
    np.testing.assert_array_equal(got, mat)
    np.testing.assert_array_equal(got, jax_native.read_fvecs(path))

    raw = np.fromfile(path, dtype=np.int32)
    ragged = raw.copy()
    ragged[8] = 6                              # second record's dimension
    for name, bad in (("corrupt", raw[:-3]), ("ragged", ragged)):
        bad_path = tmp_path / f"{name}.fvecs"
        bad.tofile(bad_path)
        with pytest.raises(AssertionError):
            jax_native.read_fvecs(bad_path)
        with pytest.raises(ValueError, match=name):
            utils.read_fvecs(bad_path)
    empty = tmp_path / "empty.fvecs"
    empty.write_bytes(b"")
    with pytest.raises(ValueError, match="empty"):
        utils.read_fvecs(empty)


# --------------------------------------------------------- names


def test_the_jax_names_exist_in_the_port():
    for jax_mod, port_mod in ((tinyknn_tpu, tinyknn_tpu_torch),
                              (tinyknn_tpu.ops, tinyknn_tpu_torch.ops),
                              (tinyknn_tpu.utils, tinyknn_tpu_torch.utils),
                              (tinyknn_tpu.models, tinyknn_tpu_torch.models)):
        names = getattr(jax_mod, "__all__", None) or [
            n for n in dir(jax_mod) if not n.startswith("__")]
        missing = [n for n in names if not hasattr(port_mod, n)]
        assert not missing, (port_mod.__name__, missing)
    assert tinyknn_tpu_torch.ops is ops and tinyknn_tpu_torch.utils is utils


# ------------------------------------------- brute force on NumPy input


def test_knn_brute_numpy_input_goes_to_the_card():
    """NumPy input with no device goes to the card, as every entry point
    does: it raises on a machine without CUDA (it used to run on the
    CPU). With device='cpu' the ids are the JAX package's."""
    rng = np.random.default_rng(11)
    X = rng.standard_normal((30, 6)).astype(np.float32)
    Y = rng.standard_normal((200, 6)).astype(np.float32)
    calls = (lambda **kw: bruteforce.knn_brute(X, Y, 5, **kw),
             lambda **kw: bruteforce.cdist(X, Y, **kw),
             lambda **kw: bruteforce.knn_brute1(X[0], Y, 5, **kw))
    for call in calls:
        if _no_card():
            with pytest.raises((AssertionError, RuntimeError)):
                call()
        else:
            assert call().device.type == "cuda"
        assert call(device="cpu").device.type == "cpu"
    # a tensor keeps its device whatever ``device`` says
    assert bruteforce.knn_brute(torch.as_tensor(X), Y, 5,
                                device="cuda").device.type == "cpu"
    for metric in ("euclidean", "angular"):
        np.testing.assert_array_equal(
            bruteforce.knn_brute(X, Y, 10, metric=metric,
                                 device="cpu").numpy(),
            np.asarray(jax_bf.knn_brute(X, Y, 10, metric=metric)))
