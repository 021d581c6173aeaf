"""Import hygiene of the port: ``import tinyknn_tpu_torch`` pulls in
neither JAX nor triton and initialises no CUDA. Run in a subprocess so
this session's imports cannot mask a regression."""

import re
import subprocess
import sys
from pathlib import Path

_PROG = """
import sys
import tinyknn_tpu_torch  # noqa: F401
import tinyknn_tpu_torch.ops.kernels  # noqa: F401
import tinyknn_tpu_torch.parallel  # noqa: F401
import tinyknn_tpu_torch.parallel.mesh  # noqa: F401
import tinyknn_tpu_torch.parallel.sharded_ivf  # noqa: F401
import tinyknn_tpu_torch.parallel.sharded_pq  # noqa: F401
import torch
bad = sorted(m for m in sys.modules
             if m.split(".")[0] in ("jax", "jaxlib", "triton", "tinyknn_tpu"))
assert not bad, f"import pulled in {bad}"
assert not torch.cuda.is_initialized(), "import initialised CUDA"
print("clean")
"""


def test_import_pulls_in_no_jax_triton_or_cuda():
    r = subprocess.run([sys.executable, "-c", _PROG], capture_output=True,
                       text=True, timeout=120)
    assert r.returncode == 0, r.stderr
    assert "clean" in r.stdout


_JAX_IMPORT = re.compile(r"^\s*(import|from)\s+(jax|tinyknn_tpu)\b", re.M)
_ROOT = Path(__file__).resolve().parent.parent


def test_package_source_names_no_jax():
    """No module of the port imports jax or the JAX package."""
    hits = [str(p) for p in (_ROOT / "tinyknn_tpu_torch").rglob("*.py")
            if _JAX_IMPORT.search(p.read_text())]
    assert not hits, hits


def test_chip_smoke_names_no_jax():
    """The port's smoke run imports neither jax nor the JAX package."""
    assert not _JAX_IMPORT.search((_ROOT / "chip_smoke.py").read_text())
