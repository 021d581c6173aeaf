"""Import hygiene of the port: ``import tinyknn_tpu_torch`` pulls in
neither JAX nor triton and initialises no CUDA. Run in a subprocess so
this session's imports cannot mask a regression."""

import subprocess
import sys

_PROG = """
import sys
import tinyknn_tpu_torch  # noqa: F401
import tinyknn_tpu_torch.ops.kernels  # noqa: F401
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


def test_package_source_names_no_jax():
    """No module of the port imports jax or the JAX package."""
    from pathlib import Path
    import re
    root = Path(__file__).resolve().parent.parent / "tinyknn_tpu_torch"
    pat = re.compile(r"^\s*(import|from)\s+(jax|tinyknn_tpu)\b", re.M)
    hits = [str(p) for p in root.rglob("*.py") if pat.search(p.read_text())]
    assert not hits, hits
