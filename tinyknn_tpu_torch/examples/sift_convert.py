"""SIFT-1M .fvecs (or a tar archive holding it) to .npy (counterpart of
examples/sift/convert.py), on ``utils.read_fvecs``. It runs no device
code, so it takes no ``--device``.

    python -m tinyknn_tpu_torch.examples.sift_convert \\
        sift.tar.gz|sift_base.fvecs sift.npy
"""

from __future__ import annotations

import argparse
import tarfile
import tempfile
from pathlib import Path

import numpy as np

from ..utils import read_fvecs


def convert(src, dst):
    """Write the base vectors of ``src`` to ``dst``; returns the array."""
    src = Path(src)
    if src.suffix in (".tar", ".gz", ".tgz") or ".tar" in src.name:
        with tarfile.open(src) as tar, tempfile.TemporaryDirectory() as tmp:
            for member in tar.getmembers():
                if member.name.endswith("sift_base.fvecs"):
                    tar.extract(member, tmp, filter="data")
                    mat = read_fvecs(Path(tmp) / member.name)
                    break
            else:
                raise SystemExit("no sift_base.fvecs found in archive")
    else:
        mat = read_fvecs(src)
    np.save(dst, mat)
    print(f"wrote {dst}: {mat.shape} {mat.dtype}")
    return mat


def main(argv=None) -> dict:
    parser = argparse.ArgumentParser(
        description="SIFT .fvecs (or its tar archive) -> .npy")
    parser.add_argument("src", help="sift.tar.gz or sift_base.fvecs")
    parser.add_argument("dst", help="output .npy")
    args = parser.parse_args(argv)
    mat = convert(args.src, args.dst)
    return {"shape": mat.shape, "dtype": str(mat.dtype)}


if __name__ == "__main__":
    main()
