"""Run one cell of the benchmark once and print its result line.

    python gpubench/run.py --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

from the root of a checkout. The last line of standard output is one
JSON object: ``correct``, ``attempted``, ``failed``, ``metrics`` (the
cell's end-to-end metrics, or with ``--trace 1`` its per-layer ones),
``device``, with ``--trace 1`` a ``breakdown``, and last ``checks``,
each number the judge compared beside its limit; the same numbers end
standard error. Exits non-zero, with no result, when the cell needs
more CUDA devices than the machine has, or when JAX or the JAX package
was loaded.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

CHECKOUT = Path(__file__).resolve().parent.parent


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = p.parse_args(argv)
    if str(CHECKOUT) not in sys.path:
        sys.path.insert(0, str(CHECKOUT))
    import torch
    from gpubench import core
    torch.set_num_threads(4)
    try:
        result = core.run_cell(args.workload, args.seed, args.seconds,
                               bool(args.trace),
                               bench_file=CHECKOUT / "BENCHMARK.json",
                               t_start=T_START)
    except core.NoDevice as e:
        print(f"no result: {e}", file=sys.stderr)
        return 2
    found = core.forbidden_modules()
    if found:
        print(f"no result: loaded {', '.join(found)}", file=sys.stderr)
        return 3
    for name, c in result["checks"].items():
        print(f"check {name} {c['value']!r} limit {c['limit']!r}",
              file=sys.stderr)
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
