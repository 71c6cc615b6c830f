"""Run one cell of the port's benchmark once and print its result line.

    python3 swbench/run.py --workload <name> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout. The cells, their configurations, traffic and
metrics are in ``BENCHMARK.json``; ``swbench/harness.py`` says how they are
found. The last line on standard output is one JSON object (``correct``,
``attempted``, ``failed``, ``metrics``, ``device``, with ``--trace 1``
``breakdown``, and last ``checks``: each number compared with its limit,
which are also the last lines on standard error). ``--control 1`` puts the
reference in the program's place with one guarantee broken
(``swbench/control.py``): its ``correct`` has to come out false.

Exits non-zero, printing no result, without the CUDA devices the cell asks
for, where the port is missing, or where ``jax``, ``jaxlib``, ``flax`` or
the JAX package is loaded in this process once the window has closed.
Nothing but the standard library is imported at the top of this file:
spawned workers import it again.
"""

import time

T_START = time.monotonic()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CACHE = os.path.join(ROOT, "swbench_cache")  # fixed, inside the checkout, git-ignored


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    ap.add_argument("--control", type=int, choices=(0, 1), default=0)
    args = ap.parse_args()

    os.environ["TORCH_EXTENSIONS_DIR"] = os.path.join(CACHE, "torch_extensions")
    os.environ["TRITON_CACHE_DIR"] = os.path.join(CACHE, "triton")
    os.environ["USE_FLAX"] = "0"
    sys.path.insert(0, ROOT)
    from swbench import harness

    spec = harness.Spec(ROOT)
    chips = spec.workload(args.workload)["chips"]
    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"swbench: {args.workload} needs {chips} CUDA device(s); "
              f"available: {torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 2
    line = harness.run_cell(spec, args.workload, args.seed, args.seconds, bool(args.trace),
                            T_START, control=bool(args.control))
    found = harness.forbidden_modules()
    if found:
        print(f"swbench: modules of JAX or the JAX package are loaded: {found}",
              file=sys.stderr)
        return 3
    for name, c in line["checks"].items():
        print(f"check {name} {c['value']} limit {c['limit']}", file=sys.stderr, flush=True)
    print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
