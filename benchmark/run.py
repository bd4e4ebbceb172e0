"""The benchmark of mpstime_tpu_torch: one run of one cell.

    python3 benchmark/run.py --workload <name> --seed <n> --seconds <s> \
        --trace <0|1>

from the root of a checkout on a machine with an NVIDIA GPU.  Prints, as
the last line of standard output, one JSON object: ``correct``,
``attempted`` (fits in the window), ``failed`` (0: a fit or classify that
raises ends the run with no result), ``metrics`` (the cell's
end-to-end metrics, or with ``--trace 1`` its per-layer metrics),
``device``, with ``--trace 1`` ``breakdown``, and last ``checks``, each
number compared with its limit (also the last lines of standard error).
Exits non-zero, with no result, where there is no card, where the cell
asks for more cards than there are, or where JAX or the JAX package got
loaded.
"""

import time

T_START = time.perf_counter()

import argparse                                   # noqa: E402
import json                                       # noqa: E402
import os                                         # noqa: E402
import subprocess                                 # noqa: E402
import sys                                        # noqa: E402
from pathlib import Path                          # noqa: E402

HERE = Path(__file__).resolve().parent
# one host thread for the fits' host work: steadier runs, as in a loop of
# trials that shares the host with others
for var in ("OMP_NUM_THREADS", "MKL_NUM_THREADS", "OPENBLAS_NUM_THREADS"):
    os.environ[var] = "1"
sys.path[:0] = [str(HERE), str(HERE.parent)]

#: Top-level module names that no run may load.
FORBIDDEN = frozenset({"jax", "jaxlib", "flax", "mpstime_tpu"})


def loaded_forbidden() -> list:
    return sorted({m.split(".")[0] for m in list(sys.modules)} & FORBIDDEN)


def card_line() -> str:
    """The card's name and power limit, as nvidia-smi reads them."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30)
        return out.stdout.strip().splitlines()[0]
    except (OSError, subprocess.SubprocessError, IndexError):
        return "nvidia-smi unavailable"


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    import harness
    cell = harness.find_cell(args.workload)
    import torch
    if not torch.cuda.is_available():
        print("no CUDA device: the benchmark runs on the card only",
              file=sys.stderr)
        return 2
    if torch.cuda.device_count() < cell.chips:
        print(f"{args.workload} needs {cell.chips} cards, "
              f"{torch.cuda.device_count()} present", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    print(f"card: {card_line()}", file=sys.stderr, flush=True)
    result = harness.run_cell(cell, args.seed, args.seconds,
                              bool(args.trace), T_START)
    bad = loaded_forbidden()
    if bad:
        print(f"forbidden modules loaded: {bad}", file=sys.stderr)
        return 3
    for name, c in result["checks"].items():
        print(f"check {name} {c['value']!r} limit {c['limit']!r}",
              file=sys.stderr)
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
