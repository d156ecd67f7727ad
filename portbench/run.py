"""Run one cell of the benchmark of ``tpusysbio_torch`` on the card.

    python3 -m portbench.run --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

from the root of a checkout. The last line of standard output is one JSON
object: ``correct``, ``attempted``, ``failed``, ``metrics`` (the cell's
end-to-end metrics, or with ``--trace 1`` its per-layer metrics),
``device`` and, traced, ``breakdown``; its last key, ``checks``, holds
each number the correctness check compared beside its limit, which also
end standard error. Without a CUDA card, with fewer cards than the cell
asks for, or with a forbidden module loaded (``jax``, ``jaxlib``,
``flax``, ``tpusysbio``) the run prints no result and exits with 2.

``--control bf16`` puts the comparison's control in the program's place:
the reference with its sensitivity columns in bfloat16, the precision
below the configurations' f32 columns. The benchmark's own runs never
pass it.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import math  # noqa: E402
import sys  # noqa: E402


def _finite(x):
    """JSON has no infinity: a number that is not finite prints as
    1e308."""
    if isinstance(x, dict):
        return {k: _finite(v) for k, v in x.items()}
    if isinstance(x, list):
        return [_finite(v) for v in x]
    if isinstance(x, float) and not math.isfinite(x):
        return 1e308
    return x


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    ap.add_argument("--control", choices=("bf16",), default=None)
    args = ap.parse_args(argv)

    from portbench import harness

    try:
        line = harness.run_cell(args.workload, args.seed, args.seconds,
                                bool(args.trace), t_start=T_START,
                                control=args.control)
    except harness.Refused as exc:
        print(f"portbench: {exc}", file=sys.stderr, flush=True)
        return 2
    line = _finite(line)
    for name, c in line["checks"].items():
        print(f"check {name} {c['value']!r} limit {c['limit']!r}",
              file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
