"""Run one cell of the benchmark once and print its result line.

    python3 -m gpubench.run --workload <name> --seed <n> --seconds <s> --trace <0|1>

From the root of a checkout that holds the program (``ivit_tpu_torch``).
The last line of standard output is one JSON object: ``correct``,
``attempted``, ``failed``, ``metrics`` (the cell's end-to-end metrics, or
with ``--trace 1`` its per-layer ones), ``device``, with ``--trace 1``
``breakdown``, and last ``checks``, each compared number beside its limit;
the same numbers end standard error.  Without a card, or with fewer than
the cell asks for, it prints no result and exits 2.
"""

import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402


def _since_process_start():
    """Seconds since this process was created (Linux), else since the
    harness module started."""
    try:
        import os
        with open("/proc/self/stat") as f:
            start_ticks = int(f.read().rsplit(")", 1)[1].split()[19])
        boot = time.clock_gettime(time.CLOCK_BOOTTIME)
        return boot - start_ticks / os.sysconf("SC_CLK_TCK")
    except (OSError, ValueError, IndexError, AttributeError):
        return time.perf_counter() - T0


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    t0 = time.perf_counter() - _since_process_start()
    from gpubench import harness
    try:
        result = harness.run_cell(args.workload, args.seed, args.seconds,
                                  bool(args.trace), t0=t0)
    except harness.NoDevice as e:
        print(f"gpubench: {e}; no result", file=sys.stderr)
        return 2
    found = harness.forbidden_modules()
    if found:
        print(f"gpubench: modules of the JAX package or JAX loaded: {found}; "
              "no result", file=sys.stderr)
        return 3
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
