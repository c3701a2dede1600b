"""Run one cell of the port's benchmark once and print its result line.

    python3 portbench/run.py --workload <name> --seed <n> --seconds <s> \
        --trace <0|1>

Run from the root of a checkout. Needs an NVIDIA GPU: without one it exits
non-zero and prints no result (there is no CPU fallback). With ``--trace 0``
the result's metrics are the cell's end-to-end metrics, with ``--trace 1``
its per-layer metrics. Set-up phases, counters and each compared number
beside its limit go to standard error; the last line of standard output is
one JSON object.
"""
import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def cache_dirs():
    """Every kernel cache at a fixed path inside the checkout, so that only
    the first run of a cell in a checkout builds. The port's own nvcc and
    g++ builds go to ``indigo_tpu_torch/_build/`` inside the checkout."""
    base = os.path.join(ROOT, "portbench", ".cache")
    for var, sub in (("TRITON_CACHE_DIR", "triton"),
                     ("TORCH_EXTENSIONS_DIR", "torch_extensions")):
        os.environ[var] = os.path.join(base, sub)
        os.makedirs(os.environ[var], exist_ok=True)


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = p.parse_args(argv)
    cache_dirs()
    os.environ.setdefault("USE_FLAX", "0")
    sys.path.insert(0, ROOT)

    import torch

    from portbench.lib import harness, spec
    from portbench.lib.timing import card_line

    cell = spec.workload(spec.benchmark(), args.workload)
    if not torch.cuda.is_available():
        harness.log("no CUDA device: the benchmark runs on the card only")
        return 2
    if torch.cuda.device_count() < int(cell["chips"]):
        harness.log(f"{torch.cuda.device_count()} CUDA devices, the cell "
                    f"needs {cell['chips']}")
        return 2
    harness.log(f"card {card_line()}; torch {torch.__version__}, CUDA "
                f"{torch.version.cuda}")
    result = harness.run_cell(args.workload, args.seed, args.seconds,
                              bool(args.trace), t_start=T_START)
    found = harness.banned_modules()
    if found:
        harness.log("loaded in this process: " + ", ".join(found))
        return 3
    for name, c in result["checks"].items():
        harness.log(f"check {name} {c['value']!r} limit {c['limit']!r}")
    harness.log(f"correct {result['correct']}")
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
