"""Run one cell of the benchmark of ``gs_init_tpu_torch`` once.

    python3 benchmark/run.py --workload <name> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout. The cell is the workload of that name in
``BENCHMARK.json``; its traffic names the generator in ``benchmark/harness/``
that drives it. The last line of standard output is the result (JSON); the
numbers that decide ``correct`` are the last lines of standard error. Exits
non-zero, with no result, without a CUDA device (or too few for the cell),
or if JAX or the JAX package got loaded.

``--control tf32`` puts the plain reference, with TF32 matmuls, in the
program's place for the check (the control, which has to come out not
correct); ``--calibrate`` also prints, on standard error, the readings the
limits are set from (the control's and planted faults'); ``--device cpu``
runs the harness on the CPU, for its tests only.
"""
import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
THREADS = 2
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)


def parse(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    p.add_argument("--control", choices=("tf32",), default=None, help=argparse.SUPPRESS)
    p.add_argument("--device", choices=("cuda", "cpu"), default="cuda", help=argparse.SUPPRESS)
    p.add_argument("--calibrate", action="store_true", help=argparse.SUPPRESS)
    return p.parse_args(argv)


def main(argv=None) -> int:
    args = parse(argv)
    from benchmark.harness import common

    common.cache_env()
    import importlib

    import torch

    spec = common.benchmark_spec()
    cell, config, traffic = common.find_cell(spec, args.workload)
    if args.device == "cuda":
        if not torch.cuda.is_available() or torch.cuda.device_count() < cell["chips"]:
            print(f"{args.workload} needs {cell['chips']} CUDA device(s); found "
                  f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}", file=sys.stderr)
            return 2
        dev = torch.device("cuda", 0)
        torch.cuda.set_device(dev)
        # Load from one process with few threads: idle OpenMP workers that
        # spin beside the launching thread slow it on a shared host.
        torch.set_num_threads(THREADS)
    else:
        dev = torch.device("cpu")
        torch.set_num_threads(min(4, os.cpu_count() or 1))  # the tests run several cells side by side
    generator = importlib.import_module(f"benchmark.harness.{traffic['generator']}")
    out = generator.run(args, spec, cell, config, traffic, T_START, dev)
    bad = common.forbidden_modules()
    if bad:
        print(f"modules of JAX or the JAX package were loaded: {bad}", file=sys.stderr)
        return 3
    common.emit(out["correct"], out["attempted"], out["failed"], out["metrics"], out["device"],
                out["limits"], out.get("breakdown"))
    return 0


if __name__ == "__main__":
    sys.exit(main())
