"""Run one cell of the benchmark once and print its result line.

    python3 -m lsbench.run --workload tandt-train.walk --seed 1 \
        --seconds 30 --trace 0

Run from the root of a checkout. It measures the PyTorch and CUDA port
(``src/repro_torch``) on the cards of this machine and needs as many as
the cell asks for. The last line of standard output is the result (JSON:
``correct``, ``attempted``, ``failed``, ``metrics``, ``device``, with
``--trace 1`` also ``breakdown``, and ``checks`` last); the last lines of
standard error give each number the check compared beside its limit.
"""
import time

T_PROCESS = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

REPO = Path(__file__).resolve().parents[1]


def power_limit() -> str:
    try:
        proc = subprocess.run(
            ["nvidia-smi", "--query-gpu=power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=20)
    except (OSError, subprocess.TimeoutExpired):
        return "unknown"
    return proc.stdout.strip().splitlines()[0] if proc.stdout.strip() \
        else "unknown"


def environment() -> None:
    """Build and kernel caches inside the checkout, no JAX through
    ``transformers``, and the port's ``src`` on the path."""
    build = REPO / "build" / "lsbench"
    os.environ["TORCH_EXTENSIONS_DIR"] = str(build / "torch_extensions")
    os.environ["TRITON_CACHE_DIR"] = str(build / "triton")
    os.environ["USE_FLAX"] = "0"
    sys.path.insert(0, str(REPO / "src"))


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = p.parse_args(argv)
    environment()
    import torch
    from lsbench import harness
    bench = harness.benchmark()
    chips = int(harness.workload(bench, args.workload).get("chips", 1))
    found = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if found < chips:
        print(f"lsbench: the cell needs {chips} CUDA device(s); found "
              f"{found}", file=sys.stderr)
        return 2
    result = harness.run_cell(bench, args.workload, args.seed, args.seconds,
                              bool(args.trace), "cuda", T_PROCESS)
    loaded = harness.forbidden_modules()
    if loaded:
        print(f"lsbench: modules loaded that the port must not use: "
              f"{loaded}", file=sys.stderr)
        return 3
    checks = result.pop("checks")
    result["card"] = {"power_limit": power_limit()}
    result["checks"] = checks
    print(json.dumps(result), flush=True)
    print(f"correct: {result['correct']}", file=sys.stderr)
    for name, c in checks.items():
        print(f"{name}: {c['value']!r} (limit {c['limit']!r})",
              file=sys.stderr)
    return 0


if __name__ == "__main__":
    sys.exit(main())
