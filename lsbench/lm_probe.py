"""One run of a training mix on a registered LM configuration of the port,
through the harness, with the workload entry made in memory: a reading
of ``tokens_per_s`` and ``setup_s`` on a configuration that has no cell.

    python3 -m lsbench.lm_probe --arch moonshot-v1-16b-a3b --layers 4 \
        --seq-len 8192 --sequences 2 --seed 1 --seconds 40

The configuration is the port's registered one (``configs.get_config``),
cut to ``--layers``; the mix is ``lm_train`` with ``--warmup-steps`` and
``--check-steps``. Its check holds the program to its plain reference
(``reference/lm_decoder.py``) and prints the numbers with no limit: a
probe's reading, not a correctness result. Prints the result line last,
as ``lsbench.run``.
"""
import time

T_PROCESS = time.perf_counter()

import argparse  # noqa: E402
import dataclasses  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402

from lsbench.run import environment, power_limit  # noqa: E402

OPTIMIZER = dict(peak_lr=3e-4, warmup_steps=0, total_steps=10_000,
                 min_lr_ratio=0.1, b1=0.9, b2=0.95, eps=1e-8,
                 weight_decay=0.1, clip_norm=1.0)


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--arch", required=True)
    p.add_argument("--layers", type=int, required=True)
    p.add_argument("--seq-len", type=int, required=True)
    p.add_argument("--sequences", type=int, required=True)
    p.add_argument("--warmup-steps", type=int, default=3)
    p.add_argument("--check-steps", type=int, default=2)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = p.parse_args(argv)
    environment()
    import torch
    from lsbench import harness, lm_train, peaks
    from repro_torch.configs import get_config
    if not torch.cuda.is_available():
        print("lsbench.lm_probe: no CUDA device", file=sys.stderr)
        return 2
    name = f"{args.arch}-{args.layers}l"
    arch = dataclasses.replace(get_config(args.arch), num_layers=args.layers)
    cfg = dict(name=name, arch=dataclasses.asdict(arch),
               reference="lm_decoder")
    mix = dict(kind="lm_train", seq_len=args.seq_len,
               sequences_per_step=args.sequences,
               warmup_steps=args.warmup_steps, check_steps=args.check_steps,
               trace_steps=2, optimizer=OPTIMIZER)
    bench = harness.benchmark()
    bench["configs"].append(dict(name=name, source="probe", file="probe",
                                 reduced=["num_layers"], why="probe"))
    workload = f"{name}.probe"
    bench["workloads"].append(dict(name=workload, config=name,
                                   traffic="probe", chips=1, why="probe"))
    lm_train.reporting(bench, workload)
    readings = dict.fromkeys(("loss_rel", "grad_norm_rel", "grad_rel",
                              "update_rel", "leaves_below_dtype"),
                             float("inf"))
    result = harness.run_cell(bench, workload, args.seed, args.seconds,
                              bool(args.trace), "cuda", T_PROCESS,
                              cfg=cfg, traffic=mix, limits=readings)
    loaded = harness.forbidden_modules()
    if loaded:
        print(f"lsbench: modules loaded that the port must not use: "
              f"{loaded}", file=sys.stderr)
        return 3
    result["card"] = {"power_limit": power_limit()}
    result["probe"] = dict(config=name, seq_len=args.seq_len,
                           sequences=args.sequences,
                           flops_per_step=peaks.lm_train_flops(
                               cfg["arch"], args.sequences, args.seq_len))
    result["readings"] = {k: c["value"]
                          for k, c in result.pop("checks").items()}
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
