"""Readings that the check's limits are set from, on the card.

    python3 -m lsbench.calibrate --workload tandt-train.walk \
        --seeds 1,2,3 --seconds 8 --control-seeds 1,2,3

For each seed, one short run of the cell at its own size and load (the
same set-up, traffic and checked windows as ``lsbench.run``), and the
check's numbers for the program, with the share of tiles re-rendered in
the checked warped frames of a stream. For each control seed also the
control: the driver's own ``control(cell, out)`` where it has one (it
then has its own ``numbers`` too); else the reference computed in
bfloat16, one step below the configuration's float32, put in the
program's place and held to the float32 reference on the same windows.
One JSON line per seed; all in one process. ``--num-gaussians`` runs a
scene configuration at another N (a probe of the size a window holds).
"""
import time

T_PROCESS = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402

from lsbench.run import REPO  # noqa: E402


def scene_line(cell, out, with_control: bool) -> dict:
    """A renderer cell's line: frames, checked windows, the program's
    numbers, the re-rendered share of the checked warped frames and, with
    ``with_control``, the control's numbers."""
    import torch
    from lsbench import check, harness
    line = dict(seed=cell.seed, n=cell.config["num_gaussians"],
                frames=out["frames"], e2e=out["e2e"],
                checked=len(out["checked"]),
                program=harness.numbers(cell, out))
    warped = [float(f["active"].float().mean()) for win in out["checked"]
              for f in win if "active" in f and not f["key"]]
    if warped:
        line["rerender_share"] = [min(warped), sum(warped) / len(warped),
                                  max(warped)]
    if with_control:
        parts = []
        for win in out["checked"]:
            want = check.reference_window(out["scene"], cell.config, win)
            low = check.reference_window(out["scene"], cell.config, win,
                                         dtype=torch.bfloat16)
            parts.append(check.compare(cell.config, check.as_program(low),
                                       want))
        line["control"] = check.merge(parts)
    return line


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--control-seeds", default="")
    p.add_argument("--num-gaussians", type=int, default=0)
    args = p.parse_args(argv)
    sys.path.insert(0, str(REPO / "src"))
    import torch
    from lsbench import harness
    if not torch.cuda.is_available():
        print("lsbench.calibrate: no CUDA device", file=sys.stderr)
        return 2
    bench = harness.benchmark()
    cfg = harness.config(harness.workload(bench, args.workload)["config"])
    if args.num_gaussians:
        cfg["num_gaussians"] = args.num_gaussians
    control = {int(s) for s in args.control_seeds.split(",") if s}
    for seed in (int(s) for s in args.seeds.split(",")):
        cell = harness.make_cell(bench, args.workload, seed, args.seconds,
                                 False, "cuda", time.perf_counter(),
                                 cfg=cfg)
        out = harness.drive(cell)
        own = getattr(harness.kind(cell), "control", None)
        if own is None:
            line = scene_line(cell, out, seed in control)
        else:
            line = dict(seed=seed, e2e=out["e2e"],
                        attempted=out["attempted"],
                        program=harness.numbers(cell, out))
            if seed in control:
                line["control"] = own(cell, out)
        print(json.dumps(line), flush=True)
        del out
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
