"""The knee of a venue cell: its open loop at several offered rates.

    python3 -m lsbench.sweep --workload tandt-train.venue --seeds 1,2,3 \
        --rates 6,7,8 --seconds 40

One process warms up once; for each seed it draws the scene, then for
each offered rate (frames/s over all viewers) serves a fresh
``StreamServer`` for ``--seconds`` and drains it. A JSON line per seed
and rate: frames completed per second, the 50th and 95th percentiles of
latency over the frames due, and the backlog (frames due on the open
loop's schedule and not yet rendered) at each quarter of the window.
The knee is the highest rate whose backlog grows on no seed: it ends
the window above one frame a viewer, or rises at every quarter. The
venue's traffic file offers 0.8 of it.
"""
import time

T_PROCESS = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402

from lsbench.run import REPO  # noqa: E402


def grows(backlog, viewers: int) -> bool:
    return backlog[-1] > viewers or all(
        b > a for a, b in zip(backlog, backlog[1:]))


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", required=True)
    p.add_argument("--rates", required=True)
    p.add_argument("--seconds", type=float, required=True)
    args = p.parse_args(argv)
    sys.path.insert(0, str(REPO / "src"))
    import numpy as np
    import torch
    from lsbench import harness, venue
    from lsbench.scene import scene_and_camera
    if not torch.cuda.is_available():
        print("lsbench.sweep: no CUDA device", file=sys.stderr)
        return 2
    bench = harness.benchmark()
    entry = harness.workload(bench, args.workload)
    cfg, mix = harness.config(entry["config"]), harness.mix(entry["traffic"])
    for n, seed in enumerate(int(s) for s in args.seeds.split(",")):
        scene, cam = scene_and_camera(cfg, seed, "cuda")
        if n == 0:
            venue.warm_up(venue.make_server(scene, cam, cfg, mix, "cuda"),
                          mix)
        for rate in (float(r) for r in args.rates.split(",")):
            srv = venue.make_server(scene, cam, cfg, mix, "cuda")
            v = venue.Venue(srv, mix, rate)
            t0 = srv.clock()
            backlog = []
            for q in range(1, 5):
                v.serve(t0 + args.seconds * q / 4)
                backlog.append(v.backlog(srv.clock()))
            t_end = t0 + args.seconds
            v.drain()
            lat, due, done = venue.latencies(v, t_end)
            print(json.dumps(dict(
                seed=seed, rate=rate, completed_per_s=done / args.seconds,
                due=due, p50_ms=float(np.percentile(lat, 50)) * 1e3,
                p95_ms=float(np.percentile(lat, 95)) * 1e3,
                backlog=backlog, grows=grows(backlog, int(mix["viewers"])),
                rounds=v.rounds,
                round_ms=srv.render_seconds / max(srv.busy_rounds, 1) * 1e3,
                occupancy=srv.active_slot_frames
                / max(srv.capacity_frames, 1))), flush=True)
            del v, srv
            torch.cuda.empty_cache()
        del scene, cam
    return 0


if __name__ == "__main__":
    sys.exit(main())
