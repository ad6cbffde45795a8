"""A tiny CPU version of each cell: the real configuration and mix with
their sizes cut to a test's."""
import time


def tiny(workload: str, **mix_changes):
    """(bench, cfg, mix) of ``workload`` cut to a CPU test's size."""
    from lsbench import harness
    bench = harness.benchmark()
    entry = harness.workload(bench, workload)
    cfg = harness.config(entry["config"])
    cfg.update(num_gaussians=2048, resolution_x=64, resolution_y=48)
    cfg["render"] = dict(cfg["render"], capacity=512)
    mix = harness.mix(entry["traffic"])
    if mix["kind"] == "venue":
        mix.update(offered_frames_per_s=20.0, viewers=3,
                   session_poses=[8, 12], r_buckets=[8, 16, 32])
    else:
        mix.update(session_poses=[8, 12], check_every=1)
    mix.update(mix_changes)
    return bench, cfg, mix


def run_tiny(workload: str, seed: int = 3, seconds: float = 1.5,
             trace: bool = False, **mix_changes) -> dict:
    from lsbench import harness
    bench, cfg, mix = tiny(workload, **mix_changes)
    return harness.run_cell(bench, workload, seed, seconds, trace, "cpu",
                            time.perf_counter(), cfg=cfg, traffic=mix)
