"""A tiny training cell for CPU tests: the port's ``-smoke`` size of a
registered LM configuration under an ``lm_train`` mix, with its plain
reference ``lm_decoder``."""
import dataclasses
import time

OPTIMIZER = dict(peak_lr=1e-3, warmup_steps=0, total_steps=1000,
                 min_lr_ratio=0.1, b1=0.9, b2=0.95, eps=1e-8,
                 weight_decay=0.1, clip_norm=1.0)
# Limits of the tiny cell, from readings on the CPU over seeds 1-6 at
# seq_len 40 and 300: sound runs read at most 1.4e-7, 7.4e-7, 1.6e-6 and
# 1.6e-6; the program in bfloat16 at least 2.7e-4, 1.8e-3, 4.3e-3 and
# 0.10; one leaf's update scaled by 1.001 a step reads 1.2e-4 in
# grad_norm_rel and 6.1e-3 in update_rel. A leaf stored below the stated
# dtype is counted exactly.
LIMITS = dict(loss_rel=1e-5, grad_norm_rel=1e-5, grad_rel=1e-4,
              update_rel=1e-4, leaves_below_dtype=0)


def tiny_lm(arch: str = "moonshot-v1-16b-a3b", **mix_changes):
    """(bench, cfg, mix) of a training cell ``<arch>-smoke.train`` that is
    not in ``BENCHMARK.json``: the workload entry is added in memory."""
    from lsbench import harness
    from repro_torch.configs import get_config
    bench = harness.benchmark()
    name = f"{arch}-smoke"
    fields = dataclasses.asdict(get_config(name))
    cfg = dict(name=name, source="test", arch=fields,
               reference="lm_decoder")
    mix = dict(kind="lm_train", why="test", seq_len=40,
               sequences_per_step=2, warmup_steps=3, check_steps=2,
               trace_steps=1, optimizer=dict(OPTIMIZER))
    mix.update(mix_changes)
    bench["configs"].append({"name": name, "source": "test",
                             "file": f"lsbench/configs/{name}.json",
                             "reduced": [], "why": "test"})
    bench["workloads"].append({"name": f"{name}.train", "config": name,
                               "traffic": "train", "chips": 1,
                               "why": "test"})
    return bench, cfg, mix


def run_tiny_lm(arch: str = "moonshot-v1-16b-a3b", seed: int = 3,
                seconds: float = 0.5, trace: bool = False,
                **mix_changes) -> dict:
    from lsbench import harness
    bench, cfg, mix = tiny_lm(arch, **mix_changes)
    return harness.run_cell(bench, f"{arch}-smoke.train", seed, seconds,
                            trace, "cpu", time.perf_counter(), cfg=cfg,
                            traffic=mix, limits=dict(LIMITS))
