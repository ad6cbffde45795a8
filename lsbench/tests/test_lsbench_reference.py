"""The reference against the port at a tiny size on the CPU, and the
control (the reference in bfloat16 in the program's place) refused."""
import time

import pytest
import torch

from lsbench import check, harness
from lsbench.tests.tiny import tiny


@pytest.mark.parametrize("workload", ["tandt-train.walk", "tandt-train.turn",
                                      "tandt-train.venue"])
def test_reference_agrees_with_port(workload):
    bench, cfg, mix = tiny(workload)
    cell = harness.make_cell(bench, workload, 11, 1.5, False, "cpu",
                             time.perf_counter(), cfg=cfg, traffic=mix)
    out = harness.drive(cell)
    assert out["checked"], "no window was checked"
    nums = harness.numbers(cell, out)
    # On the CPU the port runs the plain versions of its kernels, the
    # same arithmetic as the reference: no pixel, pair or block differs.
    assert all(v == 0.0 for v in nums.values()), nums
    assert set(nums) == set(check.load_limits(workload))


@pytest.mark.parametrize("workload", ["tandt-train.walk",
                                      "lsgaussian-1088p.walk"])
def test_control_fails_the_check(workload):
    bench, cfg, mix = tiny(workload)
    cell = harness.make_cell(bench, workload, 12, 1.5, False, "cpu",
                             time.perf_counter(), cfg=cfg, traffic=mix)
    out = harness.drive(cell)
    parts = []
    for win in out["checked"]:
        want = check.reference_window(out["scene"], cfg, win)
        low = check.reference_window(out["scene"], cfg, win,
                                     dtype=torch.bfloat16)
        parts.append(check.compare(cfg, check.as_program(low), want))
    ok, rows = check.judge(check.merge(parts), {
        k: v for k, v in check.load_limits(workload).items() if k != "ldu"})
    assert not ok, rows


def test_ldu_schedule_follows_the_paper():
    from lsbench.reference import render as ref
    import numpy as np
    wl = np.array([5, 1, 9, 3, 0, 7, 2, 8, 4, 6, 1, 1, 2, 3, 5, 8])
    block, order = ref.ldu_schedule(wl, np.ones(16, bool), 4, 4, 4)
    assert set(block.tolist()) <= set(range(4))
    loads = [wl[block == b].sum() for b in range(4)]
    cap = (1 + 1 / 4) * wl.sum() / 4
    assert max(loads) <= cap
    for b in range(4):
        ids = np.flatnonzero(block == b)
        ranked = ids[np.argsort(order[ids])]
        assert list(wl[ranked]) == sorted(wl[ids])
