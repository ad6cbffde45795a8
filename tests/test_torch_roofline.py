"""Port parity: the roofline (``launch/roofline.py``) against the
reference's, and the dry-run on the fake 2 x 16 x 16 mesh.

The analytic functions (``model_flops``, ``_attn_flops``,
``_decode_attn_flops``, ``memory_floor_bytes``, ``_correction_layers``)
equal the reference's exactly for the four configs x four shapes;
``analyze``'s terms equal the reference's scaled by the ratio of the
constants (the port's are one H100 SXM's, the reference's a TPU's). The
reduced configs' train, prefill and decode cells run on the fake 512-rank
mesh in a spawned process (``_torch_dist_workers.dryrun_worker``), and
``corrected_cell``'s extrapolation from two minis is held against the
full count of a 3-layer config: the port runs every layer, so the
extrapolation must reproduce the count.
"""
import math

import pytest

import _torch_dist_workers as W
from repro.configs import get_config as jget
from repro.configs.base import SHAPES as JSHAPES
from repro.launch import roofline as JR
from repro_torch import hardware
from repro_torch.configs import ARCH_IDS, get_config, get_shape
from repro_torch.configs.base import SHAPES
from repro_torch.launch import roofline as R

CELLS = ("train_4k", "prefill_32k", "decode_32k")
# (arch, shape) of corrected_cell, at CORRECTED_LAYERS layers
CORRECTED = (("yi-9b", "train_4k"), ("minicpm3-4b", "prefill_32k"),
             ("moonshot-v1-16b-a3b", "decode_32k"))
CORRECTED_LAYERS = 3


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Half the configs' cells, the other half's, and the corrected cells,
    each in a process of its own, all at once."""
    halves = (ARCH_IDS[:2], ARCH_IDS[2:])
    payloads = [{"multi_pod": True, "archs": h, "shapes": CELLS}
                for h in halves] + [
        {"multi_pod": True, "archs": (), "shapes": (),
         "corrected": [(a, s, CORRECTED_LAYERS) for a, s in CORRECTED]}]
    jobs = [W.Spawned(W.dryrun_worker, 1, tmp_path_factory.mktemp("roof"),
                      p, gloo=False) for p in payloads]
    out = {"cells": {}, "corrected": {}}
    for job in jobs:
        got = job.result()
        out["cells"].update(got["cells"])
        out["corrected"].update(got["corrected"])
    return out


def test_constants_are_the_h100s():
    assert R.PEAK_FLOPS == hardware.BF16_FLOPS_PER_S == 989.4e12
    assert R.HBM_BW == hardware.HBM_BYTES_PER_S == 3.35e12
    assert R.LINK_BW == hardware.NVLINK_BYTES_PER_S
    assert not {R.PEAK_FLOPS, R.HBM_BW, R.LINK_BW} & {JR.PEAK_FLOPS,
                                                      JR.HBM_BW, JR.ICI_BW}


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_analytic_counts_equal_the_reference(arch):
    cfg, jcfg = get_config(arch), jget(arch)
    assert R._correction_layers(cfg) == JR._correction_layers(jcfg)
    for s, js in zip(SHAPES, JSHAPES):
        assert R.model_flops(cfg, s) == JR.model_flops(jcfg, js)
        for train in (False, True):
            assert R._attn_flops(cfg, s.seq_len, s.tokens, train=train) == \
                JR._attn_flops(jcfg, js.seq_len, js.tokens, train=train)
        assert R._decode_attn_flops(cfg, s.seq_len, s.global_batch) == \
            JR._decode_attn_flops(jcfg, js.seq_len, js.global_batch)
        for chips in (1, 256, 512):
            assert R.memory_floor_bytes(cfg, s, chips) == \
                JR.memory_floor_bytes(jcfg, js, chips)


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_analyze_equals_the_reference_scaled(arch):
    """The same artifact through both: each time term scales by the ratio
    of the constants, the model FLOPs and useful ratio are equal."""
    for shape in CELLS:
        for chips, mesh in ((256, "pod16x16"), (512, "pod2x16x16")):
            art = {"arch": arch, "shape": shape, "mesh": mesh,
                   "flops": 3.0e15, "bytes_accessed": 7.0e11,
                   "collective_bytes": {"all-gather": 2.0e9,
                                        "all-reduce": 5.0e8,
                                        "reduce-scatter": 1.0e9,
                                        "all-to-all": 0.0,
                                        "collective-permute": 0.0}}
            got, want = R.analyze(art, chips), JR.analyze(art, chips)
            rel = 1e-12
            assert math.isclose(got.compute_s * R.PEAK_FLOPS,
                                want.compute_s * JR.PEAK_FLOPS, rel_tol=rel)
            assert math.isclose(got.memory_s * R.HBM_BW,
                                want.memory_s * JR.HBM_BW, rel_tol=rel)
            assert math.isclose(got.memory_floor_s * R.HBM_BW,
                                want.memory_floor_s * JR.HBM_BW, rel_tol=rel)
            assert math.isclose(got.collective_s * R.LINK_BW,
                                want.collective_s * JR.ICI_BW, rel_tol=rel)
            assert got.model_flops == want.model_flops
            assert got.useful_ratio == want.useful_ratio
            terms = {"compute": got.compute_s, "memory": got.memory_floor_s,
                     "collective": got.collective_s}
            assert got.bottleneck == max(terms, key=terms.get)


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_reduced_cells_run_on_2x16x16(runs, arch):
    cfg = get_config(arch).reduced()
    for shape in CELLS:
        r = runs["cells"][arch, shape]
        assert r["status"] == "ok", r.get("error")
        roof = R.analyze(dict(r, arch=arch, shape=shape), 512, cfg=cfg)
        print(arch, shape, r["run_s"], r["flops"], r["collective_counts"],
              roof.row())
        assert r["flops"] > 0 and r["bytes_accessed"] > 0
        assert all(math.isfinite(v) and v >= 0 for v in
                   (roof.compute_s, roof.memory_s, roof.collective_s))
        assert sum(r["collective_counts"].values()) > 0


@pytest.mark.parametrize("arch,shape", CORRECTED)
def test_corrected_cell_reproduces_the_full_count(runs, arch, shape):
    """corrected = mini(1) + (L - 1) (mini(2) - mini(1)) against the full
    run at L = CORRECTED_LAYERS. FLOPs agree exactly for every kind;
    bytes and collectives too for train and decode, where the minis run
    the cell's own path. Prefill's minis run the materialized softmax
    (as the reference's), whose bytes differ from flash's: printed."""
    r = runs["corrected"][arch, shape]
    assert r["status"] == "ok", r.get("error")
    assert "correction_error" not in r
    gaps = {"flops": r["flops_corrected"] / r["flops"] - 1,
            "bytes": r["bytes_corrected"] / r["bytes_accessed"] - 1}
    print(arch, shape, "corrected / full - 1:", gaps)
    assert r["flops_corrected"] == r["flops"]
    if get_shape(shape).kind != "prefill":
        assert r["bytes_corrected"] == r["bytes_accessed"]
        assert r["collective_bytes_corrected"] == r["collective_bytes"]

