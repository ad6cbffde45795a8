"""Roofline analysis from the dry-run's artifacts (the port of the
reference's ``launch/roofline.py``).

Hardware model: one NVIDIA H100 SXM (``repro_torch.hardware``; the
reference's figures are a TPU's and are not used):
  peak      989.4 TFLOP/s bf16 per GPU (dense)
  HBM       3.35 TB/s per GPU
  NVLink    478.1 GB/s per GPU each way (18 links of 26.562 GB/s, as
            nvidia-smi reports them on the card; links between nodes
            are not modelled)

Three terms per (arch x shape x mesh), each per device (the artifacts
hold per-device numbers):
  compute    = flops / peak
  memory     = bytes_accessed / hbm_bw   (and the analytic floor)
  collective = collective_bytes / link_bw

The reference extrapolates each cell from two unrolled minis because
XLA counts a scanned layer stack's body once. The port's layers are a
list and the dry-run runs every op, so its count is complete;
``corrected_cell`` still runs the two minis and reports the
``*_corrected`` values, which test the per-layer arithmetic.

MODEL_FLOPS = 6*N*D for training (2*N*D inference) with N = active params
(MoE) plus causal attention-score FLOPs; the usefulness ratio
MODEL_FLOPS / (flops * chips) flags remat and redundant work.

Usage:
  PYTHONPATH=src python -m repro_torch.launch.roofline [--glob PATTERN]
  PYTHONPATH=src python -m repro_torch.launch.roofline --sweep [--device cpu]
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import os
from typing import Any, Dict, Optional, Tuple

from repro_torch import hardware

PEAK_FLOPS = hardware.BF16_FLOPS_PER_S   # bf16 / GPU
HBM_BW = hardware.HBM_BYTES_PER_S        # B/s / GPU
LINK_BW = hardware.NVLINK_BYTES_PER_S    # B/s / GPU, each way

ARTIFACT_DIR = os.path.join(os.path.dirname(__file__), "..", "..", "..",
                            "build", "dryrun")


def _correction_layers(cfg) -> Optional[Tuple[int, int, int, int, int]]:
    """(L1, L2, units1, units2, units_full) for the 2-point correction."""
    if cfg.family == "hybrid":
        k = cfg.shared_attn_every
        tail = cfg.num_layers - (cfg.num_layers // k) * k
        return (k + tail, 2 * k + tail, 1, 2, cfg.num_layers // k)
    return (1, 2, 1, 2, cfg.num_layers)


def corrected_cell(arch: str, shape_name: str, *, multi_pod: bool,
                   hook_overrides=None, cfg_override=None,
                   tag: str = "", device_type: str = "cuda",
                   save: bool = True) -> Dict[str, Any]:
    """Run the full cell and two minis (1 and 2 layers); add the values
    extrapolated from the minis (``*_corrected``)."""
    from repro_torch.configs import get_config, get_shape
    from repro_torch.launch import dryrun

    cfg = cfg_override if cfg_override is not None else get_config(arch)
    full = dryrun.run_cell(arch, shape_name, multi_pod=multi_pod,
                           hook_overrides=hook_overrides,
                           cfg_override=cfg, tag=tag,
                           device_type=device_type, save=save)
    if full["status"] != "ok":
        return full

    l1, l2, u1, u2, units_full = _correction_layers(cfg)
    # As the reference: the minis run the materialized-softmax path for
    # prefill (the same product FLOPs as flash's full S x T rectangle).
    mini_hooks = dict(hook_overrides or {})
    if get_shape(shape_name).kind == "prefill":
        mini_hooks.setdefault("attn_impl", "sdpa")

    def mini(n_layers):
        c = dataclasses.replace(cfg, num_layers=n_layers, scan_layers=False,
                                encoder_layers=min(cfg.encoder_layers, 1))
        return dryrun.run_cell(arch, shape_name, multi_pod=multi_pod,
                               save=False, hook_overrides=mini_hooks,
                               cfg_override=c, tag="mini",
                               device_type=device_type)

    r1, r2 = mini(l1), mini(l2)
    if r1["status"] == "ok" and r2["status"] == "ok":
        def extrapolate(a, b):
            return a + (units_full - u1) * (b - a) / (u2 - u1)

        full["flops_corrected"] = extrapolate(r1["flops"], r2["flops"])
        full["bytes_corrected"] = extrapolate(r1["bytes_accessed"],
                                              r2["bytes_accessed"])
        full["collective_bytes_corrected"] = {
            k: extrapolate(r1["collective_bytes"][k],
                           r2["collective_bytes"][k])
            for k in r1["collective_bytes"]}
    else:
        full["correction_error"] = r1.get("error") or r2.get("error")
    if save:
        _write(full)
    return full


def _write(result: Dict[str, Any]) -> None:
    os.makedirs(ARTIFACT_DIR, exist_ok=True)
    tag = ("_" + result["tag"]) if result.get("tag") else ""
    name = (f"torch_roofline_{result['arch']}_{result['shape']}_"
            f"{result['mesh']}{tag}.json")
    with open(os.path.join(ARTIFACT_DIR, name), "w") as f:
        json.dump(result, f, indent=1)


def model_flops(cfg, shape) -> float:
    """Analytic useful FLOPs for the cell (global, per step)."""
    n_active = cfg.active_param_count()
    if shape.kind == "train":
        base = 6.0 * n_active * shape.tokens
        attn = _attn_flops(cfg, shape.seq_len, shape.tokens, train=True)
    elif shape.kind == "prefill":
        base = 2.0 * n_active * shape.tokens
        attn = _attn_flops(cfg, shape.seq_len, shape.tokens, train=False)
    else:  # decode: one token per sequence
        toks = shape.global_batch
        base = 2.0 * n_active * toks
        attn = _decode_attn_flops(cfg, shape.seq_len, toks)
    return base + attn


def _attn_flops(cfg, seq, tokens, *, train: bool) -> float:
    """Causal QK^T + PV matmul FLOPs (0.5 triangle), fwd(+bwd)."""
    if cfg.attention == "none":
        return 0.0
    hd = cfg.resolved_head_dim
    if cfg.attention == "mla":
        hd = cfg.nope_head_dim + cfg.rope_head_dim
    heads = cfg.num_heads
    layers = cfg.num_layers if cfg.family != "hybrid" \
        else cfg.num_layers // max(cfg.shared_attn_every, 1)
    per_tok = 2.0 * 2.0 * heads * hd * (seq / 2.0)
    mult = 3.0 if train else 1.0   # bwd of the two matmuls ~ 2x fwd
    return per_tok * tokens * layers * mult


def _decode_attn_flops(cfg, cache_len, toks) -> float:
    if cfg.attention == "none":
        return 0.0
    hd = cfg.resolved_head_dim
    if cfg.attention == "mla":
        hd = cfg.kv_lora_rank + cfg.rope_head_dim  # absorbed decode
    heads = cfg.num_heads
    layers = cfg.num_layers if cfg.family != "hybrid" \
        else cfg.num_layers // max(cfg.shared_attn_every, 1)
    return 2.0 * 2.0 * heads * hd * cache_len * toks * layers


def memory_floor_bytes(cfg, shape, chips: int) -> float:
    """Analytic per-device HBM-traffic floor: weights touched fwd+bwd+opt,
    caches read/written, token activations once. The dry-run's
    bytes_accessed counts every op before fusion, so it OVERSTATES
    traffic; the truth lies between this floor and that number."""
    n = cfg.param_count()
    per_dev = n / chips
    if shape.kind == "train":
        # bf16 weights read twice (fwd+bwd) + grads written + opt state
        # (m, v fp32) read+write + fp32 master update.
        w = per_dev * (2 * 2 + 2 + 4 * 2 * 2 + 4 * 2)
        acts = shape.tokens / chips * cfg.d_model * 2 * 4
        return w + acts
    if shape.kind == "prefill":
        w = per_dev * 2
        acts = shape.tokens / chips * cfg.d_model * 2 * 4
        return w + acts
    # decode: weights (active for MoE) + full cache read per token
    active = cfg.active_param_count() / chips
    hd = cfg.resolved_head_dim
    if cfg.attention == "mla":
        cache_row = cfg.kv_lora_rank + cfg.rope_head_dim
    elif cfg.attention == "none":
        cache_row = 0
    else:
        cache_row = 2 * cfg.num_kv_heads * hd
    layers = cfg.num_layers if cfg.family != "hybrid" \
        else cfg.num_layers // max(cfg.shared_attn_every, 1)
    cache = shape.global_batch * shape.seq_len * cache_row * 2 * layers \
        / chips
    return active * 2 + cache


@dataclasses.dataclass
class Roofline:
    compute_s: float
    memory_s: float
    memory_floor_s: float
    collective_s: float
    bottleneck: str
    model_flops: float
    useful_ratio: float

    def row(self) -> Dict[str, Any]:
        return dataclasses.asdict(self)


def analyze(artifact: Dict[str, Any], chips: int, *, cfg=None,
            shape=None) -> Roofline:
    """The three per-device terms of a dry-run artifact on H100s, and the
    analytic model FLOPs. ``cfg`` and ``shape`` default to the artifact's
    registered config and shape (a cell counted at another shape, such as
    a training run's own batch, passes its ``ShapeSpec``)."""
    from repro_torch.configs import get_config, get_shape

    cfg = cfg if cfg is not None else get_config(artifact["arch"])
    shape = shape if shape is not None else get_shape(artifact["shape"])
    flops = artifact.get("flops_corrected", artifact["flops"])
    bts = artifact.get("bytes_corrected", artifact["bytes_accessed"])
    coll = artifact.get("collective_bytes_corrected",
                        artifact["collective_bytes"])
    coll_total = sum(v for k, v in coll.items() if k != "counts")
    compute_s = flops / PEAK_FLOPS
    memory_s = bts / HBM_BW
    floor_s = memory_floor_bytes(cfg, shape, chips) / HBM_BW
    collective_s = coll_total / LINK_BW
    # bottleneck judged on the FLOOR memory estimate (bytes_accessed is a
    # pre-fusion upper bound; see the module docstring).
    terms = {"compute": compute_s, "memory": floor_s,
             "collective": collective_s}
    mf = model_flops(cfg, shape)
    return Roofline(
        compute_s=compute_s, memory_s=memory_s, memory_floor_s=floor_s,
        collective_s=collective_s,
        bottleneck=max(terms, key=terms.get),
        model_flops=mf,
        useful_ratio=mf / (flops * chips) if flops > 0 else 0.0)


def sweep(multi_pod: bool = False, device_type: str = "cuda") -> None:
    """Corrected-roofline pass over every applicable cell (single-pod by
    default, as the reference's)."""
    from repro_torch.configs import ARCH_IDS, get_config
    from repro_torch.configs.base import SHAPES, shape_applicable

    for arch in ARCH_IDS:
        cfg = get_config(arch)
        for s in SHAPES:
            ok, why = shape_applicable(cfg, s)
            if not ok:
                print(f"[skip] {arch} {s.name}: {why}", flush=True)
                continue
            r = corrected_cell(arch, s.name, multi_pod=multi_pod,
                               device_type=device_type)
            print(f"[{r['status']}] {arch} {s.name} "
                  f"flops={r.get('flops_corrected', r.get('flops'))}",
                  flush=True)


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--glob", default="torch_roofline_*.json")
    ap.add_argument("--sweep", action="store_true")
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda",
                    help="the sweep's mesh device type")
    args = ap.parse_args()
    if args.sweep:
        sweep(device_type=args.device)
        return
    import glob as g
    rows = []
    for path in sorted(g.glob(os.path.join(ARTIFACT_DIR, args.glob))):
        with open(path) as f:
            art = json.load(f)
        # baseline table: skip tagged variants
        if art.get("tag"):
            continue
        if art.get("status") != "ok":
            rows.append((art, None))
            continue
        chips = 512 if art["mesh"] == "pod2x16x16" else 256
        rows.append((art, analyze(art, chips)))
    hdr = (f"{'arch':27s}{'shape':13s}{'mesh':11s}{'compute_s':>11s}"
           f"{'mem_hlo_s':>11s}{'mem_floor':>10s}{'coll_s':>9s}"
           f"{'bound':>8s}{'useful':>8s}")
    print(hdr)
    for art, r in rows:
        if r is None:
            print(f"{art['arch']:27s}{art['shape']:13s}{art['mesh']:11s}"
                  f"  [{art['status']}] {art.get('reason', '')[:40]}")
            continue
        print(f"{art['arch']:27s}{art['shape']:13s}{art['mesh']:11s}"
              f"{r.compute_s:>11.4f}{r.memory_s:>11.4f}"
              f"{r.memory_floor_s:>10.4f}"
              f"{r.collective_s:>9.4f}{r.bottleneck:>8s}"
              f"{r.useful_ratio:>8.2f}")


if __name__ == "__main__":
    main()
