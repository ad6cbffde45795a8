"""The comparison that decides ``correct``.

The program's frames are held against ``reference/render.py``, which
renders the same scene from the same poses on its own: each checked
key-frame window is rendered again from its key frame, and its warped
frames are warped from the reference's own previous frame. The numbers
compared, each against the limit in ``limits/<workload>.json``:

- ``key_px``: the largest share, over the checked key frames, of pixels
  whose colour differs from the reference's by more than ``PX_TOL`` in
  some channel (preprocess, TAIT, binning, the blend kernel).
- ``warp_px``: the same over the checked warped frames (the warp, the
  re-render plan, DPES, the inpaint and the compose, on top).
- ``pairs``: the largest relative gap, over the checked key frames,
  between the program's pair counts and the reference's, tile by tile:
  the sum over tiles of the absolute difference in TAIT pairs, and in
  pairs binned (at most K a tile), over the reference's sum. On a warped
  frame a tile whose arrived pixels sit at the interpolation threshold
  may go either way, which moves the counts by a whole tile's pairs; the
  pixels of such frames are ``warp_px``'s.
- ``ldu``: tiles whose LDU block or position in it differs from the
  reference's schedule of the frame's own plan (its binned counts and
  active tiles as the program recorded them, which ``pairs`` holds to
  the reference's tile by tile on key frames): exact, limit 0.

Numbers a cell cannot give (the venue keeps no records) are left out.
"""
from __future__ import annotations

import json
from pathlib import Path
from typing import Dict, List

import numpy as np
import torch

from lsbench import peaks
from lsbench.reference import render as ref

PX_TOL = 1.0 / 255.0
LIMITS = Path(__file__).resolve().parent / "limits"


def load_limits(workload: str) -> Dict[str, float]:
    with open(LIMITS / f"{workload}.json") as f:
        return {k: float(v["limit"]) for k, v in json.load(f).items()
                if not k.startswith("_")}


def px_share(got: torch.Tensor, want: torch.Tensor) -> float:
    bad = (got.float() - want.float()).abs().amax(-1) > PX_TOL
    return float(bad.float().mean())


def tile_gap(got, want: torch.Tensor) -> float:
    """Sum over tiles of |got - want| over the sum of ``want``."""
    got = torch.as_tensor(got).to(want.device, torch.int64)
    return float((got - want).abs().sum()) / max(int(want.sum()), 1)


def reference_window(scene, cfg: dict, window: List[dict],
                     dtype=torch.float32) -> List[ref.Frame]:
    """The reference's frames of one key-frame window (``window``'s items
    carry ``pose`` and, on the venue, the round's ``capacity``)."""
    s = ref.Settings.from_config(cfg["render"])
    dev = scene[0].device
    views = [ref.make_view(torch.as_tensor(w["pose"], device=dev),
                           cfg["resolution_x"], cfg["resolution_y"],
                           cfg["fov_deg"]) for w in window]
    out = [ref.key_frame(scene, views[0], s, dtype)]
    for i in range(1, len(window)):
        out.append(ref.warped_frame(scene, out[-1], views[i - 1], views[i],
                                    s, window[i].get("capacity"), dtype))
    return out


def compare(cfg: dict, window: List[dict], frames: List[ref.Frame]
            ) -> Dict[str, float]:
    """The numbers of one window: program (``window``) against reference
    (``frames``)."""
    key = [px_share(w["rgb"], f.rgb) for w, f in zip(window, frames)
           if w["key"]]
    warp = [px_share(w["rgb"], f.rgb) for w, f in zip(window, frames)
            if not w["key"]]
    out = {"key_px": max(key, default=0.0),
           "warp_px": max(warp, default=0.0)}
    if "raw_pairs" not in window[0]:
        return out
    out["pairs"] = max(
        max(tile_gap(w["raw_pairs"], f.tile_raw),
            tile_gap(w["sort_pairs"], f.tile_sort))
        for w, f in zip(window, frames) if w["key"])
    if "block_of_tile" not in window[0]:
        return out
    tx = cfg["resolution_x"] // ref.TILE
    ty = cfg["resolution_y"] // ref.TILE
    ldu = 0
    for w in window:
        block, order = ref.ldu_schedule(
            w["sort_pairs"].cpu().numpy(), w["active"].cpu().numpy(), tx, ty,
            cfg["render"]["ldu_blocks"])
        ldu += int(((w["block_of_tile"].cpu().numpy() != block)
                    | (w["order_in_block"].cpu().numpy() != order)).sum())
    out["ldu"] = float(ldu)
    return out


def as_program(frames: List[ref.Frame]) -> List[dict]:
    """Reference frames in the form the check reads the program's: the
    control puts the reference, in a lower precision, in the program's
    place."""
    return [dict(rgb=f.rgb, key=f.is_key, raw_pairs=f.tile_raw,
                 sort_pairs=f.tile_sort) for f in frames]


def merge(parts: List[Dict[str, float]]) -> Dict[str, float]:
    """Worst of each number over the windows (``ldu`` summed)."""
    out: Dict[str, float] = {}
    for p in parts:
        for k, v in p.items():
            out[k] = out.get(k, 0.0) + v if k == "ldu" \
                else max(out.get(k, 0.0), v)
    return out


def judge(numbers: Dict[str, float], limits: Dict[str, float]):
    """(correct, [(name, value, limit)]): every number at or under its
    limit, and every limit's number present."""
    rows = [(k, numbers.get(k, float("nan")), v) for k, v in limits.items()]
    ok = bool(rows) and all(np.isfinite(x) and x <= lim
                            for _, x, lim in rows)
    return ok, rows


def work(frames: List[ref.Frame], n_gaussians: int, lanes: int) -> dict:
    """The least time the card could take for the reference's count of
    the work on ``frames``: the blend alone, and the blend with the
    preprocess (the intersect is left out)."""
    blend_flops = sum(f.evaluated * peaks.EVAL_FLOPS
                      + f.blended * peaks.BLEND_FLOPS for f in frames)
    blend_bytes = sum(peaks.blend_bytes(f.sort_pairs, f.tiles, lanes)
                      for f in frames)
    pre_flops = len(frames) * n_gaussians * peaks.PREPROCESS_FLOPS
    pre_bytes = len(frames) * peaks.preprocess_bytes(n_gaussians)
    return dict(blend_s=peaks.bound_s(blend_flops, blend_bytes),
                frame_s=peaks.bound_s(blend_flops + pre_flops,
                                      blend_bytes + pre_bytes))
