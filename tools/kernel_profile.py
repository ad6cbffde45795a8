#!/usr/bin/env python3
"""Profile the port's CUDA raster and sort kernels on one GPU.

    python3 tools/kernel_profile.py [--baseline CSRC_DIR] [--sass DIR]

Inputs are chip_smoke.py's: the first key frame's (8160, 1024) bins of
its trajectory cell (1920x1088, 131,072 Gaussians) for the tile raster
kernel and the fused kernel, and those bins' depth keys with int32 ids
for the tile sorter. For each kernel it prints nvcc's registers and
spills, the occupancy those registers, the CTA size and the shared
memory allow (theoretical: 2048 threads, 32 CTAs, 65,536 registers and
228 KiB a SM), the static SASS opcode mix (``cuobjdump -sass``) and the
device time (chip_smoke.kernel_ms: profiler, median of 20, L2 flushed).

``--baseline CSRC_DIR`` builds the two raster kernels of another source
tree with the same C interface, for example an older commit's
(``mkdir -p build/old && git archive <commit> src/repro_torch/csrc |
tar -x -C build/old``, then ``--baseline build/old/src/repro_torch/csrc``),
times each against the current build in turns (baseline, current,
current, baseline) and holds the six outputs of each pair bit for bit:
the tile raster kernel at chunk 64, 16 and 256 and, on the first 960
lanes, 48; the fused kernel at chunk 64.

``--sass DIR`` writes each current kernel's SASS to ``DIR``.
"""
import argparse
import contextlib
import ctypes
import math
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(ROOT / "src"))

import torch  # noqa: E402

import chip_smoke as cs  # noqa: E402

RASTER = ("raster_tile", "raster_plan")
SYMBOL = {"raster_tile": "raster_tile_kernel",
          "raster_plan": "raster_plan_kernel",
          "tile_sort": "tile_sort_kernel"}
OUTPUTS = ("rgb", "trans", "exp_depth", "trunc_depth", "processed",
           "lane_contrib")


def theoretical_occupancy(regs, threads, smem):
    """(CTAs a SM, resident warps / 64) that registers, threads and shared
    memory allow on an H100 (registers allocated per warp in units of
    256, 1 KiB of shared memory reserved per CTA)."""
    warps = math.ceil(threads / 32)
    per_warp = math.ceil(regs * 32 / 256) * 256
    ctas = min(32, 2048 // threads, 65536 // (per_warp * warps),
               (228 * 1024) // (smem + 1024))
    return ctas, ctas * warps / 64


def ptxas_lines(report, symbol):
    """nvcc -Xptxas -v's lines for the entry function ``symbol``."""
    lines = report.splitlines()
    for i, line in enumerate(lines):
        if "Compiling entry function" in line and symbol in line:
            return [ln.strip() for ln in lines[i + 1:i + 6]
                    if "registers" in ln or "spill" in ln]
    return []


def registers(lines):
    for ln in lines:
        if "registers" in ln:
            return int(ln.split("Used ")[1].split(" registers")[0])
    return 0


def build(csrc, out_dir, names):
    """Compile ``names`` from ``csrc`` into ``out_dir``; returns name ->
    (CDLL, library path, ptxas report)."""
    from repro_torch.kernels import _build
    libs = {}
    for name in names:
        out = Path(out_dir) / f"lib{name}.so"
        _, report = _build.compile_library(name, csrc=Path(csrc), out=out)
        libs[name] = (ctypes.CDLL(str(out)), out, report)
    return libs


@contextlib.contextmanager
def using(libs):
    """Route the kernel wrappers' library loads to ``libs``."""
    from repro_torch.kernels import _build
    load = _build.load_library
    _build.load_library = lambda name: libs[name][0]
    try:
        yield
    finally:
        _build.load_library = load


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--baseline", default=None, metavar="CSRC_DIR")
    ap.add_argument("--sass", default=None, metavar="DIR")
    opt = ap.parse_args()
    if not torch.cuda.is_available():
        print("kernel_profile.py needs a CUDA GPU", file=sys.stderr)
        return 1
    from repro_torch.core.camera import make_camera
    from repro_torch.core.pipeline import RenderConfig
    from repro_torch.kernels import _build, raster_plan, raster_tile, \
        tile_sort
    from repro_torch.scenes.synthetic import structured_scene
    from repro_torch.scenes.trajectory import dolly_trajectory

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip()
    print(f"nvidia-smi: {smi}", flush=True)
    cur = build(_build.CSRC, _build.BUILD_DIR, (*RASTER, "tile_sort"))
    base = None
    if opt.baseline:
        base = build(opt.baseline, ROOT / "build" / "baseline", RASTER)

    poses = dolly_trajectory(cs.N_FRAMES, start=(0.0, -0.3, -2.0),
                             target=(0.0, 0.0, 6.0))
    cam = make_camera(poses[0], width=cs.WIDTH, height=cs.HEIGHT)
    scene = structured_scene(cs.SEED, cs.N_GAUSSIANS, sh_degree=3)
    cfg = RenderConfig(capacity=1024, chunk=64, window=5,
                       intersect_method="tait", use_dpes=True,
                       ldu_blocks=32)
    args = cs.key_frame_bins(scene, cam, cfg)[3]
    del scene
    depth, counts = args[4], args[6]
    t, k = depth.shape
    lane = torch.arange(k, device=depth.device)
    keys = torch.where(lane[None] < counts[:, None], depth,
                       float("inf")).contiguous()
    ids = lane[None].expand(t, k).to(torch.int32).contiguous()
    chunk = 64
    active = torch.ones((t,), dtype=torch.bool, device=depth.device)
    calls = {"raster_tile": lambda: raster_tile.raster_tile_cuda(
                 *args, chunk=chunk),
             "raster_plan": lambda: raster_plan.raster_plan_cuda(
                 *args, active, chunk=chunk),
             "tile_sort": lambda: tile_sort.tile_sort_cuda(keys, ids)}

    print(f"== static: bins R={t} K={k} pairs={int(counts.sum())}",
          flush=True)
    k_pad = raster_plan.pow2_at_least(max(k, chunk))
    lay = tile_sort.sort_layout(k)
    shape = {"raster_tile": (256, (10 * k + 8 * chunk) * 4),
             "raster_plan": (256, (12 * k_pad + 8 * chunk) * 4),
             "tile_sort": (lay.threads, lay.smem)}
    # The sorter's source instantiates one kernel per (E, CTA bound).
    symbol = dict(SYMBOL, tile_sort="tile_sort_kernelILi%dELi%dE" % (
        lay.e, 256 if lay.threads <= 256 else 1024))
    for kind, libs in (("current", cur), ("baseline", base or {})):
        for name, (_, path, report) in libs.items():
            lines = ptxas_lines(report, symbol[name])
            text = f"  {kind} {name}: {'; '.join(lines)}"
            if kind == "current":
                threads, smem = shape[name]
                ctas, occ = theoretical_occupancy(registers(lines), threads,
                                                  smem)
                text += (f"; {threads} threads, {smem} B shared a CTA -> "
                         f"{ctas} CTAs/SM, theoretical occupancy {occ:.3f}")
            print(text, flush=True)
            mix = cs.opcode_mix(path, symbol[name])
            top = sorted(mix.items(), key=lambda kv: -kv[1])[:24]
            print(f"    static SASS ({sum(mix.values())} instructions): "
                  f"{dict(top)}", flush=True)
            if opt.sass and kind == "current":
                Path(opt.sass).mkdir(parents=True, exist_ok=True)
                (Path(opt.sass) / f"{name}.sass").write_text(
                    "\n".join(cs.sass(path, symbol[name])) + "\n")

    flush = torch.empty(64 << 20, dtype=torch.uint8, device="cuda")
    print("== device ms (profiler, median of 20, L2 flushed)", flush=True)
    with using(cur):
        for name, fn in calls.items():
            if base is None or name not in base:
                ms = cs.kernel_ms(fn, SYMBOL[name], 20, flush)
                print(f"  {name}: {ms:.4f}", flush=True)
                continue
            times = []
            for kind in ("baseline", "current", "current", "baseline"):
                with using(base if kind == "baseline" else cur):
                    ms = cs.kernel_ms(fn, SYMBOL[name], 20, flush)
                times.append(f"{kind} {ms:.4f}")
            print(f"  {name}: {', '.join(times)}", flush=True)

    if base is None:
        return 0
    print("== baseline vs current outputs", flush=True)
    cut = tuple(x[:, :960].contiguous() for x in args[:5]) \
        + (args[5], args[6].clamp(max=960))
    cases = [("raster_tile", bins, c) for bins, c in
             ((args, 64), (args, 16), (args, 256), (cut, 48))]
    cases.append(("raster_plan", args, 64))
    same_all = True
    for name, bins, c in cases:
        outs = []
        for libs in (cur, base):
            with using(libs):
                outs.append(
                    raster_tile.raster_tile_cuda(*bins, chunk=c)
                    if name == "raster_tile" else
                    raster_plan.raster_plan_cuda(*bins, active, chunk=c))
        torch.cuda.synchronize()
        same = {n: torch.equal(g.view(torch.int32), w.view(torch.int32))
                for n, g, w in zip(OUTPUTS, *outs)}
        diff = {n: cs.max_err(g.float(), w.float())
                for n, g, w in zip(OUTPUTS, *outs) if not same[n]}
        same_all = same_all and all(same.values())
        print(f"  {name} K={bins[3].shape[1]} chunk={c}: all six "
              f"bit-identical {all(same.values())}; differences {diff}",
              flush=True)
    return 0 if same_all else 1


if __name__ == "__main__":
    sys.exit(main())
