#!/usr/bin/env python3
"""Profile the port's CUDA kernels on one GPU.

    python3 tools/kernel_profile.py [--baseline CSRC_DIR] [--sass DIR]

Inputs are chip_smoke.py's: the first key frame's (8160, 1024) bins of
its trajectory cell (1920x1088, 131,072 Gaussians) for the tile raster
kernel and the fused kernel, those bins' depth keys with int32 ids for
the tile sorter, and the scene's 131,072 Gaussians at the first pose for
the preprocess kernel. For each kernel it prints nvcc's registers and
spills, the occupancy those registers, the CTA size and the shared
memory allow (theoretical: 2048 threads, 32 CTAs, 65,536 registers and
228 KiB a SM), the static SASS opcode mix (``cuobjdump -sass``) and the
device time (chip_smoke.kernel_ms: profiler, median of 20, L2 flushed).

``--baseline CSRC_DIR`` takes another source tree of the package, for
example an older commit's (``mkdir -p build/old && git archive <commit>
src/repro_torch | tar -x -C build/old``, then ``--baseline
build/old/src/repro_torch/csrc``). It builds that tree's two raster
kernels (same C interface), times each against the current build in
turns (baseline, current, current, baseline) and holds the six outputs
of each pair bit for bit: the tile raster kernel at chunk 64, 16 and 256
and, on the first 960 lanes, 48; the fused kernel at chunk 64. Where the
tree's ``kernels/preprocess.py`` (beside CSRC_DIR) has the Triton
preprocess kernel of the port's first slices, it imports that module
from the tree's path, times its kernel against the current CUDA one in
turns (device time, and launch-inclusive time by CUDA events) and holds
the current kernel's outputs to it with phase 2b's tolerances.

``--sass DIR`` writes each current kernel's SASS to ``DIR``.
"""
import argparse
import contextlib
import ctypes
import importlib.util
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
          "tile_sort": "tile_sort_kernel",
          "preprocess": "preprocess_kernel"}
OUTPUTS = ("rgb", "trans", "exp_depth", "trunc_depth", "processed",
           "lane_contrib")


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


def triton_preprocess(csrc):
    """The Triton preprocess module of the tree whose ``csrc`` is given
    (its ``kernels/preprocess.py``, imported from that path), or None
    where the tree has none."""
    path = csrc.parent / "kernels" / "preprocess.py"
    if not path.exists() or "preprocess_geom_triton" not in path.read_text():
        return None
    spec = importlib.util.spec_from_file_location("baseline_preprocess",
                                                  path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


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
    from repro_torch.kernels import (_build, preprocess, raster_plan,
                                     raster_tile, tile_sort)
    from repro_torch.scenes.synthetic import structured_scene
    from repro_torch.scenes.trajectory import dolly_trajectory

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip()
    print(f"nvidia-smi: {smi}", flush=True)
    cur = build(_build.CSRC, _build.BUILD_DIR,
                (*RASTER, "tile_sort", "preprocess"))
    base, base_pre = None, None
    if opt.baseline:
        base = build(opt.baseline, ROOT / "build" / "baseline", RASTER)
        base_pre = triton_preprocess(Path(opt.baseline))

    poses = dolly_trajectory(cs.N_FRAMES, start=(0.0, -0.3, -2.0),
                             target=(0.0, 0.0, 6.0))
    cam = make_camera(poses[0], width=cs.WIDTH, height=cs.HEIGHT)
    scene = structured_scene(cs.SEED, cs.N_GAUSSIANS, sh_degree=3)
    cfg = RenderConfig(capacity=1024, chunk=64, window=5,
                       intersect_method="tait", use_dpes=True,
                       ldu_blocks=32)
    args = cs.key_frame_bins(scene, cam, cfg)[3]
    pre_in = cs.preprocess_inputs(scene, cam)
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
             "tile_sort": lambda: tile_sort.tile_sort_cuda(keys, ids),
             "preprocess": lambda: preprocess.preprocess_geom_cuda(*pre_in)}

    print(f"== static: bins R={t} K={k} pairs={int(counts.sum())}",
          flush=True)
    k_pad = raster_plan.pow2_at_least(max(k, chunk))
    lay = tile_sort.sort_layout(k)
    shape = {"raster_tile": (256, (10 * k + 8 * chunk) * 4),
             "raster_plan": (256, raster_plan.smem_bytes(k_pad, chunk)),
             "tile_sort": (lay.threads, lay.smem),
             "preprocess": (128, 0)}
    # The sorter's source instantiates one kernel per (E, CTA bound), the
    # fused kernel's one per E.
    symbol = dict(SYMBOL, tile_sort="tile_sort_kernelILi%dELi%dE" % (
        lay.e, 256 if lay.threads <= 256 else 1024))
    for kind, libs in (("current", cur), ("baseline", base or {})):
        sym = dict(symbol)
        if kind == "current":
            sym["raster_plan"] = "raster_plan_kernelILi%dE" % (
                raster_plan.items_per_thread(k_pad))
        for name, (_, path, report) in libs.items():
            lines = cs.ptxas_lines(report, sym[name])
            text = f"  {kind} {name}: {'; '.join(lines)}"
            if kind == "current":
                threads, smem = shape[name]
                ctas, occ = cs.theoretical_occupancy(cs.registers(lines),
                                                     threads, smem)
                text += (f"; {threads} threads, {smem} B shared a CTA -> "
                         f"{ctas} CTAs/SM, theoretical occupancy {occ:.3f}")
            print(text, flush=True)
            mix = cs.opcode_mix(path, sym[name])
            top = sorted(mix.items(), key=lambda kv: -kv[1])[:24]
            print(f"    static SASS ({sum(mix.values())} instructions): "
                  f"{dict(top)}", flush=True)
            if opt.sass and kind == "current":
                Path(opt.sass).mkdir(parents=True, exist_ok=True)
                (Path(opt.sass) / f"{name}.sass").write_text(
                    "\n".join(cs.sass(path, sym[name])) + "\n")

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
        if base_pre is not None:
            dev, launch = [], []
            for kind in ("baseline", "current", "current", "baseline"):
                fn = (lambda: base_pre.preprocess_geom_triton(*pre_in)) \
                    if kind == "baseline" else calls["preprocess"]
                ms = cs.kernel_ms(fn, SYMBOL["preprocess"], 20, flush)
                dev.append(f"{kind} {ms:.4f}")
                launch.append(f"{kind} {cs.time_ms(fn, 20, flush):.4f}")
            print(f"  preprocess (baseline: Triton): {', '.join(dev)}; "
                  f"with its launch (CUDA events, median of 20): "
                  f"{', '.join(launch)}", flush=True)

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
    if base_pre is not None:
        with using(cur):
            got = calls["preprocess"]()
        cs.check_preprocess(got, base_pre.preprocess_geom_triton(*pre_in),
                            "current CUDA vs baseline Triton preprocess")
    return 0 if same_all else 1


if __name__ == "__main__":
    sys.exit(main())
