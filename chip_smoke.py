#!/usr/bin/env python3
"""Run the PyTorch + CUDA port's main path on one GPU and check it.

    python3 chip_smoke.py

Phases (each prints its own lines; a failed check exits non-zero):

1. Device: the card's name and power limit, the seven kernel libraries
   built from ``src/repro_torch`` (one nvcc per ``csrc/*.cu``, all seven
   started together), their build times and ptxas lines.
2. Kernels vs their plain PyTorch versions on the card, at the main
   paths' shapes: the first key frame's real (R = 8160, K = 1024) bins
   for the fused sort + blend kernel (2a: as binned, with lanes shuffled
   per slot, with masked slots, at K = 960 against the plain version and
   at K = 2,048 and 4,096 bit for bit against K = 1,024; its registers,
   shared memory, CTAs a SM and its sort's sweeps per level) and the
   tile raster kernel (2c:
   against its plain version and bit for bit against the fused kernel,
   at chunk 64 and also 16 and 256, and at chunk 48 on the first 960
   lanes against the plain version; its static SASS by class and the
   (pixel, lane) evaluations it runs), all N Gaussians for the
   preprocess kernel (2b, with its registers and CTAs a SM), and that
   frame's (8160, 1024) depth keys with
   int32 ids for the tile sorter (2d, exact, through its counting
   wrapper; also rows with ties, NaN, -0, +-inf, K not a power of two,
   K = 1, 257, 4096 and 16384; each case's layout and its network's
   sweeps per level: register, warp shuffle, shared memory). 2e: the LDU
   fill kernel exactly against its plain version (the host scan) on the
   key frame's bin counts (B = 32) and a warped frame's, at B = 1, 7,
   33, 64, in its dynamic mode, and on inputs that force every branch
   (all workloads zero, all equal, one above the cap, none active, sums
   past 2**24). 2f: the sparse TAIT intersect and binning kernels
   exactly against their plain version and the dense path (every field
   of ``intersect_and_bin``) at the benchmark's key frames (1.1 M
   Gaussians x 2,170 tiles at 992x560, 560 k x 8,160 at 1920x1088) and
   on a warped frame one 4-degree turn step later (re-render plan, DPES
   limits; once more with a cull), with one host wait a call.
   Each kernel's median device time (profiler), its time with the launch
   (CUDA events), the plain version's time, a library call's time where
   one computes the same function, and the least time the card could
   take for the work these inputs need (bytes over 3.35 TB/s or fp32
   operations over 67 TFLOP/s). 2a and 2c bound the pixels past rounding:
   stop flips (T near 1e-4) and alpha flips (a lane's alpha within
   ALPHA_ULPS of 1/255), each within its derived bound, at most 1e-4 of
   the pixels in all. For the LDU fill also the floor of its
   design, printed apart: active slots x one dependent step's latency.
3. The slice: a 10-frame dolly trajectory at 1920x1088 over a
   131,072-Gaussian structured scene (SH degree 3) with capacity 1024,
   chunk 64, window 5, TAIT, DPES, 32 LDU blocks — 2 key frames and 8
   warped frames through ``engine.render_trajectory``. Checks the launch
   counts, finite frames, the key frame against the plain raster, and
   every warped frame's PSNR (> 24 dB) against a full render of its pose.
3b. Culling: the same trajectory at ``cull_threshold=2.0``; sparse frames
   >= 30 dB against the unculled run, strictly fewer sort pairs over the
   sparse frames, and pairs actually culled.
3c. The paper's accelerator ablation (Figs. 14/15, Tab. I) on phase 3's
   records and on a ``window=1`` render of the same poses: the model
   cycles per frame, speedup against ``gpu_like``, utilization and sort
   stall of ``gpu_like``, ``gscore_like``, ``ld1``, ``ls_gaussian`` and
   ``recorded``; the tiles whose recorded (device) block differs from
   the host golden's, with the float32 and float64 caps (a frame that
   differs must have an integer between them); DPES ``predict_workload`` on the warped frames, held to
   their records.
4. Profile of one key and one warped frame (stage spans, idle share).
5. Serve: ``StreamServer`` over two scenes padded into one 131,072
   bucket (``structured_scene`` 131,072 and ``random_blob_scene``
   100,000, SH degree 3) with impl "cuda", Poisson traffic of 6 streams
   of 8-12 frames, elastic B in (2, 4) and R in (512, 1024, 2048).
   Checks that every stream finishes, that a served session's frames
   equal a solo render of its poses bit for bit, that the tile raster
   kernel (not the fused one) rendered, that padding rows are invalid,
   the bound on cache keys and the Chrome trace; prints latency,
   frames/s, the B and R histories, first vs steady rounds, peak memory
   and the device idle share of one profiled round; the LDU fill kernel
   launched once per served frame.
5b. The slot split (``serve/placement.py``): 4 streams of 4 frames over
   phase 5's two scenes through ``build_render_fn(cam, cfg, (cuda:0,) *
   D, multi_scene=True)`` for D = 4 (one slot a group: the single-stream
   branch) and D = 2, each against the plain path (frames and carries
   within 1e-5, records exact), with both paths' wall times and the
   kernels' launches; then phase 5's traffic through a ``StreamServer``
   with ``use_sharding`` on the card's own devices (``num_devices`` 1)
   and forced onto ``(cuda:0,) * 2`` (``num_devices`` 2), every session
   of the forced run equal to its solo render bit for bit. The groups
   share one card and run one after another: no gain is expected.
6. LM serving (the renderer's tensors freed first): yi-9b at its
   published width and depth in bfloat16 (8.83 B parameters, random
   weights from a seed). ``launch/serve.serve`` at the launcher's
   defaults (8 requests, 4 slots, prompt 16, max_new 16, max_seq 64):
   every request finishes; tok/s and peak memory. The serve loop's
   decode step timed alone (median of 20 after warm-up, CUDA events)
   against its bound (weight + cache bytes over 3.35 TB/s), and one step
   profiled (kernel time, launches, idle share).
   ``serve_step.greedy_generate`` at batch 2 x 2,048 prompt, 16 new
   tokens, through the flash prefill. ``decode_step`` against
   ``forward``'s last position, gated at LM_BF16_GATE x std(logits),
   and the same decode one position early shown to fail that gate.
6b. The four registered configs (yi-9b, starcoder2-7b, minicpm3-4b,
   moonshot-v1-16b-a3b) at full width, depth cut to 4 layers, float32
   with TF32 off: prefill -> decode, ``attn_impl`` "flash" (also with
   ``causal_skip``) against "sdpa" on a 2,048 prompt, and three decode
   steps at batch 4 (moonshot: the capped MoE decode dispatch), each
   gated at LM_F32_GATE x std(logits). This slice adds no kernel: the
   reference computes attention in jnp, outside any Pallas kernel.
6c. The ssm, hybrid, encdec and vlm families (mamba2-780m, zamba2-7b,
   whisper-large-v3, internvl2-2b from tests/_torch_family_configs.py)
   at full width. float32 with TF32 off, depth cut to LM_CHECK_LAYERS
   (zamba2: one shared group of 6 and a tail of 1; whisper's encoder as
   deep as its decoder), each gate LM_F32_GATE x std(logits): mamba2's
   prefill of FAMILY_PROMPT (two SSD chunks) + FAMILY_DECODE decode
   steps against the forward, and the forward at ssm_chunk 256 against
   a finer chunk; zamba2's decode steps from ``init_cache`` against the
   forward (the reference's forward builds no decode-layout cache for
   it); whisper's and internvl2's (after the 256-token vision prefix)
   prefill + one decode step against the forward, and whisper's decode
   through the projected ``enc_out`` against the precomputed
   ``cross_kv``. Then each at full depth in bf16 from seeded random
   weights: batch 4, a 512-token prompt (zamba2: through
   ``decode_step``), 32 greedy decode steps twice from the prompt's
   cache (the same ids), every logit finite; prefill and decode-step
   medians, tok/s, launches of a profiled step, peak memory, and the
   decode bound (weight + cache bytes over the HBM rate). No kernel:
   the reference's Mamba2 mixer and cross-attention are jnp.
7. LM training (phase 6's weights freed first): minicpm3-4b at its
   published width and depth (62 layers, MLA, 4.26 B parameters) in
   bfloat16 with ``remat="full"``, random weights from a seed, through
   ``launch/train.train_loop`` at the launcher's defaults (batch 8, seq
   128, the CLI's optimizer config) for TRAIN_STEPS steps: every step's
   loss (finite), grad norm, lr and time (CUDA events); the median step
   after the first against its bound (the larger of the executed FLOPs
   over the bf16 peak and the bytes the step must move over the HBM
   rate), MFU (6 N D over the step time at the bf16 peak), tokens/s and
   peak memory; one step profiled (launches, idle share, top kernels;
   its optimizer's AdamW kernel launches counted, 3, and the eager loop
   never called),
   one counted under ``FlopCounterMode`` (phase 9b's reference) and one
   more split into forward, backward and optimizer. Then the same state
   at the train4k cell's batch, 2 x 4,096, where every layer's attention
   takes the flash kernel: two steps timed, the second counted
   (``flash_attention`` called 124 times, 124 forward and 124 backward
   launches: 62 layers, forward and recompute, two backward kernels a
   layer), and their peak memory; ``lsbench``'s train4k cell times the
   step.
7a. The flash attention kernel (``csrc/flash_attention.cu``) at MiniCPM3's
   train4k shape (B 2, S 4,096, 40 heads, K 96, Kv 64, bf16, causal; k and
   v as MLA's transposed views, as the train step passes them): its three
   kernels' ptxas lines, shared memory and occupancy; the forward and all
   three gradients against the chunk loop (the plain version) in bf16
   and in float32: by norm, each at least as close to the float32 one as
   the bf16 loop and within FLASH_REL_TOL of it; the forward's device ms
   (calls queued between CUDA events) against its bound (the causal
   products at the bf16 peak) and with its launch, the backward's against
   twice the bound; the chunk loop's ms and
   ``F.scaled_dot_product_attention``'s (the library yardstick, never
   called by the port). ``python3 chip_smoke.py --only 7a`` runs phase 1
   and this phase alone.
7c. The AdamW kernel (``csrc/adamw.cu``) over minicpm3-4b's 871 leaves at
   full size (bf16 parameters and gradients drawn from a seed, float32
   moments, 51 GB): its three kernels' ptxas lines and occupancy; one
   ``adamw_update`` (three launches, the eager loop never called), its
   norm within ADAMW_NORM_TOL of float64 and, leaf by leaf from the same
   draws, the eager loop given the kernel's norm: parameters and moments
   bit for bit; a second call's norm of the same gradients bit-equal;
   device ms of the kernel (all three by CUDA events around queued
   calls; each kernel's in the profiler where a trace holds every
   launch's record, which after phase 7 it may not) and of the eager
   loop (CUDA events) against the bound, 24 bytes a bf16 element and 32
   a float32 one at the HBM rate.
   ``python3 chip_smoke.py --only 7c`` runs phase 1 and this phase alone.
7b. The four registered configs at full width, depth cut to
   TRAIN_CHECK_LAYERS layers, float32 with TF32 off: one train step with
   ``remat="full"`` against ``"none"`` (loss, gradients and updated
   parameters, each within its stated bound); the loss's gradient along
   a seeded direction in float64 against a central difference; and a
   checkpoint save -> restore -> next step that reproduces the
   uninterrupted step exactly (deterministic algorithms on).
8. Sharded training (phase 7's state freed first): the same minicpm3-4b
   run through ``launch/train.train_loop(mesh=make_mesh((1, 1), ("data",
   "model"), "cuda"))`` for SHARD_STEPS steps on a DTensor mesh over an
   NCCL process group of world size 1 (the machine has one card and
   NCCL refuses two ranks on one GPU, so every rule's axis has size 1
   and each leaf is placed ``Replicate()``; meshes of several ranks are
   held by the gloo tests on CPU ranks). Checks: every loss finite, the
   first equal to phase 7's bit for bit and the later ones within
   SHARD_LOSS_GATE; every parameter and moment a DTensor with the
   placements ``param_shardings`` gives; a checkpoint saved from the
   mesh written bit for bit, restored onto the mesh and onto the
   unsharded path bit for bit, and the next step's loss equal on both;
   one profiled step's optimizer through the AdamW kernel's update on the
   local tensors (1 launch, the eager loop never called). Prints the step
   median against phase 7's and the bound, MFU, peak memory, and that
   step's launches and idle share.
8b. Over the same group: ``compressed_psum_grads`` over phase 8's full
   gradient tree (dequantized + residual = input exactly; timed in turns
   against a plain all-reduce of each leaf) and ``pipeline_apply`` with
   one stage on a toy stack at d_model 2,560 against the sequential loop.
9. The dry-run (``launch/dryrun.py``) at the four configs' published
   widths: every shape on the fake 16 x 16 group and yi-9b decode_32k on
   2 x 16 x 16, each cell a ``python -m repro_torch.launch.dryrun``
   process, DRYRUN_PROCS at once (a fake group cannot share a process
   with phase 8's NCCL one), started when phase 7 ends so that they run
   beside phase 7b, which times nothing, and reported after 7b, before
   phase 8's timed steps. Every applicable cell must be ``ok`` and
   ``long_500k`` skipped with the reference's reason; prints each
   cell's per-device FLOPs, bytes, collective bytes by kind, memory and
   seconds, and its ``launch/roofline.analyze`` terms on H100 constants;
   each train_4k cell's temp beside its value while the loss's gradient
   was held at its global shape (it must fall; yi-9b's below 60 GB).
9b. Phase 7's own cell counted on a (1, 1) fake mesh: its FLOPs equal
   phase 7's ``FlopCounterMode`` count of a real step exactly; its
   predicted peak memory (arguments + temp) within DRYRUN_MEM_BAND of
   phase 7's measured peak; the ratio of its FLOPs to
   ``train_step_bound``'s and of the roofline's bound to phase 7's
   median step.

The last two lines are the kernels' JSON record and the device record.
Needs a CUDA GPU; exits non-zero without one.
"""
import dataclasses
import gc
import json
import math
import os
import statistics
import subprocess
import sys
import time

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                "src"))

import numpy as np  # noqa: E402
import torch  # noqa: E402

# The card's published peaks (H100 SXM data sheet, 700 W; dense rates),
# one source for this script and the port's roofline.
from repro_torch.hardware import (BF16_FLOPS_PER_S,  # noqa: E402
                                  FP32_FLOPS_PER_S, HBM_BYTES_PER_S)
# Floating-point operations the blend needs per (pixel, real lane) reached
# while the pixel is not yet done: offsets 2, power 9, exp 1, alpha 3,
# stop test 1.
EVAL_FLOPS = 16
# ... and, on top, per (pixel, lane) with a nonzero weight: transmittance
# 5, weight 1, colour 6, depth 2, weight sum 1, truncated depth 1, min 1.
BLEND_FLOPS = 17
# Floating-point operations per Gaussian in the preprocess kernel
# (transform 18, quaternion + scales 40, covariances 50, Jacobian and 2D
# covariance 50, conic + eigen + radii 40).
PREPROCESS_FLOPS = 200
# Dependent cycles each active slot's step of the LDU fill kernel takes
# at least: the FADD of acc + w, then the FSETP against the cap that
# decides the next step (4 each; derived, not measured).
LDU_STEP_CYCLES = 8

N_GAUSSIANS = 131_072
BLOB_GAUSSIANS = 100_000    # phase 5's second scene
WIDTH, HEIGHT = 1920, 1088
N_FRAMES = 10
SEED = 0


def check(ok, what):
    if not ok:
        raise SystemExit(f"FAILED: {what}")
    print(f"  ok: {what}", flush=True)


def time_ms(fn, runs, flush):
    """Median ms of ``fn`` over CUDA events, L2 flushed before each run.

    The events enclose the host's work too (checks, allocations, the
    launch), so for one short kernel this is launch-inclusive time.
    """
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(runs):
        flush.zero_()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def queued_ms(fn, runs):
    """Device ms a call of ``fn``: ``runs`` calls queued back to back
    between two CUDA events, for calls whose kernels run far longer than
    their host work, so that the card never waits for the host."""
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(runs):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / runs


def kernel_ms(fn, kernel, runs, flush):
    """Median device duration (ms) of the kernel whose name contains
    ``kernel``, over ``runs`` calls of ``fn`` (L2 flushed before each),
    read from the profiler's CUDA trace: the kernel's own time, without
    the host's launch."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    # The trace now and then drops a launch's record; such a trace is
    # taken again, and the median is read only from one that holds all.
    for attempt in range(3):
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(runs):
                flush.zero_()
                fn()
            torch.cuda.synchronize()
        times = [e.time_range.elapsed_us() / 1e3 for e in prof.events()
                 if e.device_type == DeviceType.CUDA and kernel in e.name]
        if len(times) == runs:
            return statistics.median(times)
        print(f"  profiler trace {attempt + 1} holds {len(times)} of "
              f"{runs} launches of {kernel}", flush=True)
    raise SystemExit(f"FAILED: no profiler trace of 3 held all {runs} "
                     f"launches of {kernel}")


def bound(nbytes, flops):
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / FP32_FLOPS_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def max_err(a, b):
    return float((a - b).abs().max()) if a.numel() else 0.0


KERNELS = ("raster_tile", "raster_plan_fused", "preprocess_geom",
           "tile_sort", "ldu_fill", "intersect_bin")


def launch_counts(since=None):
    """Every kernel's launches in this process, by kernel name, less
    ``since`` (an earlier reading)."""
    from repro_torch.obs.metrics import kernel_launches
    since = since or {}
    return {k: int(kernel_launches(k).value) - since.get(k, 0)
            for k in KERNELS}


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


def print_occupancy(what, lines, threads, smem):
    """Print a kernel's ptxas lines and the CTAs a SM they allow."""
    ctas, occ = theoretical_occupancy(registers(lines), threads, smem)
    print(f"  {what}: {'; '.join(lines)}; {threads} threads, {smem} B "
          f"shared a CTA -> {ctas} CTAs/SM, theoretical occupancy "
          f"{occ:.3f}", flush=True)


def phase_device():
    from concurrent.futures import ThreadPoolExecutor
    from repro_torch.kernels import (adamw, flash_attention, intersect_bin,
                                     ldu_fill, preprocess, raster_plan,
                                     raster_tile, tile_sort)
    print("== phase 1: device", flush=True)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip()
    print(f"nvidia-smi: {smi}", flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    print(f"torch {torch.__version__} cuda {torch.version.cuda} "
          f"device {torch.cuda.get_device_name(0)}", flush=True)
    mods = (preprocess, raster_plan, raster_tile, tile_sort, ldu_fill,
            intersect_bin, flash_attention, adamw)
    t0 = time.perf_counter()
    with ThreadPoolExecutor(len(mods)) as pool:
        builds = [pool.submit(m.build) for m in mods]
        results = [b.result() for b in builds]
    print(f"build of {len(mods)} CUDA sources in parallel: "
          f"{time.perf_counter() - t0:.2f} s", flush=True)
    reports = {}
    for mod, (nvcc_s, report) in zip(mods, results):
        name = mod.__name__.rsplit(".", 1)[1]
        reports[name] = report
        print(f"build {name}.cu (nvcc, sm_90a): {nvcc_s:.2f} s", flush=True)
        for line in report.splitlines():
            if "registers" in line or "spill" in line:
                print(f"  ptxas: {line.strip()}")
    return smi, reports


def key_frame_bins(scene, cam, cfg):
    """The first key frame's plan, projected Gaussians and (R, K) bins."""
    from repro_torch.core import binning, intersect, pipeline, plan
    from repro_torch.core.projection import preprocess
    tplan = plan.full_plan(cam.tiles_x, cam.tiles_y, device=cam.device)
    proj = preprocess(scene, cam, near=cfg.near)
    grid = intersect.make_tile_grid(cam)
    slots = intersect.take_tiles(grid, tplan.tile_ids)
    bins = pipeline.intersect_and_bin(proj, grid, tplan, cfg, None)[0]
    tg = binning.gather_tiles(proj, bins)
    return tplan, proj, bins, (tg.mean2d, tg.conic, tg.rgb, tg.opacity,
                               tg.depth, slots.origins, bins.count)


def check_stop_flips(rgb_g, t_g, rgb_w, t_w, off, what):
    """Pixels past rounding must be stop flips, within their bound.

    At the sticky stop (T < 1e-4) a pixel whose transmittance lands
    within rounding of 1e-4 blends one Gaussian more in one version than
    in the other. Such a pixel has T < 1e-2 in both (alpha <= 0.99); the
    extra weight alpha * T_before is at most max(T) of the two, so T
    differs by at most max(T) and rgb by at most 2 max(T) (colours stay
    below 2). Flips may touch at most 1e-4 of the pixels.
    """
    n_off = int(off.sum())
    check(n_off <= off.numel() // 10_000,
          f"{what}: {n_off} pixels past rounding <= 1e-4 of {off.numel()}")
    t_max = torch.maximum(t_g[off], t_w[off])
    check(bool((t_max < 1e-2).all()),
          f"{what}: every pixel past rounding is at the T < 1e-4 stop")
    d_t = (t_g[off] - t_w[off]).abs()
    d_rgb = (rgb_g[off] - rgb_w[off]).abs().amax(dim=-1)
    check(bool((d_t <= t_max).all() and (d_rgb <= 2 * t_max).all()),
          f"{what}: at those pixels |dT| <= max T and |drgb| <= 2 max T "
          f"(max |dT| {max_err(t_g[off], t_w[off]):.3g}, max |drgb| "
          f"{max_err(rgb_g[off], rgb_w[off]):.3g})")
    return max(max_err(t_g[off], t_w[off]), max_err(rgb_g[off], rgb_w[off]))


# The blend's alpha cut (kernels/ref.py ALPHA_MIN), and how near it an
# alpha must lie to explain a pixel past rounding away from the stop:
# ALPHA_ULPS float32 ulps of 1/255 (2^-31 each), as the CPU tests hold
# the port's renders against the reference's (tests/_torch_parity.py).
ALPHA_MIN = 1.0 / 255.0
ALPHA_ULPS = 16
ALPHA_ULP = 2.0 ** -31


def lane_alphas(args, idx):
    """(n, K) alphas of every lane at the n tile pixels ``idx`` (rows of
    (slot, pixel row, pixel column)), as the blend computes them before
    its 1/255 cut."""
    mean2d, conic, _, opacity, _, origins, _ = args
    r = idx[:, 0]
    px = origins[r, 0] + idx[:, 2] + 0.5
    py = origins[r, 1] + idx[:, 1] + 0.5
    dx = px[:, None] - mean2d[r, :, 0]
    dy = py[:, None] - mean2d[r, :, 1]
    c = conic[r]
    power = (-0.5 * (c[..., 0] * dx * dx + c[..., 2] * dy * dy)
             - c[..., 1] * dx * dy)
    return torch.clamp_max(opacity[r] * torch.exp(power), 0.99)


def check_alpha_flips(rgb_g, t_g, rgb_w, t_w, off, alphas, what):
    """Pixels past rounding away from the stop must be alpha flips,
    within their bound.

    Where a Gaussian's alpha at a pixel lands within rounding of 1/255,
    one version blends it and the other does not: such a pixel holds a
    lane whose alpha (``alphas``, one row per pixel of ``off``) lies
    within ALPHA_ULPS of 1/255. That Gaussian, of alpha a, enters the
    blend at transmittance T_b <= 1 with the weight a T_b and scales the
    rest of the blend (weights summing to at most T_b, colours in
    [0, 2)) by 1 - a: T moves by at most a and rgb by at most 2 a, with a
    at most 1/255 + ALPHA_ULPS ulps. Flips may touch at most 1e-4 of the
    pixels.
    """
    n_off = int(off.sum())
    check(n_off <= off.numel() // 10_000,
          f"{what}: {n_off} pixels past rounding away from the stop "
          f"<= 1e-4 of {off.numel()}")
    if not n_off:
        return 0.0
    near = ((alphas - ALPHA_MIN).abs() <= ALPHA_ULPS * ALPHA_ULP).any(dim=1)
    check(bool(near.all()),
          f"{what}: each of those {n_off} pixels holds a lane whose alpha "
          f"lies within {ALPHA_ULPS} ulps of 1/255")
    a_hi = ALPHA_MIN + ALPHA_ULPS * ALPHA_ULP
    d_t = (t_g[off] - t_w[off]).abs()
    d_rgb = (rgb_g[off] - rgb_w[off]).abs().amax(dim=-1)
    check(bool((d_t <= a_hi).all() and (d_rgb <= 2 * a_hi).all()),
          f"{what}: at those pixels |dT| <= {a_hi:.6g} and |drgb| <= "
          f"{2 * a_hi:.6g} (max |dT| {max_err(t_g[off], t_w[off]):.3g}, "
          f"max |drgb| {max_err(rgb_g[off], rgb_w[off]):.3g})")
    return max(max_err(t_g[off], t_w[off]), max_err(rgb_g[off], rgb_w[off]))


def compare_raster(got, want, what, chunk, args):
    """Hold the fused kernel's outputs against the plain version's on the
    bins ``args``.

    Rounding (the plain version's cumprod is a parallel scan and its
    colour sum a matmul) keeps every pixel within atol 2e-5 (the
    reference suite's fused-vs-jnp pin) + rtol 1e-5 (depths run to ~20),
    except stop flips (``check_stop_flips``, pixels at T < 1e-2) and
    alpha flips (``check_alpha_flips``, the others): at most 1e-4 of
    the pixels in all.
    """
    names = ("rgb", "trans", "exp_depth", "trunc_depth")
    off = torch.zeros(got[1].shape, dtype=torch.bool, device=got[1].device)
    for g, w in zip(got[:4], want[:4]):
        bad = ~torch.isclose(g, w, atol=2e-5, rtol=1e-5)
        off |= bad.reshape(bad.shape[0], 16, 16, -1).any(dim=-1)
    errs = {n: max_err(g[~off], w[~off]) for n, g, w in
            zip(names, got[:4], want[:4])}
    print(f"  {what}: max abs err outside stop and alpha flips {errs}",
          flush=True)
    check(int(off.sum()) <= off.numel() // 10_000,
          f"{what}: {int(off.sum())} pixels past rounding in all (stop "
          f"and alpha flips) <= 1e-4 of {off.numel()}")
    stop = off & (torch.maximum(got[1], want[1]) < 1e-2)
    flip = check_stop_flips(got[0], got[1], want[0], want[1], stop, what)
    rest = off & ~stop
    flip = max(flip, check_alpha_flips(
        got[0], got[1], want[0], want[1], rest,
        lane_alphas(args, rest.nonzero()), what))
    d_proc = (got[4] - want[4]).abs()
    n_proc = int((d_proc > 0).sum())
    check(n_proc <= int(off.sum()) and int(d_proc.max()) <= chunk,
          f"{what}: processed pairs differ in {n_proc} slots, each by at "
          f"most one chunk, only where a pixel flipped")
    # Per-lane sums over 256 pixels in another order; a flip moves at
    # most 1e-2 onto one lane.
    check(torch.allclose(got[5], want[5], atol=1e-2, rtol=1e-4),
          f"{what}: lane_contrib within atol 1e-2 + rtol 1e-4 "
          f"(max abs err {max_err(got[5], want[5]):.3g})")
    return max(max(errs.values()), flip)


def shuffle_lanes(args, gen):
    """Permute each slot's first ``count`` lanes (padding stays put)."""
    mean2d, conic, rgb, opacity, depth, origins, counts = args
    r, k = opacity.shape
    lane = torch.arange(k, device=opacity.device)
    key = torch.rand((r, k), generator=gen, device=opacity.device)
    key = torch.where(lane[None] < counts[:, None], key, float("inf"))
    perm = torch.sort(key, dim=1, stable=True).indices

    def take(x):
        idx = perm if x.dim() == 2 else perm[..., None].expand_as(x)
        return torch.take_along_dim(x, idx, dim=1).contiguous()

    return (take(mean2d), take(conic), take(rgb), take(opacity),
            take(depth), origins, counts), perm


def tie_slots(depth, counts):
    """(R,) bool: slots where two real lanes share a depth. Their order is
    by lane, which a shuffle changes, so they are left out of the
    shuffled run's exact check."""
    k = depth.shape[1]
    lane = torch.arange(k, device=depth.device)
    key = torch.where(lane[None] < counts[:, None], depth, float("inf"))
    s = torch.sort(key, dim=1).values
    return ((s[:, 1:] == s[:, :-1]) & torch.isfinite(s[:, 1:])).any(dim=1)


def sort_levels(counts, k_pad):
    """Slots by the fused kernel's sort length n, and the sweeps of their
    sorts per level, summed over the slots."""
    from repro_torch.kernels import raster_plan
    rows, levels = {}, {}
    for c in counts.tolist():
        lay = raster_plan.sort_layout(c, k_pad)
        rows[lay.n if c > 0 else 0] = rows.get(lay.n if c > 0 else 0, 0) + 1
        for _, _, level in raster_plan.network_schedule(c, k_pad):
            levels[level] = levels.get(level, 0) + 1
    return dict(sorted(rows.items())), levels


def phase_raster_kernel(args, flush, report):
    from repro_torch.kernels import raster_plan
    print("== phase 2a: fused sort + blend kernel vs its plain version",
          flush=True)
    mean2d, conic, rgb, opacity, depth, origins, counts = args
    r, k = opacity.shape
    active = torch.ones((r,), dtype=torch.bool, device=opacity.device)
    print(f"  bins: R={r} K={k} pairs={int(counts.sum())}", flush=True)
    chunk = 64
    k_pad = raster_plan.pow2_at_least(max(k, chunk))
    e = raster_plan.items_per_thread(k_pad)
    print_occupancy(f"raster_plan_kernel<{e}>",
                    ptxas_lines(report, f"raster_plan_kernelILi{e}E"), 256,
                    raster_plan.smem_bytes(k_pad, chunk))
    rows, levels = sort_levels(counts, k_pad)
    total = sum(levels.values())
    full = {}
    for _, _, level in raster_plan.network_schedule(k_pad, k_pad):
        full[level] = full.get(level, 0) + 1
    print(f"  sort: E = {e}; slots by sorted items (0: not sorted) {rows}; "
          f"sweeps per level over the slots {levels} (shares "
          f"{ {lv: round(c / total, 4) for lv, c in levels.items()} }); a "
          f"full row of {k_pad}: {full}", flush=True)
    got = raster_plan.raster_plan_cuda(*args, active, chunk=chunk)
    work = {}
    want = raster_plan.raster_plan_torch(*args, active, chunk=chunk,
                                         work=work)
    torch.cuda.synchronize()
    err = compare_raster(got, want, "as binned", chunk, args)

    gen = torch.Generator(device=opacity.device).manual_seed(SEED + 1)
    shuf, perm = shuffle_lanes(args, gen)
    got_s = raster_plan.raster_plan_cuda(*shuf, active, chunk=chunk)
    torch.cuda.synchronize()
    ties = tie_slots(depth, counts)
    keep = ~ties
    print(f"  shuffled lanes: {int(ties.sum())} slots with equal depths "
          "left out of the exact check", flush=True)
    same = all(torch.equal(a[keep], b[keep]) for a, b in
               zip(got_s[:5], got[:5]))
    check(same, "shuffled lanes render bit-identically")
    check(torch.equal(got_s[5][keep],
                      torch.take_along_dim(got[5], perm, dim=1)[keep]),
          "shuffled lanes: lane_contrib permutes with the lanes")
    err = max(err, compare_raster(
        got_s, raster_plan.raster_plan_torch(*shuf, active, chunk=chunk),
        "shuffled", chunk, shuf))

    masked = torch.arange(r, device=opacity.device) % 2 == 0
    counts_m = torch.where(masked, counts, 0)
    got_m = raster_plan.raster_plan_cuda(*args[:6], counts_m, masked,
                                         chunk=chunk)
    torch.cuda.synchronize()
    off = ~masked
    check(bool((got_m[0][off] == 0).all() and (got_m[1][off] == 1).all()
               and (got_m[4][off] == 0).all() and (got_m[5][off] == 0).all()),
          "masked slots read empty (rgb 0, T 1, 0 pairs, 0 contribution)")
    check(all(torch.equal(a[masked], b[masked]) for a, b in
              zip(got_m, got)), "active slots unchanged by masking")

    # Other row widths: K = 960 (padded to 1,024) against the plain
    # version; K = 2,048 and 4,096 (the E = 8 and E = 16 instances, shared
    # memory past 48 KiB) on the same lanes with zero lanes appended, which
    # no slot reads: the outputs must equal the K = 1,024 run bit for bit.
    cut = tuple(x[:, :960].contiguous() for x in args[:5]) \
        + (origins, counts.clamp(max=960))
    err = max(err, compare_raster(
        raster_plan.raster_plan_cuda(*cut, active, chunk=chunk),
        raster_plan.raster_plan_torch(*cut, active, chunk=chunk),
        "K 960", chunk, cut))
    for wide in (2048, 4096):
        padded = tuple(torch.nn.functional.pad(
            x, [0, 0] * (x.dim() - 2) + [0, wide - k]) for x in args[:5])
        got_w = raster_plan.raster_plan_cuda(*padded, origins, counts,
                                             active, chunk=chunk)
        torch.cuda.synchronize()
        check(all(torch.equal(a, b) for a, b in zip(got_w[:5], got[:5]))
              and torch.equal(got_w[5][:, :k], got[5])
              and not bool(got_w[5][:, k:].any()),
              f"K {wide} (E = {raster_plan.items_per_thread(wide)}): the "
              f"K = {k} outputs bit for bit, 0 on the appended lanes")
        del padded, got_w

    run = lambda: raster_plan.raster_plan_cuda(  # noqa: E731
        *args, active, chunk=chunk)
    dev_ms = kernel_ms(run, "raster_plan_kernel", 20, flush)
    launch_ms = time_ms(run, 20, flush)
    plain_ms = time_ms(lambda: raster_plan.raster_plan_torch(
        *args, active, chunk=chunk), 5, flush)
    # The least work the function needs on these inputs: each real pair's
    # 10 floats read once (padding lanes are never read), origins, counts
    # and the slot mask; every output written once (lane_contrib in full);
    # the plain version's own count of the (pixel, lane) pairs reached
    # before the pixel is done, and of those with a nonzero weight.
    pairs = int(counts.sum())
    nbytes = 4 * (pairs * 10 + r * 4 + r * 256 * 6 + r + r * k)
    flops = work["evaluated"] * EVAL_FLOPS + work["blended"] * BLEND_FLOPS
    bound_ms, bound_by = bound(nbytes, flops)
    print(f"  work: {work['evaluated']} (pixel, lane) pairs evaluated, "
          f"{work['blended']} blended (of {pairs * 256} pixel-pairs)",
          flush=True)
    print(f"  kernel {dev_ms:.4f} ms device time (profiler, median of 20), "
          f"{launch_ms:.4f} ms with its launch (CUDA events, median of 20), "
          f"plain {plain_ms:.3f} ms (CUDA events, median of 5), bound "
          f"{bound_ms:.4f} ms ({bound_by}: {nbytes / 1e6:.1f} MB, "
          f"{flops / 1e9:.3f} GFLOP)", flush=True)
    return dict(name="raster_plan_fused", route="cuda",
                source="src/repro_torch/csrc/raster_plan.cu",
                replaces="src/repro/kernels/raster_plan.py:43",
                max_abs_err=err, ms=dev_ms, ms_with_launch=launch_ms,
                plain_ms=plain_ms, bound_ms=bound_ms, bound_by=bound_by,
                library_ms=None)


def check_preprocess(got, want, what):
    """Hold one preprocess result against another (the plain version's);
    returns the largest error over the compared fields."""
    n = want.depth.shape[0]
    n_valid_diff = int((got.valid != want.valid).sum())
    n_r3_diff = int((got.radius3 != want.radius3).sum())
    print(f"  {what}, N={n}: valid differs on {n_valid_diff}, radius3 (a "
          f"ceil) on {n_r3_diff} Gaussians", flush=True)
    # Flags and the ceil flip only where a value sits within rounding of
    # the threshold: allow one in 10^4.
    check(n_valid_diff <= n // 10_000,
          f"{what}: valid flags agree (<= 1e-4 of N)")
    check(n_r3_diff <= n // 10_000 and
          bool(((got.radius3 - want.radius3).abs() <= 1).all()),
          f"{what}: radius3 agrees (<= 1e-4 of N differ, by at most 1)")
    both = got.valid & want.valid
    err = 0.0
    # Each element isclose(rtol, atol) to the plain value, the atol far
    # below the field's meaningful scale (pixels 1e-3 to 1e-2, the
    # 0.3 px^2 dilation 1e-3, conics 1e-6 px^-2). mean2d and depth take a
    # few operations with no cancellation: rtol 1e-5. The covariance
    # fields take rtol 1e-2, because det = ac - b^2 cancels for thin
    # splats: after the dilation the condition number ac / det reaches
    # ~1e4, so float32 rounding (~1e-7) moves cov2d's small entries, the
    # conic and the minor eigenvalue by up to ~1e-3 relative. A cov2d
    # without its dilation, or b with the wrong sign, still fails.
    tols = {"mean2d": (1e-5, 1e-3), "depth": (1e-5, 1e-5),
            "cov2d": (1e-2, 1e-3), "conic": (1e-2, 1e-6),
            "eigvals": (1e-2, 1e-3), "r_major": (1e-2, 1e-2),
            "r_minor": (1e-2, 1e-2), "tight_half_wh": (1e-2, 1e-2)}
    for name, (rtol, atol) in tols.items():
        g, w = getattr(got, name)[both], getattr(want, name)[both]
        e = max_err(g, w)
        err = max(err, e)
        ratio = float(((g - w).abs() / (atol + rtol * w.abs())).max())
        rel = float(((g - w).abs() / w.abs().clamp_min(1e-30)).max())
        check(ratio <= 1.0,
              f"{what}: {name}: isclose(rtol {rtol:g}, atol {atol:g}) "
              f"everywhere (worst |err| / tol {ratio:.3g}, max abs err "
              f"{e:.3g}, max rel err {rel:.3g})")
    # The minor axis (b, lam2 - a) / norm cancels in lam2 - a: an input
    # error of ~100 ulps in a, c moves it by ~100 eps max(|a|, |c|) / |b|
    # (unbounded as b -> 0, where the axis is the other branch's).
    a, b, c = want.cov2d[both].abs().unbind(-1)
    eps = torch.finfo(torch.float32).eps
    tol = 1e-4 + 100 * eps * torch.maximum(a, c) / b.clamp_min(1e-30)
    e_row = (got.minor_axis[both] - want.minor_axis[both]).abs().amax(-1)
    loose = int((tol > 1e-2).sum())
    err = max(err, float(e_row.max()) if e_row.numel() else 0.0)
    check(bool((e_row <= tol).all()),
          f"{what}: minor_axis: within 1e-4 + 100 eps max(|a|,|c|)/|b| per "
          f"row (max abs err {float(e_row.max()):.3g}; {loose} rows with "
          f"|b| so small that the bound exceeds 1e-2)")
    return err


def preprocess_inputs(scene, cam):
    """The preprocess kernel's inputs for ``scene`` seen by ``cam``."""
    op = torch.sigmoid(scene.opacity_logits)
    return (scene.means, scene.log_scales, scene.quats, op, cam.w2c,
            (cam.fx, cam.fy, cam.cx, cam.cy, cam.width, cam.height))


def phase_preprocess_kernel(scene, cam, flush, report):
    from repro_torch.kernels import preprocess as kp
    print("== phase 2b: preprocess kernel vs its plain version", flush=True)
    inputs = preprocess_inputs(scene, cam)
    n = scene.means.shape[0]
    print_occupancy("preprocess_kernel",
                    ptxas_lines(report, "preprocess_kernel"), 128, 0)
    got = kp.preprocess_geom_cuda(*inputs)
    want = kp.preprocess_geom_torch(*inputs)
    torch.cuda.synchronize()
    err = check_preprocess(got, want, "kernel vs plain")

    run = lambda: kp.preprocess_geom_cuda(*inputs)  # noqa: E731
    dev_ms = kernel_ms(run, "preprocess_kernel", 20, flush)
    launch_ms = time_ms(run, 20, flush)
    plain_ms = time_ms(lambda: kp.preprocess_geom_torch(*inputs), 20, flush)
    nbytes = n * (44 + 73) + 64
    bound_ms, bound_by = bound(nbytes, n * PREPROCESS_FLOPS)
    print(f"  kernel {dev_ms:.4f} ms device time (profiler, median of 20), "
          f"{launch_ms:.4f} ms with its launch (CUDA events, median of 20), "
          f"plain {plain_ms:.4f} ms (CUDA events, median of 20), bound "
          f"{bound_ms:.5f} ms ({bound_by})", flush=True)
    return dict(name="preprocess_geom", route="cuda",
                source="src/repro_torch/csrc/preprocess.cu",
                replaces="src/repro/kernels/preprocess.py:25",
                max_abs_err=err, ms=dev_ms, ms_with_launch=launch_ms,
                plain_ms=plain_ms, bound_ms=bound_ms, bound_by=bound_by,
                library_ms=None)


# SASS opcodes by the unit that issues them (the rest: integer, control).
SASS_CLASSES = {
    "shared load": ("LDS",), "shared store": ("STS",),
    "shuffle": ("SHFL",), "vote": ("VOTE", "VOTEU"),
    "fp32": ("FADD", "FMUL", "FFMA", "FMNMX", "FSETP", "FSEL", "FCHK"),
    "mufu": ("MUFU",), "barrier": ("BAR",), "global": ("LDG", "STG")}


def sass(lib, kernel):
    """The SASS instructions (``cuobjdump -sass``) of the kernel in the
    library file ``lib`` whose mangled name contains ``kernel``."""
    from repro_torch.kernels import _build
    text = subprocess.run([_build.cuda_tool("cuobjdump"), "-sass", str(lib)],
                          capture_output=True, text=True, check=True).stdout
    out, inside = [], False
    for line in text.splitlines():
        if "Function :" in line:
            inside = kernel in line
        elif inside and line.lstrip().startswith("/*") and ";" in line:
            out.append(line.split("*/", 1)[1].split(";", 1)[0].strip())
    return out


def opcode_mix(lib, kernel):
    """Static SASS opcode counts (the opcode before its first modifier:
    ``LDS``, ``SHFL``, ...) of a kernel: one count per instruction in the
    binary, not per execution."""
    mix = {}
    for ins in sass(lib, kernel):
        if ins.startswith("@"):                 # predicate guard
            ins = ins.split(None, 1)[1]
        op = ins.split(None, 1)[0].split(".", 1)[0]
        mix[op] = mix.get(op, 0) + 1
    return mix


def sass_classes(lib, kernel):
    """Static SASS instruction counts of ``kernel`` by class."""
    from repro_torch.kernels import _build
    mix = opcode_mix(_build.library_path(lib), kernel)
    out = {c: sum(mix.get(op, 0) for op in ops)
           for c, ops in SASS_CLASSES.items()}
    out["other"] = sum(mix.values()) - sum(out.values())
    return out


def phase_tile_raster_kernel(args, flush):
    from repro_torch.kernels import raster_plan, raster_tile
    print("== phase 2c: tile raster kernel vs its plain version and the "
          "fused kernel", flush=True)
    mean2d, conic, rgb, opacity, depth, origins, counts = args
    r, k = opacity.shape
    chunk = 64
    got = raster_tile.raster_tile_cuda(*args, chunk=chunk)
    work = {}
    want = raster_plan.raster_chunked(*args, chunk=chunk, work=work)
    torch.cuda.synchronize()
    err = compare_raster(got, want, "tile kernel vs plain", chunk, args)
    # Binning ordered each slot's lanes by (depth, id) and the fused
    # kernel sorts by (depth, lane), so both blend one order with one
    # blend loop (csrc/blend.cuh): the outputs must be bit-identical.
    active = torch.ones((r,), dtype=torch.bool, device=opacity.device)
    fused = raster_plan.raster_plan_cuda(*args, active, chunk=chunk)
    again = raster_tile.raster_tile_cuda(*args, chunk=chunk)
    torch.cuda.synchronize()
    names = ("rgb", "trans", "exp_depth", "trunc_depth", "processed",
             "lane_contrib")
    diff = {n: max_err(g.float(), f.float()) for n, g, f in
            zip(names, got, fused)}
    print(f"  tile vs fused kernel: largest difference {diff}", flush=True)
    check(all(torch.equal(g, f) for g, f in zip(got, fused)),
          "tile kernel bit-identical to the fused kernel on sorted bins")
    check(all(torch.equal(g, a) for g, a in zip(got, again)),
          "tile kernel repeats bit for bit")
    # Other chunks: 16 (no lane in a full group of the blend's transposed
    # reduction), 256, and 48 on the first 960 lanes (one group of 32, 16
    # lanes one by one); the fused kernel takes power-of-two chunks only.
    for c in (16, 256):
        tile_c = raster_tile.raster_tile_cuda(*args, chunk=c)
        fused_c = raster_plan.raster_plan_cuda(*args, active, chunk=c)
        torch.cuda.synchronize()
        check(all(torch.equal(g, f) for g, f in zip(tile_c, fused_c)),
              f"chunk {c}: tile kernel bit-identical to the fused kernel")
    cut = tuple(x[:, :960].contiguous() for x in args[:5]) \
        + (origins, counts.clamp(max=960))
    compare_raster(raster_tile.raster_tile_cuda(*cut, chunk=48),
                   raster_plan.raster_chunked(*cut, chunk=48),
                   "K 960, chunk 48: tile kernel vs plain", 48, cut)
    print(f"  raster_tile_kernel static SASS by class: "
          f"{sass_classes('raster_tile', 'raster_tile_kernel')}", flush=True)
    # A warp runs all 32 x chunk (pixel, lane) pairs of each chunk it
    # does not skip; the plain version's done flags count those chunks.
    # Without the warp skip every warp would run each chunk its CTA runs:
    # ceil(processed / chunk) of them.
    lanes_run = int(((got[4] + chunk - 1) // chunk).sum()) * chunk
    print(f"  (pixel, lane) evaluations the warps run: "
          f"{work['warp_chunks'] * 32 * chunk} ({work['warp_chunks']} "
          f"warp chunks, counted by the plain version's done flags); "
          f"{lanes_run * 256} without the warp skip; the function needs "
          f"{work['evaluated']}", flush=True)

    run = lambda: raster_tile.raster_tile_cuda(  # noqa: E731
        *args, chunk=chunk)
    dev_ms = kernel_ms(run, "raster_tile_kernel", 20, flush)
    launch_ms = time_ms(run, 20, flush)
    plain_ms = time_ms(lambda: raster_plan.raster_chunked(
        *args, chunk=chunk), 5, flush)
    # As phase 2a counts it, less the slot mask: each real pair's 10
    # floats, origins and counts read once, every output written once.
    pairs = int(counts.sum())
    nbytes = 4 * (pairs * 10 + r * 3 + r * 256 * 6 + r + r * k)
    flops = work["evaluated"] * EVAL_FLOPS + work["blended"] * BLEND_FLOPS
    bound_ms, bound_by = bound(nbytes, flops)
    print(f"  kernel {dev_ms:.4f} ms device time (profiler, median of 20), "
          f"{launch_ms:.4f} ms with its launch (CUDA events, median of 20), "
          f"plain {plain_ms:.3f} ms (CUDA events, median of 5), bound "
          f"{bound_ms:.4f} ms ({bound_by}: {nbytes / 1e6:.1f} MB, "
          f"{flops / 1e9:.3f} GFLOP)", flush=True)
    return dict(name="raster_tile", route="cuda",
                source="src/repro_torch/csrc/raster_tile.cu",
                replaces="src/repro/kernels/raster_tile.py:31",
                max_abs_err=err, ms=dev_ms, ms_with_launch=launch_ms,
                plain_ms=plain_ms, bound_ms=bound_ms, bound_by=bound_by,
                library_ms=None)


def sort_rows(seed, t, k):
    """(t, k) float32 keys with many ties, one NaN, -0, +0 and +-inf, and
    int32 values, from a seed."""
    rng = np.random.default_rng(seed)
    keys = rng.integers(0, 6, size=(t, k)).astype(np.float32)
    flat = keys.reshape(-1)
    for i, v in enumerate((np.nan, -0.0, 0.0, np.inf, -np.inf, np.nan)):
        flat[(i * 7919) % flat.size] = v
    vals = rng.integers(-1000, 1000, size=(t, k)).astype(np.int32)
    return (torch.from_numpy(keys).cuda(), torch.from_numpy(vals).cuda())


def same_bits(a, b):
    """Exact equality of float tensors bit for bit (NaN and -0 included)."""
    return torch.equal(a.view(torch.int32), b.view(torch.int32))


def sweep_levels(k):
    """Sweeps of the tile sorter's network per level for rows of k keys."""
    from repro_torch.kernels import tile_sort
    levels = {}
    for _, _, level in tile_sort.network_schedule(k):
        levels[level] = levels.get(level, 0) + 1
    return levels


def phase_tile_sort_kernel(args, flush):
    from repro_torch.kernels import ref, tile_sort
    print("== phase 2d: tile sort kernel vs its plain version", flush=True)
    # Edge cases through the counting wrapper, exact against the stable
    # plain sort: ties, NaN (last), -0 (tied with +0), +-inf, K not a
    # power of two (the network pads to pow2(K)) and K = 1. The plain
    # version runs on CPU copies of the inputs: that is the order the CPU
    # tests hold against the reference's jnp.argsort(stable=True); the
    # plain version on the card is printed beside it.
    base = launch_counts()
    cases = [(33, 100), (5, 1), (4, 16), (7, 1000), (64, 4096), (9, 257),
             (2, 16384)]
    for seed, (t, k) in enumerate(cases):
        lay = tile_sort.sort_layout(k)
        print(f"  ({t}, {k}): {lay.n} items a row, {lay.e} a thread, "
              f"{lay.rows_per_cta} row(s) a CTA of {lay.threads} threads, "
              f"{lay.smem} B shared; sweeps per level {sweep_levels(k)}",
              flush=True)
        keys, vals = sort_rows(seed, t, k)
        got = tile_sort.tile_sort(keys, vals)
        on_card = ref.tile_sort_ref(keys, vals)
        want = ref.tile_sort_ref(keys.cpu(), vals.cpu())
        torch.cuda.synchronize()
        print(f"  ({t}, {k}): plain version on the card equals it on the "
              f"CPU: {same_bits(on_card[0].cpu(), want[0])} and "
              f"{torch.equal(on_card[1].cpu(), want[1])}", flush=True)
        check(same_bits(got[0].cpu(), want[0])
              and torch.equal(got[1].cpu(), want[1]),
              f"({t}, {k}) rows with ties, NaN, -0, +0, +-inf: the wrapper's "
              "kernel equals the stable plain sort bit for bit")
    check(launch_counts(base)["tile_sort"] == len(cases),
          f"the wrapper launched the kernel once per call ({len(cases)})")

    depth, counts = args[4], args[6]
    t, k = depth.shape
    lane = torch.arange(k, device=depth.device)
    keys = torch.where(lane[None] < counts[:, None], depth,
                       float("inf")).contiguous()
    ids = lane[None].expand(t, k).to(torch.int32).contiguous()
    got = tile_sort.tile_sort(keys, ids)
    want = ref.tile_sort_ref(keys, ids)
    torch.cuda.synchronize()
    print(f"  ({t}, {k}) key frame rows: {tile_sort.sort_layout(k)}; "
          f"sweeps per level {sweep_levels(k)}", flush=True)
    check(same_bits(got[0], want[0]) and torch.equal(got[1], want[1]),
          f"({t}, {k}) depth keys with ids: kernel equals the stable "
          "plain sort exactly")

    def library():
        order = torch.sort(keys, dim=1, stable=True)
        return order.values, torch.take_along_dim(ids, order.indices, dim=1)

    lib = library()
    check(torch.equal(lib[1], got[1]), "torch.sort + gather agrees")
    run = lambda: tile_sort.tile_sort_cuda(keys, ids)  # noqa: E731
    dev_ms = kernel_ms(run, "tile_sort_kernel", 20, flush)
    launch_ms = time_ms(run, 20, flush)
    plain_ms = time_ms(lambda: ref.tile_sort_ref(keys, ids), 20, flush)
    library_ms = time_ms(library, 20, flush)
    # Keys and values read once and written once; one fp32 compare per
    # element per level of a comparison sort (K log2 K per row).
    nbytes = 16 * t * k
    bound_ms, bound_by = bound(nbytes, t * k * math.log2(max(k, 2)))
    print(f"  kernel {dev_ms:.4f} ms device time (profiler, median of 20), "
          f"{launch_ms:.4f} ms with its launch (CUDA events, median of 20), "
          f"plain {plain_ms:.4f} ms, torch.sort + gather {library_ms:.4f} ms "
          f"(CUDA events, median of 20), bound {bound_ms:.5f} ms "
          f"({bound_by}: {nbytes / 1e6:.1f} MB)", flush=True)
    return dict(name="tile_sort", route="cuda",
                source="src/repro_torch/csrc/tile_sort.cu",
                replaces="src/repro/kernels/tile_sort.py:22",
                max_abs_err=0.0, ms=dev_ms, ms_with_launch=launch_ms,
                plain_ms=plain_ms, bound_ms=bound_ms, bound_by=bound_by,
                library_ms=library_ms)


def host_syncs(fn):
    """Run ``fn`` under torch's CUDA sync debug mode; returns (its result,
    {where: count} of the operations that made the host wait for the
    device), each place named by its innermost frame outside the
    installed packages, with the torch frame that warned."""
    import traceback
    import warnings
    where = {}

    def record(message, category, filename, lineno, file=None, line=None):
        if "synchroniz" not in str(message):
            return
        ours = [f for f in traceback.extract_stack()[:-1]
                if "-packages" not in f.filename
                and "/lib/python" not in f.filename]
        at = (f"{os.path.relpath(ours[-1].filename)}:{ours[-1].lineno}"
              if ours else "?") + f" ({os.path.basename(filename)}:{lineno})"
        where[at] = where.get(at, 0) + 1

    with warnings.catch_warnings():
        # Switching the mode on may warn by itself; a call into torch
        # surfaces that before the recording starts.
        warnings.simplefilter("ignore")
        torch.cuda.set_sync_debug_mode("warn")
        torch.cuda.get_sync_debug_mode()
    try:
        with warnings.catch_warnings():
            warnings.simplefilter("always")
            warnings.showwarning = record
            out = fn()
    finally:
        torch.cuda.set_sync_debug_mode(0)
    return out, where


def ldu_cases(key_bins, warped):
    """Phase 2e's (name, workload, active, B, mode) cases: the key frame's
    and a warped frame's real fills, other B, the dynamic fill, and inputs
    that force every branch of the greedy fill."""
    tplan, _, bins, _ = key_bins
    wl, act = bins.count, tplan.slot_active
    r = wl.shape[0]
    ones = torch.ones_like(act)
    spike = torch.ones_like(wl)
    spike[r // 3] = 10 * r            # above the cap: no block fits it
    cases = [("key frame", wl, act, 32, "greedy"),
             ("warped frame", warped[0], warped[1], 32, "greedy")]
    cases += [(f"key frame B {b}", wl, act, b, "greedy")
              for b in (1, 7, 33, 64)]
    cases += [(f"key frame dynamic B {b}", wl, act, b, "dynamic")
              for b in (7, 32, 33)]
    cases += [("warped frame dynamic", warped[0], warped[1], 32, "dynamic"),
              ("all zero", torch.zeros_like(wl), ones, 32, "greedy"),
              ("all equal", torch.full_like(wl, 100), ones, 32, "greedy"),
              ("all equal B 33", torch.full_like(wl, 100), ones, 33,
               "greedy"),
              ("one slot above the cap", spike, ones, 32, "greedy"),
              ("sums past 2**24 B 1", torch.full_like(wl, 4097), ones, 1,
               "greedy"),
              ("sums past 2**24 B 3", torch.full_like(wl, 4097), ones, 3,
               "greedy"),
              ("no slot active", wl, torch.zeros_like(act), 32, "greedy"),
              ("no slot active dynamic", wl, torch.zeros_like(act), 32,
               "dynamic")]
    return cases


def warped_fill_input(scene, cam, poses, cfg):
    """A warped frame's LDU input: frame 1's post-DPES workload and
    re-render mask over the tiles in Morton order (the order of its plan's
    slots)."""
    from repro_torch.core import engine, load_balance
    step = engine.make_frame_step(scene, cam, cfg)
    carry = engine.init_carry(cam, poses[0])
    for f in range(2):
        carry, (_, rec) = step(carry, poses[f])
    visit = torch.argsort(load_balance.morton_rank(
        cam.tiles_x, cam.tiles_y, device=cam.device), stable=True)
    return rec.sort_pairs[visit].contiguous(), rec.active[visit].contiguous()


def phase_ldu_kernel(key_bins, warped, flush, report):
    from repro_torch.kernels import ldu_fill as kl
    print("== phase 2e: LDU fill kernel vs its plain version (exact)",
          flush=True)
    print_occupancy("ldu_fill_kernel", ptxas_lines(report, "ldu_fill_kernel"),
                    32, kl.smem_bytes(32))
    base = launch_counts()
    cases = ldu_cases(key_bins, warped)
    for name, wl, act, b, mode in cases:
        got = kl.ldu_fill(wl, act, b, mode)
        want = kl.ldu_fill_host(wl, act, b, mode)
        torch.cuda.synchronize()
        n_act = int(act.sum())
        used = int(torch.unique(got[got >= 0]).numel())
        extra = ""
        if mode == "greedy":
            cap = kl.fill_cap(wl.cpu().numpy().astype(np.float32),
                              act.cpu().numpy(), b)
            extra = f", float32 cap {float(cap)!r}"
        print(f"  {name}: R={wl.shape[0]}, {n_act} active, B={b}, {mode}; "
              f"{used} blocks used{extra}", flush=True)
        check(got.dtype == torch.int32 and torch.equal(got, want),
              f"{name}: block_of equals the plain version exactly")
    check(launch_counts(base)["ldu_fill"] == len(cases),
          f"the wrapper launched the kernel once per call ({len(cases)})")
    from repro_torch.core import plan
    tplan = key_bins[0]
    torch.cuda.synchronize()
    _, syncs = host_syncs(lambda: plan.schedule_plan(
        tplan, key_bins[2].count, 32))
    check(not syncs, f"plan.schedule_plan (the repro.frame/ldu_schedule "
          f"stage) makes the host wait nowhere (sync debug mode: {syncs})")

    tplan, _, bins, _ = key_bins
    wl, act = bins.count, tplan.slot_active
    n_act = int(act.sum())
    times = {}
    for name, (w, a) in (("key", (wl, act)), ("warped", warped)):
        run = lambda: kl.ldu_fill_cuda(w, a, 32)  # noqa: E731,B023
        times[name] = (kernel_ms(run, "ldu_fill_kernel", 20, flush),
                       time_ms(run, 20, flush),
                       time_ms(lambda: kl.ldu_fill_host(w, a, 32), 5, flush),
                       int(a.sum()))
        dev, launch, plain, n = times[name]
        print(f"  {name} frame ({n} active of {w.shape[0]}): kernel "
              f"{dev:.4f} ms device time (profiler, median of 20), "
              f"{launch:.4f} ms with its launch (CUDA events, median of 20), "
              f"plain host scan {plain:.3f} ms (CUDA events, median of 5)",
              flush=True)
    dyn = kernel_ms(lambda: kl.ldu_fill_cuda(wl, act, 32, "dynamic"),
                    "ldu_fill_kernel", 20, flush)
    print(f"  key frame dynamic fill: kernel {dyn:.4f} ms device time",
          flush=True)
    dev_ms, launch_ms, plain_ms, _ = times["key"]
    # Bound by the card's rates: the workload and the mask read once, the
    # block ids written once; per active slot an add and a compare.
    r = wl.shape[0]
    bound_ms, bound_by = bound(r * (4 + 1 + 4), 2 * n_act)
    # The kernel places one active slot a step, each step waiting for the
    # previous one's accumulator: its floor is LDU_STEP_CYCLES a slot at
    # the card's top SM clock (derived, not measured; not bound_ms).
    mhz = float(subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.max.sm",
         "--format=csv,noheader,nounits"], capture_output=True, text=True,
        check=True).stdout.split()[0])
    chain_ms = n_act * LDU_STEP_CYCLES / (mhz * 1e6) * 1e3
    print(f"  bound {bound_ms:.6f} ms ({bound_by}: {r * 9} B); the "
          f"design's dependency-chain floor {chain_ms:.4f} ms ({n_act} "
          f"active slots x {LDU_STEP_CYCLES} cycles at {mhz:.0f} MHz; "
          f"derived); kernel / floor {dev_ms / chain_ms:.2f}", flush=True)
    return dict(name="ldu_fill", route="cuda",
                source="src/repro_torch/csrc/ldu_fill.cu",
                replaces="src/repro/core/load_balance.py:177 (greedy_fill, "
                         "lax.scan; no Pallas kernel)",
                max_abs_err=0.0, ms=dev_ms, ms_with_launch=launch_ms,
                plain_ms=plain_ms, bound_ms=bound_ms, bound_by=bound_by,
                library_ms=None)


def phase_slice(scene, cam, poses, cfg):
    from repro_torch.core import engine, pipeline
    from repro_torch.core.metrics import psnr
    print("== phase 3: the slice (render_trajectory)", flush=True)
    print(f"  config: {WIDTH}x{HEIGHT} ({cam.num_tiles} tiles), N="
          f"{N_GAUSSIANS} structured_scene sh_degree 3, {N_FRAMES}-frame "
          f"dolly, {cfg}", flush=True)
    print("  reduced: N cut from 2,000,000 (repro/configs/lsgaussian.py:12)"
          " to keep the script's phases within its time limit", flush=True)

    torch.cuda.reset_peak_memory_stats()
    base = launch_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    res = engine.render_trajectory(scene, cam, poses, cfg)
    torch.cuda.synchronize()
    total_s = time.perf_counter() - t0
    launches = launch_counts(base)
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    print(f"  trajectory (first run, with first-use costs): "
          f"{total_s * 1e3:.1f} ms for {N_FRAMES} frames, "
          f"launches {launches}, peak memory {peak_gb:.2f} GB", flush=True)
    check(launches["raster_plan_fused"] == N_FRAMES,
          f"fused kernel launched once per frame ({N_FRAMES})")
    check(launches["preprocess_geom"] == N_FRAMES,
          f"preprocess kernel launched once per frame ({N_FRAMES})")
    check(launches["ldu_fill"] == N_FRAMES,
          f"LDU fill kernel launched once per frame ({N_FRAMES})")
    check(launches["intersect_bin"] == 5 * N_FRAMES,
          f"sparse intersect's five kernels launched once per frame "
          f"({5 * N_FRAMES})")
    check(bool(torch.isfinite(res.frames).all()), "all frames finite")
    is_full = res.records.is_full.tolist()
    check(is_full == [f % cfg.window == 0 for f in range(N_FRAMES)],
          "key frames at 0 and 5, warped frames between")

    rec = res.records
    for f in range(N_FRAMES):
        print(f"  frame {f} {'key' if is_full[f] else 'warped'}: sort pairs "
              f"{int(rec.sort_pairs[f].sum())}, raster pairs "
              f"{int(rec.raster_pairs[f].sum())}, overflow "
              f"{int(rec.overflow_pairs[f])}, tiles interpolated "
              f"{int(rec.tiles_interpolated[f])}, re-rendered "
              f"{int(rec.active[f].sum())}", flush=True)

    # Per-frame times: the same frame step, synchronised after each frame.
    step = engine.make_frame_step(scene, cam, cfg)
    carry = engine.init_carry(cam, poses[0])
    frame_ms = []
    for f in range(N_FRAMES):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        carry, _ = step(carry, poses[f])
        torch.cuda.synchronize()
        frame_ms.append((time.perf_counter() - t0) * 1e3)
    key_ms = [t for t, k in zip(frame_ms, is_full) if k]
    warp_ms = [t for t, k in zip(frame_ms, is_full) if not k]
    print(f"  frame ms: {[round(t, 3) for t in frame_ms]}", flush=True)
    print(f"  key frame ms median {statistics.median(key_ms):.3f}, warped "
          f"frame ms median {statistics.median(warp_ms):.3f}", flush=True)

    key_cam = cam.with_pose(poses[0])
    fused = pipeline.render_full_frame(scene, key_cam, cfg)[0]
    check(torch.equal(res.frames[0], fused.rgb),
          "key frame repeats bit for bit in a second render")
    plain = pipeline.render_full_frame(
        scene, key_cam, dataclasses.replace(cfg, impl="torch_chunked"))[0]
    off = ~torch.isclose(fused.rgb, plain.rgb, atol=2e-5,
                         rtol=0.0).any(dim=-1)
    off |= ~torch.isclose(fused.transmittance, plain.transmittance,
                          atol=2e-5, rtol=0.0)
    print(f"  key frame vs torch_chunked: max abs err outside stop flips "
          f"{max_err(fused.rgb[~off], plain.rgb[~off]):.3g}", flush=True)
    check_stop_flips(fused.rgb, fused.transmittance, plain.rgb,
                     plain.transmittance, off, "key frame")
    for f in range(N_FRAMES):
        if is_full[f]:
            continue
        full = pipeline.render_full_frame(scene, cam.with_pose(poses[f]),
                                          cfg)[0].rgb
        q = float(psnr(res.frames[f], full))
        print(f"  frame {f} PSNR vs full render: {q:.2f} dB", flush=True)
        check(q > 24.0, f"warped frame {f} PSNR > 24 dB")
    return launches, res


def phase_cull(scene, cam, poses, cfg, base):
    from repro_torch.core import engine
    from repro_torch.core.metrics import psnr
    print("== phase 3b: contribution culling (cull_threshold=2.0)",
          flush=True)
    cull_cfg = dataclasses.replace(cfg, cull_threshold=2.0)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    res = engine.render_trajectory(scene, cam, poses, cull_cfg)
    torch.cuda.synchronize()
    print(f"  trajectory: {(time.perf_counter() - t0) * 1e3:.1f} ms for "
          f"{N_FRAMES} frames", flush=True)
    is_full = res.records.is_full.tolist()
    culled = res.records.culled_pairs.tolist()
    sort_cull = res.records.sort_pairs.sum(dim=1).tolist()
    sort_base = base.records.sort_pairs.sum(dim=1).tolist()
    for f in range(N_FRAMES):
        q = float(psnr(res.frames[f], base.frames[f]))
        print(f"  frame {f} {'key' if is_full[f] else 'warped'}: culled "
              f"{culled[f]}, sort pairs {sort_cull[f]} (unculled "
              f"{sort_base[f]}), PSNR vs unculled {q:.2f} dB", flush=True)
        if is_full[f]:
            check(culled[f] == 0 and torch.equal(res.frames[f],
                                                 base.frames[f]),
                  f"key frame {f} untouched by culling")
        else:
            check(q >= 30.0, f"sparse frame {f} >= 30 dB against unculled")
    sparse = [f for f in range(N_FRAMES) if not is_full[f]]
    check(sum(sort_cull[f] for f in sparse) <
          sum(sort_base[f] for f in sparse),
          "strictly fewer sort pairs over the sparse frames")
    check(sum(culled) > 0, f"pairs culled ({sum(culled)})")


# The paper's accelerator ablation (Figs. 14/15, Tab. I): the modes of
# benchmarks/accelerator.py:36-47, copied.
ACCEL_MODES = {
    "gpu_like": dict(policy="dynamic", workload_source="raw",
                     light_to_heavy=False, streaming=False),
    "gscore_like": dict(policy="round_robin", workload_source="raw",
                        light_to_heavy=False, streaming=True),
    "ld1": dict(policy="ls_gaussian", workload_source="dpes",
                light_to_heavy=False, streaming=True),
    "ls_gaussian": dict(policy="ls_gaussian", workload_source="dpes",
                        light_to_heavy=True, streaming=True),
}


def ablation(frames, acfg, what):
    """Print the accelerator model's ablation over ``frames``; returns
    {mode: throughput} with ``recorded`` beside the host modes."""
    from repro_torch.core.streaming import simulate_sequence, throughput
    rows = {}
    for mode, kw in list(ACCEL_MODES.items()) + [
            ("recorded", dict(policy="recorded", streaming=True))]:
        t0 = time.perf_counter()
        rows[mode] = throughput(simulate_sequence(frames, acfg, **kw),
                                acfg.num_blocks)
        rows[mode]["host_s"] = time.perf_counter() - t0
    base = rows["gpu_like"]["cycles_per_frame"]
    print(f"  {what}: model cycles per frame of the simulated accelerator "
          f"(not card times), {acfg.num_blocks} raster blocks", flush=True)
    for mode, t in rows.items():
        print(f"    {mode:12s} cycles/frame {t['cycles_per_frame']:.1f}, "
              f"speedup vs gpu_like {base / t['cycles_per_frame']:.4f}, "
              f"utilization {t['utilization']:.6f}, sort stall "
              f"{t['sort_stall']:.1f}, idle stall {t['idle_stall']:.1f} "
              f"(host {t['host_s']:.2f} s to simulate)", flush=True)
    rec, host = rows["recorded"], rows["ls_gaussian"]
    print(f"    recorded - ls_gaussian: cycles/frame "
          f"{rec['cycles_per_frame'] - host['cycles_per_frame']:.4f}, "
          f"utilization {rec['utilization'] - host['utilization']:.3g}",
          flush=True)
    return rows


def schedule_gap(frames, b, what):
    """Tiles whose recorded block (the device fill, float32 cap) differs
    from the host golden ``schedule``'s (float64 cap), per frame, with
    both caps. Pair counts and block sums are integers below 2**24, so
    the two fills can decide differently only where an integer lies
    between the caps; a frame that differs without one fails."""
    from repro_torch.core.load_balance import golden_cap, schedule
    from repro_torch.kernels.ldu_fill import fill_cap
    diffs = []
    for f, fw in enumerate(frames):
        gold = schedule(fw.sort_pairs, b, policy="ls_gaussian",
                        tiles_x=fw.tiles_x, tiles_y=fw.tiles_y,
                        active=fw.active)
        d_blk = int((gold.block_of_tile != fw.block_of).sum())
        d_ord = int((gold.order_in_block != fw.order_in_block).sum())
        diffs.append(d_blk)
        act = np.asarray(fw.active, bool)
        cap32 = float(fill_cap(
            np.asarray(fw.sort_pairs, np.int32).astype(np.float32), act, b))
        cap64 = golden_cap(fw.sort_pairs, b, act)
        straddle = math.floor(cap32) != math.floor(cap64)
        print(f"    frame {f}: {d_blk} tiles in another block, {d_ord} in "
              f"another position; cap float32 {cap32!r}, float64 "
              f"{cap64!r}; an integer between them: {straddle}", flush=True)
        if d_blk or d_ord:
            check(straddle, f"{what} frame {f}: the gap can be the cap's "
                  "rounding (an integer lies between the caps)")
    print(f"  {what}: {sum(diffs)} tiles in another block than the host "
          f"golden over {len(frames)} frames", flush=True)
    return sum(diffs)


def dpes_workloads(scene, cam, poses, cfg, records):
    """DPES ``predict_workload`` on each warped frame's re-render tiles,
    from the warp of the frame before: predicted against raw pairs, held
    to the frame's record (raw pairs, and sort pairs = predicted capped
    at K)."""
    from repro_torch.core import dpes, engine, intersect, warp
    from repro_torch.core.pipeline import PAIR_BLOCK
    from repro_torch.core.projection import preprocess
    step = engine.make_frame_step(scene, cam, cfg)
    carry = engine.init_carry(cam, poses[0])
    for f in range(N_FRAMES):
        if not bool(records.is_full[f]):
            st, tgt = carry.state, cam.with_pose(poses[f])
            w = warp.viewpoint_transform(
                st.rgb, st.exp_depth, st.trunc_depth, st.source_mask,
                cam.with_pose(carry.prev_pose), tgt, n0_ratio=cfg.n0_ratio,
                near=cfg.near)
            ids = torch.nonzero(records.active[f]).squeeze(1)
            proj = preprocess(scene, tgt, near=cfg.near)
            slots = intersect.take_tiles(intersect.make_tile_grid(tgt), ids)
            n = proj.depth.shape[0]
            rows = max(1, PAIR_BLOCK // n)
            parts = []
            for r0 in range(0, ids.shape[0], rows):
                blk = intersect.TileSlots(slots.centers[r0:r0 + rows],
                                          slots.origins[r0:r0 + rows])
                mask = intersect.tait_stage1_mask(proj, blk) \
                    & intersect.tait_stage2_keep(proj, blk)
                parts.append(dpes.predict_workload(
                    mask, proj.depth, w.dpes_depth[ids[r0:r0 + rows]],
                    margin=cfg.dpes_margin))
            pw = dpes.TileWorkload(*(torch.cat(x) for x in zip(*parts)))
            raw, pred = int(pw.raw.sum()), int(pw.predicted.sum())
            print(f"    frame {f}: {ids.shape[0]} re-render tiles, raw "
                  f"pairs {raw}, DPES predicted {pred} "
                  f"({1 - pred / max(raw, 1):.4f} culled), largest tile "
                  f"{int(pw.raw.max())} raw / {int(pw.predicted.max())} "
                  f"predicted", flush=True)
            check(torch.equal(pw.raw, records.raw_pairs[f][ids])
                  and torch.equal(torch.clamp_max(pw.predicted,
                                                  cfg.capacity),
                                  records.sort_pairs[f][ids]),
                  f"frame {f}: raw pairs and min(predicted, K) equal the "
                  "record's raw and sort pairs")
        carry, _ = step(carry, poses[f])


def phase_ablation(scene, cam, poses, cfg, base):
    """The paper's accelerator ablation on frames the card rendered."""
    from repro_torch.core import engine
    from repro_torch.core.streaming import (AcceleratorConfig,
                                            frameworks_from_stacked)
    print("== phase 3c: accelerator ablation (Figs. 14/15, Tab. I) on the "
          "rendered frames", flush=True)
    acfg = AcceleratorConfig(num_blocks=cfg.ldu_blocks)
    n_px = cam.width * cam.height
    frames = frameworks_from_stacked(base.records, cam.tiles_x, cam.tiles_y,
                                     n_px)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    full = engine.render_trajectory(scene, cam, poses,
                                    dataclasses.replace(cfg, window=1))
    torch.cuda.synchronize()
    print(f"  window 1 (Tab. I's full frames): {N_FRAMES} key frames in "
          f"{(time.perf_counter() - t0) * 1e3:.1f} ms", flush=True)
    check(torch.equal(full.frames[0], base.frames[0]),
          "window 1: frame 0 equals phase 3's key frame")
    frames_full = frameworks_from_stacked(full.records, cam.tiles_x,
                                          cam.tiles_y, n_px)
    out = {}
    for what, fr in (("window 5 (phase 3)", frames),
                     ("window 1", frames_full)):
        out[what] = ablation(fr, acfg, what)
        out[what]["gap_tiles"] = schedule_gap(fr, acfg.num_blocks, what)
    print("  DPES on the warped frames (phase 3):", flush=True)
    dpes_workloads(scene, cam, poses, cfg, base.records)
    return out


# Phase 2f: the sparse TAIT intersect and binning (kernels/intersect_bin.py)
# at the benchmark's key frames and on a turn-like warped frame: (name, N,
# width, height). Each scene is this script's structured_scene at that size.
INTERSECT_SCENES = (("tandt-train", 1_100_000, 992, 560),
                    ("lsgaussian-1088p", 560_000, 1920, 1088))
# The orbit step of the benchmark's turn traffic: 360 deg/s at 90 Hz.
TURN_DEG = 4.0
INTERSECT_KERNELS = ("intersect_map_kernel", "intersect_pairs_kernel",
                     "intersect_scan_kernel", "bin_select_kernel")


def device_ms_per_call(fn, names, runs, flush=None, expect=None):
    """Mean device ms a call of ``fn`` of the kernels whose names contain
    one of ``names`` (None: every kernel), in all and by name, over
    ``runs`` profiled calls (L2 flushed before each where ``flush`` is
    given). With ``expect`` (launches a call of each of ``names``) a
    trace that lacks a launch's record is taken again, as ``kernel_ms``
    does, and (None, None) comes back where three traces all lack one:
    after phase 7's profiled steps the profiler drops records."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    for attempt in range(3):
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(runs):
                if flush is not None:
                    flush.zero_()
                fn()
            torch.cuda.synchronize()
        by, count = {}, {}
        for e in prof.events():
            if e.device_type != DeviceType.CUDA \
                    or e.name.startswith("repro."):
                continue
            hit = [n for n in names if n in e.name] if names else [e.name]
            if hit:
                by[hit[0]] = by.get(hit[0], 0.0) \
                    + e.time_range.elapsed_us() / 1e3
                count[hit[0]] = count.get(hit[0], 0) + 1
        if expect is None or all(count.get(n, 0) == expect * runs
                                 for n in names):
            by = {k: v / runs for k, v in by.items()}
            return sum(by.values()), by
        print(f"  profiler trace {attempt + 1} holds {count} of "
              f"{expect * runs} launches each", flush=True)
    return None, None


def intersect_inputs(name, n, width, height, cfg):
    """(case name, proj, grid, plan, limit, cull) of the scene's key frame
    and of a warped frame one turn step later (DPES limit, re-render
    plan; once more with a cull over its warp gate)."""
    from repro_torch.core import culling, intersect, pipeline, plan
    from repro_torch.core import warp as warp_mod
    from repro_torch.core.camera import look_at, make_camera
    from repro_torch.core.projection import preprocess
    from repro_torch.scenes.synthetic import structured_scene
    scene = structured_scene(SEED, n, sh_degree=3)
    target = torch.tensor([0.0, 0.0, 6.0], device="cuda")

    def pose(deg):
        th = np.radians(deg)
        eye = target + 6.0 * torch.tensor(
            [np.sin(th), -0.5 / 6.0, -np.cos(th)], dtype=torch.float32,
            device="cuda")
        return look_at(eye, target)

    cam0 = make_camera(pose(0.0), width=width, height=height)
    cam1 = cam0.with_pose(pose(TURN_DEG))
    grid = intersect.make_tile_grid(cam0)
    key_plan = plan.full_plan(cam0.tiles_x, cam0.tiles_y)
    yield (f"{name} key frame", preprocess(scene, cam0, near=cfg.near),
           grid, key_plan, None, None)
    _, state, _ = pipeline.render_full_frame(scene, cam0, cfg)
    w = warp_mod.viewpoint_transform(
        state.rgb, state.exp_depth, state.trunc_depth, state.source_mask,
        cam0, cam1, n0_ratio=cfg.n0_ratio, near=cfg.near)
    wplan = plan.sparse_plan(w.rerender_tile, cam1.tiles_x, cam1.tiles_y,
                             None)
    limit = w.dpes_depth[wplan.tile_ids.long()] * cfg.dpes_margin
    proj1 = preprocess(scene, cam1, near=cfg.near)
    yield (f"{name} warped frame ({TURN_DEG:g} deg turn)", proj1, grid, wplan,
           limit, None)
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    prior = torch.rand((n,), generator=gen, device="cuda") * 4.0
    yield (f"{name} warped frame, cull 1.0", proj1, grid, wplan, limit,
           (prior, culling.warp_gate(w.valid_per_tile)))


def same_bins(got, want):
    """Names of the fields of two intersect_and_bin results that differ."""
    bad = [f for f in ("indices", "valid", "count", "overflow")
           if not torch.equal(getattr(got[0], f), getattr(want[0], f))]
    bad += [f for f, a, b in zip(("candidate_pairs", "raw_slots",
                                  "culled_pairs", "slot_active"),
                                 got[1:], want[1:]) if not torch.equal(a, b)]
    return bad


def phase_intersect_kernel(flush, report):
    from repro_torch.core import pipeline
    from repro_torch.core.pipeline import RenderConfig
    from repro_torch.kernels import intersect_bin as ib
    print("== phase 2f: sparse TAIT intersect and binning kernel vs its "
          "plain version and the dense path (exact)", flush=True)
    for kname in INTERSECT_KERNELS:
        lines = ptxas_lines(report, kname)
        print(f"  {kname}: {'; '.join(lines)}", flush=True)
    base_cfg = RenderConfig(capacity=1024, chunk=64, window=5,
                            intersect_method="tait", use_dpes=True,
                            ldu_blocks=32)
    rows = []
    for scene_name, n, width, height in INTERSECT_SCENES:
        for case, proj, grid, tplan, limit, cull in intersect_inputs(
                scene_name, n, width, height, base_cfg):
            cfg = dataclasses.replace(
                base_cfg, cull_threshold=1.0 if cull else 0.0)
            keep = None if cull is None else (cull[0] >= cfg.cull_threshold,
                                              cull[1])
            call = lambda: pipeline.intersect_and_bin(  # noqa: E731
                proj, grid, tplan, cfg, limit, cull)    # noqa: B023
            base = launch_counts()
            got = call()
            check(launch_counts(base)["intersect_bin"] == 5,
                  f"{case}: one call launched the five kernels")
            pairs_t = ib.intersect_pairs_torch(proj, grid, tplan.tile_ids,
                                               tplan.slot_active, limit, keep)
            plain = (ib.select_bins_torch(pairs_t, cfg.capacity),
                     pairs_t.candidate_pairs, pairs_t.raw_slots,
                     pairs_t.culled_pairs, pairs_t.slot_active)
            dense = pipeline.dense_intersect_and_bin(proj, grid, tplan, cfg,
                                                     limit, cull)
            torch.cuda.synchronize()
            full = got[0].count + got[0].overflow
            r, act = tplan.num_slots, int(tplan.slot_active.sum())
            print(f"  {case}: N {n}, R {r} ({act} active), stage-1 pairs "
                  f"{int(got[1])}, binned pairs (count_full) "
                  f"{int(full.sum())}, largest slot {int(full.max())}, "
                  f"slots past K {int((full > cfg.capacity).sum())}, "
                  f"overflow {int(got[0].overflow.sum())}, culled "
                  f"{int(got[3])}, demoted "
                  f"{int((tplan.slot_active & ~got[4]).sum())}", flush=True)
            bad = same_bins(got, plain)
            check(not bad, f"{case}: every field equals the plain version "
                  f"(differ: {bad})")
            bad = same_bins(got, dense)
            check(not bad, f"{case}: every field equals the dense path "
                  f"(differ: {bad})")
            _, syncs = host_syncs(call)
            check(sum(syncs.values()) == 1,
                  f"{case}: one host wait a call (sync debug mode: {syncs})")
            dev_ms, by = device_ms_per_call(call, INTERSECT_KERNELS, 10,
                                            flush)
            launch_ms = time_ms(call, 10, flush)
            dense_call = lambda: pipeline.dense_intersect_and_bin(  # noqa
                proj, grid, tplan, cfg, limit, cull)            # noqa: B023
            plain_ms = time_ms(dense_call, 3, flush)
            _, dense_by = device_ms_per_call(dense_call, None, 3)
            topk_ms = sum(v for k, v in dense_by.items() if "topk" in k)
            dense_dev = sum(dense_by.values())
            # Least bytes: each Gaussian's TAIT inputs read once (mean,
            # half extents, minor axis: 24 B; r_minor, depth: 8 B; valid,
            # keep: 2 B), the plan's tile ids, flags and limits (9 B a
            # slot) and the gate (1 B a tile); the bins written once (5 B
            # a lane) with count and overflow (8 B a slot).
            k = min(cfg.capacity, n)
            nbytes = n * 34 + r * 9 + grid.num_tiles + r * k * 5 + r * 8
            bound_ms, bound_by = bound(nbytes, 0)
            print(f"    kernels {dev_ms:.4f} ms device time a call "
                  f"(profiler, mean of 10; "
                  + ", ".join(f"{k2} {v:.4f}" for k2, v in by.items())
                  + f"), {launch_ms:.4f} ms with launches and the host read "
                  f"(CUDA events, median of 10); dense path {plain_ms:.3f} "
                  f"ms (CUDA events, median of 3), its kernels "
                  f"{dense_dev:.3f} ms of which torch.topk {topk_ms:.3f} ms "
                  f"(profiler, mean of 3); bound {bound_ms:.4f} ms "
                  f"({bound_by}: {nbytes} B)", flush=True)
            rows.append(dict(case=case, ms=dev_ms, ms_with_launch=launch_ms,
                             plain_ms=plain_ms, library_ms=topk_ms,
                             bound_ms=bound_ms, bound_by=bound_by))
            del got, plain, pairs_t, dense
        del proj, grid, tplan, limit, cull
        free_cuda()
    key = rows[0]
    return dict(name="intersect_bin", route="cuda",
                source="src/repro_torch/csrc/intersect_bin.cu",
                replaces="no TPU kernel: src/repro/core/intersect.py TAIT "
                         "masks + src/repro/core/binning.py:47 "
                         "build_tile_bins (lax.top_k)",
                max_abs_err=0.0, ms=key["ms"],
                ms_with_launch=key["ms_with_launch"],
                plain_ms=key["plain_ms"], bound_ms=key["bound_ms"],
                bound_by=key["bound_by"], library_ms=key["library_ms"],
                cases=rows)


def phase_profile(scene, cam, poses, cfg):
    """Where one key frame and one warped frame spend their time."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.core import engine
    print("== phase 4: profile of one key and one warped frame", flush=True)
    step = engine.make_frame_step(scene, cam, cfg)
    carry = engine.init_carry(cam, poses[0])
    for f, kind in ((0, "key"), (1, "warped")):
        torch.cuda.synchronize()
        carry, syncs = host_syncs(lambda: step(carry, poses[f])[0])  # noqa: B023
        print(f"  {kind} frame: host syncs (sync debug mode) "
              f"{sum(syncs.values())} at {syncs}", flush=True)
    carry = engine.init_carry(cam, poses[0])
    for f, kind in ((0, "key"), (1, "warped")):
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            carry, _ = step(carry, poses[f])
            torch.cuda.synchronize()
            wall_ms = (time.perf_counter() - t0) * 1e3
        events = prof.events()
        # Device-side events: kernels, plus one span per annotated stage
        # (first to last kernel launched inside it).
        device = [e for e in events if e.device_type == DeviceType.CUDA]
        kernels = [e for e in device if not e.name.startswith("repro.")]
        busy_ms = sum(e.time_range.elapsed_us() for e in kernels) / 1e3
        print(f"  {kind} frame: wall {wall_ms:.3f} ms, kernels "
              f"{busy_ms:.3f} ms ({len(kernels)} launches), device idle "
              f"share {1 - busy_ms / wall_ms:.3f}", flush=True)
        stages = {}
        for e in events:
            if e.name.startswith("repro."):
                on_dev = e.device_type == DeviceType.CUDA
                dev, host = stages.get(e.name, (0.0, 0.0))
                ms = e.time_range.elapsed_us() / 1e3
                stages[e.name] = (dev + ms, host) if on_dev \
                    else (dev, host + ms)
        for name, (dev, host) in sorted(stages.items(),
                                        key=lambda kv: -kv[1][1]):
            print(f"    stage {name}: host {host:.3f} ms, device span "
                  f"{dev:.3f} ms", flush=True)
        by_kernel = {}
        for e in kernels:
            by_kernel[e.name] = by_kernel.get(e.name, 0.0) \
                + e.time_range.elapsed_us() / 1e3
        for name, ms in sorted(by_kernel.items(), key=lambda kv: -kv[1])[:8]:
            print(f"    kernel {ms:8.3f} ms  {name[:90]}", flush=True)


def device_split(events, wall_ms):
    """(kernel ms, kernel launches, idle share) from profiler events."""
    from torch.autograd import DeviceType
    kernels = [e for e in events if e.device_type == DeviceType.CUDA
               and not e.name.startswith("repro.")]
    busy_ms = sum(e.time_range.elapsed_us() for e in kernels) / 1e3
    return busy_ms, len(kernels), 1 - busy_ms / wall_ms


def record_serving(srv, reg):
    """Wrap ``srv``'s attach and its batchers' builds: the returned lists
    fill as it serves with (session, poses) and, per rendered group,
    (R, slot sids, counts)."""
    sessions, chunks = [], []
    attach = srv.try_attach

    def recording_attach(poses, **kw):
        sess = attach(poses, **kw)
        if sess is not None:
            sessions.append((sess, poses))
        return sess

    srv.try_attach = recording_attach
    for bat in [srv.batcher_for(b) for b in reg.buckets_in_use()]:
        build = bat.build

        def recording_build(manager, build=build):
            batch = build(manager)
            chunks.append((srv.capacity, batch.sids, batch.counts.tolist()))
            return batch

        bat.build = recording_build
    return sessions, chunks


def solo_frames(sess, poses, chunks, scene, cam, cfg):
    """A solo render of a served session's poses from ``scene``, at the R
    of each round it rendered in, and those R."""
    from repro_torch.core import engine
    rs = [(r, counts[sids.index(sess.sid)]) for r, sids, counts in chunks
          if sess.sid in sids and counts[sids.index(sess.sid)]]
    pose_t = torch.as_tensor(poses, device=cam.device)
    if len({r for r, _ in rs}) == 1:
        return engine.render_trajectory(
            scene, cam, pose_t, dataclasses.replace(
                cfg, rerender_capacity=rs[0][0]),
            phase=sess.phase).frames, [r for r, _ in rs]
    carry, frames, f = engine.init_carry(cam, pose_t[0]), [], 0
    for r, n in rs:
        step_fn = engine.make_frame_step(scene, cam, dataclasses.replace(
            cfg, rerender_capacity=r), sess.phase)
        for _ in range(n):
            carry, (rgb, _) = step_fn(carry, pose_t[f])
            frames.append(rgb)
            f += 1
    return torch.stack(frames), [r for r, _ in rs]


def serve_traffic():
    """Phase 5's traffic: 6 Poisson streams of 8-12 frames over the two
    scenes."""
    from repro_torch.serve import PoissonTraffic, TrafficConfig
    return PoissonTraffic(TrafficConfig(n_streams=6, rate=3.0, min_frames=8,
                                        max_frames=12, seed=SEED, scenes=2))


def serve_config():
    from repro_torch.serve import ServeConfig
    return ServeConfig(chunk=4, b_buckets=(2, 4), r_buckets=(512, 1024, 2048),
                       adapt_every=2, scene_buckets=(65536, 131072),
                       collect_frames=True)


def serve_scenes(cfg, scfg, device="cuda"):
    """Phase 5's render config (impl "cuda"), its two scenes and a
    registry holding them padded into one bucket, and their entries."""
    from repro_torch.scenes.synthetic import (random_blob_scene,
                                              structured_scene)
    from repro_torch.serve import SceneRegistry
    originals = [structured_scene(SEED, N_GAUSSIANS, sh_degree=3,
                                  device=device),
                 random_blob_scene(SEED + 1, BLOB_GAUSSIANS, sh_degree=3,
                                   device=device)]
    reg = SceneRegistry(scfg.scene_buckets, device=device)
    entries = [reg.register(s) for s in originals]
    check(len({e.bucket for e in entries}) == 1,
          f"both scenes padded into one bucket {entries[0].bucket}")
    return dataclasses.replace(cfg, impl="cuda"), originals, reg, entries


def phase_serve(cam, cfg):
    """The serve loop at full width: two scenes in one bucket, Poisson
    traffic, impl "cuda"."""
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.core.projection import preprocess as project
    from repro_torch.obs.trace import validate_chrome_trace
    from repro_torch.serve import StreamServer, TrafficConfig
    from repro_torch.serve.server import sample_trajectory
    print("== phase 5: serve (StreamServer, impl cuda)", flush=True)
    scfg = dataclasses.replace(serve_config(), sim_latency=True, trace=True)
    scfg_cfg, originals, reg, entries = serve_scenes(cfg, scfg)
    srv = StreamServer(reg, cam, scfg_cfg, scfg)
    traffic = serve_traffic()
    print(f"  config: {scfg_cfg}", flush=True)
    print(f"  serve: {scfg}", flush=True)

    # Record each session, the poses it brought and, per round, which
    # sessions rendered how many frames at which R.
    sessions, chunks = record_serving(srv, reg)
    warm_s = srv.warmup()
    base = launch_counts()
    torch.cuda.reset_peak_memory_stats()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    report = srv.run(traffic, max_rounds=200)
    torch.cuda.synchronize()
    total_s = time.perf_counter() - t0
    launches = launch_counts(base)
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    print(f"  run: {total_s:.3f} s, {report['rounds']} rounds "
          f"({report['busy_rounds']} busy), {report['frames']} frames, "
          f"launches {launches}, peak memory {peak_gb:.2f} GB (warmup "
          f"{warm_s * 1e3:.1f} ms: masked frames render nothing)",
          flush=True)
    check(report["streams_finished"] == 6 and not srv.manager.sessions,
          "every stream finished (6 of 6)")
    check(launches["raster_tile"] > 0 and launches["raster_plan_fused"] == 0,
          "the tile raster kernel rendered, the fused kernel did not")
    check(launches["ldu_fill"] == launches["raster_tile"] == report["frames"],
          f"the LDU fill kernel launched once per served frame "
          f"({report['frames']})")
    n_keys = report["cache"]["distinct_executables"]
    check(n_keys <= len(scfg.b_buckets) * len(scfg.r_buckets),
          f"{n_keys} cache keys <= {len(scfg.b_buckets)} x "
          f"{len(scfg.r_buckets)}")
    summary = validate_chrome_trace(srv.tracer.to_chrome())
    check(summary["spans"] > 0,
          f"Chrome trace validates ({summary['spans']} spans on "
          f"{summary['tracks']} tracks)")
    busy = [r for r in report["rounds_trace"] if r["frames"]]
    round_ms = [r["render_seconds"] * 1e3 for r in busy]
    print(f"  latency p50 {report['latency_p50_ms']} ms, p99 "
          f"{report['latency_p99_ms']} ms per frame (enqueue -> round "
          f"end); {report['frames_per_second']} frames/s over rendering "
          f"rounds; slot utilization {report['slot_utilization']}",
          flush=True)
    print(f"  B history {report['slots_history']}, R history "
          f"{report['capacity_history']}, cache keys "
          f"{report['cache']['keys']}", flush=True)
    print(f"  round ms {[round(t, 1) for t in round_ms]}; first busy round "
          f"{round_ms[0]:.1f} ms, later rounds median "
          f"{statistics.median(round_ms[1:]):.1f} ms", flush=True)
    print(f"  per bucket {report['per_bucket']}", flush=True)
    print(f"  simulated accelerator {report['sim']}", flush=True)

    # Padding rows are invalid for every pose the blob scene was served at
    # (sigmoid(-20) ~ 2e-9 fails the opacity cull in the preprocess
    # kernel).
    blob = reg.get(entries[1].scene_id).scene
    served_poses = [p for sess, poses in sessions
                    if sess.scene_id == entries[1].scene_id for p in poses]
    n_valid = sum(int(project(blob, cam.with_pose(torch.as_tensor(
        p, device=cam.device)), near=cfg.near).valid[BLOB_GAUSSIANS:].sum())
        for p in served_poses)
    check(n_valid == 0, f"padding rows invalid at all {len(served_poses)} "
          "poses the padded scene was served at")

    # One session (the padded scene's, when it has one) against a solo
    # render of its poses from the unpadded scene, at the R of each round.
    pick = next((x for x in sessions if x[0].scene_id == entries[1].scene_id),
                sessions[0])
    sess, poses = pick
    scene = originals[[e.scene_id for e in entries].index(sess.scene_id)]
    solo, rs = solo_frames(sess, poses, chunks, scene, cam, scfg_cfg)
    check(torch.equal(torch.cat(sess.frames), solo),
          f"session {sess.sid} ({len(poses)} frames, phase {sess.phase}, "
          f"scene {sess.scene_id}, R per chunk {rs}) equals a solo render "
          f"from the unpadded scene bit for bit")

    # The device idle share of one steady round, profiled after the
    # measured run (the profiler's start and teardown would otherwise
    # land between rounds and in the latencies): four more 8-frame
    # streams, one round to bind them, then the profiled round.
    rng = np.random.default_rng(SEED + 1)
    for i in range(4):
        srv.attach(sample_trajectory(rng, TrafficConfig(
            min_frames=8, max_frames=8)), scene_id=entries[i % 2].scene_id)
    srv.step()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        info = srv.step()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
    busy_ms, n_kernels, idle = device_split(prof.events(), wall)
    print(f"  profiled round ({info['frames']} frames of "
          f"{info['bound_slots']} streams, R {info['capacity']}): wall "
          f"{wall:.1f} ms, kernels {busy_ms:.1f} ms ({n_kernels} launches),"
          f" device idle share {idle:.3f}", flush=True)
    srv.run(max_rounds=srv.rounds + 10)
    check(not srv.manager.sessions, "the profiled streams finished too")
    return launches


# Phase 5b: the slot split (serve/placement.py) at phase 5's width. B =
# SPLIT_SLOTS streams of SPLIT_FRAMES frames (ragged counts) over phase
# 5's two scenes in contiguous scene groups, split over (cuda:0,) * D for
# each D in SPLIT_DEVICES against the plain path: frames and carries
# within SPLIT_ATOL, records and frame_active exactly. Then phase 5's
# traffic through a StreamServer with use_sharding on the card's own
# devices (one card: one device divides B, num_devices 1) and forced
# onto (cuda:0,) * 2 (num_devices 2), every session of the forced run
# equal to its solo render bit for bit. The groups share the one card
# and run one after another: no gain is expected.
SPLIT_SLOTS, SPLIT_FRAMES = 4, 4
SPLIT_COUNTS = (4, 3, 4, 2)
SPLIT_SLOT_SCENE = (0, 0, 1, 1)
SPLIT_DEVICES = (4, 2)
SPLIT_ATOL = 1e-5
SPLIT_KERNELS = ("preprocess_geom", "raster_tile", "ldu_fill")


def split_mismatch(got, want):
    """What differs between two StreamsResults past SPLIT_ATOL (frames,
    float carries) or at all (records, frame_active, steps, poses)."""
    bad = []
    if max_err(got.frames, want.frames) > SPLIT_ATOL:
        bad.append(f"frames {max_err(got.frames, want.frames)}")
    for name, g, w in zip(want.records.stacked._fields,
                          got.records.stacked, want.records.stacked):
        if (g is None) != (w is None) or (w is not None
                                          and not torch.equal(g, w)):
            bad.append(f"record {name}")
    for name in ("frame_active", "counts", "phases"):
        if not torch.equal(getattr(got, name), getattr(want, name)):
            bad.append(name)
    gc_, wc = got.carries, want.carries
    if not (torch.equal(gc_.step, wc.step)
            and torch.equal(gc_.prev_pose, wc.prev_pose)):
        bad.append("carry step / pose")
    for name, g, w in zip(wc.state._fields, gc_.state, wc.state):
        if (g is None) != (w is None):
            bad.append(f"carry {name}")
        elif w is not None and (
                not torch.equal(g, w) if g.dtype == torch.bool
                else max_err(g.float(), w.float()) > SPLIT_ATOL):
            bad.append(f"carry {name}")
    return bad


def phase_split(cam, cfg):
    from repro_torch.core import engine
    from repro_torch.scenes.trajectory import dolly_trajectory
    from repro_torch.serve import StreamServer, build_render_fn, stream_mesh
    print("== phase 5b: the slot split over (cuda:0,) * D and the server's "
          "per-B placement", flush=True)
    t_phase = time.perf_counter()
    card = cam.device
    scfg = serve_config()
    scfg_cfg, originals, reg, entries = serve_scenes(cfg, scfg, card)
    split_cfg = dataclasses.replace(scfg_cfg, rerender_capacity=1024)
    ids = [e.scene_id for e in entries]
    stack = reg.stack(ids, SPLIT_SLOTS)
    poses = torch.stack([dolly_trajectory(
        SPLIT_FRAMES, start=(0.05 * i, -0.3, -2.0), target=(0.0, 0.0, 6.0),
        device=card) for i in range(SPLIT_SLOTS)])
    args = (stack, poses,
            torch.tensor(SPLIT_COUNTS, dtype=torch.int32, device=card),
            engine.stream_phases(SPLIT_SLOTS, split_cfg.window, device=card),
            engine.init_stream_carries(cam, poses),
            torch.tensor(SPLIT_SLOT_SCENE, dtype=torch.int32, device=card))

    def run(mesh):
        fn = build_render_fn(cam, split_cfg, mesh, multi_scene=True)
        base = launch_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn(*args)
        torch.cuda.synchronize()
        return out, (time.perf_counter() - t0) * 1e3, launch_counts(base)

    run(None)                     # first use: library loads, allocations
    plain, plain_ms, plain_n = run(None)
    print(f"  plain path: B {SPLIT_SLOTS} x F {SPLIT_FRAMES}, counts "
          f"{SPLIT_COUNTS}, slot scenes {SPLIT_SLOT_SCENE}: {plain_ms:.3f} ms"
          f" wall, launches {plain_n}", flush=True)
    for d in SPLIT_DEVICES:
        mesh = stream_mesh(SPLIT_SLOTS, (card,) * d)
        check(mesh == (card,) * d, f"stream_mesh({SPLIT_SLOTS}) over "
              f"{d} handles to {card}: {d} devices")
        got, ms, n = run(mesh)
        check(all(n[k] > 0 for k in SPLIT_KERNELS)
              and n["raster_plan_fused"] == 0,
              f"D = {d} (local B {SPLIT_SLOTS // d}): {ms:.3f} ms wall "
              f"({ms / plain_ms:.4f} of the plain path), launches {n}")
        bad = split_mismatch(got, plain)
        check(not bad, f"D = {d}: frames {max_err(got.frames, plain.frames)}"
              f" max abs (<= {SPLIT_ATOL}), records and frame_active "
              f"exact, carries within {SPLIT_ATOL} {bad or ''}")
    del plain, got, args, stack

    for devices in (None, (card,) * 2):
        srv = StreamServer(reg, cam, scfg_cfg, scfg, device=card,
                           devices=devices)
        sessions, chunks = record_serving(srv, reg)
        base = launch_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        report = srv.run(serve_traffic(), max_rounds=200)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        n = launch_counts(base)
        want = 2 if devices else 1
        where = "(cuda:0,) * 2" if devices else "the card's own devices"
        check(report["streams_finished"] == 6 and not srv.manager.sessions
              and report["num_devices"] == want
              and all(n[k] > 0 for k in SPLIT_KERNELS),
              f"server, use_sharding on {where}: 6 of 6 streams, num_devices "
              f"{report['num_devices']} (want {want}), {wall:.3f} s, "
              f"{report['frames']} frames, {report['frames_per_second']} "
              f"frames/s, B history {report['slots_history']}, launches {n}")
        if devices:
            for sess, sposes in sessions:
                scene = originals[ids.index(sess.scene_id)]
                solo, rs = solo_frames(sess, sposes, chunks, scene, cam,
                                       scfg_cfg)
                check(torch.equal(torch.cat(sess.frames), solo),
                      f"session {sess.sid} ({len(sposes)} frames, scene "
                      f"{sess.scene_id}, R {rs}) equals its solo render bit "
                      f"for bit")
        del srv, sessions, chunks
    print(f"  phase 5b: {time.perf_counter() - t_phase:.1f} s", flush=True)


# Phase 6: the LM serving harness. yi-9b at its published width and
# depth in bfloat16, then the four registered configs at full width cut
# to LM_CHECK_LAYERS layers in float32.
LM_ARCHS = ("yi-9b", "starcoder2-7b", "minicpm3-4b", "moonshot-v1-16b-a3b")
LM_CHECK_LAYERS = 4
LM_LONG_PROMPT = 2048
# Gate on max |decode_step - forward| over the logits' standard deviation.
# bfloat16: the two paths round different intermediates (other GEMM
# shapes, a masked 16- vs 15-position softmax) through 48 layers, each
# rounding up to 2^-9 relative; a one-position cache error must stay far
# above the gate (phase 6 prints it beside). float32 without TF32: sums
# in another order only.
LM_BF16_GATE = 0.25
LM_F32_GATE = 1e-3


class CallCounter:
    """Count calls of ``module.name`` inside the ``with`` block."""

    def __init__(self, module, name):
        self.module, self.name, self.calls = module, name, 0

    def __enter__(self):
        self.real = getattr(self.module, self.name)

        def spy(*args, **kwargs):
            self.calls += 1
            return self.real(*args, **kwargs)

        setattr(self.module, self.name, spy)
        return self

    def __exit__(self, *exc):
        setattr(self.module, self.name, self.real)


def lm_bytes(tensors):
    return sum(t.numel() * t.element_size() for t in tensors)


def logits_gate(what, got, want, gate):
    """Check max |got - want| <= ``gate`` x std(want), all finite."""
    got, want = got.float(), want.float()
    finite = bool(torch.isfinite(got).all() and torch.isfinite(want).all())
    diff = float((got - want).abs().max())
    std = float(want.std())
    ratio = diff / std
    check(finite and ratio <= gate, f"{what}: logits finite, max|d| "
          f"{diff:.4g}, std {std:.4g}, max|d|/std {ratio:.3g} <= {gate}")


def free_cuda():
    gc.collect()
    torch.cuda.empty_cache()


def kernels_by_name(events, top):
    """Print the ``top`` kernels by device time: ms, launches, name."""
    from torch.autograd import DeviceType
    by_name = {}
    for e in events:
        if e.device_type == DeviceType.CUDA and not e.name.startswith(
                "repro."):
            ms, n = by_name.get(e.name, (0.0, 0))
            by_name[e.name] = (ms + e.time_range.elapsed_us() / 1e3, n + 1)
    for name, (ms, n) in sorted(by_name.items(),
                                key=lambda kv: -kv[1][0])[:top]:
        print(f"    {ms:8.3f} ms {n:6d} x {name[:90]}", flush=True)


def phase_lm_full(smi, arch="yi-9b"):
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.configs import get_config
    from repro_torch.launch.serve import serve
    from repro_torch.models import layers as L
    from repro_torch.models import model as M
    from repro_torch.train import serve_step as S
    cfg = get_config(arch)
    print(f"== phase 6: LM serving, {arch} at its published width and "
          f"depth, {cfg.dtype} ({smi})", flush=True)
    print(f"  {cfg.num_layers} layers, d_model {cfg.d_model}, "
          f"{cfg.num_heads} heads / {cfg.num_kv_heads} kv heads, head_dim "
          f"{cfg.resolved_head_dim}, d_ff {cfg.d_ff}, vocab "
          f"{cfg.vocab_size}; memory in use before the phase "
          f"{torch.cuda.memory_allocated() / 1e9:.2f} GB", flush=True)

    # launch/serve.serve at the launcher's defaults.
    free_cuda()
    torch.cuda.reset_peak_memory_stats()
    out = serve(cfg, batch_slots=4, max_seq=64, n_requests=8,
                prompt_len=16, max_new=16, seed=SEED)
    peak_serve = torch.cuda.max_memory_allocated() / 1e9
    print(f"  serve (8 requests, 4 slots, prompt 16, max_new 16, max_seq "
          f"64): {out}; peak memory {peak_serve:.2f} GB", flush=True)
    check(out["requests_done"] == 8 and out["decode_steps"] == 62,
          "every request finished (8 of 8) in 62 decode steps")
    free_cuda()

    # The serve loop's decode step, timed alone (same weights: one seed).
    params = M.init_params(cfg, seed=SEED)
    weight_b = lm_bytes(params.parameters())
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    cache = M.init_cache(cfg, 4, 64)
    cache_b = lm_bytes(cache.kv)
    tok = torch.randint(0, cfg.vocab_size, (4, 1), generator=gen,
                        device="cuda")
    times = []
    for i in range(24):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        logits, cache = M.decode_step(params, tok, cache, cfg)
        end.record()
        end.synchronize()
        if i >= 4:                                 # after warm-up
            times.append(start.elapsed_time(end))
        tok = torch.argmax(logits[:, 0], -1, keepdim=True)
    check(bool(torch.isfinite(logits).all()), "decode-step logits finite")
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        logits, cache = M.decode_step(params, tok, cache, cfg)
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
    busy_ms, n_kernels, idle = device_split(prof.events(), wall)
    step_ms = statistics.median(times)
    bound_ms = (weight_b + cache_b) / HBM_BYTES_PER_S * 1e3
    print(f"  decode step (batch 4, max_seq 64): median {step_ms:.3f} ms "
          f"over {len(times)} steps after 4 warm-up (CUDA events; "
          f"min {min(times):.3f}, max {max(times):.3f}); bound "
          f"{bound_ms:.3f} ms = ({weight_b / 1e9:.3f} GB weights + "
          f"{cache_b / 1e6:.2f} MB cache) / {HBM_BYTES_PER_S / 1e12:.2f} "
          f"TB/s; {bound_ms / step_ms:.3f} of the bound; "
          f"{4 / step_ms * 1e3:.1f} tok/s at batch 4", flush=True)
    print(f"  one decode step profiled: wall {wall:.3f} ms (profiler on), "
          f"kernels {busy_ms:.3f} ms over {n_kernels} launches "
          f"({bound_ms / busy_ms:.3f} of the bound), device idle share "
          f"{idle:.3f}", flush=True)
    kernels_by_name(prof.events(), 5)
    del cache, logits
    free_cuda()

    # greedy_generate at batch 2 x 2,048 prompt: the prefill takes flash.
    prompt = torch.randint(0, cfg.vocab_size, (2, LM_LONG_PROMPT),
                           generator=gen, device="cuda")
    for _ in range(2):                  # the second prefill is timed
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        S.prefill(params, {"tokens": prompt}, cfg,
                  max_seq=LM_LONG_PROMPT + 16)
        torch.cuda.synchronize()
        prefill_s = time.perf_counter() - t0
    free_cuda()
    torch.cuda.reset_peak_memory_stats()
    torch.cuda.synchronize()
    with CallCounter(L, "flash_attention") as flash:
        t0 = time.perf_counter()
        ids = S.greedy_generate(params, prompt, cfg, max_new=16,
                                max_seq=LM_LONG_PROMPT + 16)
        torch.cuda.synchronize()
        gen_s = time.perf_counter() - t0
    peak_gen = torch.cuda.max_memory_allocated() / 1e9
    print(f"  greedy_generate (batch 2, prompt {LM_LONG_PROMPT}, 16 new): "
          f"{gen_s:.3f} s ({32 / gen_s:.1f} new tok/s, prefill included; "
          f"a prefill alone {prefill_s:.3f} s, "
          f"{2 * LM_LONG_PROMPT / prefill_s:.0f} prompt tok/s), peak memory "
          f"{peak_gen:.2f} GB; first ids {ids[:, :6].tolist()}", flush=True)
    check(tuple(ids.shape) == (2, 16) and bool(
        ((ids >= 0) & (ids < cfg.vocab_size)).all()),
        "greedy_generate gave (2, 16) ids in the vocabulary")
    check(flash.calls == cfg.num_layers,
          f"the prefill took the flash path in every layer ({flash.calls})")
    del ids
    free_cuda()

    # decode_step against forward's last position (tests/test_archs_smoke.py).
    toks = torch.randint(0, cfg.vocab_size, (2, 16), generator=gen,
                         device="cuda")
    full = M.forward(params, {"tokens": toks}, cfg)[0][:, -1]
    _, cache = S.prefill(params, {"tokens": toks[:, :-1]}, cfg, max_seq=16)
    dec, _ = M.decode_step(params, toks[:, -1:], cache, cfg)
    logits_gate(f"decode_step vs forward ({cfg.dtype}, batch 2, position "
                f"16)", dec[:, 0], full, LM_BF16_GATE)
    # The same decode one position early (it overwrites the prompt's last
    # cache row): the gate must separate such a fault.
    _, cache = S.prefill(params, {"tokens": toks[:, :-1]}, cfg, max_seq=16)
    off, _ = M.decode_step(params, toks[:, -1:], cache._replace(index=14),
                           cfg)
    off_ratio = float((off[:, 0].float() - full.float()).abs().max()
                      / full.float().std())
    check(off_ratio > LM_BF16_GATE,
          f"a decode one position early is off by {off_ratio:.3g} std, "
          f"above the gate")
    del params, full, dec, off, cache
    free_cuda()
    return {"tok_per_s": out["tok_per_s"], "step_ms": step_ms,
            "bound_ms": bound_ms, "peak_gb": peak_serve}


def phase_lm_checks():
    from repro_torch.configs import get_config
    from repro_torch.models import layers as L
    from repro_torch.models import model as M
    from repro_torch.models.sharding_hooks import set_hooks
    from repro_torch.train import serve_step as S
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    print(f"== phase 6b: the four configs at full width, depth cut to "
          f"{LM_CHECK_LAYERS} layers (so that all four fit the run's time),"
          f" float32; TF32 off (torch.backends.cuda.matmul.allow_tf32="
          f"{torch.backends.cuda.matmul.allow_tf32}, float32 matmul "
          f"precision {torch.get_float32_matmul_precision()!r}); each gate "
          f"is max|d| <= {LM_F32_GATE} x std(logits)", flush=True)
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    for arch in LM_ARCHS:
        cfg = dataclasses.replace(get_config(arch),
                                  num_layers=LM_CHECK_LAYERS,
                                  dtype="float32")
        t0 = time.perf_counter()
        params = M.init_params(cfg, seed=SEED)
        print(f"  {arch}: {lm_bytes(params.parameters()) / 1e9:.2f} GB of "
              f"weights ({cfg.attention}, {cfg.family}, mlp "
              f"{cfg.mlp_type})", flush=True)

        # 1. prefill -> decode (forward against _pad_cache_seq +
        # decode_step), batch 2, position 16.
        toks = torch.randint(0, cfg.vocab_size, (2, 16), generator=gen,
                             device="cuda")
        full = M.forward(params, {"tokens": toks}, cfg)[0][:, -1]
        _, _, cache = M.forward(params, {"tokens": toks[:, :-1]}, cfg,
                                build_cache=True)
        cache = S._pad_cache_seq(cache, 32)
        dec, _ = M.decode_step(params, toks[:, -1:], cache, cfg)
        logits_gate(f"{arch} prefill->decode", dec[:, 0], full, LM_F32_GATE)

        # 2. attn_impl "flash" (and with causal_skip) against "sdpa" on a
        # 2,048 prompt.
        long = torch.randint(0, cfg.vocab_size, (1, LM_LONG_PROMPT),
                             generator=gen, device="cuda")
        set_hooks({"attn_impl": "sdpa"})
        dense = M.forward(params, {"tokens": long}, cfg)[0]
        for flags in ({"attn_impl": "flash"},
                      {"attn_impl": "flash", "causal_skip": True}):
            set_hooks(flags)
            with CallCounter(L, "flash_attention") as flash:
                got = M.forward(params, {"tokens": long}, cfg)[0]
            check(flash.calls == LM_CHECK_LAYERS,
                  f"{arch} {flags}: flash in every layer")
            logits_gate(f"{arch} {flags} vs sdpa ({LM_LONG_PROMPT} "
                        f"positions)", got, dense, LM_F32_GATE)
            del got
        set_hooks({})
        del dense

        # 3. decode at batch 4 (moonshot: the capped MoE decode dispatch),
        # three steps against the forward over the whole sequence.
        toks = torch.randint(0, cfg.vocab_size, (4, 19), generator=gen,
                             device="cuda")
        full = M.forward(params, {"tokens": toks}, cfg)[0]
        _, cache = S.prefill(params, {"tokens": toks[:, :16]}, cfg,
                             max_seq=32)
        with CallCounter(L, "_moe_decode_dispatch") as moe:
            for i in range(16, 19):
                dec, cache = M.decode_step(params, toks[:, i:i + 1], cache,
                                           cfg)
                logits_gate(f"{arch} decode batch 4, position {i + 1}",
                            dec[:, 0], full[:, i], LM_F32_GATE)
        if cfg.family == "moe":
            check(moe.calls == 3 * LM_CHECK_LAYERS,
                  f"the MoE decode dispatch ran in every layer (factor "
                  f"{cfg.moe_decode_capacity_factor}, capacity "
                  f"{L.decode_capacity(cfg, 4)} of 4 tokens x "
                  f"{cfg.experts_per_token} experts)")
        print(f"  {arch}: {time.perf_counter() - t0:.2f} s", flush=True)
        del params, full, dec, cache
        free_cuda()


# Phase 6c: the four families no registered config reaches, from
# tests/_torch_family_configs.py (the reference's own configs).
FAMILY_NAMES = ("mamba2-780m", "zamba2-7b", "whisper-large-v3",
                "internvl2-2b")
FAMILY_PROMPT = 512          # two SSD chunks of 256
FAMILY_DECODE = 64           # ssm: decode steps, and the finer chunk
FAMILY_HYBRID_STEPS = 8      # hybrid: decode steps from init_cache
FAMILY_BATCH = 4             # bf16 serving batch
FAMILY_NEW = 32              # bf16 greedy decode steps


def family_configs():
    """{name: the port's ArchConfig} of the four family configs."""
    sys.path.insert(0, os.path.join(
        os.path.dirname(os.path.abspath(__file__)), "tests"))
    from _torch_family_configs import FAMILY_CONFIGS
    from repro_torch.configs.base import ArchConfig
    return {name: ArchConfig(**FAMILY_CONFIGS[name])
            for name in FAMILY_NAMES}


def family_batch(cfg, tokens, gen):
    """{"tokens"} plus the stub frontends' inputs the family takes (unit
    normal, from ``gen``), in the model's dtype."""
    b = tokens.shape[0]
    batch = {"tokens": tokens}
    dtype = getattr(torch, cfg.dtype)
    for key, n in (("frames", cfg.encoder_seq if cfg.family == "encdec"
                    else 0),
                   ("vision", cfg.num_vision_tokens if cfg.family == "vlm"
                    else 0)):
        if n:
            batch[key] = torch.randn((b, n, cfg.d_model), generator=gen,
                                     device="cuda").to(dtype)
    return batch


def clone_cache(cache):
    """A copy of a ``DecodeCache`` whose tensors are new (decode writes
    its buffers in place)."""
    def copy(x):
        if isinstance(x, torch.Tensor):
            return x.clone()
        if isinstance(x, tuple):
            return type(x)(*(copy(v) for v in x))
        return x
    return copy(cache)


def cache_tensors(cache):
    out = []
    for x in cache[:-1]:
        if isinstance(x, torch.Tensor):
            out.append(x)
        elif x is not None:
            out.extend(x)
    return out


def family_checks(name, cfg, gen):
    """Phase 6c's float32 self-consistency gates for one family at full
    width, depth cut (see ``phase_lm_families``)."""
    from repro_torch.models import model as M
    from repro_torch.train import serve_step as S
    params = M.init_params(cfg, seed=SEED)
    print(f"  {name}: {cfg.num_layers} layers"
          f"{f', encoder {cfg.encoder_layers}' if cfg.encoder_layers else ''}"
          f", float32, {lm_bytes(params.parameters()) / 1e9:.2f} GB of "
          f"weights", flush=True)
    if cfg.family == "ssm":
        s, k = FAMILY_PROMPT, FAMILY_DECODE
        toks = torch.randint(0, cfg.vocab_size, (2, s + k), generator=gen,
                             device="cuda")
        fine = dataclasses.replace(cfg, ssm_chunk=k)     # k divides s + k
        full = M.forward(params, {"tokens": toks}, fine)[0]
        coarse = M.forward(params, {"tokens": toks[:, :s]}, cfg)[0]
        logits_gate(f"{name} forward over {s} at ssm_chunk "
                    f"{cfg.ssm_chunk} ({s // cfg.ssm_chunk} chunks) vs {k}",
                    coarse, full[:, :s], LM_F32_GATE)
        _, cache = S.prefill(params, {"tokens": toks[:, :s]}, cfg)
        worst = 0.0
        for i in range(s, s + k):
            dec, cache = M.decode_step(params, toks[:, i:i + 1], cache, cfg)
            ref = full[:, i]
            worst = max(worst, float((dec[:, 0] - ref).abs().max()
                                     / ref.std()))
        check(worst <= LM_F32_GATE,
              f"{name} prefill({s}) + {k} decode_steps vs forward over "
              f"{s + k} (ssm_chunk {k}): worst max|d|/std {worst:.3g} <= "
              f"{LM_F32_GATE}")
    elif cfg.family == "hybrid":
        k = FAMILY_HYBRID_STEPS
        toks = torch.randint(0, cfg.vocab_size, (2, k), generator=gen,
                             device="cuda")
        full = M.forward(params, {"tokens": toks}, cfg)[0]
        cache = M.init_cache(cfg, 2, 16)
        worst = 0.0
        for i in range(k):
            dec, cache = M.decode_step(params, toks[:, i:i + 1], cache, cfg)
            worst = max(worst, float((dec[:, 0] - full[:, i]).abs().max()
                                     / full[:, i].std()))
        check(worst <= LM_F32_GATE,
              f"{name} {k} decode_steps from init_cache vs forward over "
              f"{k} (groups of {cfg.shared_attn_every} + tail "
              f"{cfg.num_layers % cfg.shared_attn_every}): worst "
              f"max|d|/std {worst:.3g} <= {LM_F32_GATE}")
    else:
        s = 16
        toks = torch.randint(0, cfg.vocab_size, (2, s + 1), generator=gen,
                             device="cuda")
        batch = family_batch(cfg, toks, gen)
        full = M.forward(params, batch, cfg)[0][:, -1]
        _, cache = S.prefill(params, dict(batch, tokens=toks[:, :s]), cfg,
                             max_seq=cache_len(cfg, s) + 16)
        what = f"{name} prefill({s}) + decode_step vs forward over {s + 1}"
        if cfg.family == "vlm":
            what += f" after {cfg.num_vision_tokens} vision positions"
        static = clone_cache(cache)
        dec, _ = M.decode_step(params, toks[:, s:], static, cfg)
        logits_gate(what + (" (cross_kv)" if cfg.family == "encdec"
                            else ""), dec[:, 0], full, LM_F32_GATE)
        if cfg.family == "encdec":
            proj, _ = M.decode_step(params, toks[:, s:],
                                    cache._replace(cross_kv=None), cfg)
            logits_gate(f"{name} decode_step kv_x=enc_out vs static_kv",
                        proj[:, 0], dec[:, 0], LM_F32_GATE)
    del params
    free_cuda()


def cache_len(cfg, s):
    """Cache positions a prompt of ``s`` tokens takes (vlm: the vision
    prefix too)."""
    return s + (cfg.num_vision_tokens if cfg.family == "vlm" else 0)


def family_serve(name, cfg, gen, smi):
    """Phase 6c's bf16 run of one family at full width and depth."""
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.models import model as M
    from repro_torch.train import serve_step as S
    b, s, new = FAMILY_BATCH, FAMILY_PROMPT, FAMILY_NEW
    free_cuda()
    torch.cuda.reset_peak_memory_stats()
    params = M.init_params(cfg, seed=SEED)
    weight_b = lm_bytes(params.parameters())
    toks = torch.randint(0, cfg.vocab_size, (b, s), generator=gen,
                         device="cuda")
    batch = family_batch(cfg, toks, gen)
    max_seq = cache_len(cfg, s) + new
    finite = torch.ones((), dtype=torch.bool, device="cuda")
    prefill_ms = []
    if cfg.family == "hybrid":
        # The reference's forward builds no decode-layout cache for the
        # hybrid family: the prompt goes through decode_step.
        cache = M.init_cache(cfg, b, max_seq)
        for i in range(s):
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            logits, cache = M.decode_step(params, toks[:, i:i + 1], cache,
                                          cfg)
            end.record()
            end.synchronize()
            prefill_ms.append(start.elapsed_time(end))
            finite &= torch.isfinite(logits).all()
        prompt_ms = sum(prefill_ms)
        how = (f"prompt through decode_step: {prompt_ms:.1f} ms, median "
               f"step {statistics.median(prefill_ms):.3f} ms")
    else:
        for _ in range(4):                  # the first is warm-up
            torch.cuda.synchronize()
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            logits, cache = S.prefill(params, batch, cfg, max_seq=max_seq)
            end.record()
            end.synchronize()
            prefill_ms.append(start.elapsed_time(end))
            finite &= torch.isfinite(logits).all()
        prompt_ms = statistics.median(prefill_ms[1:])
        how = (f"prefill median {prompt_ms:.3f} ms over 3 after a warm-up "
               f"({b * cache_len(cfg, s) / prompt_ms * 1e3:.0f} prompt "
               f"positions/s)")
    first = torch.argmax(logits[:, -1:], dim=-1)
    cache_b = lm_bytes(cache_tensors(cache))
    start_cache = clone_cache(cache)

    def greedy(c):
        nonlocal finite
        tok, out, times = first, [], []
        for _ in range(new):
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            logits, c = M.decode_step(params, tok, c, cfg)
            end.record()
            end.synchronize()
            times.append(start.elapsed_time(end))
            finite &= torch.isfinite(logits).all()
            tok = torch.argmax(logits[:, -1:], dim=-1)
            out.append(tok)
        return torch.cat(out, 1), times

    ids, times = greedy(cache)
    again, _ = greedy(clone_cache(start_cache))
    step_ms = statistics.median(times[2:])
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        M.decode_step(params, first, clone_cache(start_cache), cfg)
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
    busy_ms, n_kernels, idle = device_split(prof.events(), wall)
    peak = torch.cuda.max_memory_allocated() / 1e9
    bound_ms = (weight_b + cache_b) / HBM_BYTES_PER_S * 1e3
    print(f"  {name} bf16, {cfg.num_layers} layers: {how}; decode step "
          f"median {step_ms:.3f} ms over {new - 2} steps after 2 "
          f"(CUDA events; min {min(times):.3f}, max {max(times):.3f}), "
          f"{b / step_ms * 1e3:.1f} tok/s at batch {b}; bound "
          f"{bound_ms:.3f} ms = ({weight_b / 1e9:.3f} GB weights + "
          f"{cache_b / 1e9:.3f} GB cache at max_seq {max_seq}) / "
          f"{HBM_BYTES_PER_S / 1e12:.2f} TB/s, {bound_ms / step_ms:.4f} of "
          f"it; one step profiled: {n_kernels} launches, kernels "
          f"{busy_ms:.3f} ms, idle share {idle:.3f}; peak memory "
          f"{peak:.2f} GB ({smi})", flush=True)
    check(bool(finite), f"{name}: every prompt and decode logit finite")
    check(torch.equal(ids, again) and bool(
        ((ids >= 0) & (ids < cfg.vocab_size)).all()),
        f"{name}: greedy decode of {new} tokens at batch {b} the same over "
        f"two runs from the prompt's cache (first ids "
        f"{ids[0, :6].tolist()})")
    del params, cache, start_cache, logits
    free_cuda()
    return {"prompt_ms": prompt_ms, "step_ms": step_ms, "bound_ms": bound_ms,
            "launches": n_kernels, "peak_gb": peak}


def phase_lm_families(smi):
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cfgs = family_configs()
    print(f"== phase 6c: the ssm, hybrid, encdec and vlm families "
          f"({', '.join(FAMILY_NAMES)}) at full width: float32 checks, "
          f"depth cut to {LM_CHECK_LAYERS} layers (hybrid "
          f"{cfgs['zamba2-7b'].shared_attn_every + 1}: one shared group "
          f"and a tail of 1; the encoder as deep as the decoder), TF32 off,"
          f" each gate max|d| <= {LM_F32_GATE} x std(logits); then bf16 at "
          f"full depth, batch {FAMILY_BATCH}, prompt {FAMILY_PROMPT}, "
          f"{FAMILY_NEW} greedy decode steps ({smi})", flush=True)
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    t0 = time.perf_counter()
    for name, full in cfgs.items():
        layers = full.shared_attn_every + 1 if full.family == "hybrid" \
            else LM_CHECK_LAYERS
        cut = dataclasses.replace(
            full, num_layers=layers, dtype="float32",
            encoder_layers=min(full.encoder_layers, LM_CHECK_LAYERS))
        family_checks(name, cut, gen)
    print(f"  float32 checks: {time.perf_counter() - t0:.1f} s", flush=True)
    out = {}
    for name, full in cfgs.items():
        t1 = time.perf_counter()
        out[name] = family_serve(name, full, gen, smi)
        print(f"  {name}: {time.perf_counter() - t1:.1f} s", flush=True)
    print(f"  phase 6c: {time.perf_counter() - t0:.1f} s", flush=True)
    return out


# Phase 7: the LM harness's training path. minicpm3-4b is the one
# registered config whose training state (bf16 parameters and gradients,
# float32 moments: 12 bytes a parameter) fits one card at its published
# width and depth.
TRAIN_ARCH = "minicpm3-4b"
TRAIN_STEPS = 8
TRAIN_BATCH, TRAIN_SEQ = 8, 128            # the launcher's defaults
TRAIN_CHECK_LAYERS = 2
TRAIN_CHECK_BATCH = 2
# remat "full" against "none" in float32: gradients differ by the order
# of atomic adds (the embedding's and the MoE combine's index_add_) only.
TRAIN_GRAD_GATE = 1e-5                     # max|dg| / max|g|, per leaf
# After one AdamW step at lr from warm-up 1: where |g| is at least
# TRAIN_G_FLOOR x the leaf's max|g| the update is ~lr sign(g) whatever
# the gradient's last bits, so the parameters agree to TRAIN_P_GATE x lr
# (+ 2 ulp); below the floor a sign may flip: at most 2 lr (+ 2 ulp).
TRAIN_G_FLOOR = 1e-3
TRAIN_P_GATE = 1e-3
# The float64 directional derivative against a central difference of
# relative step TRAIN_FD_H along the seeded direction.
TRAIN_FD_H = 1e-5
TRAIN_FD_GATE = 1e-6


class Patched:
    """Replace ``module.name`` by ``wrap(the real one)`` inside the
    ``with`` block."""

    def __init__(self, module, name, wrap):
        self.module, self.name, self.wrap = module, name, wrap

    def __enter__(self):
        self.real = getattr(self.module, self.name)
        setattr(self.module, self.name, self.wrap(self.real))
        return self

    def __exit__(self, *exc):
        setattr(self.module, self.name, self.real)


def train_step_bound(cfg, params, tokens):
    """(bound ms, bound_by, executed FLOPs, bytes) of one AdamW train
    step on ``tokens`` tokens: the larger of the executed FLOPs over the
    bf16 peak and the bytes the step must move over the HBM rate.

    FLOPs: 2 per weight of every product (all but the embedding lookup
    and the norms' scales) per token, plus attention's full S x S scores
    and PV products; the blocks run forward, again under remat "full",
    and backward (2x), the head forward and backward. Bytes: the weights
    read by the forward, the recompute and the backward; the gradients
    written once and read by the global norm and the update; the update's
    read and write of each parameter and of both float32 moments."""
    p_bytes = lm_bytes(params.parameters())
    m_bytes = 4 * sum(p.numel() for p in params.parameters())
    head = "embed" if cfg.tie_embeddings else "lm_head"
    n_head = params[head].numel()
    n_blocks = sum(p.numel() for n, p in params.named_parameters()
                   if p.dim() >= 2 and n.startswith("layers."))
    b, s = TRAIN_BATCH, TRAIN_SEQ
    if cfg.attention == "mla":
        qk, v = cfg.nope_head_dim + cfg.rope_head_dim, cfg.v_head_dim
    else:
        qk = v = cfg.resolved_head_dim
    attn = 2 * b * cfg.num_heads * s * s * (qk + v) * cfg.num_layers
    f_blocks = 2 * tokens * n_blocks + attn
    f_head = 2 * tokens * n_head
    flops = f_blocks * (4 if cfg.remat == "full" else 3) + 3 * f_head
    nbytes = 8 * p_bytes + 4 * m_bytes
    flops_ms = flops / BF16_FLOPS_PER_S * 1e3
    bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
    if flops_ms > bytes_ms:
        return flops_ms, "operations", flops, nbytes
    return bytes_ms, "bytes", flops, nbytes


def timed_steps(steps):
    """A wrapper for ``train_step.make_train_step`` whose steps append
    (CUDA-event ms, metrics) to ``steps``."""
    def timed(make):
        def make_timed(*args, **kwargs):
            step_fn = make(*args, **kwargs)

            def run_step(state, batch):
                start = torch.cuda.Event(enable_timing=True)
                end = torch.cuda.Event(enable_timing=True)
                start.record()
                state, metrics = step_fn(state, batch)
                end.record()
                end.synchronize()
                steps.append((start.elapsed_time(end), metrics))
                return state, metrics
            return run_step
        return make_timed
    return timed


def phase_train_full(smi):
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile, record_function
    from torch.utils.flop_counter import FlopCounterMode
    from repro_torch.configs import get_config
    from repro_torch.kernels import adamw as KA
    from repro_torch.launch import train as LT
    from repro_torch.train import data as D
    from repro_torch.train import optimizer as O
    from repro_torch.train import train_step as TS
    cfg = get_config(TRAIN_ARCH)
    print(f"== phase 7: LM training, {TRAIN_ARCH} at its published width "
          f"and depth, {cfg.dtype}, remat {cfg.remat!r} ({smi})",
          flush=True)
    print(f"  {cfg.num_layers} layers, d_model {cfg.d_model}, "
          f"{cfg.num_heads} heads ({cfg.attention}: q_lora "
          f"{cfg.q_lora_rank}, kv_lora {cfg.kv_lora_rank}), d_ff "
          f"{cfg.d_ff}, vocab {cfg.vocab_size}; {cfg.param_count() / 1e9:.3f}"
          f" B parameters; memory in use before the phase "
          f"{torch.cuda.memory_allocated() / 1e9:.2f} GB", flush=True)
    free_cuda()
    torch.cuda.reset_peak_memory_stats()
    data_cfg = D.DataConfig(batch_size=TRAIN_BATCH, seq_len=TRAIN_SEQ,
                            vocab_size=cfg.vocab_size, seed=SEED)
    # the CLI's optimizer config for --steps TRAIN_STEPS
    opt_cfg = O.OptimizerConfig(total_steps=TRAIN_STEPS,
                                warmup_steps=max(TRAIN_STEPS // 20, 1))
    run = LT.RunConfig(steps=TRAIN_STEPS, log_every=1)
    steps = []
    t0 = time.perf_counter()
    with Patched(TS, "make_train_step", timed_steps(steps)):
        out = LT.train_loop(cfg, data_cfg, opt_cfg, run,
                            log=lambda m: print(f"  {m}", flush=True))
    loop_s = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated() / 1e9
    state = out["state"]
    for i, (ms, m) in enumerate(steps):
        print(f"  step {i}: loss {float(m['loss']):.6f} grad_norm "
              f"{float(m['grad_norm']):.6f} lr {m['lr']:.4e} "
              f"{ms:.3f} ms (CUDA events)", flush=True)
    losses = out["history"]
    check(len(losses) == TRAIN_STEPS and all(math.isfinite(x)
                                            for x in losses),
          f"{TRAIN_STEPS} steps, every loss finite (first {losses[0]:.4f},"
          f" last {losses[-1]:.4f}; ln V = {math.log(cfg.vocab_size):.4f})")
    check(all(math.isfinite(float(m["grad_norm"])) for _, m in steps),
          "every grad norm finite")
    times = [ms for ms, _ in steps[1:]]
    step_ms = statistics.median(times)
    tokens = TRAIN_BATCH * TRAIN_SEQ
    bound_ms, bound_by, flops, nbytes = train_step_bound(
        cfg, state.params, tokens)
    mfu = 6 * cfg.param_count() * tokens / (step_ms / 1e3) \
        / BF16_FLOPS_PER_S
    print(f"  train_loop ({TRAIN_STEPS} steps, batch {TRAIN_BATCH} x seq "
          f"{TRAIN_SEQ}, init included): {loop_s:.3f} s; peak memory "
          f"{peak:.2f} GB ({smi})", flush=True)
    print(f"  train step: median {step_ms:.3f} ms over {len(times)} steps "
          f"after the first (min {min(times):.3f}, max {max(times):.3f}; "
          f"first {steps[0][0]:.3f}); bound {bound_ms:.3f} ms "
          f"({bound_by}: {flops / 1e12:.2f} TFLOP executed / "
          f"{BF16_FLOPS_PER_S / 1e12:.1f} TFLOP/s = "
          f"{flops / BF16_FLOPS_PER_S * 1e3:.3f} ms, {nbytes / 1e9:.2f} GB "
          f"/ {HBM_BYTES_PER_S / 1e12:.2f} TB/s = "
          f"{nbytes / HBM_BYTES_PER_S * 1e3:.3f} ms); "
          f"{bound_ms / step_ms:.3f} of the bound; MFU {mfu:.4f} (6 N D = "
          f"{6 * cfg.param_count() * tokens / 1e12:.2f} TFLOP a step); "
          f"{tokens / step_ms * 1e3:.1f} tokens/s", flush=True)

    # One step as train_loop runs it, profiled: launches and idle share;
    # its optimizer counted: the AdamW kernel's launches, no eager pass.
    step_fn = TS.make_train_step(cfg, opt_cfg)
    batch = D.batch_at(data_cfg, TRAIN_STEPS)
    adamw0 = KA._LAUNCHES.value
    with CallCounter(O, "adamw_update_eager") as eager, \
            profile(activities=[ProfilerActivity.CPU,
                                ProfilerActivity.CUDA]) as prof:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        state, _ = step_fn(state, batch)
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
    adamw_launches = int(KA._LAUNCHES.value - adamw0)
    check(adamw_launches == KA.LAUNCHES and eager.calls == 0,
          f"the step's optimizer through the AdamW kernel: {adamw_launches} "
          f"launches (norm 2, update 1), the eager loop called "
          f"{eager.calls} times")
    busy_ms, n_kernels, idle = device_split(prof.events(), wall)
    print(f"  one train step profiled: wall {wall:.3f} ms (profiler on), "
          f"kernels {busy_ms:.3f} ms over {n_kernels} launches "
          f"({bound_ms / busy_ms:.3f} of the bound), device idle share "
          f"{idle:.3f}; top kernels by device time:", flush=True)
    kernels_by_name(prof.events(), 8)
    del prof

    # One more step under FlopCounterMode: the FLOPs phase 9b's fake count
    # of this cell must equal.
    with FlopCounterMode(display=False) as counter:
        state, _ = step_fn(state, batch)
    counted = counter.get_total_flops()
    print(f"  one train step under FlopCounterMode: {counted} FLOPs "
          f"({counted / flops:.4f} of train_step_bound's {flops / 1e12:.2f} "
          f"TFLOP)", flush=True)

    # One more step split into its three parts, with a sync after each so
    # that each kernel runs inside the part that launched it.
    loss_fn = TS.make_loss_fn(cfg)
    named = dict(state.params.named_parameters())
    parts = ("repro.train/forward", "repro.train/backward",
             "repro.train/optimizer")
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        torch.cuda.synchronize()
        with record_function(parts[0]):
            total, _ = loss_fn(state.params, batch)
            torch.cuda.synchronize()
        with record_function(parts[1]):
            grads = torch.autograd.grad(total, list(named.values()))
            torch.cuda.synchronize()
        with record_function(parts[2]):
            O.adamw_update(dict(zip(named, grads)), state.opt, named,
                           opt_cfg)
            torch.cuda.synchronize()
    del grads, total
    events = prof.events()
    spans = {e.name: e.time_range for e in events
             if e.name in parts and e.device_type == DeviceType.CPU}
    kernels = [e for e in events if e.device_type == DeviceType.CUDA
               and not e.name.startswith("repro.")]
    placed = 0
    for name in parts:
        span = spans[name]
        mine = [e for e in kernels
                if span.start <= e.time_range.start < span.end]
        placed += len(mine)
        ms = sum(e.time_range.elapsed_us() for e in mine) / 1e3
        wall_ms = span.elapsed_us() / 1e3
        print(f"  {name.split('/')[1]:9s}: wall {wall_ms:9.3f} ms, kernels "
              f"{ms:8.3f} ms over {len(mine):6d} launches, idle share "
              f"{1 - ms / wall_ms:.3f}", flush=True)
    print(f"  ({placed} of {len(kernels)} kernels placed in a part)",
          flush=True)
    del prof, events, kernels, named
    flash_launches = flash_steps(cfg, state, step_fn, smi)
    del state, out, steps
    free_cuda()
    return {"step_ms": step_ms, "bound_ms": bound_ms, "mfu": mfu,
            "tok_per_s": tokens / step_ms * 1e3, "peak_gb": peak,
            "launches": n_kernels, "idle": idle, "losses": losses,
            "flops_counted": counted, "bound_flops": flops,
            "flash_launches": flash_launches,
            "adamw_launches": adamw_launches}


def flash_steps(cfg, state, step_fn, smi):
    """Two steps of phase 7's state at the train4k cell's batch (2 x
    4,096), where every layer's attention, forward, recompute and
    backward, takes the flash kernel: both timed, the second counted by
    the kernel's launch counters. Returns its launches."""
    from repro_torch.kernels import flash_attention as FK
    from repro_torch.models import layers as L
    from repro_torch.train import data as D
    b, s = FLASH_SHAPE[:2]
    data = D.DataConfig(batch_size=b, seq_len=s, vocab_size=cfg.vocab_size,
                        seed=SEED)
    torch.cuda.reset_peak_memory_stats()
    times = []
    for i in range(2):
        fwd0, bwd0 = FK._FWD.value, FK._BWD.value
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        with CallCounter(L, "flash_attention") as calls:
            start.record()
            state, m = step_fn(state, D.batch_at(data, i))
            end.record()
            end.synchronize()
        times.append(start.elapsed_time(end))
    fwd, bwd = FK._FWD.value - fwd0, FK._BWD.value - bwd0
    n = cfg.num_layers
    print(f"  {TRAIN_ARCH} train steps at {b} x {s} (remat {cfg.remat!r}): "
          f"{times[0]:.3f}, {times[1]:.3f} ms (CUDA events), "
          f"{b * s / times[1] * 1e3:.1f} tokens/s at the second; loss "
          f"{float(m['loss']):.4f}; the second's flash_attention calls "
          f"{calls.calls}, kernel launches forward {int(fwd)}, backward "
          f"{int(bwd)}; peak memory "
          f"{torch.cuda.max_memory_allocated() / 1e9:.2f} GB ({smi})",
          flush=True)
    check(calls.calls == 2 * n and fwd == 2 * n and bwd == 2 * n,
          f"every layer's attention through the kernel: {2 * n} forward "
          f"launches ({n} layers, forward and recompute), {n} backward calls "
          f"of two launches each")
    return int(fwd + bwd)


def max_rel_leaf_err(got, want):
    """max over leaves of max|got - want| / max|want|."""
    worst = 0.0
    for k in want:
        scale = float(want[k].abs().max())
        err = float((got[k] - want[k]).abs().max())
        worst = max(worst, err / scale if scale > 0 else err)
    return worst


# MiniCPM3's attention at the benchmark's train4k cell: (B, S, heads, Hq,
# key width 64 + 32, value width 64).
FLASH_SHAPE = (2, 4096, 40, 1, 96, 64)
FLASH_RUNS = 20
# The kernel's forward and gradients against the float32 chunk loop, by
# norm: bf16 outputs round once (up to 2^-9 relative, ~1.6e-3 over a
# tensor's norm) and dS rounds to bf16 before dq and dk, as the chunk
# loop's autograd rounds it (tests/test_torch_flash_card.py).
FLASH_REL_TOL = 4e-3
FLASH_KERNELS = ("flash_fwd_kernel", "flash_bwd_dq_kernel",
                 "flash_bwd_dkv_kernel")


def causal_flops(b, s, heads, d, dv):
    """Operations of the two products over the causal (query, key) pairs,
    2 (d + dv) a pair, as ``lsbench.peaks.lm_train_flops`` counts them."""
    return 2.0 * b * heads * s * (s + 1) / 2 * (d + dv)


def flash_inputs(seed):
    """q (B,S,H,1,K) and k, v as MLA passes them: (B,H,T,·) views of
    (B,T,H,·) tensors; dout (B,S,H,1,Kv); all bf16 from ``seed``."""
    b, s, h, hq, d, dv = FLASH_SHAPE
    gen = torch.Generator(device="cuda").manual_seed(seed)

    def draw(*shape):
        return torch.randn(shape, generator=gen, device="cuda").bfloat16()

    return (draw(b, s, h, hq, d), draw(b, s, h, d).transpose(1, 2),
            draw(b, s, h, dv).transpose(1, 2), draw(b, s, h, hq, dv))


def phase_flash_kernel(smi, report):
    """7a: the flash attention kernel at MiniCPM3's train4k shape on MLA's
    transposed k and v: the forward and gradients against the chunk loop in
    bf16 and float32, device ms against its bound, the chunk loop's and
    SDPA's ms."""
    import torch.nn.functional as F
    from repro_torch.kernels import flash_attention as FK
    from repro_torch.models import layers as L
    b, s, h, hq, d, dv = FLASH_SHAPE
    print(f"== phase 7a: flash attention kernel at (B {b}, S {s}, heads {h},"
          f" Hq {hq}, K {d}, Kv {dv}), bf16, causal ({smi})", flush=True)
    free_cuda()
    flush = torch.empty(64 << 20, dtype=torch.uint8, device="cuda")
    for which, name in enumerate(FLASH_KERNELS):
        lines = ptxas_lines(report, f"{name}I13__nv_bfloat16Li{d}ELi{dv}E")
        print_occupancy(f"{name}<bf16, {d}, {dv}>", lines, 128,
                        FK.smem_bytes(which, d, dv))
    q, k, v, dout = flash_inputs(SEED)
    scale = d ** -0.5
    kw = dict(causal=True, scale=scale)
    flops = causal_flops(b, s, h * hq, d, dv)
    fwd_bound = flops / BF16_FLOPS_PER_S * 1e3

    def forward():
        return FK.flash_attention(q, k, v, **kw)

    def both(fn=FK.flash_attention, args=(q, k, v, dout)):
        qq, kk, vv = (x.detach().requires_grad_() for x in args[:3])
        out = fn(qq, kk, vv, **kw)
        return (out.detach(),
                *torch.autograd.grad(out, (qq, kk, vv), args[3]))

    check(not (k.is_contiguous() or v.is_contiguous())
          and FK.refusal(q, k, v) is None,
          "k and v are MLA's transposed views, and the kernel takes them")
    got = both()
    loop = both(L.flash_attention_chunked)
    f32 = both(L.flash_attention_chunked,
               tuple(x.float() for x in (q, k, v, dout)))
    for name, g, c, w in zip(("out", "dq", "dk", "dv"), got, loop, f32):
        err = float((g.float() - w).norm() / w.norm())
        loop_err = float((c.float() - w).norm() / w.norm())
        check(err <= loop_err and err < FLASH_REL_TOL,
              f"{name}: the kernel's error by norm against the float32 chunk"
              f" loop {err:.3e} <= the bf16 chunk loop's {loop_err:.3e}, "
              f"< {FLASH_REL_TOL:g} (max abs {max_err(g.float(), w):.3e})")
    fwd_err = max_err(got[0].float(), f32[0])
    del got, loop, f32

    # Device time by CUDA events around calls queued back to back, not by
    # the profiler: after phase 7's profiled steps its trace dropped records
    # of these launches in all three tries. Each call's host work is far
    # shorter than its kernels, so the card never waits between calls.
    _, out32, lse = FK._forward(q, k, v, True, scale, 0, keep=True)
    with torch.no_grad():
        fwd_ms = queued_ms(forward, FLASH_RUNS)
        fwd_launch = time_ms(forward, FLASH_RUNS, flush)
    keep_ms = queued_ms(lambda: FK._forward(q, k, v, True, scale, 0,
                                            keep=True), FLASH_RUNS)
    bwd_ms = queued_ms(lambda: FK._backward(q, k, v, out32, lse, dout, True,
                                            scale, 0), FLASH_RUNS)
    both_ms = keep_ms + bwd_ms
    both_launch = time_ms(both, FLASH_RUNS, flush)
    del out32, lse
    print(f"  forward: kernel {fwd_ms:.4f} ms device time ({FLASH_RUNS} "
          f"calls queued), {fwd_launch:.4f} ms with its launch (CUDA events,"
          f" median of {FLASH_RUNS}); bound {fwd_bound:.4f} ms "
          f"({flops / 1e9:.1f} GFLOP of causal products at "
          f"{BF16_FLOPS_PER_S / 1e12:.0f} TFLOP/s): "
          f"{fwd_ms / fwd_bound:.2f}x the bound", flush=True)
    print(f"  forward + backward (the forward keeping its float32 output "
          f"{keep_ms:.4f} ms, then dq and dk / dv {bwd_ms:.4f} ms; "
          f"{FLASH_RUNS} calls queued): {both_ms:.4f} ms device time, "
          f"{both_launch:.4f} ms with launches through autograd; backward "
          f"against twice the bound {2 * fwd_bound:.4f} ms: "
          f"{bwd_ms / (2 * fwd_bound):.2f}x", flush=True)
    with torch.no_grad():
        loop_fwd = time_ms(lambda: L.flash_attention_chunked(q, k, v, **kw),
                           3, flush)
    loop_both = time_ms(lambda: both(L.flash_attention_chunked), 3, flush)
    print(f"  the chunk loop (plain version, 512 x 1,024 chunks, no skip): "
          f"forward {loop_fwd:.3f} ms, forward + backward {loop_both:.3f} ms "
          f"(CUDA events, median of 3); kernel / loop {fwd_launch / loop_fwd:.4f}"
          f", {both_launch / loop_both:.4f}", flush=True)
    # The library yardstick, never called by the port: SDPA on (B, H, S, ·).
    qs, ks, vs = (x.squeeze(3).transpose(1, 2) if x.dim() == 5 else x
                  for x in (q, k, v))
    try:
        with torch.no_grad():
            lib_fwd = time_ms(lambda: F.scaled_dot_product_attention(
                qs, ks, vs, is_causal=True, scale=scale), FLASH_RUNS, flush)

        def lib_both():
            qq, kk, vv = (x.detach().requires_grad_() for x in (qs, ks, vs))
            out = F.scaled_dot_product_attention(qq, kk, vv, is_causal=True,
                                                 scale=scale)
            return torch.autograd.grad(out, (qq, kk, vv),
                                       dout.squeeze(3).transpose(1, 2))
        lib_both_ms = time_ms(lib_both, FLASH_RUNS, flush)
        print(f"  library yardstick F.scaled_dot_product_attention: forward "
              f"{lib_fwd:.4f} ms, forward + backward {lib_both_ms:.4f} ms "
              f"(CUDA events, median of {FLASH_RUNS})", flush=True)
    except RuntimeError as err:
        lib_fwd = None
        print(f"  library yardstick F.scaled_dot_product_attention: not "
              f"available at these widths ({str(err)[:120]})", flush=True)
    del q, k, v, dout, flush
    free_cuda()
    # launches: phase 7's counted step at 2 x 4,096 (main sets them)
    return dict(name="flash_attention", route="cuda",
                source="src/repro_torch/csrc/flash_attention.cu",
                replaces="no TPU kernel: src/repro/models/layers.py:101 "
                         "flash_attention (jnp)",
                max_abs_err=fwd_err, ms=fwd_ms, ms_with_launch=fwd_launch,
                plain_ms=loop_fwd, bound_ms=fwd_bound, bound_by="operations",
                library_ms=lib_fwd, launches=None)


# Phase 7c: the AdamW kernel at minicpm3-4b's 871 leaves, bf16, full size.
ADAMW_SEED = 7_000_000
ADAMW_RUNS = 5            # kernel calls queued between two CUDA events
ADAMW_EAGER_RUNS = 2      # eager-loop calls queued likewise
ADAMW_NORM_TOL = 1e-5     # the kernel's norm against float64, relative
# (entry function, threads a CTA, shared bytes a CTA)
ADAMW_KERNELS = (("norm_chunks", 256, 256 * 8),
                 ("norm_finish", 1024, 1024 * 8),
                 ("update_chunks", 256, 0))
ADAMW_STD = (0.02, 1e-4, 1e-4, 1e-4)           # p, g, m, sqrt(v)


def phase_adamw_kernel(smi, report):
    """7c: the AdamW kernel over minicpm3-4b's leaves at full size against
    the eager loop: the update through ``adamw_update`` (three launches,
    no eager pass), its norm against float64 and, leaf by leaf from the
    same draws, the eager loop given the kernel's norm, bit for bit; a
    repeat's norm bit-equal; device ms of both (CUDA events around queued
    calls; the kernel's split in the profiler where its trace is whole)
    against the bound, 24 bytes a bf16 element and 32 a float32 one at
    the HBM rate."""
    from repro_torch.configs import get_config
    from repro_torch.kernels import adamw as KA
    from repro_torch.models import model as M
    from repro_torch.train import optimizer as O
    cfg = get_config(TRAIN_ARCH)
    print(f"== phase 7c: the AdamW kernel over {TRAIN_ARCH}'s leaves, "
          f"{cfg.dtype}, float32 moments ({smi})", flush=True)
    free_cuda()
    for name, threads, smem in ADAMW_KERNELS:
        print_occupancy(name, ptxas_lines(report, name), threads, smem)
    params = {k: p.detach() for k, p in
              M.empty_params(cfg, device="cuda").named_parameters()}
    names = list(params)

    def draw(i, what, like, dtype):
        gen = torch.Generator(device="cuda")
        gen.manual_seed(ADAMW_SEED + 4 * i + what)
        x = torch.randn(like.shape, generator=gen, device="cuda")
        x = x * ADAMW_STD[what]
        return (x.square() if what == 3 else x).to(dtype)

    def bits(x):
        return x.view(torch.int16 if x.element_size() == 2 else torch.int32)

    def originals(i, k):
        p = params[k]
        return (draw(i, 0, p, p.dtype), draw(i, 2, p, torch.float32),
                draw(i, 3, p, torch.float32))

    grads, mu, nu = {}, {}, {}
    for i, k in enumerate(names):
        p0, mu[k], nu[k] = originals(i, k)
        params[k].copy_(p0)
        grads[k] = draw(i, 1, params[k], params[k].dtype)
        del p0
    elems = sum(p.numel() for p in params.values())
    wide = sum(p.numel() for p in params.values()
               if p.dtype == torch.float32)
    nbytes = 24 * (elems - wide) + 32 * wide
    bound_ms = nbytes / HBM_BYTES_PER_S * 1e3
    print(f"  {len(names)} leaves, {elems:,} elements ({wide:,} float32); "
          f"{KA.leaf_table(grads, params, mu, nu, names)[1]:,} chunks of "
          f"{KA.CHUNK:,}; memory in use {torch.cuda.memory_allocated() / 1e9:.2f}"
          f" GB", flush=True)
    opt_cfg = O.OptimizerConfig(peak_lr=3e-4, warmup_steps=0)
    opt = O.OptState(step=0, mu=mu, nu=nu)
    check(KA.route(grads, params, mu, nu) == "kernel",
          "plain CUDA leaves route to the kernel")

    # The update through adamw_update: three launches, no eager pass; its
    # norm against float64 and the eager loop's float32 norm.
    before = KA._LAUNCHES.value
    with CallCounter(O, "adamw_update_eager") as eager:
        _, opt1, metrics = O.adamw_update(grads, opt, params, opt_cfg)
    torch.cuda.synchronize()
    launches = int(KA._LAUNCHES.value - before)
    check(launches == KA.LAUNCHES and eager.calls == 0,
          f"adamw_update on the card: {launches} launches, the eager loop "
          f"called {eager.calls} times")
    a = metrics["grad_norm"]
    norm = float(a)
    f64 = math.sqrt(sum(float(g.double().square().sum())
                        for g in grads.values()))
    eager_norm = float(O.global_norm(grads))
    check(abs(norm - f64) <= ADAMW_NORM_TOL * f64,
          f"norm {norm!r} against float64 {f64!r}: rel "
          f"{abs(norm - f64) / f64:.3e} <= {ADAMW_NORM_TOL:g} (the eager "
          f"loop's float32 norm {eager_norm!r}: rel "
          f"{abs(eager_norm - f64) / f64:.3e})")

    # The eager loop leaf by leaf from the same draws, given the kernel's
    # norm: the same bits.
    differ, worst = [], 0.0
    with Patched(O, "global_norm", lambda real: lambda tree: a):
        for i, k in enumerate(names):
            p0, m0, v0 = originals(i, k)
            O.adamw_update_eager({k: grads[k]}, O.OptState(0, {k: m0},
                                                           {k: v0}),
                                 {k: p0}, opt_cfg)
            for what, got, ref in (("p", params[k], p0), ("m", mu[k], m0),
                                   ("v", nu[k], v0)):
                if not torch.equal(bits(got), bits(ref)):
                    differ.append(f"{k}.{what}")
                    worst = max(worst, max_err(got.float(), ref.float()))
            del p0, m0, v0
    check(not differ, f"parameters and moments bit-equal to the eager loop "
          f"in all {len(names)} leaves ({len(differ)} tensors differ"
          f"{', max abs ' + format(worst, '.3e') if differ else ''}"
          f"{': ' + ', '.join(differ[:5]) if differ else ''})")
    _, opt1, again = O.adamw_update(grads, opt1, params, opt_cfg)
    check(torch.equal(bits(again["grad_norm"]), bits(a)),
          f"the same gradients' norm again bit-equal: {norm!r}")

    # Device time: calls queued back to back between CUDA events; each
    # kernel's own from the profiler's trace where it holds every record.
    def step():
        O.adamw_update(grads, opt1, params, opt_cfg)

    kernel = queued_ms(step, ADAMW_RUNS)
    traced, by = device_ms_per_call(step, [n for n, _, _ in ADAMW_KERNELS],
                                    ADAMW_RUNS, expect=1)
    t0 = time.perf_counter()
    O.adamw_update(grads, opt1, params, opt_cfg)
    host_ms = (time.perf_counter() - t0) * 1e3
    torch.cuda.synchronize()
    eager_ms = queued_ms(lambda: O.adamw_update_eager(grads, opt1, params,
                                                      opt_cfg),
                         ADAMW_EAGER_RUNS)
    split = ("no split: no profiler trace held every launch's record"
             if traced is None else
             f"in the profiler's trace {traced:.3f} ms: "
             + ", ".join(f"{n} {ms:.3f}" for n, ms in by.items()))
    print(f"  kernel: {kernel:.3f} ms a call ({ADAMW_RUNS} calls queued, "
          f"CUDA events); {split}"
          + f"; host {host_ms:.3f} ms to issue one; bound {bound_ms:.3f} ms "
          f"({nbytes / 1e9:.2f} GB at {HBM_BYTES_PER_S / 1e12:.2f} TB/s): "
          f"{bound_ms / kernel:.3f} of it, {nbytes / kernel / 1e6:.1f} GB/s",
          flush=True)
    print(f"  the eager loop (plain version): {eager_ms:.3f} ms a call "
          f"({ADAMW_EAGER_RUNS} queued); kernel / eager "
          f"{kernel / eager_ms:.4f} ({smi})", flush=True)
    del params, grads, mu, nu, opt, opt1, metrics, again, a
    free_cuda()
    # launches: phase 7's counted step (main sets them)
    return dict(name="adamw", route="cuda",
                source="src/repro_torch/csrc/adamw.cu",
                replaces="no TPU kernel: src/repro/train/optimizer.py:58 "
                         "adamw_update (jnp)",
                max_abs_err=worst, ms=kernel, ms_with_launch=None,
                plain_ms=eager_ms, bound_ms=bound_ms, bound_by="bytes",
                library_ms=None, launches=None)


def phase_train_checks(smi):
    import tempfile
    from repro_torch.configs import get_config
    from repro_torch.models import model as M
    from repro_torch.train import checkpoint as C
    from repro_torch.train import data as D
    from repro_torch.train import optimizer as O
    from repro_torch.train import train_step as TS
    print(f"== phase 7b: training checks, the four configs at full width, "
          f"depth cut to {TRAIN_CHECK_LAYERS} layers, float32, TF32 "
          f"{'on' if torch.backends.cuda.matmul.allow_tf32 else 'off'}, "
          f"batch {TRAIN_CHECK_BATCH} x seq {TRAIN_SEQ} ({smi})", flush=True)
    opt_cfg = O.OptimizerConfig(warmup_steps=1)
    lr = O.lr_schedule(opt_cfg, 1)
    ckpt_root = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                             "build")
    os.makedirs(ckpt_root, exist_ok=True)
    for arch in LM_ARCHS:
        t0 = time.perf_counter()
        cfg = dataclasses.replace(get_config(arch),
                                  num_layers=TRAIN_CHECK_LAYERS,
                                  dtype="float32")
        data_cfg = D.DataConfig(batch_size=TRAIN_CHECK_BATCH,
                                seq_len=TRAIN_SEQ,
                                vocab_size=cfg.vocab_size, seed=SEED)
        b0, b1 = D.batch_at(data_cfg, 0), D.batch_at(data_cfg, 1)

        # 1. remat "full" against "none": loss, gradients, one step.
        none = dataclasses.replace(cfg, remat="none")
        state = TS.init_train_state(none, seed=SEED)
        named = dict(state.params.named_parameters())
        print(f"  {arch}: {lm_bytes(named.values()) / 1e9:.2f} GB of "
              f"parameters ({cfg.attention}, {cfg.family}); remat "
              f"{cfg.remat!r}", flush=True)
        grads = {}
        for c in (cfg, none):
            total, m = TS.make_loss_fn(c)(state.params, b0)
            grads[c.remat] = (float(m["loss"].detach()), dict(zip(
                named, torch.autograd.grad(total, list(named.values())))))
            del total
        (loss_f, g_f), (loss_n, g_n) = grads["full"], grads["none"]
        g_err = max_rel_leaf_err(g_f, g_n)
        exact = cfg.family != "moe"
        check((loss_f == loss_n) if exact else
              abs(loss_f - loss_n) <= 1e-6 * abs(loss_n),
              f"{arch} loss, remat full {loss_f!r} vs none {loss_n!r}"
              + ("" if exact else " (<= 1e-6 relative: the MoE combine's "
                 "index_add_ is atomic)"))
        check(g_err <= TRAIN_GRAD_GATE,
              f"{arch} gradients, remat full vs none: max|dg| / max|g| "
              f"{g_err:.3g} <= {TRAIN_GRAD_GATE}")
        del g_f, grads
        floor = {k: TRAIN_G_FLOOR * float(g.abs().max())
                 for k, g in g_n.items()}
        big = {k: g.abs() >= floor[k] for k, g in g_n.items()}
        del g_n
        state, m_n = TS.make_train_step(none, opt_cfg)(state, b0)
        p_n = {k: p.detach().clone() for k, p in named.items()}
        del state, named
        free_cuda()
        state = TS.init_train_state(cfg, seed=SEED)
        state, m_f = TS.make_train_step(cfg, opt_cfg)(state, b0)
        tight = worst_small = 0.0
        n_small = n_over = 0
        for k, p in state.params.named_parameters():
            d = (p.detach() - p_n[k]).abs()
            ulp2 = 2 * torch.finfo(p.dtype).eps * p_n[k].abs()
            tight = max(tight, float(((d - ulp2) * big[k]).max()) / lr)
            rest = (d - ulp2)[~big[k]]
            n_small += rest.numel()
            if rest.numel():
                worst_small = max(worst_small, float(rest.max()) / lr)
                n_over += int((rest > TRAIN_P_GATE * lr).sum())
        check(tight <= TRAIN_P_GATE and worst_small <= 2.0,
              f"{arch} one step, remat full vs none: loss "
              f"{float(m_f['loss'])!r} vs {float(m_n['loss'])!r}; "
              f"parameters (less 2 ulp) "
              f"within {tight:.3g} lr where |g| >= {TRAIN_G_FLOOR} x the "
              f"leaf's max|g| (gate {TRAIN_P_GATE}); below the floor "
              f"{n_over} of {n_small} elements past {TRAIN_P_GATE} lr, the "
              f"worst {worst_small:.3g} lr (gate 2 lr); lr {lr:.3e}")
        del state, p_n, big
        free_cuda()

        # 2. float64: the gradient along a seeded direction against a
        # central difference.
        c64 = dataclasses.replace(cfg, dtype="float64")
        params = M.init_params(c64, seed=SEED).double().requires_grad_()
        named = dict(params.named_parameters())
        loss_fn = TS.make_loss_fn(c64)
        total, _ = loss_fn(params, b0)
        grads = torch.autograd.grad(total, list(named.values()))
        del total
        rms = {k: float(p.detach().square().mean().sqrt())
               for k, p in named.items()}
        gen = torch.Generator(device="cuda")

        def direction():
            gen.manual_seed(SEED + 1)
            for k, p in named.items():
                yield k, p, torch.randn(p.shape, generator=gen,
                                        device="cuda",
                                        dtype=torch.float64) * rms[k]

        dd = sum(float((g * u).sum())
                 for g, (_, _, u) in zip(grads, direction()))
        del grads
        orig = {k: p.detach().clone() for k, p in named.items()}
        side = []
        with torch.no_grad():
            for sign in (1.0, -1.0):
                for k, p, u in direction():
                    p.copy_(orig[k] + sign * TRAIN_FD_H * u)
                side.append(float(loss_fn(params, b0)[0]))
        fd = (side[0] - side[1]) / (2 * TRAIN_FD_H)
        rel = abs(fd - dd) / abs(dd)
        check(rel <= TRAIN_FD_GATE,
              f"{arch} float64 directional derivative: autograd {dd!r}, "
              f"central difference (h = {TRAIN_FD_H}) {fd!r}, relative "
              f"error {rel:.3g} <= {TRAIN_FD_GATE}")
        del params, named, orig
        free_cuda()

        # 3. checkpoint save -> restore -> next step, against the step
        # without the restart; deterministic algorithms (the index_add_
        # and index backward kernels' sorted forms) for bit equality.
        torch.use_deterministic_algorithms(True, warn_only=True)
        try:
            import warnings
            with warnings.catch_warnings():
                warnings.simplefilter("ignore")
                step_fn = TS.make_train_step(cfg, opt_cfg)
                state = TS.init_train_state(cfg, seed=SEED)
                state, _ = step_fn(state, b0)
                with tempfile.TemporaryDirectory(dir=ckpt_root) as d:
                    t1 = time.perf_counter()
                    C.save(d, 1, state, metadata={"arch": arch})
                    save_s = time.perf_counter() - t1
                    size = sum(os.path.getsize(os.path.join(r, f))
                               for r, _, fs in os.walk(d) for f in fs)
                    t1 = time.perf_counter()
                    template = TS.TrainState(
                        params=M.empty_params(cfg, device="meta"
                                              ).requires_grad_(),
                        opt=O.init_opt_state(M.empty_params(
                            cfg, device="meta")))
                    restored, step, _ = C.restore(d, template,
                                                  device="cuda")
                    load_s = time.perf_counter() - t1
                same = restored.opt.step == state.opt.step == step == 1
                for a, b in ((dict(restored.params.named_parameters()),
                              dict(state.params.named_parameters())),
                             (restored.opt.mu, state.opt.mu),
                             (restored.opt.nu, state.opt.nu)):
                    same = same and all(torch.equal(a[k], b[k]) for k in b)
                check(same, f"{arch} checkpoint ({size / 1e9:.2f} GB, save "
                      f"{save_s:.2f} s, restore {load_s:.2f} s): the "
                      f"restored state equals the saved one bit for bit")
                state, m_a = step_fn(state, b1)
                restored, m_b = step_fn(restored, b1)
                same = float(m_a["loss"]) == float(m_b["loss"]) and all(
                    torch.equal(p, q) for p, q in zip(
                        state.params.parameters(),
                        restored.params.parameters()))
                check(same, f"{arch} the step after the restore equals the "
                      f"uninterrupted step exactly: loss "
                      f"{float(m_b['loss'])!r}, every parameter")
        finally:
            torch.use_deterministic_algorithms(False)
        del state, restored, template
        free_cuda()
        print(f"  {arch}: {time.perf_counter() - t0:.2f} s", flush=True)


# Phase 8: sharded training on a DTensor mesh. The card's machine has one
# GPU and NCCL refuses two ranks on one device, so the mesh is (1, 1) over
# an NCCL process group of world size 1: every rule's axis has size 1 and
# each leaf is placed Replicate(), so this phase shows the mesh path's
# placement, its DTensor dispatch cost and its checkpoints on the card.
# The collectives of meshes with more than one rank are held by the gloo
# tests on CPU ranks (tests/test_torch_dist_*.py).
SHARD_STEPS = 4
# Steps after the first against phase 7's (same seed, data, optimizer):
# the first is bit for bit; later ones differ by the card's
# nondeterministic adds (the embedding's backward) amplified by AdamW.
SHARD_LOSS_GATE = 5e-3
# The pipeline's one stage against the sequential loop, float32 (GEMMs of
# another row count may sum in another order).
PIPE_GATE = 1e-5
PIPE_LAYERS, PIPE_BATCH, PIPE_SEQ, PIPE_MICRO = 4, 8, 16, 4


def start_nccl(root):
    """The default process group: NCCL, world size 1, rank 0, through a
    FileStore under ``root`` (no port)."""
    import datetime
    import tempfile
    import torch.distributed as dist
    store = tempfile.mkdtemp(dir=root, prefix=".store_")
    dist.init_process_group(
        "nccl", store=dist.FileStore(os.path.join(store, "store"), 1),
        rank=0, world_size=1, device_id=torch.device("cuda", 0),
        timeout=datetime.timedelta(seconds=600))
    return store


def host_leaves(tree):
    """{checkpoint key: the leaf's bits on the host} (a DTensor leaf by its
    local tensor, here the whole tensor; bfloat16 as int16)."""
    from torch.distributed.tensor import DTensor
    from repro_torch.train import checkpoint as C
    out = {}
    for k, leaf in C._leaves(tree):
        if isinstance(leaf, DTensor):
            leaf = leaf.to_local()
        if isinstance(leaf, torch.Tensor):
            leaf = leaf.detach()
            if leaf.dtype == torch.bfloat16:
                leaf = leaf.view(torch.int16)
            leaf = leaf.cpu()
        out[k] = leaf
    return out


def same_bits_as(tree, host):
    """Every leaf of ``tree`` bit for bit against ``host_leaves``' copy."""
    from torch.distributed.tensor import DTensor
    from repro_torch.train import checkpoint as C
    for k, leaf in C._leaves(tree):
        want = host[k]
        if not isinstance(leaf, torch.Tensor):
            if leaf != want:
                return False
            continue
        if isinstance(leaf, DTensor):
            leaf = leaf.to_local()
        leaf = leaf.detach()
        if leaf.dtype == torch.bfloat16:
            leaf = leaf.view(torch.int16)
        if not torch.equal(leaf, want.to(leaf.device)):
            return False
    return True


def phase_train_mesh(smi, phase7):
    import shutil
    import tempfile
    import warnings
    from torch.distributed.tensor import DTensor
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.configs import get_config
    from repro_torch.distributed import sharding as S
    from repro_torch.kernels import adamw as KA
    from repro_torch.launch import train as LT
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.train import checkpoint as C
    from repro_torch.train import data as D
    from repro_torch.train import optimizer as O
    from repro_torch.train import train_step as TS
    cfg = get_config(TRAIN_ARCH)
    mesh = make_mesh((1, 1), ("data", "model"), "cuda")
    print(f"== phase 8: sharded training, {TRAIN_ARCH} at its published "
          f"width and depth ({cfg.num_layers} layers), {cfg.dtype}, remat "
          f"{cfg.remat!r}, on a DTensor mesh {dict(S.axis_sizes(mesh))} over "
          f"an NCCL group of world size 1 (one card: NCCL refuses two ranks "
          f"on one GPU; the multi-rank collectives are held by the gloo "
          f"tests) ({smi})", flush=True)
    free_cuda()
    torch.cuda.reset_peak_memory_stats()
    data_cfg = D.DataConfig(batch_size=TRAIN_BATCH, seq_len=TRAIN_SEQ,
                            vocab_size=cfg.vocab_size, seed=SEED)
    # phase 7's optimizer config, so that the schedules agree
    opt_cfg = O.OptimizerConfig(total_steps=TRAIN_STEPS,
                                warmup_steps=max(TRAIN_STEPS // 20, 1))
    run = LT.RunConfig(steps=SHARD_STEPS, log_every=1)
    steps = []
    t0 = time.perf_counter()
    with Patched(TS, "make_train_step", timed_steps(steps)):
        out = LT.train_loop(cfg, data_cfg, opt_cfg, run, mesh=mesh,
                            log=lambda m: print(f"  {m}", flush=True))
    loop_s = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated() / 1e9
    state = out["state"]
    losses = out["history"]
    del out
    for i, (ms, m) in enumerate(steps):
        print(f"  step {i}: loss {float(m['loss'])!r} (phase 7: "
              f"{phase7['losses'][i]!r}) grad_norm {float(m['grad_norm']):.6f}"
              f" {ms:.3f} ms (CUDA events)", flush=True)
    check(len(losses) == SHARD_STEPS and all(math.isfinite(x)
                                            for x in losses),
          f"{SHARD_STEPS} steps on the mesh, every loss finite")
    check(losses[0] == phase7["losses"][0],
          f"the first step's loss on the mesh equals the unsharded step's "
          f"(phase 7, same seed) bit for bit: {losses[0]!r}")
    later = max(abs(a - b) for a, b in zip(losses[1:], phase7["losses"][1:]))
    check(later <= SHARD_LOSS_GATE,
          f"later steps within {later:.3g} of phase 7's (gate "
          f"{SHARD_LOSS_GATE})")
    want = S.param_shardings(state, mesh)
    specs = S.param_specs(state, mesh)
    placed = all(isinstance(p, DTensor) and p.device_mesh == mesh
                 and p.placements == want.params[k].placements
                 and state.opt.mu[k].placements == want.params[k].placements
                 and state.opt.nu[k].placements == want.params[k].placements
                 for k, p in state.params.named_parameters())
    n_leaves = sum(1 for _ in state.params.parameters())
    check(placed, f"all {n_leaves} parameters and their moments are "
          f"DTensors on the mesh with the placements param_shardings gives")
    for k in ("embed", "layers.0.attn.w_uq", "layers.0.mlp.w_out"):
        print(f"    {k}: spec {tuple(specs.params[k])} -> placements "
              f"{want.params[k].placements}", flush=True)
    times = [ms for ms, _ in steps[1:]]
    step_ms = statistics.median(times)
    tokens = TRAIN_BATCH * TRAIN_SEQ
    mfu = 6 * cfg.param_count() * tokens / (step_ms / 1e3) \
        / BF16_FLOPS_PER_S
    print(f"  train_loop on the mesh ({SHARD_STEPS} steps, init and "
          f"placement included): {loop_s:.3f} s; peak memory {peak:.2f} GB "
          f"(phase 7: {phase7['peak_gb']:.2f}) ({smi})", flush=True)
    print(f"  train step on the mesh: median {step_ms:.3f} ms over "
          f"{len(times)} steps after the first (min {min(times):.3f}, max "
          f"{max(times):.3f}; first {steps[0][0]:.3f}) against phase 7's "
          f"unsharded {phase7['step_ms']:.3f} ms in this run "
          f"({step_ms / phase7['step_ms']:.3f}x) and the "
          f"{phase7['bound_ms']:.3f} ms bound "
          f"({phase7['bound_ms'] / step_ms:.3f} of it); MFU {mfu:.4f}; "
          f"{tokens / step_ms * 1e3:.1f} tokens/s",
          flush=True)

    step_fn = TS.make_train_step(cfg, opt_cfg, mesh)

    def mesh_batch(i):
        batch = D.batch_at(data_cfg, i)
        return S.distribute(batch, S.batch_shardings(batch, mesh))

    batch = mesh_batch(SHARD_STEPS)
    adamw0 = KA._LAUNCHES.value
    with CallCounter(O, "adamw_update_eager") as eager, \
            profile(activities=[ProfilerActivity.CPU,
                                ProfilerActivity.CUDA]) as prof:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        state, _ = step_fn(state, batch)
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
    adamw_launches = int(KA._LAUNCHES.value - adamw0)
    check(adamw_launches == 1 and eager.calls == 0,
          f"the mesh step's optimizer through the AdamW kernel's update on "
          f"the local tensors: {adamw_launches} launches (the norm the "
          f"DTensors' own), the eager loop called {eager.calls} times")
    busy_ms, n_kernels, idle = device_split(prof.events(), wall)
    del prof
    print(f"  one mesh step profiled: wall {wall:.3f} ms (profiler on), "
          f"kernels {busy_ms:.3f} ms over {n_kernels} launches (phase 7: "
          f"{phase7['launches']}), device idle share {idle:.3f} (phase 7: "
          f"{phase7['idle']:.3f})", flush=True)

    # Checkpoint: save from the mesh, restore onto the mesh and onto the
    # unsharded path; the next step under deterministic algorithms.
    # The state's bits stay on the host to hold the restores against.
    root = os.path.join(os.path.dirname(os.path.abspath(__file__)), "build")
    ckdir = tempfile.mkdtemp(dir=root, prefix=".ckpt_")
    try:
        saved = host_leaves(state)
        t1 = time.perf_counter()
        path = C.save(ckdir, SHARD_STEPS + 1, state,
                      metadata={"arch": cfg.name})
        save_s = time.perf_counter() - t1
        size = sum(os.path.getsize(os.path.join(path, f))
                   for f in os.listdir(path))
        print(f"  checkpoint from the mesh: {size / 1e9:.2f} GB, save "
              f"{save_s:.2f} s", flush=True)
        del state
        free_cuda()
        nxt = D.batch_at(data_cfg, SHARD_STEPS + 1)
        results = {}
        torch.use_deterministic_algorithms(True, warn_only=True)
        try:
            with warnings.catch_warnings():
                warnings.simplefilter("ignore")
                for where in ("unsharded", "mesh"):
                    t1 = time.perf_counter()
                    template = LT._template(cfg)
                    if where == "mesh":
                        restored, step, _ = C.restore(
                            ckdir, template,
                            shardings=S.param_shardings(template, mesh))
                        fn, b = step_fn, mesh_batch(SHARD_STEPS + 1)
                    else:
                        restored, step, _ = C.restore(ckdir, template,
                                                      device="cuda")
                        fn, b = TS.make_train_step(cfg, opt_cfg), nxt
                    load_s = time.perf_counter() - t1
                    ok = step == SHARD_STEPS + 1 and same_bits_as(
                        restored, saved)
                    if where == "mesh":
                        ok = ok and all(
                            isinstance(p, DTensor) and p.placements
                            == want.params[k].placements
                            for k, p in restored.params.named_parameters())
                    check(ok, f"restored {where} ({load_s:.2f} s): every "
                          f"leaf bit for bit as the state saved"
                          + (", placed by param_shardings"
                             if where == "mesh" else ""))
                    restored, m = fn(restored, b)
                    results[where] = float(m["loss"])
                    if where == "mesh":
                        params = restored.params
                    del restored, m, template
                    free_cuda()
        finally:
            torch.use_deterministic_algorithms(False)
        check(results["mesh"] == results["unsharded"],
              f"the step after the restore: loss on the mesh "
              f"{results['mesh']!r} equals the unsharded path's "
              f"{results['unsharded']!r}")
    finally:
        shutil.rmtree(ckdir, ignore_errors=True)
    del saved
    return {"step_ms": step_ms, "mfu": mfu, "peak_gb": peak,
            "launches": n_kernels, "idle": idle, "params": params,
            "mesh": mesh, "data_cfg": data_cfg}


def phase_comm(smi, shard):
    """8b: the int8 compressed all-reduce over phase 8's gradient tree
    and the pipeline's schedule, on the card over the world-1 group."""
    import torch.distributed as dist
    from torch.distributed.tensor import DTensor
    from repro_torch.configs import get_config
    from repro_torch.distributed import compression as CP
    from repro_torch.distributed import pipeline as PL
    from repro_torch.distributed import sharding as S
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.train import data as D
    from repro_torch.train import train_step as TS
    cfg = get_config(TRAIN_ARCH)
    mesh, params = shard["mesh"], shard["params"]
    print(f"== phase 8b: compressed gradient all-reduce and pipeline on the "
          f"card, world size 1 ({smi})", flush=True)
    batch = D.batch_at(shard["data_cfg"], SHARD_STEPS + 2)
    batch = S.distribute(batch, S.batch_shardings(batch, mesh))
    named = dict(params.named_parameters())
    with TS.on_mesh(mesh):
        total, _ = TS.make_loss_fn(cfg, mesh)(params, batch)
        grads = torch.autograd.grad(total, list(named.values()))
    del total
    # each rank's own gradients, as inside the reference's shard_map
    grads = {k: g.to_local() if isinstance(g, DTensor) else g
             for k, g in zip(named, grads)}
    del named, params, shard["params"]
    free_cuda()
    group = mesh["data"]
    n_bytes = lm_bytes(grads.values())

    def compressed():
        return CP.compressed_psum_grads(grads, group,
                                        CP.zero_residuals(grads))

    def plain():
        for g in grads.values():
            dist.all_reduce(g.clone(), group=group.get_group())

    mean, res = compressed()
    exact = True
    for k, g in grads.items():
        x = g.float()
        deq = CP.dequantize_int8(*CP.quantize_int8(x))
        exact = exact and torch.equal(deq + res[k], x) \
            and mean[k].dtype == g.dtype
        del x, deq
    check(exact, f"compressed_psum_grads over {len(grads)} leaves "
          f"({n_bytes / 1e9:.2f} GB of {cfg.dtype} gradients): dequantized "
          f"+ residual = input exactly, means in the gradients' dtype")
    del mean, res
    free_cuda()
    ms = {"plain": [], "compressed": []}
    for name in ("plain", "compressed", "compressed", "plain"):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        out = {"plain": plain, "compressed": compressed}[name]()
        end.record()
        end.synchronize()
        ms[name].append(start.elapsed_time(end))
        del out
        free_cuda()
    print(f"  over the tree, in turns (plain, compressed, compressed, "
          f"plain): all_reduce of each leaf {ms['plain'][0]:.3f} / "
          f"{ms['plain'][1]:.3f} ms, compressed_psum_grads (int8 + error "
          f"feedback) {ms['compressed'][0]:.3f} / {ms['compressed'][1]:.3f}"
          f" ms (world size 1: no bytes cross a link)", flush=True)
    del grads
    free_cuda()

    pmesh = make_mesh((1, 1), ("pod", "data"), "cuda")
    gen = torch.Generator(device="cuda")
    gen.manual_seed(SEED)
    d = cfg.d_model
    w = torch.randn((PIPE_LAYERS, d, d), generator=gen, device="cuda") \
        / d ** 0.5
    bvec = torch.randn((PIPE_LAYERS, d), generator=gen, device="cuda") * 0.1
    x = torch.randn((PIPE_BATCH, PIPE_SEQ, d), generator=gen, device="cuda")

    def layer(lp, h):
        wi, bi = lp
        return torch.tanh(h @ wi + bi)

    torch.cuda.synchronize()
    t1 = time.perf_counter()
    out = PL.pipeline_apply(layer, (w, bvec), x, mesh=pmesh,
                            num_micro=PIPE_MICRO)
    torch.cuda.synchronize()
    pipe_ms = (time.perf_counter() - t1) * 1e3
    ref = x
    for i in range(PIPE_LAYERS):
        ref = layer((w[i], bvec[i]), ref)
    err = float((out - ref).abs().max())
    check(bool(torch.isfinite(out).all()) and err <= PIPE_GATE,
          f"pipeline_apply, one stage, {PIPE_LAYERS} layers at d {d}, batch "
          f"{PIPE_BATCH} x {PIPE_SEQ}, {PIPE_MICRO} microbatches "
          f"(bubble {PL.bubble_fraction(1, PIPE_MICRO):.3f}): max|d| "
          f"{err:.3g} against the sequential loop (gate {PIPE_GATE}); "
          f"{pipe_ms:.3f} ms")
    return {"plain_ms": ms["plain"], "compressed_ms": ms["compressed"]}


# Phase 9: the dry-run (launch/dryrun.py) on fake process groups of 256
# and 512 ranks at the four configs' published widths: each cell in a
# process of its own (a fake group cannot share a process with phase 8's
# NCCL one), DRYRUN_PROCS at once on the host's cores. The fake tensors
# hold no memory and the card runs nothing; the cells hold the port's
# multi-rank DTensor programs on the card's own torch.
DRYRUN_SHAPES = ("train_4k", "prefill_32k", "decode_32k", "long_500k")
DRYRUN_MULTI_POD = (("yi-9b", "decode_32k"),)
DRYRUN_PROCS = 8
# Each train_4k cell's temp per device (GB) on 16 x 16 while the
# cross-entropy's backward held the logits' gradient at its global
# (B, S, V) shape on every device (this phase's output on an H100 80GB
# HBM3, torch 2.11.0+cu128), and the most yi-9b's may take now that the
# loss runs on each rank's shard (its local gradient, 16 x 4,096 x 4,000
# float32, is 1.05 GB).
DRYRUN_TEMP_BEFORE_GB = {"yi-9b": 305.854, "starcoder2-7b": 235.159,
                         "minicpm3-4b": 367.930,
                         "moonshot-v1-16b-a3b": 776.971}
DRYRUN_TEMP_MAX_GB = {"yi-9b": 60.0}
DRYRUN_TIMEOUT_S = 600
DRYRUN_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                          "build", "dryrun")


def run_procs(cmds, env, procs, timeout, log_dir):
    """Run each argument list in ``cmds`` as a process, ``procs`` at once;
    {index: (exit code, wall s)}. Each one's output goes to a log under
    ``log_dir``; a process past ``timeout`` is killed (code None)."""
    pending, running, done = list(enumerate(cmds)), {}, {}
    while pending or running:
        while pending and len(running) < procs:
            i, cmd = pending.pop(0)
            log = open(os.path.join(log_dir, f"cell_{i}.log"), "w")
            running[i] = (subprocess.Popen(cmd, env=env, stdout=log,
                                           stderr=subprocess.STDOUT),
                          time.perf_counter(), log)
        for i, (proc, t0, log) in list(running.items()):
            wall = time.perf_counter() - t0
            if proc.poll() is None and wall < timeout:
                continue
            if proc.poll() is None:
                proc.kill()
                proc.wait()
            log.close()
            done[i] = (proc.returncode if wall < timeout else None, wall)
            del running[i]
        time.sleep(0.5)
    return done


def start_dryrun():
    """Start phase 9's cells in the background: each a ``python -m
    repro_torch.launch.dryrun`` process, DRYRUN_PROCS at once, run by
    ``run_procs`` on a thread. Returns (cells, future of (done, wall s));
    ``phase_dryrun`` waits for it. The processes work on the host's cores
    only (fake groups and tensors), so they run beside phase 7b, whose
    checks time nothing."""
    import shutil
    from concurrent.futures import ThreadPoolExecutor
    cells = [(a, sh, False) for a in LM_ARCHS for sh in DRYRUN_SHAPES] + \
        [(a, sh, True) for a, sh in DRYRUN_MULTI_POD]
    shutil.rmtree(DRYRUN_DIR, ignore_errors=True)
    os.makedirs(DRYRUN_DIR)
    root = os.path.dirname(os.path.abspath(__file__))
    env = dict(os.environ, PYTHONPATH=os.path.join(root, "src"))
    cmds = [[sys.executable, "-m", "repro_torch.launch.dryrun", "--arch", a,
             "--shape", sh] + (["--multi-pod"] if mp else [])
            for a, sh, mp in cells]

    def run():
        t0 = time.perf_counter()
        done = run_procs(cmds, env, DRYRUN_PROCS, DRYRUN_TIMEOUT_S,
                         DRYRUN_DIR)
        return done, time.perf_counter() - t0

    pool = ThreadPoolExecutor(1)
    future = pool.submit(run)
    pool.shutdown(wait=False)
    return cells, future


def phase_dryrun(smi, started):
    from repro_torch.configs import get_config
    from repro_torch.launch import roofline as RL
    cells, future = started
    print(f"== phase 9: dry-run on fake process groups, the four configs at "
          f"their published widths: {len(cells)} cells, {DRYRUN_PROCS} "
          f"processes at once, started with phase 7b ({smi}); torch "
          f"{torch.__version__}", flush=True)
    t0 = time.perf_counter()
    done, wall_s = future.result()
    print(f"  all cells: {wall_s:.1f} s wall ({time.perf_counter() - t0:.1f}"
          f" s of it waited for here)", flush=True)
    for i, (arch, shape, mp) in enumerate(cells):
        mesh = "pod2x16x16" if mp else "pod16x16"
        rc, wall = done[i]
        path = os.path.join(DRYRUN_DIR,
                            f"torch_dryrun_{arch}_{shape}_{mesh}.json")
        art = json.load(open(path)) if os.path.exists(path) else {}
        status = art.get("status", "missing")
        if shape == "long_500k":
            family = get_config(arch).family
            want = (f"long_500k requires sub-quadratic attention ({family} "
                    f"is full-attention)")
            check(rc == 0 and status == "skipped" and art["reason"] == want,
                  f"{arch} {shape} {mesh}: skipped with the reference's "
                  f"reason ({art.get('reason')!r})")
            continue
        if status != "ok":
            with open(os.path.join(DRYRUN_DIR, f"cell_{i}.log")) as f:
                print(f.read()[-3000:], flush=True)
        check(rc == 0 and status == "ok",
              f"{arch} {shape} {mesh}: {status} (exit {rc}, {wall:.1f} s "
              f"wall) {art.get('error', '')}")
        chips = 512 if mp else 256
        roof = RL.analyze(art, chips)
        mem = art["memory"]
        coll = ", ".join(f"{k} {v:.4e} B ({art['collective_counts'][k]})"
                         for k, v in art["collective_bytes"].items() if v)
        print(f"    build {art['build_s']} s, run {art['run_s']} s; per "
              f"device: {art['flops']:.6e} FLOPs, {art['bytes_accessed']:.6e}"
              f" bytes; collectives {coll or 'none'}; memory: arguments "
              f"{mem['argument_size_in_bytes'] / 1e9:.3f} GB, temp "
              f"{mem['temp_size_in_bytes'] / 1e9:.3f} GB, outputs "
              f"{mem['output_size_in_bytes'] / 1e9:.3f} GB, aliased "
              f"{mem['alias_size_in_bytes'] / 1e9:.3f} GB", flush=True)
        if shape == "train_4k" and not mp:
            temp, before = (mem["temp_size_in_bytes"] / 1e9,
                            DRYRUN_TEMP_BEFORE_GB[arch])
            most = DRYRUN_TEMP_MAX_GB.get(arch, before)
            check(temp < most, f"{arch} train_4k temp {temp:.3f} GB per "
                  f"device, {before:.3f} GB with the loss's gradient at its "
                  f"global shape ({temp / before:.4f} of it; must be below "
                  f"{most:.3f} GB)")
        print(f"    roofline (H100 SXM: {RL.PEAK_FLOPS / 1e12:.1f} TFLOP/s, "
              f"{RL.HBM_BW / 1e12:.2f} TB/s, link {RL.LINK_BW / 1e9:.0f} "
              f"GB/s): compute {roof.compute_s:.6f} s, memory "
              f"{roof.memory_s:.6f} s (floor {roof.memory_floor_s:.6f} s), "
              f"collective {roof.collective_s:.6f} s; bound by "
              f"{roof.bottleneck}; model FLOPs {roof.model_flops:.6e}, useful"
              f" {roof.useful_ratio:.4f}", flush=True)


# Phase 9b: phase 7's own cell (minicpm3-4b, bf16, remat "full", batch
# TRAIN_BATCH x TRAIN_SEQ) counted by the dry-run on a (1, 1) fake mesh:
# its FLOPs must equal phase 7's FlopCounterMode count of a real step, and
# its predicted peak memory (arguments + temp) fall within DRYRUN_MEM_BAND
# of phase 7's measured peak.
DRYRUN_MEM_BAND = (0.9, 1.1)
COUNT_PHASE7 = """
import json, sys
from repro_torch.configs import get_config
from repro_torch.configs.base import ShapeSpec
from repro_torch.launch import dryrun as D
from repro_torch.launch.mesh import make_mesh
D.fake_group(1)
mesh = make_mesh((1, 1), ("data", "model"), "cuda")
shape = ShapeSpec("phase7", int(sys.argv[2]), int(sys.argv[3]), "train")
print(json.dumps(D.count_cell(get_config(sys.argv[1]), shape, mesh)))
"""


def phase_dryrun_phase7(smi, train):
    from repro_torch.configs import get_config
    from repro_torch.configs.base import ShapeSpec
    from repro_torch.launch import roofline as RL
    print(f"== phase 9b: phase 7's cell counted on a (1, 1) fake mesh "
          f"({smi})", flush=True)
    root = os.path.dirname(os.path.abspath(__file__))
    env = dict(os.environ, PYTHONPATH=os.path.join(root, "src"))
    t0 = time.perf_counter()
    out = subprocess.run([sys.executable, "-c", COUNT_PHASE7, TRAIN_ARCH,
                          str(TRAIN_SEQ), str(TRAIN_BATCH)], env=env,
                         capture_output=True, text=True,
                         timeout=DRYRUN_TIMEOUT_S)
    if out.returncode != 0:
        print(out.stderr[-3000:], flush=True)
    check(out.returncode == 0, f"count_cell of {TRAIN_ARCH} at batch "
          f"{TRAIN_BATCH} x {TRAIN_SEQ} on a (1, 1) fake mesh "
          f"({time.perf_counter() - t0:.1f} s)")
    r = json.loads(out.stdout.splitlines()[-1])
    check(r["flops"] == train["flops_counted"],
          f"per-device FLOPs {int(r['flops'])} equal phase 7's "
          f"FlopCounterMode count of a real step {train['flops_counted']} "
          f"exactly; {r['flops'] / train['bound_flops']:.4f} of "
          f"train_step_bound's analytic {train['bound_flops'] / 1e12:.2f} "
          f"TFLOP")
    mem = r["memory"]
    predicted = (mem["argument_size_in_bytes"] + mem["temp_size_in_bytes"]) \
        / 1e9
    ratio = predicted / train["peak_gb"]
    check(DRYRUN_MEM_BAND[0] <= ratio <= DRYRUN_MEM_BAND[1],
          f"predicted peak memory {predicted:.2f} GB (arguments "
          f"{mem['argument_size_in_bytes'] / 1e9:.2f} + temp "
          f"{mem['temp_size_in_bytes'] / 1e9:.2f}) against phase 7's "
          f"measured {train['peak_gb']:.2f} GB: {ratio:.4f} (band "
          f"{DRYRUN_MEM_BAND})")
    cfg = get_config(TRAIN_ARCH)
    shape = ShapeSpec("phase7", TRAIN_SEQ, TRAIN_BATCH, "train")
    roof = RL.analyze(dict(r, arch=TRAIN_ARCH, shape="phase7"), 1, cfg=cfg,
                      shape=shape)
    bound_s = max(roof.compute_s, roof.memory_floor_s, roof.collective_s)
    print(f"  roofline of the cell (one H100): compute {roof.compute_s:.6f} "
          f"s, memory {roof.memory_s:.6f} s (floor {roof.memory_floor_s:.6f}"
          f" s), bound {bound_s * 1e3:.3f} ms by {roof.bottleneck}; phase "
          f"7's median step {train['step_ms']:.3f} ms: "
          f"{bound_s * 1e3 / train['step_ms']:.4f} of it; build "
          f"{r['build_s']} s, run {r['run_s']} s", flush=True)
    return {"flops": r["flops"], "predicted_gb": predicted, "ratio": ratio}


def main(argv):
    if not torch.cuda.is_available():
        print("chip_smoke.py needs a CUDA GPU (torch.cuda.is_available() is "
              "False)", file=sys.stderr)
        return 1
    if argv == ["--only", "7a"]:
        smi, reports = phase_device()
        flash = phase_flash_kernel(smi, reports["flash_attention"])
        print(json.dumps({"kernels": [flash]}))
        return 0
    if argv == ["--only", "7c"]:
        smi, reports = phase_device()
        print(json.dumps({"kernels": [phase_adamw_kernel(
            smi, reports["adamw"])]}))
        return 0
    if argv:
        print("usage: chip_smoke.py [--only 7a | --only 7c]",
              file=sys.stderr)
        return 2
    from repro_torch.core.camera import make_camera
    from repro_torch.core.pipeline import RenderConfig
    from repro_torch.scenes.synthetic import structured_scene
    from repro_torch.scenes.trajectory import dolly_trajectory

    smi, reports = phase_device()
    poses = dolly_trajectory(N_FRAMES, start=(0.0, -0.3, -2.0),
                             target=(0.0, 0.0, 6.0))
    cam = make_camera(poses[0], width=WIDTH, height=HEIGHT)
    scene = structured_scene(SEED, N_GAUSSIANS, sh_degree=3)
    cfg = RenderConfig(capacity=1024, chunk=64, window=5,
                       intersect_method="tait", use_dpes=True, ldu_blocks=32)
    flush = torch.empty(64 << 20, dtype=torch.uint8, device="cuda")

    key_bins = key_frame_bins(scene, cam, cfg)
    kernels = [phase_raster_kernel(key_bins[3], flush,
                                   reports["raster_plan"]),
               phase_preprocess_kernel(scene, cam, flush,
                                       reports["preprocess"]),
               phase_tile_raster_kernel(key_bins[3], flush),
               phase_tile_sort_kernel(key_bins[3], flush),
               phase_ldu_kernel(key_bins, warped_fill_input(
                   scene, cam, poses, cfg), flush, reports["ldu_fill"]),
               phase_intersect_kernel(flush, reports["intersect_bin"])]
    launches, base = phase_slice(scene, cam, poses, cfg)
    phase_cull(scene, cam, poses, cfg, base)
    phase_ablation(scene, cam, poses, cfg, base)
    phase_profile(scene, cam, poses, cfg)
    del key_bins, base
    serve_launches = phase_serve(cam, cfg)
    phase_split(cam, cfg)
    # Each kernel's launches on its own main path: the trajectory for the
    # fused kernel and preprocess, the serve loop for the tile raster
    # kernel. The tile sorter's count is read after both runs; no render
    # path sorts with it, as in the reference.
    launches["raster_tile"] = serve_launches["raster_tile"]
    launches["tile_sort"] += serve_launches["tile_sort"]
    print(f"tile_sort launches on the main paths: trajectory + serve = "
          f"{launches['tile_sort']}; ldu_fill launches: trajectory "
          f"{launches['ldu_fill']}, serve {serve_launches['ldu_fill']}",
          flush=True)
    for k in kernels:
        k["launches"] = launches[k["name"]]

    del scene, cam, flush, poses
    free_cuda()
    lm = phase_lm_full(smi)
    phase_lm_checks()
    families = phase_lm_families(smi)
    print(f"phase 6 summary: yi-9b bf16 serve {lm['tok_per_s']:.1f} tok/s, "
          f"decode step {lm['step_ms']:.3f} ms against a "
          f"{lm['bound_ms']:.3f} ms bound, peak memory {lm['peak_gb']:.2f} "
          f"GB ({smi})", flush=True)
    print("phase 6c summary (bf16, full width and depth, batch "
          f"{FAMILY_BATCH}): " + "; ".join(
              f"{n} prompt {r['prompt_ms']:.1f} ms, decode step "
              f"{r['step_ms']:.3f} ms vs {r['bound_ms']:.3f} ms bound, "
              f"{r['launches']} launches, peak {r['peak_gb']:.2f} GB"
              for n, r in families.items()) + f" ({smi})", flush=True)
    train = phase_train_full(smi)
    kernels.append(phase_flash_kernel(smi, reports["flash_attention"]))
    kernels[-1]["launches"] = train["flash_launches"]
    kernels.append(phase_adamw_kernel(smi, reports["adamw"]))
    kernels[-1]["launches"] = train["adamw_launches"]
    dryrun = start_dryrun()
    phase_train_checks(smi)
    phase_dryrun(smi, dryrun)
    print(f"phase 7 summary: {TRAIN_ARCH} bf16 train step "
          f"{train['step_ms']:.3f} ms against a {train['bound_ms']:.3f} ms "
          f"bound, MFU {train['mfu']:.4f}, {train['tok_per_s']:.1f} "
          f"tokens/s, peak memory {train['peak_gb']:.2f} GB, "
          f"{train['launches']} launches a step, idle share "
          f"{train['idle']:.3f} ({smi})", flush=True)
    import shutil
    import torch.distributed as dist
    store = start_nccl(os.path.join(
        os.path.dirname(os.path.abspath(__file__)), "build"))
    try:
        shard = phase_train_mesh(smi, train)
        comm = phase_comm(smi, shard)
        print(f"phase 8 summary: {TRAIN_ARCH} bf16 train step on a (1, 1) "
              f"DTensor mesh (NCCL, world size 1) {shard['step_ms']:.3f} ms "
              f"against phase 7's {train['step_ms']:.3f} ms unsharded and "
              f"the {train['bound_ms']:.3f} ms bound, MFU "
              f"{shard['mfu']:.4f}, peak memory {shard['peak_gb']:.2f} GB, "
              f"{shard['launches']} launches a step, idle share "
              f"{shard['idle']:.3f}; 8b: all_reduce of the gradient tree "
              f"{min(comm['plain_ms']):.3f} ms, compressed "
              f"{min(comm['compressed_ms']):.3f} ms ({smi})", flush=True)
        del shard
    finally:
        dist.destroy_process_group()
        shutil.rmtree(store, ignore_errors=True)

    phase_dryrun_phase7(smi, train)

    print(smi)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
