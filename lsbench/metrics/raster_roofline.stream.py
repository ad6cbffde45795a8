"""The fused sort + blend kernel's (``csrc/raster_plan.cu``) share of its
bound, in %: the least time the card could take for the blend work the
reference counts on the traced slice's frames (the larger of float32
operations over 67 TFLOP/s and bytes over 3.35 TB/s), over the kernel's
device time on those frames."""

KERNEL = "raster_plan_kernel"


def read(obs):
    if obs.get("kind") != "stream" or "work" not in obs:
        return None
    sec = sum(s for name, s in obs["slice"].op_s.items() if KERNEL in name)
    return obs["work"]["blend_s"] / sec * 100.0 if sec > 0 else None
