"""Peaks of one NVIDIA H100 SXM and the work a frame's kernels need.

Compute and HBM from NVIDIA's data sheet (dense rates, at its 700 W
power limit); a card set below 700 W runs slower under load, so a run
reports the card's power limit beside its shares. The operation counts
are the program's own accounting of the blend and the preprocess
(``chip_smoke.py``), kept here so that a change to the program cannot
move them.
"""
FP32_FLOPS_PER_S = 67e12       # float32 outside the tensor cores
HBM_BYTES_PER_S = 3.35e12      # HBM3

# Floating-point operations the blend needs per (pixel, real lane) reached
# while the pixel is not yet done: offsets 2, power 9, exp 1, alpha 3,
# stop test 1.
EVAL_FLOPS = 16
# ... and, on top, per (pixel, lane) with a nonzero weight: transmittance
# 5, weight 1, colour 6, depth 2, weight sum 1, truncated depth 1, min 1.
BLEND_FLOPS = 17
# Per Gaussian in the preprocess kernel (transform 18, quaternion and
# scales 40, covariances 50, Jacobian and 2D covariance 50, conic, eigen
# and radii 40).
PREPROCESS_FLOPS = 200


def blend_bytes(pairs: int, tiles: int, lanes: int) -> int:
    """Each binned pair's 10 floats read once; per tile its origin,
    count and flag, 256 pixels of 6 outputs, and ``lanes`` contributions
    written."""
    return 4 * (pairs * 10 + tiles * (4 + 1 + 256 * 6 + lanes))


def preprocess_bytes(n: int) -> int:
    """44 bytes read and 73 written per Gaussian, and the pose."""
    return n * (44 + 73) + 64


def bound_s(flops: float, nbytes: float) -> float:
    """The least time the card could take: the larger of the two."""
    return max(flops / FP32_FLOPS_PER_S, nbytes / HBM_BYTES_PER_S)
