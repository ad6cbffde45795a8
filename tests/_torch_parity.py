"""Helpers for the port's parity tests: hand the reference's (JAX) values
to ``repro_torch`` through numpy and compare the results.

Scenes come from the reference's generators (``jax.random``), so both
sides see the same numbers; everything on the port side runs on the CPU.
"""
import numpy as np
import torch

from repro_torch import interop
from repro_torch.core.projection import ProjectedGaussians

CPU = "cpu"

# The blend's alpha cut (``kernels/ref.py`` ``ALPHA_MIN``), and how near
# it an alpha must lie to explain a pixel past the image gate: ALPHA_ULPS
# float32 ulps of 1/255 (2^-31 each). The known flips lie -4 to +8 ulps
# from it in one version or the other.
ALPHA_MIN = np.float32(1.0 / 255.0)
ALPHA_ULPS = 16
IMAGE_GATE = 1e-4


def scene(jscene):
    return interop.scene_from_numpy(*(np.asarray(x) for x in jscene),
                                    device=CPU)


def camera(jcam):
    return interop.camera_from_numpy(np.asarray(jcam.w2c), jcam.fx, jcam.fy,
                                     jcam.cx, jcam.cy, jcam.width,
                                     jcam.height, device=CPU)


def tensor(x, dtype=None):
    t = torch.tensor(np.asarray(x))
    return t if dtype is None else t.to(dtype)


def projected(jproj):
    """The reference's ProjectedGaussians as the port's (CPU tensors)."""
    return ProjectedGaussians(*(tensor(x) for x in jproj))


def frame_state(jstate):
    return interop.frame_state_from_numpy(
        *(np.asarray(x) for x in jstate[:5]),
        contrib=None if jstate.contrib is None else np.asarray(
            jstate.contrib), device=CPU)


def np_(x):
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) \
        else np.asarray(x)


def assert_close(got, want, *, atol=0.0, rtol=0.0, err_msg=""):
    np.testing.assert_allclose(np_(got), np_(want), atol=atol, rtol=rtol,
                               err_msg=err_msg)


def assert_equal(got, want, err_msg=""):
    np.testing.assert_array_equal(np_(got), np_(want), err_msg=err_msg)


def assert_records(got, want):
    """FrameRecord (or stacked FrameRecord) fields: exact, except the
    per-lane contributions (rtol 1e-4, sums over 256 pixels in another
    order); None fields must be None on both sides."""
    assert got._fields == want._fields
    for name in want._fields:
        w = getattr(want, name)
        g = getattr(got, name)
        if w is None:
            assert g is None, name
            continue
        if name == "lane_contrib":
            assert_close(g, w, rtol=1e-4, atol=1e-6, err_msg=name)
            continue
        assert tuple(g.shape) == tuple(np.asarray(w).shape), name
        assert_equal(g, w, err_msg=name)


def alphas_at(proj, x, y):
    """Each Gaussian's alpha at the centre of pixel (x, y) from ``proj``
    (either package's ``ProjectedGaussians``), as the blend computes it
    before its 1/255 cut, in float32."""
    m, c, o = (np_(v).astype(np.float32)
               for v in (proj.mean2d, proj.conic, proj.opacity))
    dx = np.float32(x + 0.5) - m[:, 0]
    dy = np.float32(y + 0.5) - m[:, 1]
    power = -0.5 * (c[:, 0] * dx * dx + c[:, 2] * dy * dy) \
        - c[:, 1] * dx * dy
    return np.minimum(o * np.exp(power), np.float32(0.99))


def assert_alpha_flips(got, want, alphas, gate=IMAGE_GATE):
    """Pixels past the image ``gate`` must be alpha-threshold flips,
    within their bound; returns how many pixels are past it.

    ``got`` and ``want`` are each version's (rgb (..., H, W, 3),
    transmittance (..., H, W)); ``alphas(index)`` gives, for a pixel's
    index into the transmittance, each version's (N,) alphas there
    (``alphas_at``).

    Where a Gaussian's alpha at a pixel lands within rounding of 1/255,
    one version blends it and the other does not. So each pixel past the
    gate must hold a Gaussian whose alpha lies within ALPHA_ULPS of 1/255
    in either version. One Gaussian of alpha a entering the blend at
    transmittance T_b <= 1 takes the weight a T_b and scales the rest of
    the blend (weights summing to at most T_b, colours in [0, 2)) by
    1 - a: T moves by a T_without <= a, and rgb by at most 2 a T_b <=
    2 a, with a at most 1/255 + ALPHA_ULPS ulps. The flips may touch at
    most 1e-4 of the pixels.
    """
    rgb_g, t_g = (np_(x) for x in got)
    rgb_w, t_w = (np_(x) for x in want)
    d_rgb = np.abs(rgb_g - rgb_w).max(axis=-1)
    d_t = np.abs(t_g - t_w)
    off = (d_rgb > gate) | (d_t > gate)
    n_off = int(off.sum())
    assert n_off <= off.size // 10_000, \
        f"{n_off} pixels past {gate} > 1e-4 of {off.size}"
    window = ALPHA_ULPS * np.spacing(ALPHA_MIN)
    a_hi = float(ALPHA_MIN + window)
    for idx in map(tuple, np.argwhere(off)):
        near = [np.abs(a - ALPHA_MIN) <= window for a in alphas(idx)]
        assert any(n.any() for n in near), \
            f"pixel {idx}: no Gaussian's alpha within {ALPHA_ULPS} ulps of " \
            f"1/255 (|drgb| {d_rgb[idx]:.3g}, |dT| {d_t[idx]:.3g})"
        assert d_t[idx] <= a_hi and d_rgb[idx] <= 2 * a_hi, \
            f"pixel {idx}: |dT| {d_t[idx]:.3g} > {a_hi:.4g} or |drgb| " \
            f"{d_rgb[idx]:.3g} > {2 * a_hi:.4g}"
    return n_off
