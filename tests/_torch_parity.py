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
