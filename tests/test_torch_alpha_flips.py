"""Port parity: alpha-threshold flips between the port's renderer and the
reference's, bounded (``_torch_parity.assert_alpha_flips``) with the
1e-4 image gate as it is.

The scene is one from the port's generators that flips:
``_torch_placement_inputs.SCENES["multi2"]`` (seed 52, 300 Gaussians,
clutter 0.4 + 0.1 x 2) through the port's ``structured_scene``, not the
reference's, at 48 x 48, at the eight placement streams' four dolly
poses, every pose rendered as a key frame by both packages
(``jnp_chunked`` and ``torch_chunked``, the placement streams' config).
There a Gaussian's alpha at a pixel lands a few ulps from 1/255, above
it in the port and below it in the reference, so only the port blends
it.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import _torch_parity as P
import _torch_placement_inputs as I
from repro.core import pipeline as jpipe
from repro.core import projection as jproj
from repro.core.camera import look_at, make_camera
from repro.core.gaussians import GaussianScene
from repro_torch.core import pipeline as tpipe
from repro_torch.core import projection as tproj
from repro_torch.scenes.synthetic import structured_scene
from repro_torch.scenes.trajectory import dolly_trajectory

SEED, N, CLUTTER = I.SCENES["multi2"]


def test_port_scene_flips_stay_within_their_bound():
    torch_scene = structured_scene(SEED, N, clutter=CLUTTER, device=P.CPU)
    jscene = GaussianScene(*(jnp.asarray(x.numpy()) for x in torch_scene))
    jcam = make_camera(look_at(*I.CAM_LOOK), width=I.SIZE, height=I.SIZE)
    tcam = P.camera(jcam)
    poses = torch.stack([dolly_trajectory(
        I.F, start=(0.03 * i, -0.3, -2.0), target=(0.0, 0.0, 6.0),
        device=P.CPU) for i in range(I.B)]).reshape(-1, 4, 4)
    jcfg = jpipe.RenderConfig(impl="jnp_chunked", **I.STREAM_CFG)
    tcfg = tpipe.RenderConfig(impl="torch_chunked", **I.STREAM_CFG)
    jrender = jax.jit(lambda w2c: jpipe.render_full_frame(
        jscene, jcam.with_pose(w2c), jcfg)[0][:2])
    got, want = [], []
    for pose in poses:
        out = tpipe.render_full_frame(torch_scene, tcam.with_pose(pose),
                                      tcfg)[0]
        got.append((out.rgb, out.transmittance))
        want.append(jrender(jnp.asarray(pose.numpy())))

    def alphas(idx):
        f, y, x = idx
        w2c = poses[f]
        return (P.alphas_at(tproj.preprocess(torch_scene,
                                             tcam.with_pose(w2c)), x, y),
                P.alphas_at(jproj.preprocess(
                    jscene, jcam.with_pose(jnp.asarray(w2c.numpy()))), x, y))

    stack = [np.stack([P.np_(v[i]) for v in vs])
             for vs in (got, want) for i in (0, 1)]
    n_off = P.assert_alpha_flips(stack[:2], stack[2:], alphas)
    print(f"{n_off} pixels past the gate, each an alpha-threshold flip")
    assert n_off >= 1, "the scene's known flips no longer show"


def _frame(h=100, w=100):
    rgb = np.full((h, w, 3), 0.5, np.float32)
    return rgb, np.full((h, w), 0.2, np.float32)


def test_the_bound_refuses_what_is_not_an_alpha_flip():
    """A pixel past the gate with no alpha near 1/255, a flip past its
    bound, and more than 1e-4 of the pixels are each refused."""
    near = np.array([0.5, P.ALPHA_MIN + 2 * np.spacing(P.ALPHA_MIN)],
                    np.float32)
    far = np.array([0.5, 0.01], np.float32)
    want = _frame()
    got = _frame()
    got[0][3, 4] += 2e-3
    got[1][3, 4] -= 7e-4
    assert P.assert_alpha_flips(got, want, lambda i: (far, near)) == 1
    with pytest.raises(AssertionError, match="no Gaussian"):
        P.assert_alpha_flips(got, want, lambda i: (far, far))
    over = _frame()
    over[0][3, 4] += 9e-3
    with pytest.raises(AssertionError, match="drgb"):
        P.assert_alpha_flips(over, want, lambda i: (near, near))
    many = tuple(np.stack([a, a]) for a in _frame())
    many[0][:, 3, 4:6] += 2e-3
    with pytest.raises(AssertionError, match="1e-4 of"):
        P.assert_alpha_flips(many, tuple(np.stack([a, a]) for a in want),
                             lambda i: (near, near))
