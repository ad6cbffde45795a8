"""Port parity: camera, Gaussians, SH, projection and the preprocess
kernel's plain version against the JAX reference (CPU)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import _torch_parity as P
from repro.core import camera as jcamera
from repro.core import gaussians as jgauss
from repro.core import metrics as jmetrics
from repro.core import projection as jproj
from repro.kernels import ops as jops
from repro.scenes import trajectory as jtraj
from repro_torch.core import camera as tcamera
from repro_torch.core import gaussians as tgauss
from repro_torch.core import metrics as tmetrics
from repro_torch.core import projection as tproj
from repro_torch.kernels import ops as tops
from repro_torch.kernels import preprocess as tpre
from repro_torch.obs.metrics import kernel_launches
from repro_torch.scenes import synthetic as tsyn
from repro_torch.scenes import trajectory as ttraj

# Float fields of ProjectedGaussians: same float32 math in another order.
RTOL = ATOL = 1e-5


@pytest.mark.parametrize("eye,target", [
    ((0.0, -0.3, -2.0), (0.0, 0.0, 6.0)),
    ((0.5, -0.5, -3.0), (0.0, 0.0, 6.0)),
    ((2.0, 1.0, 0.0), (-1.0, 0.5, 7.0)),
])
def test_look_at_and_camera(eye, target):
    jw = jcamera.look_at(eye, target)
    tw = tcamera.look_at(eye, target, device="cpu")
    P.assert_close(tw, jw, atol=1e-6)
    jc = jcamera.make_camera(jw, width=128, height=96, fov_deg=50.0)
    tc = tcamera.make_camera(tw, width=128, height=96, fov_deg=50.0,
                             device="cpu")
    assert (tc.fx, tc.fy, tc.cx, tc.cy) == (jc.fx, jc.fy, jc.cx, jc.cy)
    assert (tc.tiles_x, tc.tiles_y, tc.num_tiles) == \
        (jc.tiles_x, jc.tiles_y, jc.num_tiles)
    P.assert_close(tcamera.camera_position(tc),
                   jcamera.camera_position(jc), atol=1e-5)
    P.assert_close(tcamera.cam_to_world(tc), jcamera.cam_to_world(jc),
                   atol=1e-5)


def test_make_camera_rejects_partial_tiles():
    with pytest.raises(ValueError, match="multiple of 16"):
        tcamera.make_camera(torch.eye(4), width=60, height=64, device="cpu")


def test_backproject_and_project(small_cam):
    tc = P.camera(small_cam)
    rng = np.random.default_rng(0)
    depth = rng.uniform(1.0, 9.0, (small_cam.height, small_cam.width))
    depth = depth.astype(np.float32)
    jpts = jcamera.backproject(small_cam, jnp.asarray(depth))
    tpts = tcamera.backproject(tc, torch.from_numpy(depth))
    P.assert_close(tpts, jpts, atol=1e-5, rtol=1e-5)
    for got, want in zip(tcamera.project(tc, tpts),
                         jcamera.project(small_cam, jpts)):
        P.assert_close(got, want, atol=1e-3, rtol=1e-5)
    u, v = tcamera.pixel_grid(tc)
    ju, jv = jcamera.pixel_grid(small_cam)
    P.assert_equal(u, ju)
    P.assert_equal(v, jv)


def test_covariances_and_rotations(small_scene):
    ts = P.scene(small_scene)
    P.assert_close(tgauss.quat_to_rotmat(ts.quats),
                   jgauss.quat_to_rotmat(small_scene.quats), atol=1e-6)
    P.assert_close(tgauss.covariances(ts), jgauss.covariances(small_scene),
                   atol=1e-6, rtol=1e-5)
    P.assert_close(tgauss.opacities(ts), jgauss.opacities(small_scene),
                   atol=1e-7)
    assert ts.num_gaussians == small_scene.num_gaussians
    assert ts.sh_degree == small_scene.sh_degree


@pytest.mark.parametrize("degree", [0, 1, 2, 3])
def test_eval_sh(degree):
    rng = np.random.default_rng(degree)
    k = (degree + 1) ** 2
    sh = rng.normal(size=(257, k, 3)).astype(np.float32)
    dirs = rng.normal(size=(257, 3)).astype(np.float32)
    dirs /= np.linalg.norm(dirs, axis=-1, keepdims=True)
    got = tgauss.eval_sh(torch.from_numpy(sh), torch.from_numpy(dirs))
    P.assert_close(got, jgauss.eval_sh(jnp.asarray(sh), jnp.asarray(dirs)),
                   atol=1e-5, rtol=1e-5)
    rgb = rng.uniform(size=(5, 3)).astype(np.float32)
    P.assert_close(tgauss.rgb_to_sh_dc(torch.from_numpy(rgb)),
                   jgauss.rgb_to_sh_dc(jnp.asarray(rgb)), atol=1e-6)


def _assert_minor_axis(got, want, cov2d):
    """The eigenvector (b, lam2 - a) / norm cancels in lam2 - a, so its
    error is ~eps * max(|a|, |c|) / |b| however close the inputs are
    (1-ulp cov2d differences suffice): that is the tolerance per row."""
    a, b, c = np.abs(P.np_(cov2d)).T
    tol = ATOL + 8 * np.finfo(np.float32).eps * np.maximum(a, c) \
        / np.maximum(b, 1e-12)
    err = np.abs(P.np_(got) - P.np_(want)).max(axis=1)
    assert np.all(err <= tol), float((err - tol).max())


@pytest.mark.parametrize("which", ["small", "blob_wide"])
def test_preprocess_matches_reference(which, small_scene, small_cam,
                                      blob_scene, wide_cam):
    jscene, jcam = ((small_scene, small_cam) if which == "small"
                    else (blob_scene, wide_cam))
    want = jax.jit(jproj.preprocess)(jscene, jcam)
    got = tproj.preprocess(P.scene(jscene), P.camera(jcam))
    assert got._fields == want._fields
    for name in want._fields:
        g, w = getattr(got, name), getattr(want, name)
        assert g.shape == tuple(w.shape), name
        if name == "valid":
            assert g.dtype == torch.bool
            P.assert_equal(g, w, err_msg=name)
        elif name == "minor_axis":
            _assert_minor_axis(g, w, want.cov2d)
        else:
            assert g.dtype == torch.float32, name
            P.assert_close(g, w, rtol=RTOL, atol=ATOL, err_msg=name)
    assert int(np.asarray(want.valid).sum()) > 100  # the test sees work


def _geom_inputs(jscene, jcam):
    opac = jgauss.opacities(jscene)
    intrin = (jcam.fx, jcam.fy, jcam.cx, jcam.cy, jcam.width, jcam.height)
    return (jscene.means, jscene.log_scales, jscene.quats, opac, jcam.w2c,
            intrin)


def _assert_geom_tuple(got, want, args):
    """(mean2d, conic, depth, aux, minor_axis) of the port vs the JAX side."""
    for g, w in zip(got[:4], want[:4]):
        P.assert_close(g, w, rtol=RTOL, atol=ATOL)
    cov2d = tpre.preprocess_geom_torch(*(P.tensor(a) for a in args[:5]),
                                       args[5]).cov2d
    _assert_minor_axis(got[4], want[4], cov2d)


def test_preprocess_geom_plain_vs_reference_ref(small_scene, small_cam):
    """The kernel's plain version against ``ref.preprocess_geom_ref``."""
    args = _geom_inputs(small_scene, small_cam)
    want = jops.preprocess_geom(*args[:5], np.asarray(args[5]), impl="ref")
    got = tops.preprocess_geom(*(P.tensor(a) for a in args[:5]), args[5],
                               impl="cuda")
    _assert_geom_tuple(got, want, args)
    got_ref = tops.preprocess_geom(*(P.tensor(a) for a in args[:5]),
                                   args[5], impl="ref")
    for g, w in zip(got_ref, got):
        P.assert_equal(g, w)


def test_preprocess_geom_plain_vs_pallas_interpret(blob_scene, wide_cam):
    """The plain version against the Pallas kernel in interpret mode."""
    args = _geom_inputs(blob_scene, wide_cam)
    want = jops.preprocess_geom(*args[:5],
                                jnp.asarray(args[5], jnp.float32),
                                impl="pallas")
    got = tops.preprocess_geom(*(P.tensor(a) for a in args[:5]), args[5])
    _assert_geom_tuple(got, want, args)


def test_preprocess_geom_wrapper_counts_no_cpu_launch(small_scene,
                                                      small_cam):
    """On CPU tensors the wrapper runs the plain version, never a kernel."""
    launches = kernel_launches("preprocess_geom")
    before = launches.value
    tproj.preprocess(P.scene(small_scene), P.camera(small_cam))
    assert launches.value == before


@pytest.mark.parametrize("kind", ["orbit", "dolly"])
def test_trajectories(kind):
    if kind == "orbit":
        want = jtraj.orbit_trajectory(7)
        got = ttraj.orbit_trajectory(7, device="cpu")
    else:
        want = jtraj.dolly_trajectory(7, start=(0.0, -0.3, -2.0),
                                      target=(0.0, 0.0, 6.0))
        got = ttraj.dolly_trajectory(7, start=(0.0, -0.3, -2.0),
                                     target=(0.0, 0.0, 6.0), device="cpu")
    assert got.dtype == torch.float32
    P.assert_close(got, want, atol=2e-6)


@pytest.mark.parametrize("gen", ["structured", "blob"])
def test_synthetic_scenes_statistics(gen):
    """Torch-drawn scenes: the reference's shapes, dtypes and ranges."""
    if gen == "structured":
        s = tsyn.structured_scene(3, 2000, sh_degree=3, device="cpu")
        assert tuple(s.sh.shape) == (2000, 16, 3)
    else:
        s = tsyn.random_blob_scene(3, 2000, device="cpu")
        assert tuple(s.sh.shape) == (2000, 1, 3)
        assert float(s.means[:, 2].min()) >= 3.0 - 1e-5
    assert tuple(s.means.shape) == (2000, 3)
    assert all(x.dtype == torch.float32 for x in s)
    assert all(bool(torch.isfinite(x).all()) for x in s)
    again = (tsyn.structured_scene(3, 2000, sh_degree=3, device="cpu")
             if gen == "structured"
             else tsyn.random_blob_scene(3, 2000, device="cpu"))
    for a, b in zip(s, again):
        assert torch.equal(a, b)  # the seed fixes the scene


def test_psnr_and_ssim():
    rng = np.random.default_rng(5)
    a = rng.uniform(size=(40, 48, 3)).astype(np.float32)
    b = np.clip(a + rng.normal(scale=0.05, size=a.shape), 0, 1)
    b = b.astype(np.float32)
    ta, tb = torch.from_numpy(a), torch.from_numpy(b)
    P.assert_close(tmetrics.psnr(ta, tb),
                   jmetrics.psnr(jnp.asarray(a), jnp.asarray(b)), atol=1e-4)
    P.assert_close(tmetrics.ssim(ta, tb),
                   jmetrics.ssim(jnp.asarray(a), jnp.asarray(b)), atol=1e-5)
