"""The preprocess kernel's host path on the CPU: the one output buffer
and its carving into the fields, the by-value scalars, and the wrapper's
checks. The kernel (``csrc/preprocess.cu``) is held to the plain version
on the card by chip_smoke.py phase 2b; its arithmetic is the plain
version's, which tests/test_torch_core.py holds to the JAX reference."""
import ctypes
import pathlib
import re

import numpy as np
import pytest
import torch

from repro_torch.kernels import preprocess as pre
from repro_torch.obs.metrics import kernel_launches

CSRC = pathlib.Path(pre.__file__).resolve().parents[1] / "csrc"


@pytest.mark.parametrize("n", [1, 3, 4, 5, 130, 1027])
def test_output_buffer_carving(n):
    """Each field a contiguous view of one buffer, of its shape and
    dtype, 16-byte aligned, none overlapping another, at the offsets of
    ``output_layout`` (the stride S = round_up(n, 4))."""
    out = pre.alloc_outputs(n, "cpu")
    stride, offsets, total = pre.output_layout(n)
    assert stride % 4 == 0 and n <= stride < n + 4
    base = out.mean2d.untyped_storage().data_ptr()
    spans = []
    for name, width in pre.FIELDS:
        x = getattr(out, name)
        assert x.dtype == torch.float32 and x.is_contiguous()
        assert tuple(x.shape) == ((n,) if width == 1 else (n, width))
        assert x.untyped_storage().data_ptr() == base
        start = x.data_ptr() - base
        assert start == 4 * offsets[name] and start % 16 == 0
        spans.append((start, start + 4 * n * width))
    v = out.valid
    assert v.dtype == torch.bool and tuple(v.shape) == (n,)
    assert v.is_contiguous() and v.untyped_storage().data_ptr() == base
    start = v.data_ptr() - base
    assert start == 4 * offsets["valid"] and start % 16 == 0
    spans.append((start, start + n))
    spans.sort()
    assert all(a[1] <= b[0] for a, b in zip(spans, spans[1:]))
    assert spans[-1][1] <= 4 * total == out.mean2d.untyped_storage().nbytes()


def test_kernel_indexing_reads_back_through_the_views():
    """The kernel writes component c of Gaussian g of field f at word
    S * offset(f) + width(f) * g + c (and valid's byte g after 18 S words):
    values written so land in the views' elements."""
    n = 37
    out = pre.alloc_outputs(n, "cpu")
    stride, _, _ = pre.output_layout(n)
    words = out.mean2d.untyped_storage()
    flat = torch.empty(0, dtype=torch.float32).set_(words)
    rng = np.random.default_rng(0)
    want, at = {}, 0
    for name, width in pre.FIELDS:
        vals = torch.from_numpy(rng.normal(size=(n, width)).astype(
            np.float32))
        g = torch.arange(n)[:, None]
        c = torch.arange(width)[None, :]
        flat[stride * at + width * g + c] = vals
        want[name] = vals if width > 1 else vals[:, 0]
        at += width
    assert at == 18
    valid = torch.from_numpy(rng.uniform(size=n) < 0.5)
    torch.empty(0, dtype=torch.uint8).set_(words)[
        4 * 18 * stride + torch.arange(n)] = valid.to(torch.uint8)
    for name, vals in want.items():
        assert torch.equal(getattr(out, name), vals)
    assert torch.equal(out.valid, valid)


def test_field_widths_match_the_kernel():
    """FIELDS names the PreprocessGeom fields in the kernel's order and
    widths (``field_width`` in csrc/preprocess.cu)."""
    names = [name for name, _ in pre.FIELDS] + ["valid"]
    assert sorted(names) == sorted(pre.PreprocessGeom._fields)
    src = (CSRC / "preprocess.cu").read_text()
    body = re.search(r"constexpr int field_width\(int f\) \{(.*?)\}", src,
                     re.S).group(1)
    threes = {int(f) for f in re.findall(r"f == (\d)", body.split("? 3")[0])}
    twos = {int(f) for f in re.findall(r"f == (\d)",
                                       body.split("? 3")[1].split("? 2")[0])}
    for f, (_, width) in enumerate(pre.FIELDS):
        assert width == (3 if f in threes else 2 if f in twos else 1)


def test_params_struct_matches_the_kernel():
    """Params lays out the scalars as PreprocessParams in the source:
    eleven float32 fields, then the int count."""
    src = (CSRC / "preprocess.cu").read_text()
    body = re.search(r"struct PreprocessParams \{(.*?)\};", src, re.S)
    decls = re.sub(r"//[^\n]*", "", body.group(1))
    c_fields = []
    for kind, names in re.findall(r"(float|int) ([^;]+);", decls):
        c_fields += [(n.strip(), kind) for n in names.split(",")]
    got = [(name, "float" if t is ctypes.c_float else "int")
           for name, t in pre.Params._fields_]
    assert got == c_fields


@pytest.mark.parametrize("intrin,kw", [
    ((1662.77, 1662.77, 960.0, 544.0, 1920, 1088), {}),
    ((80.0, 90.0, 31.5, 30.0, 64, 60),
     dict(near=0.2, frustum_margin=1.1, dilation=0.1)),
])
def test_pack_params_matches_the_plain_version(intrin, kw):
    """The scalars the kernel gets are the float32 values the plain
    version computes with: the intrinsics, lim_x = margin * width / (2
    fx), lim_y likewise, near, the dilation and the opacity threshold."""
    p = pre.pack_params(7, intrin, **kw)
    near = kw.get("near", 0.05)
    margin = kw.get("frustum_margin", 1.3)
    dil = kw.get("dilation", pre.COV2D_DILATION)
    fx, fy, cx, cy, width, height = intrin
    want = dict(fx=fx, fy=fy, cx=cx, cy=cy, width=width, height=height,
                lim_x=margin * width / (2.0 * fx),
                lim_y=margin * height / (2.0 * fy), near=near, dilation=dil,
                alpha_thr=1.0 / 255.0)
    for name, value in want.items():
        assert getattr(p, name) == float(np.float32(value)), name
    assert p.n == 7
    # The plain version clamps tx at exactly lim_x (as float32): a
    # Gaussian far off to the side lands on the clamp's bound.
    w2c = torch.eye(4)
    means = torch.tensor([[1e4, 0.0, 1.0], [-1e4, 0.0, 1.0]])
    geom = pre.preprocess_geom_torch(
        means, torch.zeros((2, 3)), torch.tensor([[1.0, 0, 0, 0]] * 2),
        torch.ones(2), w2c, intrin, **kw)
    j02 = -fx * np.float32(p.lim_x)      # d u / d z at tx = lim_x, z = 1
    cov_xx = fx * fx + j02 * j02         # unit covariance, J J^T
    assert geom.cov2d[0, 0] == pytest.approx(cov_xx + dil, rel=1e-5)


def test_wrapper_checks_raise_and_cpu_runs_plain():
    n = 8
    f32 = dict(dtype=torch.float32)
    args = [torch.zeros((n, 3), **f32), torch.zeros((n, 3), **f32),
            torch.tensor([[1.0, 0, 0, 0]] * n), torch.ones((n,), **f32),
            torch.eye(4)]
    intrin = (10.0, 10.0, 8.0, 8.0, 16, 16)
    with pytest.raises(ValueError, match="CUDA"):
        pre.preprocess_geom_cuda(*args, intrin)
    bad = list(args)
    bad[0] = bad[0].double()
    with pytest.raises(TypeError):
        pre.preprocess_geom_cuda(*bad, intrin)
    bad = list(args)
    bad[2] = torch.zeros((n, 3))
    with pytest.raises(ValueError, match="quats"):
        pre.preprocess_geom_cuda(*bad, intrin)
    bad = list(args)
    bad[1] = torch.zeros((3, n)).T
    with pytest.raises(ValueError, match="contiguous"):
        pre.preprocess_geom_cuda(*bad, intrin)
    launches = kernel_launches("preprocess_geom")
    before = launches.value
    geom = pre.preprocess_geom(*args, intrin)
    assert launches.value == before
    want = pre.preprocess_geom_torch(*args, intrin)
    for g, w in zip(geom, want):
        assert torch.equal(g, w)
