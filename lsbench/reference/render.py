"""Plain PyTorch reference of the streaming renderer (LS-Gaussian).

The benchmark's own statement of what a frame is, written from the
paper's algorithm: EWA preprocess with SH colour, the two-stage TAIT
tile test, per-tile binning of the K nearest pairs (DPES early-stop
depth on warped frames), the front-to-back alpha blend of 3DGS, and on
warped frames the TWSR viewpoint transform, the re-render plan of at
most R tiles in Morton order, the inpaint and the compose. It imports
nothing of the program: every input comes from the benchmark (scene
tensors, poses, the configuration's numbers), and what the program made
is read only to be judged.

``dtype`` is the precision of every floating-point step; float32 is the
reference, bfloat16 the lower-precision control the check must refuse.
Ordering keys (depth) are compared as float32 bits in both.
"""
from __future__ import annotations

import math
from typing import NamedTuple, Optional

import numpy as np
import torch

TILE = 16
ALPHA_MIN = 1.0 / 255.0
ALPHA_MAX = 0.99
T_EPS = 1e-4
DILATION = 0.3
FRUSTUM_MARGIN = 1.3
TILE_CIRCUMRADIUS = TILE * math.sqrt(2.0) / 2.0
# (pixel, lane) elements of one blend temporary, and (Gaussian, tile)
# pairs of one intersect block: both bound memory only.
BLEND_BLOCK = 1 << 24
PAIR_BLOCK = 1 << 26

SH_C0 = 0.28209479177387814
SH_C1 = 0.4886025119029199
SH_C2 = (1.0925484305920792, -1.0925484305920792, 0.31539156525252005,
         -1.0925484305920792, 0.5462742152960396)
SH_C3 = (-0.5900435899266435, 2.890611442640554, -0.4570457994644658,
         0.3731763325901154, -0.4570457994644658, 1.445305721320277,
         -0.5900435899266435)


class View(NamedTuple):
    """A pinhole camera: world-to-camera ``w2c`` (4, 4), intrinsics."""

    w2c: torch.Tensor
    fx: float
    fy: float
    cx: float
    cy: float
    width: int
    height: int

    @property
    def tiles_x(self) -> int:
        return self.width // TILE

    @property
    def tiles_y(self) -> int:
        return self.height // TILE


def make_view(w2c: torch.Tensor, width: int, height: int,
              fov_deg: float) -> View:
    f = 0.5 * height / float(np.tan(np.radians(fov_deg) / 2.0))
    return View(w2c, f, f, width / 2.0, height / 2.0, width, height)


class Settings(NamedTuple):
    """The render configuration's numbers the reference follows."""

    capacity: int
    window: int
    use_dpes: bool = True
    use_mask: bool = True
    dpes_margin: float = 1.0
    n0_ratio: float = 5.0 / 6.0
    inpaint_iters: int = 8
    near: float = 0.05
    min_coverage: float = 0.25

    @classmethod
    def from_config(cls, render: dict) -> "Settings":
        keys = set(cls._fields) & set(render)
        return cls(**{k: render[k] for k in keys})


class Frame(NamedTuple):
    """One rendered frame and the state the next warp reads."""

    rgb: torch.Tensor          # (H, W, 3) float32
    exp_depth: torch.Tensor    # (H, W)
    trunc_depth: torch.Tensor  # (H, W)
    source_mask: torch.Tensor  # (H, W) bool
    raw_pairs: int             # TAIT pairs over the rendered tiles
    sort_pairs: int            # pairs binned (after DPES, at most K a tile)
    tile_raw: torch.Tensor     # (T,) int64 TAIT pairs a tile (0 off plan)
    tile_sort: torch.Tensor    # (T,) int64 pairs binned a tile (0 off plan)
    evaluated: int             # (pixel, lane) pairs reached, pixel not done
    blended: int               # ... with a nonzero blend weight
    tiles: int                 # tiles rendered
    is_key: bool


# -- preprocess ---------------------------------------------------------


def _quat_rot(q):
    q = q / (torch.linalg.norm(q, dim=-1, keepdim=True) + 1e-12)
    w, x, y, z = q.unbind(-1)
    return torch.stack([
        torch.stack([1 - 2 * (y * y + z * z), 2 * (x * y - w * z),
                     2 * (x * z + w * y)], -1),
        torch.stack([2 * (x * y + w * z), 1 - 2 * (x * x + z * z),
                     2 * (y * z - w * x)], -1),
        torch.stack([2 * (x * z - w * y), 2 * (y * z + w * x),
                     1 - 2 * (x * x + y * y)], -1)], -2)


def _sh_colour(sh, dirs):
    k = sh.shape[1]
    out = SH_C0 * sh[:, 0]
    if k > 1:
        x, y, z = dirs[:, 0:1], dirs[:, 1:2], dirs[:, 2:3]
        out = (out - SH_C1 * y * sh[:, 1] + SH_C1 * z * sh[:, 2]
               - SH_C1 * x * sh[:, 3])
        if k > 4:
            xx, yy, zz = x * x, y * y, z * z
            xy, yz, xz = x * y, y * z, x * z
            out = (out + SH_C2[0] * xy * sh[:, 4] + SH_C2[1] * yz * sh[:, 5]
                   + SH_C2[2] * (2.0 * zz - xx - yy) * sh[:, 6]
                   + SH_C2[3] * xz * sh[:, 7]
                   + SH_C2[4] * (xx - yy) * sh[:, 8])
            if k > 9:
                out = (out + SH_C3[0] * y * (3 * xx - yy) * sh[:, 9]
                       + SH_C3[1] * xy * z * sh[:, 10]
                       + SH_C3[2] * y * (4 * zz - xx - yy) * sh[:, 11]
                       + SH_C3[3] * z * (2 * zz - 3 * xx - 3 * yy)
                       * sh[:, 12]
                       + SH_C3[4] * x * (4 * zz - xx - yy) * sh[:, 13]
                       + SH_C3[5] * z * (xx - yy) * sh[:, 14]
                       + SH_C3[6] * x * (xx - 3 * yy) * sh[:, 15])
    return torch.clamp_min(out + 0.5, 0.0)


def preprocess(scene, view: View, s: Settings, dtype) -> dict:
    """Project every Gaussian (EWA) and derive TAIT's radii and box."""
    means, log_scales, quats, opacity_logits, sh = (
        t.to(dtype) for t in scene)
    w2c = view.w2c.to(dtype)
    rot, t = w2c[:3, :3], w2c[:3, 3]
    opacity = torch.sigmoid(opacity_logits)
    p = means @ rot.T + t
    z = p[:, 2]
    zs = torch.clamp_min(z, s.near)
    u = view.fx * p[:, 0] / zs + view.cx
    v = view.fy * p[:, 1] / zs + view.cy
    lim_x = FRUSTUM_MARGIN * view.width / (2.0 * view.fx)
    lim_y = FRUSTUM_MARGIN * view.height / (2.0 * view.fy)
    tx = torch.clamp(p[:, 0] / zs, -lim_x, lim_x) * zs
    ty = torch.clamp(p[:, 1] / zs, -lim_y, lim_y) * zs
    iz = 1.0 / zs
    zero = torch.zeros_like(iz)
    jac = torch.stack([
        torch.stack([view.fx * iz, zero, -view.fx * tx * iz * iz], -1),
        torch.stack([zero, view.fy * iz, -view.fy * ty * iz * iz], -1)],
        -2)
    m = _quat_rot(quats) * torch.exp(log_scales)[:, None, :]
    cov3 = m @ m.transpose(-1, -2)
    jw = jac @ rot[None]
    cov2 = jw @ cov3 @ jw.transpose(-1, -2)
    a = cov2[:, 0, 0] + DILATION
    b = cov2[:, 0, 1]
    c = cov2[:, 1, 1] + DILATION
    det = a * c - b * b
    dsafe = torch.clamp_min(det, 1e-12)
    conic = torch.stack([c / dsafe, -b / dsafe, a / dsafe], -1)
    mid, half = 0.5 * (a + c), 0.5 * (a - c)
    disc = torch.sqrt(torch.clamp_min(half * half + b * b, 1e-12))
    lam1 = mid + disc
    lam2 = torch.clamp_min(mid - disc, 1e-8)
    big = b.abs() > 1e-12
    ex = torch.where(big, b, (a <= c).to(dtype))
    ey = torch.where(big, lam2 - a, (a > c).to(dtype))
    norm = torch.sqrt(ex * ex + ey * ey) + 1e-12
    minor = torch.stack([ex / norm, ey / norm], -1)
    radius3 = torch.ceil(3.0 * torch.sqrt(lam1))
    log_ratio = torch.log(torch.clamp_min(opacity / ALPHA_MIN, 1.0 + 1e-6))
    r_major = torch.sqrt(2.0 * log_ratio * lam1)
    r_minor = torch.sqrt(2.0 * log_ratio * lam2)
    half_wh = torch.stack([
        torch.sqrt(torch.clamp_min(a / lam1, 0.0)) * r_major,
        torch.sqrt(torch.clamp_min(c / lam1, 0.0)) * r_major], -1)
    valid = ((z > s.near) & (opacity > ALPHA_MIN)
             & (u + radius3 > 0) & (u - radius3 < view.width)
             & (v + radius3 > 0) & (v - radius3 < view.height)
             & (det > 1e-12))
    eye = -rot.T @ t
    dirs = means - eye
    dirs = dirs / (torch.linalg.norm(dirs, dim=-1, keepdim=True) + 1e-12)
    return dict(mean2d=torch.stack([u, v], -1), conic=conic, depth=z,
                rgb=_sh_colour(sh, dirs), opacity=opacity, minor=minor,
                r_minor=r_minor, half_wh=half_wh, valid=valid)


# -- intersect, bin, blend ----------------------------------------------


def morton_rank(tiles_x: int, tiles_y: int) -> np.ndarray:
    """(T,) position of each tile id along the Z-order curve."""
    def spread(x):
        x = x.astype(np.uint32)
        x = (x | (x << 8)) & 0x00FF00FF
        x = (x | (x << 4)) & 0x0F0F0F0F
        x = (x | (x << 2)) & 0x33333333
        return (x | (x << 1)) & 0x55555555

    ty, tx = np.meshgrid(np.arange(tiles_y), np.arange(tiles_x),
                         indexing="ij")
    code = spread(tx.ravel()) | (spread(ty.ravel()) << 1)
    rank = np.empty(code.size, np.int64)
    rank[np.argsort(code, kind="stable")] = np.arange(code.size)
    return rank


def _depth_key(depth: torch.Tensor) -> torch.Tensor:
    """float32 depth -> int64 key in float order, id in the low 32 bits."""
    bits = depth.to(torch.float32).contiguous().view(torch.int32)
    bits = bits.to(torch.int64)
    bits = torch.where(bits < 0, bits ^ 0x7FFFFFFF, bits)
    ids = torch.arange(depth.shape[0], dtype=torch.int64,
                       device=depth.device)
    return (bits << 32) | ids


def _tile_origins(tile_ids: torch.Tensor, view: View, dtype):
    tx = (tile_ids % view.tiles_x).to(dtype) * TILE
    ty = (tile_ids // view.tiles_x).to(dtype) * TILE
    return torch.stack([tx, ty], -1)


def bin_tiles(proj: dict, tile_ids: torch.Tensor, view: View,
              s: Settings, limit: Optional[torch.Tensor]):
    """TAIT test and binning for the given tiles: (R, K) Gaussian ids in
    (depth, id) order, their count, and the raw (pre-DPES) pair count of
    each tile (R,)."""
    n = proj["depth"].shape[0]
    k = min(s.capacity, n)
    r = tile_ids.shape[0]
    dev = proj["depth"].device
    origins = _tile_origins(tile_ids, view, proj["depth"].dtype)
    key = _depth_key(proj["depth"])
    inf_key = 0x7F800000 << 32
    low = key & 0xFFFFFFFF
    ids = torch.empty((r, k), dtype=torch.int64, device=dev)
    count = torch.empty((r,), dtype=torch.int64, device=dev)
    raw = torch.empty((r,), dtype=torch.int64, device=dev)
    lo = proj["mean2d"] - proj["half_wh"]
    hi = proj["mean2d"] + proj["half_wh"]
    rows = max(1, PAIR_BLOCK // max(n, 1))
    for r0 in range(0, r, rows):
        o = origins[r0:r0 + rows]
        t_lo, t_hi = o, o + TILE
        stage1 = ((lo[:, None, 0] < t_hi[None, :, 0])
                  & (hi[:, None, 0] > t_lo[None, :, 0])
                  & (lo[:, None, 1] < t_hi[None, :, 1])
                  & (hi[:, None, 1] > t_lo[None, :, 1])
                  & proj["valid"][:, None])
        d = (o + TILE / 2.0)[None, :, :] - proj["mean2d"][:, None, :]
        along = (d[..., 0] * proj["minor"][:, None, 0]
                 + d[..., 1] * proj["minor"][:, None, 1]).abs()
        mask = stage1 & (along - TILE_CIRCUMRADIUS
                         <= proj["r_minor"][:, None])
        raw[r0:r0 + rows] = mask.sum(0)
        mask = mask.T
        if limit is not None:
            mask = mask & (proj["depth"][None, :]
                           <= limit[r0:r0 + rows, None])
        keys = torch.where(mask, key[None, :], inf_key | low[None, :])
        top = torch.topk(keys, k, dim=1, largest=False, sorted=True).values
        ids[r0:r0 + rows] = top & 0xFFFFFFFF
        count[r0:r0 + rows] = torch.clamp_max(mask.sum(1), s.capacity)
    return ids, count, raw


def blend(proj: dict, ids: torch.Tensor, count: torch.Tensor,
          tile_ids: torch.Tensor, view: View, chunk: int = 64):
    """Front-to-back blend of each tile's lanes (3DGS semantics: alpha
    capped at 0.99, skipped below 1/255, a pixel done at the Gaussian
    that would take T below 1e-4, which is not blended). Returns per
    tile (R, 16, 16) rgb, T, expected depth, truncated depth and the
    (evaluated, blended) pair counts."""
    dtype = proj["depth"].dtype
    dev = ids.device
    r, k = ids.shape
    p = TILE * TILE
    lane = torch.arange(k, device=dev)
    real = lane[None, :] < count[:, None]
    zero = torch.zeros((), dtype=dtype, device=dev)
    out_rgb = torch.zeros((r, p, 3), dtype=dtype, device=dev)
    out_t = torch.ones((r, p), dtype=dtype, device=dev)
    out_d = torch.zeros((r, p), dtype=dtype, device=dev)
    out_td = torch.zeros((r, p), dtype=dtype, device=dev)
    n_eval = torch.zeros((), dtype=torch.int64, device=dev)
    n_blend = torch.zeros((), dtype=torch.int64, device=dev)
    origins = _tile_origins(tile_ids, view, dtype)
    ii = torch.arange(TILE, dtype=dtype, device=dev)
    py, px = torch.meshgrid(ii, ii, indexing="ij")
    n_used = -(-int(count.max()) // chunk) if r else 0
    rows = max(1, BLEND_BLOCK // (p * chunk))
    for r0 in range(0, r, rows):
        b = slice(r0, r0 + rows)
        gx = px.reshape(1, -1) + origins[b, 0:1] + 0.5
        gy = py.reshape(1, -1) + origins[b, 1:2] + 0.5
        nb = gx.shape[0]
        c_acc = torch.zeros((nb, p, 3), dtype=dtype, device=dev)
        t_run = torch.ones((nb, p), dtype=dtype, device=dev)
        done = torch.zeros((nb, p), dtype=torch.bool, device=dev)
        d_acc = torch.zeros((nb, p), dtype=dtype, device=dev)
        w_acc = torch.zeros((nb, p), dtype=dtype, device=dev)
        td = torch.zeros((nb, p), dtype=dtype, device=dev)
        for i in range(n_used):
            sl = slice(i * chunk, (i + 1) * chunk)
            g = ids[b, sl]
            ok = real[b, sl]
            m = proj["mean2d"][g]
            con = proj["conic"][g]
            dep = torch.where(ok, proj["depth"][g], zero)[:, None, :]
            op = torch.where(ok, proj["opacity"][g], zero)[:, None, :]
            dx = gx[:, :, None] - m[:, None, :, 0]
            dy = gy[:, :, None] - m[:, None, :, 1]
            power = (-0.5 * (con[:, None, :, 0] * dx * dx
                             + con[:, None, :, 2] * dy * dy)
                     - con[:, None, :, 1] * dx * dy)
            alpha = torch.clamp_max(op * torch.exp(power), ALPHA_MAX)
            alpha = torch.where(alpha >= ALPHA_MIN, alpha, zero)
            cp = torch.cumprod(1.0 - alpha, dim=2)
            t_before = t_run[..., None] * torch.cat(
                [torch.ones_like(cp[..., :1]), cp[..., :-1]], dim=2)
            tp = t_run[..., None] * cp
            live = (tp >= T_EPS) & ~done[..., None]
            w = torch.where(live, alpha * t_before, zero)
            n_eval += ((t_before >= T_EPS) & ~done[..., None]
                       & ok[:, None, :]).sum()
            n_blend += (w > 0).sum()
            c_acc = c_acc + w @ proj["rgb"][g]
            d_acc = d_acc + (w * dep).sum(2)
            w_acc = w_acc + w.sum(2)
            td = torch.maximum(td, torch.where(live & (alpha > 0), dep,
                                               zero).amax(2))
            t_run = torch.where(live, tp, t_run[..., None]).amin(2)
            done = done | (tp[..., -1] < T_EPS)
        out_rgb[b], out_t[b] = c_acc, t_run
        out_d[b] = d_acc / torch.clamp_min(w_acc, 1e-8)
        out_td[b] = td
    shape = (r, TILE, TILE)
    return (out_rgb.reshape(r, TILE, TILE, 3), out_t.reshape(shape),
            out_d.reshape(shape), out_td.reshape(shape), int(n_eval),
            int(n_blend))


def _untile(x: torch.Tensor, view: View) -> torch.Tensor:
    extra = tuple(x.shape[3:])
    x = x.reshape(view.tiles_y, view.tiles_x, TILE, TILE, *extra)
    return x.transpose(1, 2).reshape(view.height, view.width, *extra)


def _tiles(img: torch.Tensor, view: View) -> torch.Tensor:
    extra = tuple(img.shape[2:])
    x = img.reshape(view.tiles_y, TILE, view.tiles_x, TILE, *extra)
    return x.transpose(1, 2).reshape(view.tiles_y * view.tiles_x, TILE,
                                     TILE, *extra)


def render_tiles(scene, view: View, s: Settings, tile_ids: torch.Tensor,
                 limit: Optional[torch.Tensor], dtype):
    """Render the listed tiles into full-frame maps (other tiles empty)."""
    proj = preprocess(scene, view, s, dtype)
    ids, count, raw = bin_tiles(proj, tile_ids, view, s, limit)
    rgb, trans, dep, tdep, n_eval, n_blend = blend(proj, ids, count,
                                                   tile_ids, view)
    t = view.tiles_x * view.tiles_y
    dev = ids.device
    full = dict(rgb=torch.zeros((t, TILE, TILE, 3), dtype=dtype,
                                device=dev),
                trans=torch.ones((t, TILE, TILE), dtype=dtype, device=dev),
                dep=torch.zeros((t, TILE, TILE), dtype=dtype, device=dev),
                tdep=torch.zeros((t, TILE, TILE), dtype=dtype, device=dev))
    for name, val in (("rgb", rgb), ("trans", trans), ("dep", dep),
                      ("tdep", tdep)):
        full[name][tile_ids] = val
    maps = {name: _untile(val, view) for name, val in full.items()}
    tile_raw = torch.zeros((t,), dtype=torch.int64, device=dev)
    tile_sort = torch.zeros((t,), dtype=torch.int64, device=dev)
    tile_raw[tile_ids], tile_sort[tile_ids] = raw, count
    work = dict(raw_pairs=int(raw.sum()), sort_pairs=int(count.sum()),
                tile_raw=tile_raw, tile_sort=tile_sort,
                evaluated=n_eval, blended=n_blend,
                tiles=int(tile_ids.shape[0]))
    return maps, work


def key_frame(scene, view: View, s: Settings, dtype=torch.float32) -> Frame:
    t = view.tiles_x * view.tiles_y
    ids = torch.arange(t, device=view.w2c.device)
    maps, work = render_tiles(scene, view, s, ids, None, dtype)
    return Frame(rgb=maps["rgb"].float(), exp_depth=maps["dep"],
                 trunc_depth=maps["tdep"],
                 source_mask=(1.0 - maps["trans"]) > s.min_coverage,
                 is_key=True, **work)


# -- TWSR warp ----------------------------------------------------------


def _reproject(ref: View, depth, mask, tgt: View, near):
    h, w = depth.shape
    dtype = depth.dtype
    u = torch.arange(w, dtype=dtype, device=depth.device) + 0.5
    v = torch.arange(h, dtype=dtype, device=depth.device) + 0.5
    uu, vv = torch.meshgrid(u, v, indexing="xy")
    pc = torch.stack([(uu - ref.cx) / ref.fx * depth,
                      (vv - ref.cy) / ref.fy * depth, depth], -1)
    r_rot, r_t = ref.w2c[:3, :3].to(dtype), ref.w2c[:3, 3].to(dtype)
    world = (pc - r_t) @ r_rot
    t_rot, t_t = tgt.w2c[:3, :3].to(dtype), tgt.w2c[:3, 3].to(dtype)
    q = world.reshape(-1, 3) @ t_rot.T + t_t
    z = q[:, 2]
    tu = tgt.fx * q[:, 0] / torch.clamp_min(z, near) + tgt.cx
    tv = tgt.fy * q[:, 1] / torch.clamp_min(z, near) + tgt.cy
    ui = torch.floor(tu).to(torch.int64)
    vi = torch.floor(tv).to(torch.int64)
    ok = (mask.reshape(-1) & (z > near) & (ui >= 0) & (ui < w) & (vi >= 0)
          & (vi < h))
    return vi * w + ui, z, ok


def _add_at(size: int, index, values):
    """Sum ``values`` rows into ``size`` bins, in a fixed order."""
    out = torch.zeros((size,) + tuple(values.shape[1:]), dtype=values.dtype,
                      device=values.device)
    order = torch.argsort(index, stable=True)
    prev = torch.are_deterministic_algorithms_enabled()
    torch.use_deterministic_algorithms(True)
    try:
        out.index_add_(0, index[order], values[order])
    finally:
        torch.use_deterministic_algorithms(prev)
    return out


def _zbuffer(ti, z, ok, values, size):
    zs = torch.where(ok, z, torch.full_like(z, 1e30))
    safe = torch.where(ok, ti, 0)
    zmin = torch.full((size,), 1e30, dtype=z.dtype, device=z.device)
    zmin.scatter_reduce_(0, safe, zs, "amin")
    win = ok & (zs <= zmin[safe] * (1.0 + 1e-5))
    idx = safe[win]
    cnt = _add_at(size, idx, torch.ones((idx.shape[0],), dtype=z.dtype,
                                        device=z.device))
    acc = _add_at(size, idx, values[win])
    hit = cnt > 0
    return (torch.where(hit, zmin, torch.zeros_like(zmin)),
            acc / torch.clamp_min(cnt, 1.0)[:, None], hit)


def _inpaint(img, filled, iters):
    f = filled.to(img.dtype)[..., None]
    cur = img * f

    def box(x):
        xp = torch.nn.functional.pad(x, (0, 0, 1, 1, 1, 1))
        return sum(xp[i:i + x.shape[0], j:j + x.shape[1]]
                   for i in range(3) for j in range(3))

    wgt = f
    for _ in range(iters):
        num = box(cur * wgt)
        den = box(wgt)
        cur = torch.where(filled[..., None], img,
                          num / torch.clamp_min(den, 1e-8))
        wgt = torch.maximum(wgt, (den[..., :1] > 0).to(img.dtype))
    return cur


def warped_frame(scene, prev: Frame, ref: View, view: View, s: Settings,
                 capacity: Optional[int], dtype=torch.float32) -> Frame:
    """A TWSR frame warped from ``prev`` (rendered at ``ref``)."""
    h, w = view.height, view.width
    size = h * w
    tx, ty = view.tiles_x, view.tiles_y
    t = tx * ty
    rgb = prev.rgb.to(dtype)
    ed, td = prev.exp_depth.to(dtype), prev.trunc_depth.to(dtype)
    ti, z, ok = _reproject(ref, ed, prev.source_mask, view, s.near)
    payload = torch.cat([rgb.reshape(-1, 3), ed.reshape(-1, 1)], -1)
    _, out, hit = _zbuffer(ti, z, ok, payload, size)
    zmap, _, _ = _zbuffer(ti, z, ok, z[:, None], size)
    w_rgb = out[:, :3].reshape(h, w, 3)
    filled = hit.reshape(h, w)
    w_ed = zmap.reshape(h, w)
    tm, zm, okm = _reproject(ref, td, prev.source_mask, view, s.near)
    w_td = torch.zeros((size,), dtype=dtype, device=zm.device)
    w_td.scatter_reduce_(0, torch.where(okm, tm, 0),
                         torch.where(okm, zm, torch.zeros_like(zm)), "amax")
    w_td = w_td.reshape(h, w)
    per_tile = _tiles(filled.to(torch.int64), view).sum((1, 2))
    n0 = int(round(s.n0_ratio * TILE * TILE))
    rerender = per_tile <= n0
    tmax = _tiles(w_td, view).amax((1, 2))
    inf = torch.full_like(tmax, float("inf"))
    dpes = torch.where((per_tile > 0) & (tmax > 0), tmax, inf)
    # The re-render plan: re-render tiles in Morton order, at most R.
    rank = torch.as_tensor(morton_rank(tx, ty), device=rerender.device)
    order = torch.argsort(torch.where(rerender, rank, t + rank), stable=True)
    r = t if capacity is None else min(int(capacity), t)
    slots = order[:r]
    slots = slots[rerender[slots]]
    limit = dpes[slots] * s.dpes_margin if s.use_dpes else None
    maps, work = render_tiles(scene, view, s, slots, limit, dtype)
    redo = torch.zeros((t,), dtype=torch.bool, device=rerender.device)
    redo[slots] = True
    redo_px = _untile(redo[:, None, None].expand(t, TILE, TILE), view)
    stacked = torch.cat([w_rgb, w_ed[..., None], w_td[..., None]], -1)
    filled_in = _inpaint(stacked, filled, s.inpaint_iters)
    out_rgb = torch.where(redo_px[..., None], maps["rgb"], filled_in[..., :3])
    out_ed = torch.where(redo_px, maps["dep"], filled_in[..., 3])
    out_td = torch.where(redo_px, maps["tdep"], filled_in[..., 4])
    covered = (1.0 - maps["trans"]) > s.min_coverage
    if s.use_mask:
        src = torch.where(redo_px, covered, filled)
    else:
        src = torch.where(redo_px, covered, torch.ones_like(filled))
    return Frame(rgb=out_rgb.float(), exp_depth=out_ed, trunc_depth=out_td,
                 source_mask=src, is_key=False, **work)


# -- the LDU schedule ---------------------------------------------------


def ldu_schedule(workload: np.ndarray, active: np.ndarray, tiles_x: int,
                 tiles_y: int, blocks: int):
    """The paper's LDU over a frame's plan: active tiles visited in Morton
    order fill blocks up to ``(1 + 1/n_avg) * w_ideal`` (float32, as the
    accelerator accumulates), deferring cyclically to the next block with
    room, else to the least-loaded; inside a block tiles run light to
    heavy, ties by tile id. Returns (block_of_tile, order_in_block), each
    (T,) int64, -1 and 0 off the plan."""
    f32 = np.float32
    t = workload.shape[0]
    b = max(int(blocks), 1)
    visit = np.argsort(morton_rank(tiles_x, tiles_y), kind="stable")
    visit = visit[active[visit]]
    wl = workload.astype(np.int32).astype(np.float32)
    total = f32(wl[visit].astype(np.float64).sum())
    w_ideal = max(total / f32(b), f32(1.0))
    n_avg = max(f32(visit.size) / f32(b), f32(1.0))
    cap = (f32(1.0) + f32(1.0) / n_avg) * w_ideal
    accs = np.zeros((b,), np.float32)
    block = np.full((t,), -1, np.int64)
    cur = 0
    for tid in visit:
        w = wl[tid]
        if accs[cur] + w > cap:
            cand = (cur + 1 + np.arange(b)) % b
            fits = accs[cand] + w <= cap
            cur = int(cand[np.argmax(fits)]) if fits.any() \
                else int(np.argmin(accs))
        accs[cur] += w
        block[tid] = cur
    order = np.zeros((t,), np.int64)
    for j in range(b):
        ids = np.flatnonzero(block == j)
        perm = ids[np.lexsort((ids, workload[ids]))]
        order[perm] = np.arange(perm.size)
    return block, order
