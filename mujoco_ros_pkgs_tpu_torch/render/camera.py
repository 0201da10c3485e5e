"""Batched ray-cast cameras: RGB, depth and segmentation of many envs at once.

Counterpart of mujoco_ros_pkgs_tpu/render/camera.py. The reference renders
offscreen with OpenGL on a thread of its own (offscreen_camera.cpp,
offscreen_rendering.cpp); here every pixel of every env is one ray cast
against the analytic geoms (ops/sensor_impl: primitives by `ray_local`,
meshes by their hull's triangles, height fields by a march and a
bisection), as torch ops on the batch's device. The outputs follow
OffscreenCamera's streams:

- RGB: flat albedo (`geom_rgba`) shaded Lambert with a headlight, the
  normal taken from screen-space differences of the hit points, so that
  every geom type shades without code of its own;
- DEPTH: metric and planar (along the view axis, as the reference converts
  OpenGL depth, offscreen_camera.cpp:239-249), 0 where nothing is hit;
- SEGMENTED: the geom id of each pixel, ngeom + k for the k-th marker,
  -1 for the background;
- camera intrinsics from fovy (offscreen_camera.cpp:129-155).

Rays are cast in chunks of RAY_CHUNK, so that the (rays, faces, 3) tensors
of a hull stay bounded whatever the image and the batch; every ray's
arithmetic is its own (elementwise sums, no matmul), so the chunking does
not change a bit of the result.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Optional, Sequence, Tuple

import torch

from mujoco_ros_pkgs_tpu_torch.core.types import Data, GeomType, Model
from mujoco_ros_pkgs_tpu_torch.ops import math as mmath
from mujoco_ros_pkgs_tpu_torch.ops.sensor_impl import _ray_geom, ray_local

# rays cast at once: at 1 << 20 a 36-face hull's (rays, faces, 3) float32
# tensors are 0.45 GB each
RAY_CHUNK = 1 << 20
BACKGROUND = (0.2, 0.3, 0.4)
_INF = float("inf")


@dataclass
class RenderMarker:
    """A visual-only geom in a render (the reference's renderCallback lets
    plugins add mjvGeoms to the scene, plugin_utils.h:97-135): an analytic
    primitive (plane, sphere, capsule, ellipsoid, cylinder or box) at `pos`
    (3,), turned by `mat` (3, 3; None: identity), of `size` (3,) and `rgba`
    (4,), the same in every env."""
    pos: torch.Tensor
    size: torch.Tensor
    rgba: torch.Tensor
    mat: Optional[torch.Tensor] = None
    gtype: int = int(GeomType.SPHERE)


def _mv(mat: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """mat @ v over leading dims, as three products and two sums."""
    return (mat[..., :, 0] * v[..., 0:1] + mat[..., :, 1] * v[..., 1:2]
            + mat[..., :, 2] * v[..., 2:3])


def _tmv(mat: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """mat^T @ v over leading dims: a world vector in mat's frame."""
    return (mat[..., 0, :] * v[..., 0:1] + mat[..., 1, :] * v[..., 1:2]
            + mat[..., 2, :] * v[..., 2:3])


def cam_pose(m: Model, d: Data, cam_id: int):
    """World pose of a camera fixed to its body in every env of d:
    position (B, 3) and rotation (B, 3, 3)."""
    dtype = d.qpos.dtype
    b = m.cam_bodyid[cam_id]
    xmat = d.xmat[:, b]
    pos = d.xpos[:, b] + _mv(xmat, m.cam_pos[cam_id].to(dtype))
    q = mmath.quat_to_mat(m.cam_quat[cam_id].to(dtype))
    rot = (xmat[..., :, :, None] * q[None, :, :]).sum(-2)
    return pos, rot


def _focal(m: Model, cam_id: int, height: int, dtype) -> torch.Tensor:
    fovy = m.cam_fovy[cam_id].to(dtype) * (math.pi / 180.0)
    return (height / 2.0) / torch.tan(fovy / 2.0)


def camera_intrinsics(m: Model, cam_id: int, width: int, height: int) -> dict:
    """fx = fy from fovy, the principal point at the image's centre (the
    stream's camera_info)."""
    fovy = float(m.cam_fovy[cam_id]) * math.pi / 180.0
    f = (height / 2.0) / math.tan(fovy / 2.0)
    return dict(fx=f, fy=f, cx=width / 2.0, cy=height / 2.0, width=width, height=height)


def pixel_ray(m: Model, d: Data, cam_id: int, x, y, width: int, height: int):
    """World ray through image pixel (x, y) (x right, y down, as render's
    grid) in every env of d: origin (B, 3), unit direction (B, 3)."""
    dtype = d.qpos.dtype
    pos, rot = cam_pose(m, d, cam_id)
    f = _focal(m, cam_id, height, dtype)
    px = (torch.as_tensor(x, dtype=dtype, device=f.device) - width / 2.0 + 0.5) / f
    py = (height / 2.0 - torch.as_tensor(y, dtype=dtype, device=f.device) - 0.5) / f
    dir_cam = torch.stack([px, py, -torch.ones_like(px)])
    dir_cam = dir_cam / torch.sqrt((dir_cam * dir_cam).sum())
    return pos, _mv(rot, dir_cam)


def _nearest(m: Model, origin_local, v, gmat, best_t, best_g, geoms, markers=()):
    """The nearest hit of rays v (R, 3) among `geoms`, then the markers, by
    a strict t < best (the lower id wins a tie): origin_local(g) gives each
    geom's ray origins in its frame, gmat(g) its rotations (R, 3, 3)."""
    for g in geoms:
        t = _ray_geom(m, g, origin_local(g), _tmv(gmat(g), v))
        hit = t < best_t
        best_t = torch.where(hit, t, best_t)
        best_g = torch.where(hit, g, best_g)
    for k, (gtype, size, mat, tl) in enumerate(markers):
        t = ray_local(gtype, size, tl, v if mat is None else _tmv(mat, v))
        hit = t < best_t
        best_t = torch.where(hit, t, best_t)
        best_g = torch.where(hit, m.ngeom + k, best_g)
    return best_t, best_g


def pick(m: Model, d: Data, cam_id: int, x, y, width: int, height: int):
    """Screen-ray selection (the viewer's mjv_select, used by its mouse
    perturbation, viewer.cpp:1451-1480) in every env of d: the distance
    along the ray (B,) (+inf on a miss), the geom hit (B,) int32 (-1: the
    background) and the world hit point (B, 3)."""
    pos, direction = pixel_ray(m, d, cam_id, x, y, width, height)
    best_t = torch.full_like(pos[:, 0], _INF)
    best_g = torch.full(best_t.shape, -1, dtype=torch.int32, device=pos.device)
    best_t, best_g = _nearest(
        m, lambda g: _tmv(d.geom_xmat[:, g], pos - d.geom_xpos[:, g]), direction,
        lambda g: d.geom_xmat[:, g], best_t, best_g, range(m.ngeom))
    point = pos + torch.where(torch.isinf(best_t), 0.0, best_t)[:, None] * direction
    return best_t, best_g, point


def render(m: Model, d: Data, cam_id: int, width: int = 720, height: int = 480,
           markers: Sequence[RenderMarker] = (), env_ids: Optional[Sequence[int]] = None
           ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Render camera cam_id in the envs env_ids of the batch d (every env
    when None), from d's kinematics (xpos, xmat, geom_xpos, geom_xmat):
    rgb (N, H, W, 3) in [0, 1], planar depth (N, H, W) in metres, seg
    (N, H, W) int32, in d's float dtype on d's device."""
    dtype, dev = d.qpos.dtype, d.qpos.device
    if env_ids is not None:
        idx = mmath.static_tensor(list(env_ids), dev, torch.int64)
        d = d.replace(**{k: getattr(d, k).index_select(0, idx)
                         for k in ("qpos", "xpos", "xmat", "geom_xpos", "geom_xmat")})
    pos, rot = cam_pose(m, d, cam_id)
    n, hw = pos.shape[0], height * width
    f = _focal(m, cam_id, height, dtype)
    ii = torch.arange(height, dtype=dtype, device=dev)
    jj = torch.arange(width, dtype=dtype, device=dev)
    # pixel rays in the camera frame: x right, y up, looking along -z
    px = (jj[None, :] - width / 2.0 + 0.5) / f
    py = (height / 2.0 - ii[:, None] - 0.5) / f
    dirs_cam = torch.stack([px.expand(height, width), py.expand(height, width),
                            -torch.ones(height, width, dtype=dtype, device=dev)], -1)
    norms = torch.sqrt((dirs_cam * dirs_cam).sum(-1, keepdim=True))
    dirs_cam = (dirs_cam / norms).reshape(hw, 3)
    dirs = _mv(rot[:, None], dirs_cam[None])                       # (N, HW, 3) world

    # each geom's ray origin in its own frame, per env: (N, ngeom, 3)
    gmat = d.geom_xmat
    origin_local = _tmv(gmat, pos[:, None] - d.geom_xpos)
    mk = []
    for marker in markers:
        mat = None if marker.mat is None else marker.mat.to(dev, dtype)
        off = pos - marker.pos.to(dev, dtype)
        mk.append((marker.gtype, marker.size.to(dev, dtype), mat,
                   off if mat is None else _tmv(mat, off)))
    flat = dirs.reshape(n * hw, 3)
    t_all = torch.empty(n * hw, dtype=dtype, device=dev)
    seg_all = torch.empty(n * hw, dtype=torch.int32, device=dev)
    for s in range(0, n * hw, RAY_CHUNK):
        e = min(s + RAY_CHUNK, n * hw)
        env = torch.arange(s, e, device=dev) // hw
        v = flat[s:e]
        ck = [(gt, size, mat, tl[env]) for gt, size, mat, tl in mk]
        best_t = torch.full((e - s,), _INF, dtype=dtype, device=dev)
        best_g = torch.full((e - s,), -1, dtype=torch.int32, device=dev)
        best_t, best_g = _nearest(m, lambda g: origin_local[env, g], v,
                                  lambda g: gmat[env, g], best_t, best_g,
                                  range(m.ngeom), ck)
        t_all[s:e] = best_t
        seg_all[s:e] = best_g

    t = t_all.reshape(n, hw)
    zcomp = -dirs_cam[:, 2]
    depth = torch.where(torch.isinf(t), 0.0, t * norms.reshape(hw) * zcomp)

    # normals from screen-space differences of the hit points (the last row
    # and column repeat themselves: a zero difference)
    view = dirs.reshape(n, height, width, 3)
    t_img = torch.where(torch.isinf(t), 0.0, t).reshape(n, height, width)
    p = pos[:, None, None, :] + t_img[..., None] * view
    dpdx = torch.diff(p, dim=2, append=p[:, :, -1:])
    dpdy = torch.diff(p, dim=1, append=p[:, -1:])
    nrm = mmath.cross(dpdx, dpdy)
    nlen = torch.sqrt((nrm * nrm).sum(-1, keepdim=True))
    nrm = nrm / torch.clamp(nlen, min=1e-12)
    lambert = (nrm * view).sum(-1).abs()                  # light along the view
    shade = 0.35 + 0.65 * lambert

    parts = [m.geom_rgba[:, :3].to(dev, dtype)]
    parts += [marker.rgba[:3].to(dev, dtype)[None] for marker in markers]
    parts.append(torch.tensor([BACKGROUND], dtype=dtype, device=dev))
    albedo = torch.cat(parts)
    seg = seg_all.reshape(n, height, width)
    bg = seg < 0
    base = albedo[torch.where(bg, m.ngeom + len(markers), seg).long()]
    shade = torch.where(bg, 1.0, shade)
    rgb = torch.clamp(base * shade[..., None], 0.0, 1.0)
    return rgb, depth.reshape(n, height, width), seg
