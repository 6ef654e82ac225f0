"""A seeded synthetic robot workcell: a floor slab and scattered spheres in a
5.12 m cube, seen by depth cameras. The smoke test and the benchmarks build
their scenes from it; depth points come from exact ray casting against the
analytic surfaces, so no mesh or sensor model is involved."""

from __future__ import annotations

import dataclasses
from typing import List

import numpy as np

EXTENT_M = 5.12          # grid edge length; 512 voxels at 1 cm


def look_at(eye, target) -> np.ndarray:
    """World-from-camera pose, +z forward, +x right, +y down."""
    eye = np.asarray(eye, np.float64)
    fwd = np.asarray(target, np.float64) - eye
    fwd /= np.linalg.norm(fwd)
    up = np.array([0.0, 0.0, 1.0])
    if abs(fwd @ up) > 0.999:
        up = np.array([0.0, 1.0, 0.0])
    right = np.cross(fwd, up)
    right /= np.linalg.norm(right)
    down = np.cross(fwd, right)
    pose = np.eye(4)
    pose[:3, :3] = np.stack([right, down, fwd], axis=1)
    pose[:3, 3] = eye
    return pose.astype(np.float32)


@dataclasses.dataclass(frozen=True)
class WorkcellScene:
    """A floor slab and spheres in a cube of edge ``EXTENT_M``; the grid
    frame is the world frame. Spheres keep clear of a 1 m cylinder over the
    middle of the floor, which the inspection camera looks down into."""
    n: int
    resolution: float
    floor_top: float        # metres; half a voxel above a voxel boundary
    centers: np.ndarray     # [S, 3] metres
    radii: np.ndarray       # [S] metres

    CLEAR_RADIUS = 1.0

    @staticmethod
    def make(n: int, seed: int, num_spheres: int = 14) -> "WorkcellScene":
        res = EXTENT_M / n
        rng = np.random.default_rng(seed)
        mid = EXTENT_M / 2.0
        centers, radii = [], []
        while len(centers) < num_spheres:
            c = rng.uniform(0.15, 0.85, 3) * EXTENT_M
            r = rng.uniform(0.2, 0.6)
            if np.hypot(c[0] - mid, c[1] - mid) > r + WorkcellScene.CLEAR_RADIUS:
                centers.append(c)
                radii.append(r)
        floor_voxels = max(1, round(0.24 / res))
        return WorkcellScene(n, res, (floor_voxels + 0.5) * res,
                             np.asarray(centers), np.asarray(radii))

    def mask(self) -> np.ndarray:
        """``[n, n, n]`` bool: voxel centres inside the floor or a sphere."""
        ax = (np.arange(self.n) + 0.5) * self.resolution
        xs, ys, zs = np.meshgrid(ax, ax, ax, indexing="ij", sparse=True)
        filled = np.broadcast_to(zs < self.floor_top, (self.n,) * 3).copy()
        for c, r in zip(self.centers, self.radii):
            filled |= ((xs - c[0]) ** 2 + (ys - c[1]) ** 2
                       + (zs - c[2]) ** 2) <= r * r
        return filled

    def camera_poses(self) -> List[np.ndarray]:
        """Four cameras outside the grid, one on each side, looking down at
        the middle of the workcell."""
        mid = EXTENT_M / 2.0
        poses = []
        for a in (0.0, 0.5 * np.pi, np.pi, 1.5 * np.pi):
            eye = (mid + 3.8 * np.cos(a), mid + 3.8 * np.sin(a), 5.0)
            poses.append(look_at(eye, (mid, mid, 0.8)))
        return poses

    def inspection_pose(self) -> np.ndarray:
        """A camera 1 m above the middle of the floor, looking straight
        down into the sphere-free cylinder: it sees only floor."""
        mid = EXTENT_M / 2.0
        return look_at((mid, mid, self.floor_top + 1.0),
                       (mid, mid, self.floor_top))

    def depth_points(self, pose: np.ndarray, width: int, height: int,
                     focal: float) -> np.ndarray:
        """Camera-frame points where the pixel rays first meet the floor
        (inside the grid) or a sphere; pixels that meet nothing give no
        point. Exact ray casting against the analytic surfaces."""
        u, v = np.meshgrid(np.arange(width), np.arange(height), indexing="xy")
        d_cam = np.stack([(u - (width - 1) / 2.0) / focal,
                          (v - (height - 1) / 2.0) / focal,
                          np.ones(u.shape)], -1).reshape(-1, 3)
        d_cam /= np.linalg.norm(d_cam, axis=-1, keepdims=True)
        pose = pose.astype(np.float64)
        d = d_cam @ pose[:3, :3].T
        o = pose[:3, 3]
        t = np.full(d.shape[0], np.inf)
        with np.errstate(divide="ignore", invalid="ignore"):
            t_floor = (self.floor_top - o[2]) / d[:, 2]
        hit_xy = o[:2] + t_floor[:, None] * d[:, :2]
        on_floor = ((t_floor > 0) & np.all(hit_xy >= 0.0, axis=-1)
                    & np.all(hit_xy <= EXTENT_M, axis=-1))
        t = np.where(on_floor, t_floor, t)
        for c, r in zip(self.centers, self.radii):
            oc = o - c
            b = d @ oc
            disc = b * b - (oc @ oc - r * r)
            t_s = -b - np.sqrt(np.maximum(disc, 0.0))
            t = np.where((disc > 0) & (t_s > 0) & (t_s < t), t_s, t)
        keep = np.isfinite(t)
        return (d_cam[keep] * t[keep, None]).astype(np.float32)
