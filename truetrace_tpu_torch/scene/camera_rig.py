"""Camera controllers and animation rigs.

Port of `truetrace_tpu/scene/camera_rig.py` (the reference's FlyCamera
behaviour, TrueTrace/Utility/FlyCamera.cs, and its demo camera
animations). A render server has no input loop, so the controllers are
programmatic: a FlyCamera that takes move and look commands and yields
Cameras, and orbit and Catmull-Rom spline paths that make a camera a
frame. The numbers are numpy float32 as in the JAX package, so a camera
is its JAX counterpart bit for bit; the Cameras are built on `device`.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Sequence, Tuple

import numpy as np

from truetrace_tpu_torch.scene.ir import Camera


@dataclass
class FlyCamera:
    """Stateful fly camera: position and yaw / pitch, Unity-style
    controls (FlyCamera.cs). `move` is in the camera's local frame
    (x strafe, y up, z forward); `look` turns by yaw (around world +y),
    then pitch."""
    position: np.ndarray = field(
        default_factory=lambda: np.zeros(3, np.float32))
    yaw: float = 0.0            # radians, 0 = looking down -z
    pitch: float = 0.0          # radians, + looks up
    fov_y_deg: float = 40.0
    aperture: float = 0.0
    focus_dist: float = 1.0
    speed: float = 1.0

    def _basis(self) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
        cy, sy = np.cos(self.yaw), np.sin(self.yaw)
        cp, sp = np.cos(self.pitch), np.sin(self.pitch)
        fwd = np.array([-sy * cp, sp, -cy * cp], np.float32)
        right = np.array([cy, 0.0, -sy], np.float32)
        up = np.cross(right, fwd)
        return right, up, fwd

    def look(self, d_yaw: float = 0.0, d_pitch: float = 0.0) -> "FlyCamera":
        self.yaw = float(self.yaw + d_yaw)
        # clamped as the reference does (no gimbal flip)
        self.pitch = float(np.clip(self.pitch + d_pitch,
                                   -0.49 * np.pi, 0.49 * np.pi))
        return self

    def move(self, strafe: float = 0.0, up: float = 0.0,
             forward: float = 0.0) -> "FlyCamera":
        r, u, f = self._basis()
        self.position = (self.position
                         + self.speed * (strafe * r + up * u + forward * f)
                         ).astype(np.float32)
        return self

    def camera(self, device="cuda") -> Camera:
        _, _, fwd = self._basis()
        return Camera.look_at(eye=self.position, target=self.position + fwd,
                              fov_y_deg=self.fov_y_deg,
                              aperture=self.aperture,
                              focus_dist=self.focus_dist, device=device)


def orbit_path(center, radius: float, height: float, n_frames: int,
               fov_y_deg: float = 40.0, revolutions: float = 1.0,
               device="cuda") -> list:
    """Turntable: n_frames cameras orbiting `center` at the given radius
    and height, each looking at the center (the reference's demo
    shots)."""
    center = np.asarray(center, np.float32)
    cams = []
    for i in range(n_frames):
        a = 2.0 * np.pi * revolutions * i / max(n_frames, 1)
        eye = center + np.array([radius * np.sin(a), height,
                                 radius * np.cos(a)], np.float32)
        cams.append(Camera.look_at(eye=eye, target=center,
                                   fov_y_deg=fov_y_deg, device=device))
    return cams


def _catmull_rom(p0, p1, p2, p3, t):
    t2, t3 = t * t, t * t * t
    return 0.5 * ((2 * p1) + (-p0 + p2) * t
                  + (2 * p0 - 5 * p1 + 4 * p2 - p3) * t2
                  + (-p0 + 3 * p1 - 3 * p2 + p3) * t3)


def spline_path(waypoints: Sequence, targets: Sequence, n_frames: int,
                fov_y_deg: float = 40.0, device="cuda") -> list:
    """Fly-through: a Catmull-Rom spline through `waypoints`, the camera
    aimed along the same spline through `targets`. The end knots are
    doubled (a clamped spline)."""
    wp = [np.asarray(w, np.float32) for w in waypoints]
    tg = [np.asarray(t, np.float32) for t in targets]
    if len(wp) < 2 or len(tg) != len(wp):
        raise ValueError("spline_path needs >= 2 waypoints and one target "
                         "each")
    wp = [wp[0]] + wp + [wp[-1]]
    tg = [tg[0]] + tg + [tg[-1]]
    n_seg = len(wp) - 3
    cams = []
    for i in range(n_frames):
        s = (i / max(n_frames - 1, 1)) * n_seg
        k = min(int(s), n_seg - 1)
        t = s - k
        eye = _catmull_rom(wp[k], wp[k + 1], wp[k + 2], wp[k + 3], t)
        at = _catmull_rom(tg[k], tg[k + 1], tg[k + 2], tg[k + 3], t)
        cams.append(Camera.look_at(eye=eye, target=at, fov_y_deg=fov_y_deg,
                                   device=device))
    return cams
