"""Camera matrices (numpy, host-side set-up; a copy of
avatarcap_tpu/render/camera.py): the canonical orthographic pair, the
perspective projection, and the model-views of the live previews.

GL conventions: row-major (4, 4) matrices; the back view is the front
view rotated pi about y around the mesh center.
"""

from __future__ import annotations

import math

import numpy as np


def _rot_x(angle):
    c, s = math.cos(angle), math.sin(angle)
    m = np.identity(4, np.float32)
    m[1, 1], m[1, 2], m[2, 1], m[2, 2] = c, -s, s, c
    return m


def _rot_y(angle):
    c, s = math.cos(angle), math.sin(angle)
    m = np.identity(4, np.float32)
    m[0, 0], m[0, 2], m[2, 0], m[2, 2] = c, s, -s, c
    return m


def gl_orthographic_projection_matrix(far=-100.0, near=-0.1):
    """Unit-scale x/y ortho window."""
    proj = np.zeros((4, 4), np.float32)
    proj[0, 0] = 1.0
    proj[1, 1] = 1.0
    proj[2, 2] = 2 / (far - near)
    proj[2, 3] = -(far + near) / (far - near)
    proj[3, 3] = 1.0
    return proj


def cano_front_back_mvp(mesh_center: np.ndarray):
    """Front/back orthographic canonical (mvp, mv) pairs:
    returns (front_mvp, front_mv, back_mvp, back_mv)."""
    proj = gl_orthographic_projection_matrix()
    front_mv = np.identity(4, np.float32)
    front_mv[:3, 3] = -mesh_center
    front_mv[2, 3] -= 10

    trans_cen = np.identity(4, np.float32)
    trans_cen[:3, 3] = -mesh_center
    trans_z = np.identity(4, np.float32)
    trans_z[2, 3] = -10
    back_mv = trans_z @ _rot_y(math.pi) @ trans_cen
    return proj @ front_mv, front_mv, proj @ back_mv, back_mv


def gl_perspective_projection_matrix(fx, fy, cx, cy, img_w, img_h,
                                     far=100.0, near=0.1, gl_space=False):
    """Perspective projection of a pinhole camera; by default the model is
    in real camera space (+z forward, y down)."""
    proj = np.zeros((4, 4), np.float32)
    proj[0, 0] = 2 * fx / img_w
    proj[0, 2] = (2 * cx - img_w) / img_w
    proj[1, 1] = -2 * fy / img_h
    proj[1, 2] = (img_h - 2 * cy) / img_h
    proj[2, 2] = (far + near) / (far - near)
    proj[2, 3] = 2 * near * far / (near - far)
    proj[3, 2] = 1.0
    if gl_space:
        real2gl = np.identity(4, np.float32)
        real2gl[1, 1] = -1
        real2gl[2, 2] = -1
        proj = proj @ real2gl
    return proj


def calc_front_mv(mesh_vertices: np.ndarray, rot_x_angle=0.0,
                  rot_y_angle=0.0):
    """Model-view looking at the mesh's box center from 20 units in front
    (the reference's utils/visualize_util.py:55-71)."""
    center = 0.5 * (mesh_vertices.max(0) + mesh_vertices.min(0))
    T0 = np.identity(4, np.float32)
    T0[:3, 3] = -center
    T0 = _rot_x(rot_x_angle) @ T0
    T0 = _rot_y(rot_y_angle) @ T0
    T2 = np.identity(4, np.float32)
    T2[2, 3] = 20
    return T2 @ T0


def calc_back_mv(mesh_vertices: np.ndarray, rot_x_angle=0.0):
    """calc_front_mv's view turned pi about y (the reference's
    utils/visualize_util.py:74-87)."""
    center = 0.5 * (mesh_vertices.max(0) + mesh_vertices.min(0))
    T0 = np.identity(4, np.float32)
    T0[:3, 3] = -center
    T0 = _rot_x(rot_x_angle) @ T0
    T1 = _rot_y(math.pi)
    T2 = np.identity(4, np.float32)
    T2[2, 3] = 20
    return T2 @ T1 @ T0


def real2gl_matrix():
    """Rotation by pi about x: real camera (y down, z forward) -> GL
    camera."""
    return _rot_x(math.pi)
