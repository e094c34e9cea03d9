"""Frozen copy of avatarcap_tpu_torch/body/smpl.py at commit 2621afd, the f32 reference path of the benchmark.

SMPL forward kinematics + LBS (counterpart of avatarcap_tpu/body/smpl.py:
``SmplParams`` with its pkl reader, ``smpl_forward``,
``smpl_forward_batch``, ``canonical_pose``).

Pose layout: 75-d = [trans (3), 24 x axis-angle (3)]. Joint 0's local
translation is the global translation, not t + (I - R) j0 (a reference
quirk kept on purpose).
"""

from __future__ import annotations

import dataclasses
import math
import pickle
from typing import NamedTuple

import numpy as np
import torch

from benchmark.reference.se3 import axis_angle_to_matrix


@dataclasses.dataclass(frozen=True)
class SmplParams:
    """Static body-model data."""

    v_template: np.ndarray       # (V, 3)
    faces: np.ndarray            # (F, 3) int32
    joints_template: np.ndarray  # (J, 3)
    kintree_parents: np.ndarray  # (J,) int32
    weights: np.ndarray          # (V, J)
    j_regressor: np.ndarray      # (J, V)
    shapedirs: np.ndarray        # (V*3, S)

    @property
    def num_vertices(self) -> int:
        return self.v_template.shape[0]

    @property
    def num_joints(self) -> int:
        return self.weights.shape[1]

    @staticmethod
    def load(pkl_path: str) -> "SmplParams":
        """Read an official SMPL pkl (latin1; the sparse J_regressor made
        dense)."""
        with open(pkl_path, "rb") as f:
            data = pickle.load(f, encoding="latin1")
        j_reg = data["J_regressor"]
        if hasattr(j_reg, "toarray"):
            j_reg = j_reg.toarray()
        v_template = np.asarray(data["v_template"], np.float32)
        vnum = v_template.shape[0]
        return SmplParams(
            v_template=v_template,
            faces=np.asarray(data["f"], np.int32),
            joints_template=np.asarray(data["J"], np.float32),
            kintree_parents=np.asarray(data["kintree_table"], np.int64)
            .T[:, 0].astype(np.int32),
            weights=np.asarray(data["weights"], np.float32),
            j_regressor=np.asarray(j_reg, np.float32),
            shapedirs=np.asarray(data["shapedirs"], np.float32)
            .reshape(vnum * 3, -1),
        )


class SmplOutput(NamedTuple):
    vertices: torch.Tensor         # (V, 3) posed vertices
    joints: torch.Tensor           # (J, 3) posed joints
    jnt_affine_mats: torch.Tensor  # (J, 4, 4)
    vertex_affine_mats: torch.Tensor  # (V, 4, 4)
    shaped_vertices: torch.Tensor  # (V, 3)
    shaped_joints: torch.Tensor    # (J, 3)


def canonical_pose(num_joints: int = 24,
                   leg_angle_deg: float = 25.0) -> np.ndarray:
    """Zero pose with the legs spread +-25 deg about z."""
    pose = np.zeros(3 + 3 * num_joints, np.float32)
    pose[3 + 3 * 1 + 2] = math.radians(leg_angle_deg)
    pose[3 + 3 * 2 + 2] = math.radians(-leg_angle_deg)
    return pose


def smpl_forward(params: SmplParams, pose: torch.Tensor,
                 shape: torch.Tensor) -> SmplOutput:
    """Shape blend, joint regression, kinematic chain and LBS for one
    (75,) pose and (S,) shape, on the pose tensor's device."""
    dev = pose.device
    J = params.num_joints

    def t(a):
        return torch.as_tensor(np.asarray(a, np.float32), device=dev)

    parents = np.asarray(params.kintree_parents)
    shaped = (t(params.v_template).reshape(-1)
              + t(params.shapedirs) @ shape).reshape(-1, 3)
    joints = t(params.j_regressor) @ shaped                  # (J, 3)
    rots = axis_angle_to_matrix(pose[3:].reshape(J, 3))      # (J, 3, 3)
    t_local = joints - torch.einsum("jab,jb->ja", rots, joints)
    t_local = torch.cat([pose[None, :3], t_local[1:]], dim=0)
    local = torch.zeros((J, 4, 4), dtype=pose.dtype, device=dev)
    local[:, :3, :3] = rots
    local[:, :3, 3] = t_local
    local[:, 3, 3] = 1.0
    mats = [local[0]]
    for j in range(1, J):
        mats.append(mats[int(parents[j])] @ local[j])
    jnt_mats = torch.stack(mats)
    posed_joints = (torch.einsum("jab,jb->ja", jnt_mats[:, :3, :3], joints)
                    + jnt_mats[:, :3, 3])
    vert_mats = torch.einsum("vj,jab->vab", t(params.weights), jnt_mats)
    posed = (torch.einsum("vab,vb->va", vert_mats[:, :3, :3], shaped)
             + vert_mats[:, :3, 3])
    return SmplOutput(posed, posed_joints, jnt_mats, vert_mats, shaped,
                      joints)


def smpl_forward_batch(params: SmplParams, poses: torch.Tensor,
                       shape: torch.Tensor) -> SmplOutput:
    """smpl_forward of each of (B, 75) poses with one (S,) shape; every
    field gains a leading batch axis."""
    outs = [smpl_forward(params, pose, shape) for pose in poses]
    return SmplOutput(*(torch.stack(field) for field in zip(*outs)))
