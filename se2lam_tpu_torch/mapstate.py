"""Fixed-capacity, struct-of-arrays SLAM map state (port of
se2lam_tpu.mapstate; reference Map/KeyFrame/MapPoint, src/Map.cpp,
src/KeyFrame.cpp, src/MapPoint.cpp).

The whole map is one NamedTuple of padded tensors with validity masks.
Field names, shapes and dtypes are those of the JAX package's
``MapState``, so the npz maps its ``io/mapstorage.py`` writes carry over
field by field. The port's mapping functions return new states; where
they write in place, the docstring says so.

- ``kf_*``      ⇔ KeyFrame fields (pose, keypoints, descriptors, view
                  estimates, observation row, preintegration to the next KF)
- ``mp_*``      ⇔ MapPoint fields (position, descriptor, normal, parallax
                  flag, observer list)
- ``covis``     ⇔ covisibility sets
- ``ftr_*``     ⇔ feature/loop SE2 constraints (written by loop closing)
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from .config import Capacity
from .device import resolve_device
from .ops import fixed_order, se2, se3

__all__ = ["MapState", "empty_map", "kf_Tcw", "MAX_FTR_EDGES"]

MAX_FTR_EDGES = 256  # feature/loop constraint slots (≈ one per KF slot)


class MapState(NamedTuple):
    # --- keyframes (capacity K, features-per-KF N) ---
    kf_pose: torch.Tensor       # (K, 3) Twb SE2
    kf_odom: torch.Tensor       # (K, 3) raw odometry reading at KF time
    kf_valid: torch.Tensor      # (K,) bool
    kf_xy: torch.Tensor         # (K, N, 2) undistorted level-0 keypoint px
    kf_octave: torch.Tensor     # (K, N) int32
    kf_angle: torch.Tensor      # (K, N) float32
    kf_feat_valid: torch.Tensor  # (K, N) bool
    kf_desc: torch.Tensor       # (K, N, 256) int8 ±1 descriptors
    kf_obs_mp: torch.Tensor     # (K, N) int32 — MP index per feature, -1 none
    kf_view_mp: torch.Tensor    # (K, N, 3) camera-frame point estimate
    kf_view_info: torch.Tensor  # (K, N, 3, 3) its 3x3 information

    kf_pre_next: torch.Tensor   # (K,) int32 — next KF in odo chain, -1 none
    kf_pre_meas: torch.Tensor   # (K, 3) preintegrated SE2 measurement to next
    kf_pre_cov: torch.Tensor    # (K, 3, 3) its covariance

    covis: torch.Tensor         # (K, K) bool symmetric covisibility

    ftr_i: torch.Tensor         # (F,) int32 from-KF
    ftr_j: torch.Tensor         # (F,) int32 to-KF
    ftr_meas: torch.Tensor      # (F, 3) relative SE2 (j in i frame)
    ftr_info: torch.Tensor      # (F, 3, 3)
    ftr_valid: torch.Tensor     # (F,) bool

    # --- map points (capacity M, obs fan-in P) ---
    mp_pos: torch.Tensor        # (M, 3) world position
    mp_valid: torch.Tensor      # (M,) bool
    mp_good_prl: torch.Tensor   # (M,) bool — parallax gate
    mp_desc: torch.Tensor       # (M, 256) int8 ±1 main descriptor
    mp_desc_votes: torch.Tensor  # (M, 256) int16 running ±1 bit votes
    mp_normal: torch.Tensor     # (M, 3) mean viewing direction
    mp_main_kf: torch.Tensor    # (M,) int32
    mp_main_feat: torch.Tensor  # (M,) int32
    mp_main_octave: torch.Tensor  # (M,) int32
    mp_min_dist: torch.Tensor   # (M,) view-distance gates
    mp_max_dist: torch.Tensor   # (M,)
    mp_obs_kf: torch.Tensor     # (M, P) int32, -1 empty
    mp_obs_feat: torch.Tensor   # (M, P) int32
    mp_n_obs: torch.Tensor      # (M,) int32

    n_kf: torch.Tensor          # () int32
    n_mp: torch.Tensor          # () int32

    @property
    def K(self):
        return self.kf_pose.shape[0]

    @property
    def M(self):
        return self.mp_pos.shape[0]

    @property
    def N(self):
        return self.kf_xy.shape[1]


def empty_map(cap: Capacity, device=None, dtype=torch.float32) -> MapState:
    """An empty map at capacity ``cap`` on ``device`` (None means CUDA)."""
    dev = resolve_device(device)
    K, M, N, P = cap.max_kfs, cap.max_mps, cap.n_features, cap.max_obs_per_mp
    F = MAX_FTR_EDGES
    i32 = torch.int32

    def z(shape, dt=dtype):
        return torch.zeros(shape, dtype=dt, device=dev)

    def full(shape, v, dt=i32):
        return torch.full(shape, v, dtype=dt, device=dev)

    return MapState(
        kf_pose=z((K, 3)),
        kf_odom=z((K, 3)),
        kf_valid=z((K,), torch.bool),
        kf_xy=z((K, N, 2)),
        kf_octave=z((K, N), i32),
        kf_angle=z((K, N)),
        kf_feat_valid=z((K, N), torch.bool),
        kf_desc=z((K, N, 256), torch.int8),
        kf_obs_mp=full((K, N), -1),
        kf_view_mp=z((K, N, 3)),
        kf_view_info=z((K, N, 3, 3)),
        kf_pre_next=full((K,), -1),
        kf_pre_meas=z((K, 3)),
        kf_pre_cov=z((K, 3, 3)),
        covis=z((K, K), torch.bool),
        ftr_i=full((F,), -1),
        ftr_j=full((F,), -1),
        ftr_meas=z((F, 3)),
        ftr_info=z((F, 3, 3)),
        ftr_valid=z((F,), torch.bool),
        mp_pos=z((M, 3)),
        mp_valid=z((M,), torch.bool),
        mp_good_prl=z((M,), torch.bool),
        mp_desc=z((M, 256), torch.int8),
        mp_desc_votes=z((M, 256), torch.int16),
        mp_normal=z((M, 3)),
        mp_main_kf=full((M,), -1),
        mp_main_feat=full((M,), -1),
        mp_main_octave=z((M,), i32),
        mp_min_dist=z((M,)),
        mp_max_dist=full((M,), float("inf"), dtype),
        mp_obs_kf=full((M, P), -1),
        mp_obs_feat=full((M, P), -1),
        mp_n_obs=z((M,), i32),
        n_kf=full((), 0),
        n_mp=full((), 0),
    )


def kf_Tcw(pose_se2, Tcb):
    """World→camera 4x4 from a body SE2 pose: Tcw = Tcb · (Twb)⁻¹
    (reference KeyFrame::setPose, src/KeyFrame.cpp:183-193). Batched
    over leading axes of ``pose_se2``."""
    return fixed_order.matmul(Tcb, se3.inv(se2.to_se3(pose_se2)))
