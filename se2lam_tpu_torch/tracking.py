"""Per-frame tracking step as a plain function on tensors (port of
se2lam_tpu.tracking; reference Track::run / mTrack, src/Track.cpp:56-160).

ORB match against the reference keyframe, fundamental-matrix RANSAC gating,
odometry-predicted pose ("vision never moves the live pose",
src/Track.cpp:162-167), SE2 preintegration, per-match DLT triangulation
with depth/parallax gates, and the new-keyframe decision. The thread's
mutable members are an explicit ``TrackState`` threaded through
``track_frame``. All shapes are static (feature capacity N) and the step
reads nothing back to the host: only the caller reads ``need_kf``.

Chunked tracking (``track_chunk``) runs the step over a stack of frames
without reading anything back, for the chunked feeds of ``SlamSystem``;
``state_at_step`` gives the exact state after any step of it. The RANSAC
noise of every tracked frame comes from ``draw_track_noise``, which the
per-frame and the chunked and pipelined feeds all call, once a frame, in
frame order (``split_chain`` for a chunk): a replayed frame reuses its
noise, so every feed sees the same draws.
"""
from __future__ import annotations

import functools
from typing import NamedTuple

import numpy as np
import torch

from . import factors
from .config import SystemConfig
from .frontend.matcher import match_by_window
from .frontend.orb import OrbFeatures
from .frontend.ransac import draw_gumbel, ransac_fundamental
from .ops import se2, se3
from .ops.camera import CameraModel
from .ops.triangulate import check_parallax, triangulate

__all__ = [
    "TrackState", "TrackResult", "init_track_state", "track_frame", "constants",
    "draw_track_noise", "split_chain", "StepFields", "ChunkSteps", "state_at_step",
    "chunk_frame", "track_chunk",
]


class TrackState(NamedTuple):
    """The tracking thread's state between frames (Track.h members)."""

    ref_feats: OrbFeatures       # reference KF features (mRefFrame)
    ref_kf_idx: torch.Tensor     # () int32 — map slot of the reference KF
    ref_pose: torch.Tensor       # (3,) Twb of ref KF
    ref_odom: torch.Tensor       # (3,) raw odometry at ref KF
    ref_obs_mask: torch.Tensor   # (N,) bool — ref-KF features with an MP
    prev_matched: torch.Tensor   # (N, 2) predicted positions (mPrevMatched)
    local_mps: torch.Tensor      # (N, 3) ref-camera-frame estimates (mLocalMPs)
    local_mp_valid: torch.Tensor  # (N,) bool
    good_prl: torch.Tensor       # (N,) bool (mvbGoodPrl)
    n_good_prl: torch.Tensor     # () int32 (mnGoodPrl)
    pre_meas: torch.Tensor       # (3,) SE2 preintegration measurement
    pre_cov: torch.Tensor        # (3, 3) its covariance
    last_odom: torch.Tensor      # (3,)
    frames_since_kf: torch.Tensor  # () int32
    # last processed frame (for KF promotion)
    cur_feats: OrbFeatures
    cur_pose: torch.Tensor       # (3,) Twb odometry-predicted
    cur_odom: torch.Tensor       # (3,)
    match_idx: torch.Tensor      # (N,) int32 ref-feature → cur-feature


class TrackResult(NamedTuple):
    n_matched: torch.Tensor      # () int32 — inlier matches this frame
    n_tracked_old: torch.Tensor  # () int32 — matches onto existing MPs
    need_kf: torch.Tensor        # () bool
    pose: torch.Tensor           # (3,) current Twb


def init_track_state(
    feats: OrbFeatures, pose, odom, kf_idx, view_mp, obs_mask
) -> TrackState:
    """Reset after a KF insertion (Track::resetLocalTrack,
    src/Track.cpp:195-209): ref frame := current, mLocalMPs := KF view MPs,
    preintegration zeroed. Everything lands on ``feats``' device."""
    N = feats.xy.shape[0]
    dtype, dev = feats.xy.dtype, feats.xy.device

    def vec(v):
        return torch.as_tensor(v, dtype=dtype).to(dev)

    def scalar_i32(v):
        return torch.as_tensor(v, dtype=torch.int32).to(dev)

    return TrackState(
        ref_feats=feats,
        ref_kf_idx=scalar_i32(kf_idx),
        ref_pose=vec(pose),
        ref_odom=vec(odom),
        ref_obs_mask=obs_mask,
        prev_matched=feats.xy,
        local_mps=view_mp,
        local_mp_valid=obs_mask,
        good_prl=torch.zeros((N,), dtype=torch.bool, device=dev),
        n_good_prl=scalar_i32(0),
        pre_meas=torch.zeros((3,), dtype=dtype, device=dev),
        pre_cov=torch.zeros((3, 3), dtype=dtype, device=dev),
        last_odom=vec(odom),
        frames_since_kf=scalar_i32(0),
        cur_feats=feats,
        cur_pose=vec(pose),
        cur_odom=vec(odom),
        match_idx=torch.full((N,), -1, dtype=torch.int32, device=dev),
    )


@functools.lru_cache(maxsize=8)
def constants(cfg: SystemConfig, dev: torch.device):
    """The constant tensors of ``cfg`` on ``dev`` that tracking and mapping
    use, made once: a copy from the host each frame would wait for the
    device. numpy float64 constants become f32 before they meet a tensor.
    Read-only."""
    def const(a):
        return torch.from_numpy(np.asarray(a, np.float32)).to(dev)

    Kmat = const([[cfg.fx, 0.0, cfg.cx], [0.0, cfg.fy, cfg.cy], [0.0, 0.0, 1.0]])
    return dict(
        cam=CameraModel.create(cfg.fx, cfg.fy, cfg.cx, cfg.cy, cfg.dist, device=dev),
        Tcb=const(cfg.Tcb_mat),
        Tbc=const(cfg.Tbc_mat),
        Kmat=Kmat,
        # inv_ex: no host sync to check for singularity (K is invertible)
        Kinv=torch.linalg.inv_ex(Kmat).inverse,
        odo_noise=const([cfg.odo_x_noise, cfg.odo_y_noise, cfg.odo_t_noise]),
        level_sigma2=const(cfg.level_sigma2),
    )


def _gather_rows(x, idx):
    """x[clip(idx, 0)] for (N,) int32 indices that are −1 where unmatched."""
    return x[idx.clamp(min=0).long()]


def track_frame(
    ts: TrackState,
    feats: OrbFeatures,
    odom,
    cfg: SystemConfig,
    *,
    generator: torch.Generator | None = None,
    gumbel=None,
):
    """One tracking step. Returns (new TrackState, TrackResult).

    The RANSAC samples come from ``generator`` or from the drawn noise
    ``gumbel`` ((cfg.cap.ransac_trials, N)); exactly one is given.
    """
    dtype, dev = ts.ref_pose.dtype, ts.ref_pose.device
    c = constants(cfg, dev)
    Tcb, Tbc = c["Tcb"], c["Tbc"]
    N = ts.prev_matched.shape[0]

    # --- 1. window match vs reference KF (src/Track.cpp:131-132,
    #        winSize=20), around the previous positions warped by the
    #        odometry-predicted camera rotation (H = K R K⁻¹) so that
    #        rotation-dominant motion stays inside the window ---
    odom = torch.as_tensor(odom, dtype=dtype).to(dev)
    d_step = se2.minus(odom, ts.last_odom)
    Rcc = (Tcb @ se2.to_se3(se2.inv(d_step)) @ Tbc)[:3, :3]
    H = c["Kmat"] @ Rcc @ c["Kinv"]
    ones = torch.ones((N, 1), dtype=dtype, device=dev)
    ph = torch.cat([ts.prev_matched, ones], dim=1) @ H.T
    pred_xy = ph[:, :2] / torch.clamp(ph[:, 2:3], min=1e-6)

    wm = match_by_window(ts.ref_feats, feats, pred_xy, win_size=20.0, nn_ratio=0.9)
    midx = wm.idx2

    # --- 2. fundamental RANSAC outlier gate (removeOutliers,
    #        src/Track.cpp:308-344) ---
    matched = midx >= 0
    fr = ransac_fundamental(
        ts.ref_feats.xy, _gather_rows(feats.xy, midx), matched,
        n_trials=cfg.cap.ransac_trials, thresh_px=3.0, min_inliers=10,
        generator=generator, gumbel=gumbel,
    )
    minus_one = torch.full_like(midx, -1)
    midx = torch.where(fr.inliers, midx, minus_one)
    n_matched = fr.n_inliers

    # keep predicted positions fresh for the next window search
    prev_matched = torch.where(
        (midx >= 0)[:, None], _gather_rows(feats.xy, midx), ts.prev_matched
    )

    # --- 3. odometry-predicted pose + SE2 preintegration
    #        (updateFramePose, src/Track.cpp:162-188) ---
    pose = se2.compose(ts.ref_pose, se2.minus(odom, ts.ref_odom))
    d_odo = se2.minus(odom, ts.last_odom)
    pre_meas, pre_cov = factors.preintegrate_se2(
        ts.pre_meas, ts.pre_cov, d_odo, c["odo_noise"]
    )

    # --- 4. triangulation + parallax (doTriangulate,
    #        src/Track.cpp:378-419); Tcr: ref camera → current camera from
    #        odometry only ---
    d_ref = se2.minus(ts.ref_odom, odom)  # mpKF->odom - mFrame.odom
    Tcr = Tcb @ se2.to_se3(d_ref) @ Tbc
    K3 = c["cam"].K
    P_ref = torch.cat([K3, torch.zeros((3, 1), dtype=K3.dtype, device=dev)], dim=1)
    P_cur = K3 @ Tcr[:3, :]

    pos = triangulate(
        ts.ref_feats.xy, _gather_rows(feats.xy, midx), P_ref[None], P_cur[None]
    )  # (N, 3)
    depth_ok = cfg.accept_depth(pos[..., 2])

    o_cur = se3.inv(Tcr)[:3, 3]
    prl_ok = check_parallax(torch.zeros(3, dtype=pos.dtype, device=dev), o_cur, pos, 2)

    do_tri = ts.frames_since_kf + 1 >= cfg.min_frames_between_kf
    is_new = (midx >= 0) & (~ts.ref_obs_mask) & do_tri
    tracked_old = (midx >= 0) & ts.ref_obs_mask & do_tri

    new_ok = is_new & depth_ok
    local_mps = torch.where(new_ok[:, None], pos, ts.local_mps)
    local_mp_valid = ts.local_mp_valid | new_ok
    good_prl = torch.where(new_ok, prl_ok, ts.good_prl)
    # depth-gate failures drop the match (src/Track.cpp:414-416)
    midx = torch.where(is_new & ~depth_ok, minus_one, midx)
    n_tracked_old = tracked_old.sum(dtype=torch.int32)
    # the KF gate counts THIS frame's good-parallax triangulations
    # (the reference resets mnGoodPrl every frame, src/Track.cpp:386-388);
    # the per-feature flags stay latest-wins for minting at KF time
    n_good_prl = (new_ok & prl_ok).sum(dtype=torch.int32)

    # --- 5. new-KF decision (needNewKF, src/Track.cpp:346-376) ---
    frames = ts.frames_since_kf + 1
    n_old_kp = ts.ref_obs_mask.sum(dtype=torch.int32)
    c0 = frames > cfg.min_frames_between_kf
    c1 = n_tracked_old.to(torch.float32) <= 0.5 * n_old_kp.to(torch.float32)
    c2 = n_good_prl > 40
    c3 = frames > cfg.max_frames_between_kf
    c4 = (n_matched < 0.1 * cfg.max_feature_num) | (n_matched < 20)
    need = c0 & ((c1 & c2) | c3 | c4)

    d_kf = se2.minus(odom, ts.ref_odom)
    c5 = d_kf[2].abs() >= 0.0349  # ≥ 2°
    cTc = Tcb @ se2.to_se3(d_kf) @ Tbc
    c6 = torch.linalg.norm(cTc[:3, 3]) >= 0.0523 * cfg.upper_depth * 0.1
    need = need & (c5 | c6)

    new_ts = ts._replace(
        prev_matched=prev_matched,
        local_mps=local_mps,
        local_mp_valid=local_mp_valid,
        good_prl=good_prl,
        n_good_prl=n_good_prl,
        pre_meas=pre_meas,
        pre_cov=pre_cov,
        last_odom=odom,
        frames_since_kf=frames,
        cur_feats=feats,
        cur_pose=pose,
        cur_odom=odom,
        match_idx=midx,
    )
    return new_ts, TrackResult(
        n_matched=n_matched,
        n_tracked_old=n_tracked_old,
        need_kf=need,
        pose=pose,
    )


def draw_track_noise(generator: torch.Generator, cfg: SystemConfig):
    """One tracked frame's RANSAC noise, (ransac_trials, N) f32 from
    ``generator`` on its device: the draw ``track_frame`` would make."""
    return draw_gumbel(generator, (cfg.cap.ransac_trials, cfg.cap.n_features))


def split_chain(draw, n: int):
    """``n`` frames' RANSAC noise, (n, ransac_trials, N): ``draw()`` called
    once a frame, in frame order, as ``n`` per-frame steps would call it
    (the counterpart of the JAX package's key chain)."""
    return torch.stack([draw() for _ in range(n)])


class StepFields(NamedTuple):
    """TrackState's fields that a tracking step changes, besides
    ``cur_feats`` (the JAX package's ``ChunkSteps`` fields)."""

    prev_matched: torch.Tensor
    local_mps: torch.Tensor
    local_mp_valid: torch.Tensor
    good_prl: torch.Tensor
    n_good_prl: torch.Tensor
    pre_meas: torch.Tensor
    pre_cov: torch.Tensor
    last_odom: torch.Tensor
    frames_since_kf: torch.Tensor
    cur_pose: torch.Tensor
    cur_odom: torch.Tensor
    match_idx: torch.Tensor


def _step_fields(ts: TrackState) -> StepFields:
    return StepFields(*(getattr(ts, k) for k in StepFields._fields))


class ChunkSteps(list):
    """Per-step records of ``track_chunk``: entry j is step j's
    ``StepFields`` (references to the step's own tensors, nothing copied),
    or None where step j was not run."""


def state_at_step(ts0: TrackState, cur_feats: OrbFeatures, steps: ChunkSteps,
                  j: int) -> TrackState:
    """The exact TrackState after chunk step ``j``: ``ts0`` gives the
    reference-keyframe block (constant within a segment, which a keyframe
    insertion ends), ``cur_feats`` the step's own features."""
    return ts0._replace(cur_feats=cur_feats, **steps[j]._asdict())


def chunk_frame(feats_stack: OrbFeatures, i: int) -> OrbFeatures:
    """Frame ``i`` of features with a leading chunk axis (views)."""
    return OrbFeatures(*(a[i] for a in feats_stack))


def track_chunk(ts: TrackState, feats_stack: OrbFeatures, odo_stack, noise, start: int,
                stop: int, cfg: SystemConfig):
    """Track the frames ``start..stop-1`` of a chunk speculatively (no
    keyframe insertion), reading nothing back: ``track_frame`` on each
    frame's features (leading chunk axis k), odometry (k, 3) and noise
    (k, ransac_trials, N), the state carried from step to step. Steps
    outside [start, stop) are not run and report need_kf False and a zero
    pose. Returns (final TrackState, (k,) need_kf, (k, 3) poses,
    ChunkSteps). The caller reads the decisions once and, where a keyframe
    fired at step j, rebuilds the state there with ``state_at_step`` and
    replays the frames after it from the new keyframe."""
    k = odo_stack.shape[0]
    dev = ts.ref_pose.device
    needs = [torch.zeros((), dtype=torch.bool, device=dev)] * k
    poses = [torch.zeros(3, dtype=ts.ref_pose.dtype, device=dev)] * k
    steps = ChunkSteps([None] * k)
    for i in range(start, stop):
        ts, res = track_frame(ts, chunk_frame(feats_stack, i), odo_stack[i], cfg, gumbel=noise[i])
        needs[i], poses[i], steps[i] = res.need_kf, res.pose, _step_fields(ts)
    return ts, torch.stack(needs), torch.stack(poses), steps
