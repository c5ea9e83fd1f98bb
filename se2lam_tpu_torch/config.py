"""Typed system configuration (the port's own copy of se2lam_tpu.config,
which the port may not import; keep the two in step).

Replacement for the reference's ~50 static globals read from two
OpenCV ``FileStorage`` YAML files (reference: src/Config.cpp:83-186,
include/se2lam/Config.h). Same key names are honored — including the
load-bearing typo ``scale_facotr`` (src/Config.cpp:137) — but the result is
an immutable dataclass passed explicitly, not process-wide mutable statics.

Also holds the *capacity plan*: the fixed array sizes that make every stage
compile to static shapes (keyframe / map-point / local-window capacities).
"""
from __future__ import annotations

import dataclasses
import re
from dataclasses import dataclass, field

import numpy as np

__all__ = ["Capacity", "SystemConfig", "read_cv_yaml"]


# ---------------------------------------------------------------------------
# OpenCV FileStorage YAML reader (no opencv dependency)
# ---------------------------------------------------------------------------

def read_cv_yaml(path: str) -> dict:
    """Parse an OpenCV FileStorage YAML file into a flat dict.

    Supports scalars and ``!!opencv-matrix`` nodes (returned as float64
    ndarrays). This covers everything the reference reads
    (src/Config.cpp:83-186: CamConfig.yml / Settings.yml).
    """
    with open(path) as f:
        text = f.read()
    # strip directives/comments
    lines = []
    for ln in text.splitlines():
        if ln.startswith("%YAML") or ln.strip() == "---":
            continue
        # strip trailing comments, but never inside a quoted scalar
        # (`path: "/data/run #3"` must survive intact)
        if '"' in ln or "'" in ln:
            out_chars, quote = [], None
            for ch in ln:
                if quote is None and ch in "\"'":
                    quote = ch
                elif quote == ch:
                    quote = None
                elif quote is None and ch == "#" and (
                    not out_chars or out_chars[-1].isspace()
                ):
                    break
                out_chars.append(ch)
            ln = "".join(out_chars)
        else:
            ln = re.sub(r"(^|\s)#.*$", "", ln)
        if ln.strip():
            lines.append(ln)

    out: dict = {}
    i = 0
    while i < len(lines):
        m = re.match(r"^(\w[\w.]*)\s*:\s*(.*)$", lines[i])
        if not m:
            i += 1
            continue
        key, rest = m.group(1), m.group(2).strip()
        if rest.startswith("!!opencv-matrix") or rest == "":
            # matrix node: rows / cols / dt / data over following lines
            block = {}
            i += 1
            data_txt = ""
            in_data = False
            while i < len(lines):
                ln = lines[i]
                if re.match(r"^\w[\w.]*\s*:", ln) and not ln.startswith(" "):
                    break
                sm = re.match(r"^\s+(rows|cols|dt)\s*:\s*(\S+)", ln)
                if sm:
                    block[sm.group(1)] = sm.group(2)
                    i += 1
                    continue
                dm = re.match(r"^\s+data\s*:\s*(.*)$", ln)
                if dm:
                    in_data = True
                    data_txt += dm.group(1)
                    i += 1
                    continue
                if in_data:
                    data_txt += " " + ln.strip()
                    i += 1
                    continue
                i += 1
            nums = [float(x) for x in re.findall(r"[-+0-9.eE]+", data_txt)]
            rows = int(block.get("rows", 1))
            cols = int(block.get("cols", len(nums)))
            out[key] = np.asarray(nums, np.float64).reshape(rows, cols)
            continue
        # scalar
        try:
            out[key] = int(rest)
        except ValueError:
            try:
                out[key] = float(rest)
            except ValueError:
                out[key] = rest.strip("\"'")
        i += 1
    return out


# ---------------------------------------------------------------------------
# Capacity plan
# ---------------------------------------------------------------------------

@dataclass(frozen=True)
class Capacity:
    """Static array capacities — the TPU analog of the reference's unbounded
    pointer graph. All pipeline stages compile once against these shapes."""

    max_kfs: int = 256          # keyframe slots (Kmax)
    max_mps: int = 8192         # map-point slots (Mmax)
    n_features: int = 1000      # feature slots per frame (MaxFtrNumber)
    max_obs_per_mp: int = 12    # observation fan-in per map point
    local_kfs: int = 24         # local-window KF slots (3-hop covisibility)
    local_ref_kfs: int = 24     # fixed frontier KF slots (RefKFs)
    local_mps: int = 2048       # local-window MP slots
    local_obs: int = 8192       # reprojection-edge slots in local BA
    ransac_trials: int = 128    # F-matrix hypotheses per gate


# ---------------------------------------------------------------------------
# System configuration
# ---------------------------------------------------------------------------

@dataclass(frozen=True)
class SystemConfig:
    """Full system configuration (reference Config statics,
    src/Config.cpp:83-186)."""

    # camera (CamConfig.yml: image_width/height, camera_matrix,
    # distortion_coefficients, rvec_b_c, tvec_b_c)
    width: int = 640
    height: int = 480
    fx: float = 500.0
    fy: float = 500.0
    cx: float = 320.0
    cy: float = 240.0
    dist: tuple = (0.0, 0.0, 0.0, 0.0, 0.0)
    Tbc: tuple = tuple(np.eye(4, dtype=np.float64).ravel())  # body→camera

    # depth gates (src/Config.cpp:132-133)
    upper_depth: float = 10000.0
    lower_depth: float = 0.1

    # odometry noise model (src/Config.cpp:142-147)
    odo_x_uncertain: float = 0.02
    odo_y_uncertain: float = 0.02
    odo_t_uncertain: float = 0.02
    odo_x_noise: float = 0.001
    odo_y_noise: float = 0.001
    odo_t_noise: float = 0.001

    # plane-motion information weights (src/Config.cpp:46-48 defaults)
    plane_motion_xrot_info: float = 1e6
    plane_motion_yrot_info: float = 1e6
    plane_motion_z_info: float = 1.0

    # keypoint measurement noise calibration: level-0 pixel sigma of the
    # frontend's keypoint localization, entering every reprojection
    # edge's information as sigma_px^2 * level_sigma2[octave]. The
    # reference hardcodes sigma_px = 1 (Sigma_u = I*Sigma2,
    # src/Map.cpp:1030); this knob exists for the same reason
    # odo_*_noise does — the estimator's noise model must match the
    # measured sensor, and an overconfident vision model lets a few
    # sparse (meter-noisy) map anchors override a calibrated odometry
    # chain (artifacts/drift_study_r5). The shipped frontend's measured
    # localization noise is ~1.1-1.6 px (examples/study_tri_accuracy.py)
    obs_sigma_px: float = 1.0


    # BA budgets (src/Config.cpp:155-160)
    th_huber2: float = 25.0
    local_iter: int = 10
    global_iter: int = 15

    # frontend (src/Config.cpp:137-139; 'scale_facotr' [sic])
    max_feature_num: int = 1000
    scale_factor: float = 1.2
    max_level: int = 5

    fps: int = 30

    # keyframe decision gates (src/Track.cpp:30-35,346-376)
    min_frames_between_kf: int = 8    # nMinFrames = FPS/3 by default
    max_frames_between_kf: int = 30   # nMaxFrames = FPS

    # loop-closure gates (src/Config.cpp:76-81)
    gm_vcl_num_min_match_mp: int = 15
    gm_vcl_num_min_match_kp: int = 30
    gm_vcl_ratio_min_match_mp: float = 0.05
    gm_dcl_min_kfid_offset: int = 20
    gm_dcl_min_score_best: float = 0.005
    # joint full-map pose+point LM refinement after each loop closure
    # (beyond the reference's pose-graph-only GlobalBA; 0 disables)
    gm_joint_ba_iters: int = 5
    # pose-graph GlobalBA edge robustifier (sqrt-chi2 kink) and the
    # eigenvalue ceiling of sparsified loop/feature-edge information
    # (the reference Sparsifier's clamp, src/sparsifier.cpp:239-263).
    # The pose-only loop Hessians saturate this ceiling, so it IS the
    # loop-edge weight — and it is only meaningful RELATIVE to the
    # preintegration chain's stiffness, which scales as 1/odo_noise².
    # The r4 calibration campaign (artifacts/pg_calib_r4/RESULTS.md)
    # found: with a CALIBRATED odometry noise model the reference's 1e4
    # is right (mean slam_pg ATE 0.095 vs odometry 0.112 across 4
    # draws; 1e3 under-weights closures); r3's "closures hurt"
    # regression only reproduces when the estimator's odo_*_noise is
    # left orders of magnitude too optimistic — fix the calibration,
    # not this ceiling.
    gm_pg_huber: float = 3.0
    gm_loop_info_ceil: float = 1e4

    # map IO (src/Config.cpp:165-176)
    use_prev_map: bool = False
    save_new_map: bool = True
    localization_only: bool = False
    map_file_path: str = "./se2lam_map"

    cap: Capacity = field(default_factory=Capacity)

    # -- derived ------------------------------------------------------------

    @property
    def Tbc_mat(self) -> np.ndarray:
        return np.asarray(self.Tbc, np.float64).reshape(4, 4)

    @property
    def Tcb_mat(self) -> np.ndarray:
        T = self.Tbc_mat
        R, t = T[:3, :3], T[:3, 3]
        out = np.eye(4)
        out[:3, :3] = R.T
        out[:3, 3] = -R.T @ t
        return out

    @property
    def level_sigma2(self) -> np.ndarray:
        return np.asarray(
            [
                self.obs_sigma_px ** 2 * self.scale_factor ** (2 * l)
                for l in range(self.max_level)
            ],
            np.float32,
        )

    def accept_depth(self, z):
        return (z >= self.lower_depth) & (z <= self.upper_depth)

    # -- loading ------------------------------------------------------------

    @classmethod
    def from_yaml(cls, cam_path: str, settings_path: str,
                  cap: Capacity | None = None) -> "SystemConfig":
        """Load from the reference's two YAML files, honoring its key names
        (src/Config.cpp:83-186)."""
        cam = read_cv_yaml(cam_path)
        st = read_cv_yaml(settings_path)

        K = np.asarray(cam.get("camera_matrix", np.eye(3))).reshape(3, 3)
        D = np.asarray(cam.get("distortion_coefficients", np.zeros(5))).ravel()
        D = np.pad(D, (0, max(0, 5 - len(D))))[:5]

        # extrinsic from Rodrigues rvec + tvec (src/Config.cpp:111-120)
        rvec = np.asarray(cam.get("rvec_b_c", np.zeros(3))).ravel()
        tvec = np.asarray(cam.get("tvec_b_c", np.zeros(3))).ravel()
        theta = np.linalg.norm(rvec)
        if theta < 1e-12:
            R = np.eye(3)
        else:
            k = rvec / theta
            Kx = np.array(
                [[0, -k[2], k[1]], [k[2], 0, -k[0]], [-k[1], k[0], 0]]
            )
            R = np.eye(3) + np.sin(theta) * Kx + (1 - np.cos(theta)) * Kx @ Kx
        Tbc = np.eye(4)
        Tbc[:3, :3] = R
        Tbc[:3, 3] = tvec

        def g(key, default, typ=float):
            v = st.get(key, default)
            try:
                return typ(v)
            except (TypeError, ValueError):
                return default

        fps = g("fps", 30, int)
        kw = dict(
            width=int(cam.get("image_width", 640)),
            height=int(cam.get("image_height", 480)),
            fx=float(K[0, 0]), fy=float(K[1, 1]),
            cx=float(K[0, 2]), cy=float(K[1, 2]),
            dist=tuple(D.tolist()),
            Tbc=tuple(Tbc.ravel().tolist()),
            upper_depth=g("upper_depth", 10000.0),
            lower_depth=g("lower_depth", 0.1),
            odo_x_uncertain=g("odo_x_uncertain", 0.02),
            odo_y_uncertain=g("odo_y_uncertain", 0.02),
            odo_t_uncertain=g("odo_theta_uncertain", 0.02),
            odo_x_noise=g("odo_x_steady_noise", 0.001),
            odo_y_noise=g("odo_y_steady_noise", 0.001),
            odo_t_noise=g("odo_theta_steady_noise", 0.001),
            plane_motion_xrot_info=g("plane_motion_xrot_info", 1e6),
            plane_motion_yrot_info=g("plane_motion_yrot_info", 1e6),
            plane_motion_z_info=g("plane_motion_z_info", 1.0),
            th_huber2=g("th_huber2", 25.0),
            local_iter=g("local_iter", 10, int),
            global_iter=g("global_iter", 15, int),
            max_feature_num=g("max_feature_num", 1000, int),
            scale_factor=g("scale_facotr", 1.2),  # [sic] src/Config.cpp:137
            max_level=g("max_level", 5, int),
            fps=fps,
            min_frames_between_kf=max(1, fps // 3),
            max_frames_between_kf=fps,
            gm_vcl_num_min_match_mp=g("gm_vcl_num_min_match_mp", 15, int),
            gm_vcl_num_min_match_kp=g("gm_vcl_num_min_match_kp", 30, int),
            gm_vcl_ratio_min_match_mp=g("gm_vcl_ratio_min_match_kp", 0.05),
            gm_dcl_min_kfid_offset=g("gm_dcl_min_kfid_offset", 20, int),
            gm_dcl_min_score_best=g("gm_dcl_min_score_best", 0.005),
            gm_joint_ba_iters=g("gm_joint_ba_iters", 5, int),
            use_prev_map=bool(g("USE_PREV_MAP", 0, int)),
            save_new_map=bool(g("SAVE_NEW_MAP", 1, int)),
            localization_only=bool(g("LOCALIZATION_ONLY", 0, int)),
            map_file_path=str(st.get("map_file_path", "./se2lam_map")),
        )
        if cap is not None:
            kw["cap"] = cap
        else:
            # the extractor rounds per-level quotas, so its slot count can
            # differ from max_feature_num — the map's feature axis must
            # match the extractor's actual output capacity
            from .frontend.orb import OrbConfig

            oc = OrbConfig(
                height=kw["height"], width=kw["width"],
                n_features=kw["max_feature_num"],
                scale_factor=kw["scale_factor"],
                n_levels=kw["max_level"],
            )
            kw["cap"] = Capacity(n_features=oc.n_slots)
        return cls(**kw)

    def replace(self, **kw) -> "SystemConfig":
        return dataclasses.replace(self, **kw)
