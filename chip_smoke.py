"""Drive the PyTorch port's main path on one NVIDIA GPU and check it.

    python3 chip_smoke.py

Run from the root of a checkout, on a machine with one CUDA card and
``nvcc`` (``/usr/local/cuda/bin``). Phases, each of which ends the run with
a nonzero exit if it fails:

1. device: the card's name and power limit (``nvidia-smi``), CUDA version;
2. build: compiles the port's CUDA kernels from ``se2lam_tpu_torch/csrc``
   and prints ptxas's report of each kernel: registers, static shared
   memory and spills;
3. kernel against plain: the FAST+NMS kernel against its plain PyTorch
   version on the card, bitwise over the whole map, at the five pyramid
   levels of a rendered bench frame and on a random 231x309 image; times
   both with CUDA events;
4. extractor: the ORB extractor on the card against the same extractor on
   the CPU, on one bench frame;
5. main path: ORB extraction and the tracking step over 20 frames of the
   synthetic bench world at 640x480, 1000 features, 5 levels, re-seeding
   the reference frame where the step asks for a keyframe; checks the
   launches, poses, feature and match counts and the keyframe timing;
6. Schur kernel against plain: the Schur point-reduction kernel against
   its plain PyTorch version (the einsum pair) on random SPD systems at
   (K, M) = (4, 12), (8, 130), (24, 512), (48, 2048), (256, 8192), on
   zeroed point columns (from mid-chunk and from a chunk boundary: the
   same bits as the shorter call), and S bitwise symmetric outside its
   diagonal 3x3 blocks; times it, the plain version and one
   ``torch.einsum`` call, each in a CUDA graph and eagerly, at the
   local-BA and global-BA shapes;
7. mapping: the synchronous SLAM loop, ``SlamSystem(cfg,
   enable_loops=False)`` at the bench configuration with the default
   ``Capacity``, over 60 frames of the bench world with noisy odometry,
   for 3 RANSAC draws: keyframe insertion (its projection match through
   the windowed top-2 kernel), pruning and local BA (the Schur kernel, at
   (K, M) = (48, 2048)) on the card. Checks the launches of all three
   kernels, that every local BA descends, finite poses, the
   keyframe count and ATE against the JAX package's spread, and the
   Schur kernel on the damped system of a real local BA of the run;
8. localization: the counted SLAM run's map saved with ``save_map`` and
   loaded back (every field and the vocabulary bitwise); the windowed
   top-2 kernel against its plain version, exact on all four outputs, at
   (8192, 1000), (8191, 997), (200, 300), with every gated distance tied
   at N2 = 1, 31, 32, 33, 997, on all-gated rows and on the real inputs of
   the first tracked localization frame, and its times;
   ``Localizer(cfg, ms, vocab)`` cold on frames 10-49 for 3 RANSAC
   draws, every projection match a kernel launch, localized count and
   error against the JAX package's spread; ``SlamSystem.resume`` on the
   saved map over frames 30-59: relocalized frame, keyframes inserted,
   every local BA descending, the launches of all three kernels.

The Schur kernel is held, on every system, to its plain version evaluated
in f64 on the same f32 inputs (see ``schur_check``).

It prints the kernels' JSON line before the last line, and last
``{"ok": true, "device": {...}}``. Nothing of JAX is imported.
"""
from __future__ import annotations

import json
import math
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

from se2lam_tpu_torch import localizer as loc_mod
from se2lam_tpu_torch import localmap, tracking
from se2lam_tpu_torch.entry import default_cfg, entry
from se2lam_tpu_torch.frontend import fast_nms as K1
from se2lam_tpu_torch.frontend import windowed_match as K2
from se2lam_tpu_torch.frontend.orb import OrbExtractor
from se2lam_tpu_torch.io import load_map
from se2lam_tpu_torch.io.synthetic import SyntheticWorld, map_gauge
from se2lam_tpu_torch.io.trajectory import ate_se2
from se2lam_tpu_torch.kernels import build_all, load_library, ptxas_summary
from se2lam_tpu_torch.kernels.samples import k2_inputs
from se2lam_tpu_torch.localizer import Localizer
from se2lam_tpu_torch.mapstate import MapState
from se2lam_tpu_torch.solver import ba
from se2lam_tpu_torch.solver import schur as K3
from se2lam_tpu_torch.system import SlamSystem

# H100 SXM peaks (NVIDIA data sheet): HBM bytes/s and f32 (non-tensor) op/s
HBM_BYTES_PER_S = 3.35e12
F32_OPS_PER_S = 67e12
# FAST+NMS per pixel: 4 B read, 3 maps of 4 B written; f32 operations: 16
# differences, 16 negations, 32 threshold subtractions, 32 clamps, 30 adds,
# 1 max, 64 threshold compares, 2 selects, 2 x (8 maxima + 2 compares +
# 1 select) for the two NMS maps
FAST_BYTES_PER_PX = 16
FAST_OPS_PER_PX = 16 + 16 + 32 + 32 + 30 + 1 + 64 + 2 + 2 * 11
T_HIGH, T_LOW = 20.0, 7.0
N_FRAMES = 20
N_DRAWS = 8        # RANSAC draws of the main path
# Schur kernel: the JAX package's own kernel tolerance
# (tests/test_pallas_schur.py), relative to the largest entry
SCHUR_REL_TOL = 1e-5
SCHUR_SHAPES = [(4, 12), (8, 130), (24, 512), (48, 2048), (256, 8192)]
SCHUR_ZERO_FROM = (65, 96)      # zeroed point columns of (8, 130): mid-chunk, chunk boundary
LOCAL_BA_SHAPE = (48, 2048)     # (local_kfs + local_ref_kfs, local_mps), default Capacity
GLOBAL_BA_SHAPE = (256, 8192)   # (max_kfs, max_mps): the loop-closing slice's joint BA
MAP_FRAMES = 60
MAP_DRAWS = 3      # RANSAC draws of the SLAM loop
ODO_NOISE = (0.004, 0.002, 0.002)   # per-step odometry noise of tests/test_system.py
# The JAX package's spread on these frames (examples/slam_draws.py, CPU,
# 6 draws): 4 keyframes in every draw, live ATE 0.00938-0.01520 m. A draw
# on the card passes with exactly that keyframe count and an ATE no worse
# than 1.5x the worst JAX draw.
JAX_KF = 4
JAX_ATE_MAX = 0.015198489440248385
# windowed top-2 (K2): the int8 tensor-core peak (NVIDIA data sheet), and
# the gate's operations on every pair (2 differences, 2 absolute values,
# 2 window and 2 octave compares, 2 validity ands)
INT8_OPS_PER_S = 1979e12
K2_GATE_OPS = 10
K2_SHAPES = [(8192, 1000), (8191, 997), (200, 300)]
K2_TIED_N2 = (1, 31, 32, 33, 997)   # columns of the all-ties check (pool=1), around a warp's 32
MAP_DIR = Path(__file__).resolve().parent / "build" / "chip_smoke" / "map"
LOC_FRAMES = range(10, 50)
RESUME_FRAMES = range(30, 60)
LOC_NOISE = (0.002, 0.001, 0.001)   # fresh odometry noise, seed 9
LOC_DRAWS = 3
# The JAX package's spread on these frames (examples/loc_draws.py, CPU, 6
# draws, reloc_min_inliers=45): the Localizer relocalizes at frame 10 and
# localizes all 40 frames, median error 0.05264 m, in every draw; resume
# relocalizes at frame 30 and inserts 2 keyframes, median error
# 0.06470-0.09131 m. A card draw passes with the same frames and counts and
# a median error no worse than 1.5x the worst JAX draw.
JAX_LOC_FIRST, JAX_LOC_N, JAX_LOC_ERR_MAX = 10, 40, 0.052635375410318375
JAX_RESUME_FRAME, JAX_RESUME_KF, JAX_RESUME_ERR_MAX = 30, 2, 0.09130726009607315


def log(msg):
    print(msg, flush=True)


def phase_device():
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: torch.cuda.is_available() is False; "
                         "this script needs a CUDA card")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip().splitlines()[0]
    log(smi)
    log(f"device: {torch.cuda.get_device_name(0)}, torch {torch.__version__}, "
        f"CUDA {torch.version.cuda}")
    return smi


def phase_build():
    t0 = time.perf_counter()
    libs = build_all()
    load_library("fast_nms")
    log(f"build: {sorted(libs)} in {time.perf_counter() - t0:.2f} s")
    for name, lib in sorted(libs.items()):
        for k in ptxas_summary(lib.with_suffix(".log").read_text()):
            log(f"ptxas {name}: " + json.dumps(k))


def events_ms(fn, reps=50, warmup=5):
    """Median over ``reps`` of the CUDA-event time of one ``fn()``."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return float(np.median(times))


def graph_ms(fn, inner=20, reps=50):
    """Device time of one ``fn()`` without the host's launch cost: ``inner``
    calls captured in a CUDA graph, the median over ``reps`` replays timed
    with CUDA events, divided by ``inner``."""
    s = torch.cuda.Stream()
    s.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(s):
        for _ in range(3):
            fn()
    torch.cuda.current_stream().wait_stream(s)
    g = torch.cuda.CUDAGraph()
    with torch.cuda.graph(g):
        for _ in range(inner):
            fn()
    return events_ms(g.replay, reps=reps, warmup=3) / inner


def sprinkled_image(rng, H, W):
    """uint8-valued noise with 30 bright 3x3 blocks (corners on purpose)."""
    img = rng.integers(0, 256, (H, W)).astype(np.float32)
    for _ in range(30):
        y, x = rng.integers(20, H - 20), rng.integers(20, W - 20)
        img[y - 1: y + 2, x - 1: x + 2] = 250.0
    return img


def phase_kernel(extract, world, gt0):
    """K1 against its plain version, and the times of both."""
    img0 = torch.from_numpy(world.render(gt0)).cuda()
    levels = [lv.contiguous() for lv in extract.pyramid(img0)]
    extra = torch.from_numpy(sprinkled_image(np.random.default_rng(0), 231, 309)).cuda()
    max_err = 0.0
    for img in levels + [extra]:
        got = K1.fast_nms(img, T_HIGH, T_LOW)
        want = K1.fast_nms_plain(img, T_HIGH, T_LOW)
        torch.cuda.synchronize()
        for name, g, w in zip(("nms_high", "nms_low", "raw_low"), got, want):
            err = float((g - w).abs().max())
            max_err = max(max_err, err)
            if not torch.equal(g, w):
                raise SystemExit(f"chip_smoke: K1 {name} differs from plain at "
                                 f"{tuple(img.shape)}: max |diff| {err}")
        if int((got[1] > 0).sum()) == 0:
            raise SystemExit(f"chip_smoke: K1 found no corner at {tuple(img.shape)}")
    shapes = [tuple(lv.shape) for lv in levels]
    log(f"kernel: K1 bitwise equal to plain on {shapes} and (231, 309)")

    def frame(f):
        return lambda: [f(lv, T_HIGH, T_LOW) for lv in levels]

    t = dict(
        level_ms=[graph_ms(lambda lv=lv: K1.fast_nms(lv, T_HIGH, T_LOW)) for lv in levels],
        ms=graph_ms(frame(K1.fast_nms)),
        eager_ms=events_ms(frame(K1.fast_nms)),
        plain_ms=graph_ms(frame(K1.fast_nms_plain)),
        plain_eager_ms=events_ms(frame(K1.fast_nms_plain)),
    )
    px = sum(h * w for h, w in shapes)
    bytes_s = FAST_BYTES_PER_PX * px / HBM_BYTES_PER_S
    ops_s = FAST_OPS_PER_PX * px / F32_OPS_PER_S
    t.update(
        px=px, max_abs_err=max_err,
        bound_ms=1e3 * max(bytes_s, ops_s),
        bound_by="bytes" if bytes_s >= ops_s else "operations",
    )
    log("kernel times (ms per 5-level frame): " + json.dumps(
        {k: t[k] for k in ("ms", "eager_ms", "plain_ms", "plain_eager_ms", "bound_ms")}))
    return t


def phase_extractor(extract, oc, img):
    """The extractor on the card against the same extractor on the CPU,
    whose plain path the CPU tests hold against the JAX package: the cuBLAS
    pyramid moves level pixels by a few ulps, which may move a keypoint's
    subpixel offset slightly and, rarely, a descriptor bit."""
    fg = extract(torch.from_numpy(img).cuda())
    fc = OrbExtractor(oc, device="cpu")(torch.from_numpy(img))
    v = fc.valid
    if not (torch.equal(fg.valid.cpu(), v) and torch.equal(fg.octave.cpu(), fc.octave)):
        raise SystemExit("chip_smoke: the card's keypoint slots differ from the CPU's")
    xy_err = float((fg.xy.cpu()[v] - fc.xy[v]).abs().max())
    same = (fg.desc_bits.cpu().view(torch.int32) == fc.desc_bits.view(torch.int32)).all(1)
    same_share = float(same[v].float().mean())
    log(f"extractor: card vs CPU on {int(v.sum())} keypoints: max |xy diff| "
        f"{xy_err} px, descriptors equal on {same_share:.4f} of them")
    if xy_err > 1e-3 or same_share < 0.99:
        raise SystemExit("chip_smoke: the card's features differ from the CPU's")


def _se2_ref_pose(ref_pose, ref_odo, odo):
    """compose(ref_pose, minus(odo, ref_odo)) in float64 on the host."""
    dx, dy = odo[0] - ref_odo[0], odo[1] - ref_odo[1]
    c, s = math.cos(ref_odo[2]), math.sin(ref_odo[2])
    rel = (c * dx + s * dy, -s * dx + c * dy, odo[2] - ref_odo[2])
    c, s = math.cos(ref_pose[2]), math.sin(ref_pose[2])
    return np.array([
        ref_pose[0] + rel[0] * c - rel[1] * s,
        ref_pose[1] + rel[0] * s + rel[1] * c,
        ref_pose[2] + rel[2],
    ])


def run_path(cfg, oc, extract, imgs, odos, gt, seed):
    """One pass of the main path over the frames: extraction and the
    tracking step, the RANSAC draws from a generator seeded with ``seed``;
    the reference frame is re-seeded where the step asks for a keyframe
    (keyframe insertion itself belongs to the mapping slice)."""
    dev = imgs[0].device
    N = oc.n_slots
    view_mp = torch.zeros((N, 3), dtype=torch.float32, device=dev)
    no_obs = torch.zeros(N, dtype=torch.bool, device=dev)

    def reseed(feats, pose, odo):
        return tracking.init_track_state(feats, pose, odo, 0, view_mp, no_obs)

    gen = torch.Generator(device=dev).manual_seed(seed)
    ev = [[torch.cuda.Event(enable_timing=True) for _ in range(3)] for _ in imgs]
    t0 = time.perf_counter()
    ev[0][0].record()
    feats = extract(imgs[0])
    ev[0][1].record()
    ts = reseed(feats, odos[0], odos[0])
    valid, results, refs, need_at = [feats.n], [], [], []
    for i in range(1, len(imgs)):
        ev[i][0].record()
        feats = extract(imgs[i])
        ev[i][1].record()
        refs.append((ts.ref_pose, ts.ref_odom))
        ts, res = tracking.track_frame(ts, feats, odos[i], cfg, generator=gen)
        ev[i][2].record()
        valid.append(feats.n)
        results.append(res)
        if bool(res.need_kf):   # the caller's one read per frame
            need_at.append(i)
            ts = reseed(ts.cur_feats, ts.cur_pose, ts.cur_odom)
    torch.cuda.synchronize()
    loop_s = time.perf_counter() - t0

    # every pose is the odometry prediction, finite
    for (ref_pose, ref_odo), r, i in zip(refs, results, range(1, len(imgs))):
        pose = r.pose.double().cpu().numpy()
        want = _se2_ref_pose(ref_pose.double().cpu().numpy(),
                             ref_odo.double().cpu().numpy(), gt[i].astype(np.float64))
        d = pose - want
        d[2] = math.remainder(d[2], 2 * math.pi)
        if not np.isfinite(pose).all() or np.abs(d).max() > 1e-5:
            raise SystemExit(f"chip_smoke: seed {seed} frame {i} pose {pose} is "
                             f"not the odometry prediction {want}")
    f = ts.cur_feats
    if f.xy.shape != (N, 2) or f.desc_bits.shape != (N, 8) or not torch.isfinite(f.xy).all():
        raise SystemExit("chip_smoke: extractor output has the wrong shape or is not finite")
    return dict(
        seed=seed, n_valid=[int(v) for v in valid],
        n_matched=[int(r.n_matched) for r in results], need_kf_at=need_at,
        extract_ms_per_frame=float(np.median(
            [e[0].elapsed_time(e[1]) for e in ev])),
        track_ms_per_frame=float(np.median(
            [e[1].elapsed_time(e[2]) for e in ev[1:]])),
        loop_s=loop_s, frames_per_s=len(imgs) / loop_s,
    )


def within_jax_spread(run):
    """The bounds every RANSAC draw of the JAX package met on these frames
    (examples/kf_timing_draws.py): >= 850 valid features a frame, >= 120
    matches a tracked frame, the first keyframe request at frame 9-14."""
    need = run["need_kf_at"]
    return (min(run["n_valid"]) >= 850 and min(run["n_matched"]) >= 120
            and bool(need) and 9 <= need[0] <= 14)


def phase_main_path(cfg, oc, extract, world, gt):
    """The counted run of the main path, then more RANSAC draws."""
    dev = torch.device("cuda")
    imgs = [torch.from_numpy(world.render(p)).to(dev) for p in gt]
    odos = [torch.from_numpy(p).to(dev) for p in gt]
    # the packaged entry point (device=None: the card), which also warms up
    # every op of the path before the counted run
    step, example_args = entry()
    _, res = step(*example_args)
    if not torch.isfinite(res.pose).all() or int(res.n_matched) < 100:
        raise SystemExit(f"chip_smoke: entry() step gave {res}")

    K1.fast_nms.launches = 0
    run = run_path(cfg, oc, extract, imgs, odos, gt, seed=0)
    launches = K1.fast_nms.launches
    log("main path: " + json.dumps(dict(run, k1_launches=launches)))
    if launches != 5 * len(imgs):
        raise SystemExit(f"chip_smoke: K1 launched {launches} times, "
                         f"want 5 per frame x {len(imgs)}")

    # The keyframe request depends on the RANSAC draw: in the JAX package
    # the first comes at frame 11 for most draws, with >= 150 matches every
    # frame, and at 13-14 for the rest, with matches down to ~125. Every
    # draw must stay inside that spread, and some draw must take the
    # frame-11 branch.
    runs = [run] + [run_path(cfg, oc, extract, imgs, odos, gt, seed=s)
                    for s in range(1, N_DRAWS)]
    log("draws: " + json.dumps([(r["need_kf_at"], min(r["n_matched"])) for r in runs]))
    bad = [r["seed"] for r in runs if not within_jax_spread(r)]
    if bad:
        raise SystemExit(f"chip_smoke: draws {bad} leave the JAX package's spread")
    if not any(r["need_kf_at"][0] == 11 and min(r["n_matched"]) >= 150 for r in runs):
        raise SystemExit("chip_smoke: no draw took the frame-11 keyframe branch")
    return launches


def spd_inverses(g, M, dev):
    """Inverses of M random SPD 3x3 blocks, contiguous, on ``dev``."""
    L = torch.randn((M, 3, 3), generator=g)
    return torch.linalg.inv(L @ L.transpose(-1, -2) + torch.eye(3)).contiguous().to(dev)


def schur_check(Hpx, Hxx_inv, what):
    """The kernel against the plain version on the same inputs, evaluated
    in f64: within SCHUR_REL_TOL of its largest entry. On a real local BA,
    Hxx⁻¹ reaches ~1e6 along weakly observed depth directions whose large
    products cancel in S, so any f32 result, the f32 plain version's
    included, sits a few 1e-6 of max|S| from the exact one; two f32
    results then differ by up to their sum, which is why the reference is
    the exact one. Returns (max |S − S_plain|, relative error)."""
    got = K3.point_reduction(Hpx, Hxx_inv)
    want = K3.point_reduction_plain(Hpx.double(), Hxx_inv.double())
    torch.cuda.synchronize()
    err = float((got.double() - want).abs().max())
    rel = err / max(float(want.abs().max()), 1e-30)
    if not math.isfinite(rel) or rel > SCHUR_REL_TOL:
        raise SystemExit(f"chip_smoke: Schur kernel differs from plain on {what}: "
                         f"relative error {rel} > {SCHUR_REL_TOL}")
    return err, rel


def schur_bound(K, M):
    """(bound ms, bound_by): the f32 operations the function needs, T and
    one triangle of the symmetric S, 2·M·(9·3K + 3·3K(3K+1)/2), over
    67 TFLOP/s, against each input read once and S written once over
    3.35 TB/s. The kernel computes the full S, about twice that work."""
    R = 3 * K
    ops = 2 * M * (9 * R + 3 * R * (R + 1) // 2)
    nbytes = 4 * (9 * K * M + 9 * M + 9 * K * K)
    ops_s, bytes_s = ops / F32_OPS_PER_S, nbytes / HBM_BYTES_PER_S
    return 1e3 * max(ops_s, bytes_s), "operations" if ops_s >= bytes_s else "bytes"


def phase_schur():
    """The Schur kernel against its plain version at every listed shape
    and on zeroed point columns, then its times."""
    dev = torch.device("cuda")
    g = torch.Generator().manual_seed(0)
    errs = {}
    inputs = {}
    for K, M in SCHUR_SHAPES:
        Hpx = torch.randn((K, 3, M, 3), generator=g).to(dev)
        Hxx_inv = spd_inverses(g, M, dev)
        errs[(K, M)] = schur_check(Hpx, Hxx_inv, f"random SPD (K, M) = ({K}, {M})")
        inputs[(K, M)] = (Hpx, Hxx_inv)
    # zeroed point columns (invalid points) add exact zeros
    Hpx, Hxx_inv = inputs[(8, 130)]
    for z in SCHUR_ZERO_FROM:
        Hz = Hpx.clone()
        Hz[:, :, z:] = 0.0
        full = K3.point_reduction(Hz, Hxx_inv)
        part = K3.point_reduction(Hz[:, :, :z].contiguous(), Hxx_inv[:z].contiguous())
        torch.cuda.synchronize()
        if not torch.equal(full, part):
            raise SystemExit(f"chip_smoke: point columns zeroed from {z} changed the Schur "
                             "kernel's result")
    # the kernel mirrors its upper tiles: S_red[k, l] = S_red[l, k]ᵀ bitwise for k != l
    for K, M in SCHUR_SHAPES:
        S = K3.point_reduction(*inputs[(K, M)])
        off = ~torch.eye(K, dtype=torch.bool, device=dev)
        if not torch.equal(S[off], S.permute(1, 0, 3, 2)[off]):
            raise SystemExit(f"chip_smoke: Schur S is not symmetric at (K, M) = ({K}, {M})")
    log("kernel: Schur within " + json.dumps(
        {f"{K}x{M}": rel for (K, M), (_, rel) in errs.items()})
        + " of plain (f64); zero columns exact; off-diagonal blocks symmetric")

    times = {}
    for K, M in (LOCAL_BA_SHAPE, GLOBAL_BA_SHAPE):
        Hpx, Hxx_inv = inputs[(K, M)]
        bound, by = schur_bound(K, M)
        fns = dict(
            kernel=lambda: K3.point_reduction(Hpx, Hxx_inv),
            plain=lambda: K3.point_reduction_plain(Hpx, Hxx_inv),
            library=lambda: torch.einsum("kamb,mbd,lcmd->klac", Hpx, Hxx_inv, Hpx),
        )
        t = {name: (graph_ms(f, inner=10, reps=20), events_ms(f, reps=20))
             for name, f in fns.items()}
        times[(K, M)] = dict(
            ms=t["kernel"][0], eager_ms=t["kernel"][1],
            plain_ms=t["plain"][0], plain_eager_ms=t["plain"][1],
            library_ms=t["library"][0], library_eager_ms=t["library"][1],
            below_library=t["kernel"][0] < t["library"][0],
            bound_ms=bound, bound_by=by, max_abs_err=errs[(K, M)][0],
            rel_err=errs[(K, M)][1],
        )
        log(f"kernel times Schur (K, M) = ({K}, {M}) (ms; graph, and eager_): "
            + json.dumps(times[(K, M)]))
    return times


class StageTimer:
    """CUDA events around every call of a module-level function, read
    after the run (the wrapper adds no host synchronisation)."""

    def __init__(self, module, name):
        self.module, self.name = module, name
        self.orig = getattr(module, name)
        self.events = []

    def __enter__(self):
        def timed(*args, **kw):
            a = torch.cuda.Event(enable_timing=True)
            b = torch.cuda.Event(enable_timing=True)
            a.record()
            out = self.orig(*args, **kw)
            b.record()
            self.events.append((a, b))
            return out

        setattr(self.module, self.name, timed)
        return self

    def __exit__(self, *exc):
        setattr(self.module, self.name, self.orig)

    def ms(self):
        torch.cuda.synchronize()
        return [a.elapsed_time(b) for a, b in self.events]


def run_slam(cfg, imgs, odos, gt, seed):
    """One pass of the SLAM loop with RANSAC draws seeded ``seed``."""
    slam = SlamSystem(cfg, enable_loops=False,
                      generator=torch.Generator(device="cuda").manual_seed(seed))
    slam.log_ba = True
    with StageTimer(tracking, "track_frame") as tr, \
            StageTimer(localmap, "insert_and_optimize") as ins, \
            StageTimer(localmap, "run_local_ba") as lba:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for img, odo in zip(imgs, odos):
            slam.process(img, odo)
        torch.cuda.synchronize()
        loop_s = time.perf_counter() - t0
        track_ms, insert_ms, ba_ms = tr.ms(), ins.ms(), lba.ms()
    est = np.asarray([p for _, p in slam.trajectory])
    cor = slam.corrected_trajectory()[:, 1:3]
    for rec in slam.ba_log:
        if not rec["chi2"] <= rec["chi2_init"]:
            raise SystemExit(f"chip_smoke: seed {seed}: local BA did not descend: {rec}")
    poses = slam.ms.kf_pose[: slam.n_keyframes()]
    if not np.isfinite(est).all() or not bool(torch.isfinite(poses).all()):
        raise SystemExit(f"chip_smoke: seed {seed}: a pose is not finite")
    return slam, dict(
        seed=seed, kf_frames=slam.kf_frame_ids, n_kf=len(slam.kf_frame_ids),
        n_local_ba=slam.n_local_ba, n_mp=slam.n_map_points(),
        ate=ate_se2(est[:, :2], gt[:, :2])[0], ate_corrected=ate_se2(cor, gt[:, :2])[0],
        chi2_ratio_max=max(r["chi2"] / r["chi2_init"] for r in slam.ba_log),
        frames_per_s=len(imgs) / loop_s, loop_s=loop_s,
        track_ms_per_frame=float(np.median(track_ms)),
        insert_ms_per_kf=float(np.median(insert_ms)),
        local_ba_ms_per_kf=float(np.median(ba_ms)),
    )


def within_jax_spread_slam(run):
    """The rule stated at JAX_KF/JAX_ATE_MAX."""
    return run["n_kf"] == JAX_KF and run["ate"] <= 1.5 * JAX_ATE_MAX


def phase_mapping(cfg, world):
    """The counted SLAM loop, more RANSAC draws, then the Schur kernel on
    the system of the last local BA of the counted run."""
    dev = torch.device("cuda")
    gt = world.circle_trajectory(352, radius=2.5)[:MAP_FRAMES]
    odo = world.odometry(gt, noise=ODO_NOISE, seed=1)
    imgs = [torch.from_numpy(world.render(p)).to(dev) for p in gt]
    # warm-up on the first frames: every op of the loop is loaded once
    run_slam(cfg, imgs[:12], odo[:12], gt[:12], seed=99)

    K1.fast_nms.launches = K2.windowed_top2.launches = K3.point_reduction.launches = 0
    with Counted(localmap, "match_by_projection_streamed") as im:
        slam, run = run_slam(cfg, imgs, odo, gt, seed=0)
    k1, k2, k3 = K1.fast_nms.launches, K2.windowed_top2.launches, K3.point_reduction.launches
    log("mapping: " + json.dumps(dict(run, k1_launches=k1, k2_launches=k2, k3_launches=k3,
                                      insert_projection_matches=im.calls)))
    if k1 != 5 * MAP_FRAMES:
        raise SystemExit(f"chip_smoke: K1 launched {k1} times in the SLAM loop, "
                         f"want 5 per frame x {MAP_FRAMES}")
    if k2 != im.calls or k2 < 1:
        raise SystemExit(f"chip_smoke: K2 launched {k2} times in the SLAM loop for "
                         f"{im.calls} projection matches of keyframe insertion")
    if run["n_local_ba"] < 1 or k3 != cfg.local_iter * run["n_local_ba"]:
        raise SystemExit(f"chip_smoke: the Schur kernel launched {k3} times, want "
                         f"{cfg.local_iter} x {run['n_local_ba']} local BAs")
    runs = [run] + [run_slam(cfg, imgs, odo, gt, seed=s)[1] for s in range(1, MAP_DRAWS)]
    log("mapping draws: " + json.dumps([(r["n_kf"], r["ate"], r["ate_corrected"]) for r in runs]))
    bad = [r["seed"] for r in runs if not within_jax_spread_slam(r)]
    if bad:
        raise SystemExit(f"chip_smoke: SLAM draws {bad} leave the JAX package's spread "
                         f"(keyframes {JAX_KF}, ATE <= {1.5 * JAX_ATE_MAX})")

    # the Schur kernel on a real local-BA system: the window of the last
    # keyframe on the final map, assembled and damped as the solver's
    # first LM step does
    c = tracking.constants(cfg, dev)
    win = localmap.build_local_ba(slam.ms, slam._ref_kf_host, cfg)
    cfg_ba = ba.BAConfig()
    _, _, Hpx, Hxx_inv, _, _ = ba.damped_system(
        win.prob, c["cam"], c["Tcb"], cfg_ba, torch.tensor(cfg_ba.lm_init_lambda, device=dev))
    err, rel = schur_check(Hpx, Hxx_inv, f"the local BA of KF {slam._ref_kf_host}")
    log(f"kernel: Schur on a real local BA {tuple(Hpx.shape)}: max |diff| {err}, "
        f"relative {rel} of plain (f64)")
    return slam, run, k1, k2, k3, err


def k2_check(args, what):
    """K2 against its plain version on the same inputs: all four outputs
    equal. Returns the largest |distance difference| (0 when equal)."""
    got = K2.windowed_top2(*args)
    want = K2.windowed_top2_plain(*args)
    torch.cuda.synchronize()
    for name, g, w in zip(("best", "second", "argbest", "argsecond"), got, want):
        if g.dtype != w.dtype or not torch.equal(g, w):
            raise SystemExit(f"chip_smoke: K2 {name} differs from plain on {what}: "
                             f"{int((g != w).sum())} rows")
    return max(float((g - w).abs().max()) for g, w in zip(got[:2], want[:2]))


def k2_bound(args):
    """(bound ms, bound_by, all-pairs bound ms, gated pairs) at these
    inputs. Operations: a dot product of 256 int8 values (512 operations)
    for each pair the gate lets through, over the int8 tensor-core peak,
    plus the gate's operations on every pair over the f32 peak. Bytes:
    each input read once, each output written once. The all-pairs bound
    counts a dot product for every pair."""
    N1, N2 = args[0].shape[0], args[6].shape[0]
    gated = int(K2.windowed_gate(*args[1:6], *args[7:10]).sum())
    ops_s = gated * 512 / INT8_OPS_PER_S + N1 * N2 * K2_GATE_OPS / F32_OPS_PER_S
    nbytes = sum(a.numel() * a.element_size() for a in args) + N1 * 16
    bytes_s = nbytes / HBM_BYTES_PER_S
    all_pairs_s = max(N1 * N2 * 512 / INT8_OPS_PER_S, bytes_s)
    return (1e3 * max(ops_s, bytes_s), "operations" if ops_s >= bytes_s else "bytes",
            1e3 * all_pairs_s, gated)


def phase_k2():
    """K2 against its plain version at every listed shape and on all-gated
    rows."""
    errs = {}
    for i, (N1, N2) in enumerate(K2_SHAPES):
        x = [a.cuda() for a in k2_inputs(N1, N2, seed=i)]
        errs[(N1, N2)] = k2_check(x, f"random ({N1}, {N2})")
    for N2 in K2_TIED_N2:
        x = [a.cuda() for a in k2_inputs(300, N2, seed=5, pool=1)]
        k2_check(x, f"all distances tied (300, {N2})")
    x = [a.cuda() for a in k2_inputs(300, 200, seed=9)]
    x[2] = torch.full_like(x[2], -1.0)          # a negative window admits nothing
    k2_check(x, "all-gated rows")
    best, second, arg, arg2 = K2.windowed_top2(*x)
    if not (bool((best == 1e9).all()) and bool((second == 1e9).all())
            and not bool(arg.any()) and not bool(arg2.any())):
        raise SystemExit("chip_smoke: K2 all-gated rows are not (1e9, 1e9, 0, 0)")
    log(f"kernel: K2 equal to plain on all four outputs at {K2_SHAPES}, with all distances "
        f"tied at N2 = {K2_TIED_N2}, and on all-gated rows")
    return max(errs.values())


def phase_save_reload(slam):
    """save_map, then load_map on the card: every field and the vocabulary
    bitwise equal."""
    vocab = slam.save_map(str(MAP_DIR))
    ms, vocab2, info = load_map(str(MAP_DIR))
    if vocab is None or vocab2 is None:
        raise SystemExit("chip_smoke: save_map wrote no vocabulary")
    pairs = [(f"ms_{n}", getattr(slam.ms, n), getattr(ms, n)) for n in MapState._fields]
    pairs += [("vocab_words", vocab.words, vocab2.words), ("vocab_idf", vocab.idf, vocab2.idf)]
    for name, a, b in pairs:
        if (a.dtype != b.dtype or a.shape != b.shape or b.device.type != "cuda"
                or a.cpu().numpy().tobytes() != b.cpu().numpy().tobytes()):
            raise SystemExit(f"chip_smoke: {name} differs after save_map/load_map")
    log(f"save/reload: {len(pairs)} arrays bitwise equal, {info['n_kf']} keyframes, "
        f"{info['n_mp']} map points, vocabulary {tuple(vocab.words.shape)}")
    return ms, vocab2


class Counted:
    """Counts the calls of a module-level function, and keeps the result
    of the latest call (the wrapper adds no host synchronisation)."""

    def __init__(self, module, name):
        self.module, self.name = module, name
        self.orig = getattr(module, name)
        self.calls, self.last = 0, None

    def __enter__(self):
        def counted(*args, **kw):
            self.calls += 1
            self.last = self.orig(*args, **kw)
            return self.last

        setattr(self.module, self.name, counted)
        return self

    def __exit__(self, *exc):
        setattr(self.module, self.name, self.orig)


def run_localize(cfg, ms, vocab, imgs, odo, gt_map, frames, seed):
    """One cold localization pass; returns the run's numbers, the counted
    projection matches and the K2 inputs of its first tracked frame."""
    loc = Localizer(cfg, ms, vocab,
                    generator=torch.Generator(device="cuda").manual_seed(seed))
    real = None
    with Counted(loc_mod, "_project_and_match") as pm, \
            Counted(K2, "projection_match_inputs") as inputs, \
            StageTimer(loc_mod, "_localize_step") as st, \
            StageTimer(loc_mod, "_project_and_match") as mt, \
            StageTimer(loc_mod, "solve_pose_only") as pt, \
            StageTimer(Localizer, "_relocalize") as rt:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        poses, frame_ms = [], []
        for i in frames:
            f0 = time.perf_counter()
            poses.append(loc.process(imgs[i], odo[i]))      # ends in a host read
            frame_ms.append(1e3 * (time.perf_counter() - f0))
            if real is None and loc.trajectory[-1][2]:
                real = inputs.last
        torch.cuda.synchronize()
        loop_s = time.perf_counter() - t0
        step_ms, match_ms, pose_ms, reloc_ms = st.ms(), mt.ms(), pt.ms(), rt.ms()
    hit = [(i, p) for i, p in zip(frames, poses) if p is not None]
    if not all(np.isfinite(p).all() for _, p in hit):
        raise SystemExit(f"chip_smoke: localization draw {seed}: a pose is not finite")
    errs = [float(np.linalg.norm(p[:2] - gt_map[i])) for i, p in hit]
    run_localize.last = loc
    return dict(
        seed=seed, first=hit[0][0] if hit else None, n_localized=len(hit),
        n_tracked=sum(t for _, _, t in loc.trajectory),
        median_err=float(np.median(errs)) if errs else None,
        frames_per_s=len(frames) / loop_s, loop_s=loop_s,
        frame_wall_ms_median=float(np.median(frame_ms)), frame_wall_ms_max=max(frame_ms),
        slowest_frame=frames[int(np.argmax(frame_ms))],
        localize_step_ms_per_frame=float(np.median(step_ms)) if step_ms else None,
        project_match_ms_per_call=float(np.median(match_ms)),
        pose_only_ms_per_call=float(np.median(pose_ms)),
        reloc_ms=reloc_ms, projection_matches=pm.calls,
    ), real


def profile_frame(loc, img, odo):
    """One more localization frame under ``torch.profiler``: the CUDA
    kernels it launched, their summed device time, the frame's wall time
    (ends in a synchronise), the device's idle share, and the five kernels
    launched most often (name, launches, device ms). None where the
    profiler saw no device activity."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        loc.process(img, odo)
        torch.cuda.synchronize()
        wall_us = 1e6 * (time.perf_counter() - t0)
    kernels = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
    if not kernels:
        return None
    busy_us = sum(e.time_range.elapsed_us() for e in kernels)
    by_name = {}
    for e in kernels:
        n, us = by_name.get(e.name, (0, 0.0))
        by_name[e.name] = (n + 1, us + e.time_range.elapsed_us())
    top = sorted(by_name.items(), key=lambda kv: -kv[1][0])[:5]
    return dict(cuda_kernels=len(kernels), device_busy_ms=busy_us / 1e3,
                wall_ms=wall_us / 1e3, device_idle_share=1.0 - busy_us / wall_us,
                tracked=bool(loc.trajectory[-1][2]),
                top_kernels=[(name[:60], n, us / 1e3) for name, (n, us) in top])


def within_jax_spread_loc(run):
    """The rule stated at JAX_LOC_FIRST/JAX_LOC_N/JAX_LOC_ERR_MAX."""
    return (run["first"] == JAX_LOC_FIRST and run["n_localized"] == JAX_LOC_N
            and run["median_err"] <= 1.5 * JAX_LOC_ERR_MAX)


def phase_localization(cfg, world, slam):
    """Save and reload the SLAM run's map, localize on it (the counted draw
    and more RANSAC draws), check and time K2 on the real inputs of the
    first tracked frame, then resume SLAM on the saved map."""
    dev = torch.device("cuda")
    gt = world.circle_trajectory(352, radius=2.5)[:MAP_FRAMES]
    gt_map = map_gauge(gt)
    odo = world.odometry(gt, noise=LOC_NOISE, seed=9)
    imgs = [torch.from_numpy(world.render(p)).to(dev) for p in gt]
    ms, vocab = phase_save_reload(slam)
    # warm-up: a short pass loads every op of the path once
    run_localize(cfg, ms, vocab, imgs, odo, gt_map, LOC_FRAMES[:4], seed=99)

    K1.fast_nms.launches = 0
    K2.windowed_top2.launches = 0
    run, real = run_localize(cfg, ms, vocab, imgs, odo, gt_map, LOC_FRAMES, seed=0)
    k1, k2 = K1.fast_nms.launches, K2.windowed_top2.launches
    log("localization: " + json.dumps(dict(run, k1_launches=k1, k2_launches=k2)))
    if k2 != run["projection_matches"] or k2 < len(LOC_FRAMES) - 1:
        raise SystemExit(f"chip_smoke: K2 launched {k2} times for "
                         f"{run['projection_matches']} projection matches")
    if k1 != 5 * len(LOC_FRAMES):
        raise SystemExit(f"chip_smoke: K1 launched {k1} times in localization, "
                         f"want 5 per frame x {len(LOC_FRAMES)}")
    last = LOC_FRAMES[-1]
    log("localization frame profile: " + json.dumps(
        profile_frame(run_localize.last, imgs[last], odo[last])))
    runs = [run] + [run_localize(cfg, ms, vocab, imgs, odo, gt_map, LOC_FRAMES, seed=s)[0]
                    for s in range(1, LOC_DRAWS)]
    log("localization draws: " + json.dumps(
        [(r["first"], r["n_localized"], r["median_err"]) for r in runs]))
    bad = [r["seed"] for r in runs if not within_jax_spread_loc(r)]
    if bad:
        raise SystemExit(f"chip_smoke: localization draws {bad} leave the JAX package's "
                         f"spread (first frame {JAX_LOC_FIRST}, {JAX_LOC_N} localized, "
                         f"median error <= {1.5 * JAX_LOC_ERR_MAX})")

    # K2 on the real inputs of the first tracked frame, then its times there
    if real is None or tuple(real[0].shape) != (cfg.cap.max_mps, 256):
        raise SystemExit("chip_smoke: no tracked frame gave K2 inputs at the bank's size")
    real = tuple(real)
    real_err = k2_check(real, "the first tracked localization frame")
    bound, by, all_pairs, gated = k2_bound(real)
    t = dict(
        shape=(real[0].shape[0], real[6].shape[0]), gated_pairs=gated,
        found_rows=int((K2.windowed_top2(*real)[0] < 1e9).sum()),
        ms=graph_ms(lambda: K2.windowed_top2(*real)),
        eager_ms=events_ms(lambda: K2.windowed_top2(*real)),
        plain_ms=graph_ms(lambda: K2.windowed_top2_plain(*real)),
        plain_eager_ms=events_ms(lambda: K2.windowed_top2_plain(*real)),
        bound_ms=bound, bound_by=by, bound_all_pairs_ms=all_pairs, max_abs_err=real_err,
    )
    log("kernel times K2 (ms) on the first tracked frame: " + json.dumps(t))

    return k2, t, phase_resume(cfg, imgs, odo, gt_map)


def phase_resume(cfg, imgs, odo, gt_map):
    """SlamSystem.resume on the saved map: the relocalized frame, the
    keyframes inserted, every local BA descending, and every kernel's
    launches."""
    slam = SlamSystem.resume(cfg, str(MAP_DIR), enable_loops=False)   # the card
    slam.log_ba = True
    n_kf0 = slam.n_keyframes()
    K1.fast_nms.launches = K2.windowed_top2.launches = K3.point_reduction.launches = 0
    with Counted(loc_mod, "_project_and_match") as pm, \
            Counted(localmap, "match_by_projection_streamed") as im:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        poses = [slam.process(imgs[i], odo[i]) for i in RESUME_FRAMES]
        torch.cuda.synchronize()
        loop_s = time.perf_counter() - t0
    k1, k2, k3 = K1.fast_nms.launches, K2.windowed_top2.launches, K3.point_reduction.launches
    hit = [(i, p) for i, p in zip(RESUME_FRAMES, poses) if np.linalg.norm(p) > 1e-6]
    errs = [float(np.linalg.norm(p[:2] - gt_map[i])) for i, p in hit]
    run = dict(
        reloc_frame=hit[0][0] if hit else None, kf_inserted=slam.n_keyframes() - n_kf0,
        median_err=float(np.median(errs)) if errs else None, n_local_ba=slam.n_local_ba,
        chi2_ratio_max=max((r["chi2"] / r["chi2_init"] for r in slam.ba_log), default=None),
        frames_per_s=len(RESUME_FRAMES) / loop_s, projection_matches=pm.calls,
        insert_projection_matches=im.calls,
        k1_launches=k1, k2_launches=k2, k3_launches=k3,
    )
    log("resume: " + json.dumps(run))
    for rec in slam.ba_log:
        if not rec["chi2"] <= rec["chi2_init"]:
            raise SystemExit(f"chip_smoke: resume: local BA did not descend: {rec}")
    if not all(np.isfinite(p).all() for p in poses) or not bool(
            torch.isfinite(slam.ms.kf_pose[: slam.n_keyframes()]).all()):
        raise SystemExit("chip_smoke: resume: a pose is not finite")
    if not (run["reloc_frame"] == JAX_RESUME_FRAME and run["kf_inserted"] == JAX_RESUME_KF
            and run["median_err"] <= 1.5 * JAX_RESUME_ERR_MAX):
        raise SystemExit(f"chip_smoke: resume leaves the JAX package's spread (relocalized "
                         f"at {JAX_RESUME_FRAME}, {JAX_RESUME_KF} keyframes inserted, median "
                         f"error <= {1.5 * JAX_RESUME_ERR_MAX})")
    # every projection match is a K2 launch: the relocalization's and one
    # for each keyframe insertion
    if k1 != 5 * len(RESUME_FRAMES) or pm.calls < 1 or im.calls < 1 or (
            k2 != pm.calls + im.calls) or (
            run["n_local_ba"] < 1 or k3 != cfg.local_iter * run["n_local_ba"]):
        raise SystemExit(f"chip_smoke: resume launches K1 {k1}, K2 {k2} for {pm.calls} + "
                         f"{im.calls} projection matches (relocalization + insertion), "
                         f"K3 {k3} for {run['n_local_ba']} local BAs")
    return run


def main():
    smi = phase_device()
    phase_build()
    cfg, oc = default_cfg()
    extract = OrbExtractor(oc)   # device=None: the card
    world = SyntheticWorld(cfg, n_landmarks=500, seed=0)
    gt = world.circle_trajectory(352, radius=2.5)[:N_FRAMES]
    t = phase_kernel(extract, world, gt[0])
    phase_extractor(extract, oc, world.render(gt[5]))
    launches = phase_main_path(cfg, oc, extract, world, gt)
    ts = phase_schur()
    slam, run, k1_map, k2_map, k3_map, real_err = phase_mapping(cfg, world)
    k2_err = phase_k2()
    k2_loc, t2, res = phase_localization(cfg, world, slam)
    kernel = dict(
        name="fast_nms", route="cuda", source="se2lam_tpu_torch/csrc/fast_nms.cu",
        replaces="se2lam_tpu/frontend/pallas_fast.py:101", launches=k1_map,
        launches_tracking_path=launches,
        max_abs_err=t["max_abs_err"], max_abs_diff=t["max_abs_err"],
        ms=t["ms"], level_ms=t["level_ms"], eager_ms=t["eager_ms"],
        plain_ms=t["plain_ms"], plain_eager_ms=t["plain_eager_ms"],
        bound_ms=t["bound_ms"], bound_us=1e3 * t["bound_ms"], bound_by=t["bound_by"],
        library_ms=None, px_per_frame=t["px"], card=smi,
    )
    loc, glob = ts[LOCAL_BA_SHAPE], ts[GLOBAL_BA_SHAPE]
    schur_kernel = dict(
        name="schur_reduce", route="cuda", source="se2lam_tpu_torch/csrc/schur_reduce.cu",
        replaces="se2lam_tpu/solver/pallas_schur.py:91", launches=k3_map,
        max_abs_err=loc["max_abs_err"], rel_err=loc["rel_err"], real_ba_max_abs_err=real_err,
        ms=loc["ms"], eager_ms=loc["eager_ms"], plain_ms=loc["plain_ms"],
        plain_eager_ms=loc["plain_eager_ms"], bound_ms=loc["bound_ms"],
        bound_by=loc["bound_by"], library_ms=loc["library_ms"],
        library_eager_ms=loc["library_eager_ms"], shape_KM=LOCAL_BA_SHAPE,
        global_ba=dict(glob, shape_KM=GLOBAL_BA_SHAPE), card=smi,
    )
    match_kernel = dict(
        name="windowed_top2", route="cuda", source="se2lam_tpu_torch/csrc/windowed_top2.cu",
        replaces="se2lam_tpu/frontend/pallas_match.py:137", launches=k2_loc,
        launches_mapping=k2_map, launches_resume=res["k2_launches"], max_abs_err=max(k2_err, t2["max_abs_err"]),
        ms=t2["ms"], eager_ms=t2["eager_ms"], plain_ms=t2["plain_ms"],
        plain_eager_ms=t2["plain_eager_ms"], bound_ms=t2["bound_ms"], bound_by=t2["bound_by"],
        bound_all_pairs_ms=t2["bound_all_pairs_ms"], gated_pairs=t2["gated_pairs"],
        library_ms=None, shape_N1N2=t2["shape"], card=smi,
    )
    print(json.dumps({"kernels": [kernel, schur_kernel, match_kernel]}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    sys.exit(main())
