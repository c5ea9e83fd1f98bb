"""Drive the PyTorch port's main path on one NVIDIA GPU and check it.

    python3 chip_smoke.py

Run from the root of a checkout, on a machine with one CUDA card and
``nvcc`` (``/usr/local/cuda/bin``). Phases, each of which ends the run with
a nonzero exit if it fails:

1. device: the card's name and power limit (``nvidia-smi``), CUDA version;
2. build: compiles the port's CUDA kernels from ``se2lam_tpu_torch/csrc``;
3. kernel against plain: the FAST+NMS kernel against its plain PyTorch
   version on the card, bitwise over the whole map, at the five pyramid
   levels of a rendered bench frame and on a random 231x309 image; times
   both with CUDA events;
4. extractor: the ORB extractor on the card against the same extractor on
   the CPU, on one bench frame;
5. main path: ORB extraction and the tracking step over 20 frames of the
   synthetic bench world at 640x480, 1000 features, 5 levels, re-seeding
   the reference frame where the step asks for a keyframe; checks the
   launches, poses, feature and match counts and the keyframe timing.

It prints the kernels' JSON line before the last line, and last
``{"ok": true, "device": {...}}``. Nothing of JAX is imported.
"""
from __future__ import annotations

import json
import math
import subprocess
import sys
import time

import numpy as np
import torch

from se2lam_tpu_torch import tracking
from se2lam_tpu_torch.entry import default_cfg, entry
from se2lam_tpu_torch.frontend import fast_nms as K1
from se2lam_tpu_torch.frontend.orb import OrbExtractor
from se2lam_tpu_torch.io.synthetic import SyntheticWorld
from se2lam_tpu_torch.kernels import build_all, load_library

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
    kernel = dict(
        name="fast_nms", route="cuda", source="se2lam_tpu_torch/csrc/fast_nms.cu",
        replaces="se2lam_tpu/frontend/pallas_fast.py:101", launches=launches,
        max_abs_err=t["max_abs_err"], max_abs_diff=t["max_abs_err"],
        ms=t["ms"], level_ms=t["level_ms"], eager_ms=t["eager_ms"],
        plain_ms=t["plain_ms"], plain_eager_ms=t["plain_eager_ms"],
        bound_ms=t["bound_ms"], bound_us=1e3 * t["bound_ms"], bound_by=t["bound_by"],
        library_ms=None, px_per_frame=t["px"], card=smi,
    )
    print(json.dumps({"kernels": [kernel]}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    sys.exit(main())
