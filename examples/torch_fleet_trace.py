"""Where a fleet tracking step's results depend on the fleet's size B.

Runs ``parallel.make_fleet_tracker``'s step over ``--frames`` frames for
B = 2, 4 and 8 robots (robot b on ``SyntheticWorld(n_landmarks=500,
seed=b)``'s circle, as ``chip_smoke.py``'s fleet phase) and for each robot
alone (B = 1), and prints every (robot, step) whose ``need_kf`` or
``n_matched`` differs. Then, at the first such step (step 1 if none),
it gives every robot its single-robot state and inputs and runs each
stage of ``tracking.track_frame`` (and the batch extraction) under
``torch.vmap`` at that B and at B = 1, and unbatched: per stage, the
output elements that differ bitwise between the batched and the B = 1
result, and the largest difference. Stage inputs come from the unbatched
path, so each stage is tested on its own. One line per stage:

    TRACE <stage> B=<B> differ_vs_B1 <n> max_abs <x> differ_B1_vs_unbatched <n>
        per_output [<n> for each output tensor]

Usage: ``python3 examples/torch_fleet_trace.py`` on a machine with a CUDA
card (``--device cpu --small`` runs it at 320x240 on the CPU);
``--step 2 --stage-sizes 2,4,8`` tests the stages at step 2 for fleets of
2, 4 and 8 robots and skips the fleet comparison.
"""
from __future__ import annotations

import argparse
import math
import sys
from pathlib import Path

import numpy as np
import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

from se2lam_tpu_torch import factors, tracking  # noqa: E402
from se2lam_tpu_torch.entry import default_cfg  # noqa: E402
from se2lam_tpu_torch.frontend import ransac  # noqa: E402
from se2lam_tpu_torch.frontend.matcher import match_by_window  # noqa: E402
from se2lam_tpu_torch.frontend.orb import OrbExtractor  # noqa: E402
from se2lam_tpu_torch.io.synthetic import SyntheticWorld  # noqa: E402
from se2lam_tpu_torch.ops import fixed_order, se2  # noqa: E402
from se2lam_tpu_torch.ops.linalg import inv_psd_small  # noqa: E402
from se2lam_tpu_torch.ops.triangulate import triangulate  # noqa: E402
from se2lam_tpu_torch.parallel import make_fleet_tracker  # noqa: E402


def tmap(fn, *trees):
    """``fn`` over the tensors of equally shaped (named) tuples."""
    t = trees[0]
    if isinstance(t, tuple):
        out = [tmap(fn, *xs) for xs in zip(*trees)]
        return type(t)(*out) if hasattr(t, "_fields") else tuple(out)
    return fn(*trees)


def leaves(t):
    return [x for xs in t for x in leaves(xs)] if isinstance(t, tuple) else [t]


def diff(a, b):
    """(elements that differ bitwise, largest |a - b| over finite pairs)."""
    if a.dtype == torch.bool or not a.is_floating_point():
        ne = a != b
        return int(ne.sum()), float((a.long() - b.long()).abs().max()) if a.numel() else 0.0
    same = (a == b) | (torch.isnan(a) & torch.isnan(b))
    fin = torch.isfinite(a) & torch.isfinite(b)
    d = (a - b).abs()[fin]
    return int((~same).sum()), float(d.max()) if d.numel() else 0.0


def pred_xy(ts, odom, cfg):
    """Step 1 of ``track_frame``: the window centres."""
    c = tracking.constants(cfg, odom.device)
    d_step = se2.minus(odom, ts.last_odom)
    Rcc = (c["Tcb"] @ se2.to_se3(se2.inv(d_step)) @ c["Tbc"])[:3, :3]
    H = c["Kmat"] @ Rcc @ c["Kinv"]
    ones = torch.ones_like(ts.prev_matched[:, :1])
    ph = torch.cat([ts.prev_matched, ones], dim=1) @ H.T
    return ph[:, :2] / torch.clamp(ph[:, 2:3], min=1e-6)


def design(p1, p2):
    """``ransac._eight_point``'s (T, 8, 9) design matrices."""
    x1, y1, x2, y2 = p1[..., 0], p1[..., 1], p2[..., 0], p2[..., 1]
    return torch.stack([x2 * x1, x2 * y1, x2, y2 * x1, y2 * y1, y2, x1, y1,
                        torch.ones_like(x1)], dim=-1)


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--small", action="store_true")
    ap.add_argument("--frames", type=int, default=16)
    ap.add_argument("--step", type=int, default=None,
                    help="trace at this step and skip the fleet comparison")
    ap.add_argument("--stage-sizes", default=None,
                    help="fleet sizes of the stage tests, e.g. 2,4,8 (default: the traced B)")
    a = ap.parse_args()
    dev = torch.device(a.device)
    cfg, oc = default_cfg(**(dict(width=320, height=240, n_features=300, n_levels=3)
                             if a.small else {}))
    sizes = (2, 4, 8)
    Bmax, T = max(sizes), a.frames
    imgs, odos = [], []
    for b in range(Bmax):
        w = SyntheticWorld(cfg, n_landmarks=500, seed=b)
        gt = w.circle_trajectory(352, radius=2.5)[:T]
        imgs.append(np.stack([w.render(p) for p in gt]))
        odos.append(gt)
    imgs = torch.from_numpy(np.stack(imgs)).to(dev)
    odos = torch.from_numpy(np.stack(odos).astype(np.float32)).to(dev)
    noise = torch.stack([torch.stack([tracking.draw_track_noise(g, cfg) for _ in range(1, T)])
                         for g in (torch.Generator(device=dev).manual_seed(b)
                                   for b in range(Bmax))])
    init_fn, step_fn, extract_fn = make_fleet_tracker(cfg, oc, device=dev)
    ext = OrbExtractor(oc, device=dev)

    def run(rb):
        ts = init_fn(extract_fn(imgs[rb, 0]), odos[rb, 0], odos[rb, 0])
        states, out = [], []
        for t in range(1, T):
            states.append(ts)
            ts, res = step_fn(ts, imgs[rb, t], odos[rb, t], noise[rb, t - 1])
            out.append(torch.stack([res.need_kf.long(), res.n_matched.long()], 1).cpu())
        return states, torch.stack(out, 1)                          # (B, T-1, 2)

    alone = [run([b]) for b in range(Bmax)]
    first = None
    for B in (() if a.step is not None else sizes):
        _, got = run(list(range(B)))
        for b in range(B):
            want = alone[b][1][0]
            for s in range(T - 1):
                if not torch.equal(got[b, s], want[s]):
                    print(f"DIFF B={B} robot {b} step {s + 1}: need_kf,n_matched "
                          f"{got[b, s].tolist()} batched, {want[s].tolist()} alone", flush=True)
                    if first is None or (B, s) < first:
                        first = (B, s)
    if a.step is not None:
        first = (sizes[0], a.step - 1)
    B, s = first if first is not None else (sizes[0], 0)
    stage_sizes = [int(x) for x in a.stage_sizes.split(",")] if a.stage_sizes else [B]
    print(f"TRACE at step {s + 1}, B = {stage_sizes}", flush=True)

    # every robot's single-robot state and inputs at step s + 1, unbatched
    one = [dict(ts=tmap(lambda x: x[0], alone[b][0][s]), img=imgs[b, s + 1],
                odo=odos[b, s + 1], g=noise[b, s]) for b in range(max(stage_sizes))]
    for r in one:
        r["feats"] = tmap(lambda x: x[0], extract_fn(r["img"][None]))
        r["pred"] = pred_xy(r["ts"], r["odo"], cfg)
        r["midx"] = match_by_window(r["ts"].ref_feats, r["feats"], r["pred"], 20.0, 0.9).idx2
        r["p2"] = tracking._gather_rows(r["feats"].xy, r["midx"])
        r["ok"] = r["midx"] >= 0
        (r["n1"], _), (r["n2"], _) = (ransac._normalize(r["ts"].ref_feats.xy, r["ok"]),
                                      ransac._normalize(r["p2"], r["ok"]))
        gm = torch.where(r["ok"][None, :], r["g"], torch.full_like(r["g"], -math.inf))
        r["idx"] = torch.sort(gm, dim=1, descending=True, stable=True).indices[:, :8]
        r["A"] = design(r["n1"][r["idx"]], r["n2"][r["idx"]])
        r["AtA"] = r["A"].transpose(-1, -2) @ r["A"]
        r["F"] = ransac._eight_point(r["n1"][r["idx"]], r["n2"][r["idx"]])
        # _eight_point's intermediates: the unprojected F, its FᵀF, v3, u3
        r["F0"] = ransac._min_eigvec(r["AtA"]).reshape(-1, 3, 3)
        r["F0tF0"] = r["F0"].transpose(-1, -2) @ r["F0"]
        r["v3"] = ransac._min_eigvec(r["F0tF0"], iters=20)
        r["wpts"] = (r["p2"] * r["ok"].to(r["p2"].dtype)[:, None]).T.contiguous()

    n9 = 9
    stages = [
        ("extract", lambda img: extract_fn(img[None]), ("img",), "frames"),
        ("track_frame", lambda ts, f, o, g: tracking.track_frame(ts, f, o, cfg, gumbel=g),
         ("ts", "feats", "odo", "g"), None),
        ("pred_xy", lambda ts, o: pred_xy(ts, o, cfg), ("ts", "odo"), None),
        ("match_by_window", lambda f1, f2, p: match_by_window(f1, f2, p, 20.0, 0.9),
         ("ts.ref_feats", "feats", "pred"), None),
        ("ransac_fundamental", lambda p1, p2, ok, g: ransac.ransac_fundamental(
            p1, p2, ok, n_trials=cfg.cap.ransac_trials, thresh_px=3.0, min_inliers=10,
            gumbel=g), ("ts.ref_feats.xy", "p2", "ok", "g"), None),
        ("ransac._normalize", ransac._normalize, ("p2", "ok"), None),
        ("ransac.sample_sort", lambda g, ok: torch.sort(torch.where(
            ok[None, :], g, torch.full_like(g, -math.inf)), dim=1, descending=True,
            stable=True).indices[:, :8], ("g", "ok"), None),
        ("ransac.design", lambda n1, n2, idx: design(n1[idx], n2[idx]),
         ("n1", "n2", "idx"), None),
        ("ransac.AtA (A^T @ A)", lambda A: A.transpose(-1, -2) @ A, ("A",), None),
        ("inv_psd_small(AtA)", lambda M: inv_psd_small(
            M + 1e-9 * (torch.diagonal(M, dim1=-2, dim2=-1).sum(-1)[..., None, None] / n9)
            * torch.eye(n9, device=M.device) + 1e-30 * torch.eye(n9, device=M.device)),
         ("AtA",), None),
        ("ransac._min_eigvec(AtA)", ransac._min_eigvec, ("AtA",), None),
        ("ransac._eight_point", lambda n1, n2, idx: ransac._eight_point(n1[idx], n2[idx]),
         ("n1", "n2", "idx"), None),
        ("ransac.FtF (F^T @ F)", lambda F: F.transpose(-1, -2) @ F, ("F",), None),
        ("ransac._min_eigvec(F0tF0, 20)", lambda M: ransac._min_eigvec(M, iters=20),
         ("F0tF0",), None),
        # single operations, in the forms before and after the rewrite
        ("op: sum over 1000 points, torch.sum", lambda x: x.sum(-1), ("wpts",), None),
        ("op: sum over 1000 points, fixed_order.sum_points",
         lambda x: fixed_order.sum_points(x, -1), ("wpts",), None),
        ("op: fixed_order.matmul(A^T, A)", lambda A: fixed_order.matmul(A.transpose(-1, -2), A),
         ("A",), None),
        ("op: x1 @ F^T (Sampson, matmul)",
         lambda F, n1: torch.cat([n1, torch.ones_like(n1[:, :1])], -1) @ F.transpose(-1, -2),
         ("F", "n1"), None),
        ("op: fixed_order.matmul(x1, F^T) (Sampson)", lambda F, n1: fixed_order.matmul(
            torch.cat([n1, torch.ones_like(n1[:, :1])], -1), F.transpose(-1, -2)),
         ("F", "n1"), None),
        ("op: einsum ...ij,...j->...i (3x3)",
         lambda M, v: torch.einsum("...ij,...j->...i", M, v), ("F0tF0", "v3"), None),
        ("op: fixed_order.rows_matvec (3x3)", fixed_order.rows_matvec, ("F0tF0", "v3"), None),
        ("op: einsum tij,tj->ti", lambda F, v: torch.einsum("tij,tj->ti", F, v),
         ("F0", "v3"), None),
        ("op: einsum ti,tij->tj", lambda F, v: torch.einsum("ti,tij->tj", v, F),
         ("F0", "v3"), None),
        ("op: fixed_order.rows_vecmat (3x3)", fixed_order.rows_vecmat, ("v3", "F0"), None),
        ("op: linalg.norm of 3-vectors", lambda v: torch.linalg.norm(v, dim=-1),
         ("v3",), None),
        ("op: diagonal sum (9x9)",
         lambda M: torch.diagonal(M, dim1=-2, dim2=-1).sum(-1), ("AtA",), None),
        ("ransac._sampson", ransac._sampson, ("F", "n1", "n2"), None),
        ("triangulate", lambda ts, p2, o: triangulate(
            ts.ref_feats.xy, p2, *cam_projections(ts, o, cfg)), ("ts", "p2", "odo"), None),
        ("preintegrate_se2", lambda ts, o: factors.preintegrate_se2(
            ts.pre_meas, ts.pre_cov, se2.minus(o, ts.last_odom),
            tracking.constants(cfg, o.device)["odo_noise"]), ("ts", "odo"), None),
    ]

    def get(r, key):
        head, *rest = key.split(".")
        v = r[head]
        for k in rest:
            v = getattr(v, k)
        return v

    for B, (name, fn, keys, kind) in ((B, st) for B in stage_sizes for st in stages):
        args = [[get(r, k) for k in keys] for r in one[:B]]
        if kind == "frames":       # the extractor batches frames itself
            outB = extract_fn(torch.stack([x[0] for x in args]))
            out1 = [extract_fn(x[0][None]) for x in args]
            outU = [ext.forward(x[0]) for x in args]
        else:
            outB = torch.vmap(fn)(*[tmap(lambda *xs: torch.stack(xs), *col)
                                    for col in zip(*args)])
            out1 = [torch.vmap(fn)(*[tmap(lambda x: x[None], a) for a in x]) for x in args]
            outU = [fn(*x) for x in args]
        n_leaf = [0] * len(leaves(outB))
        n_u, mx = 0, 0.0
        for b in range(B):
            lb = leaves(tmap(lambda x, b=b: x[b], outB))
            l1 = leaves(tmap(lambda x: x[0], out1[b]))
            for i, (x, y) in enumerate(zip(lb, l1)):
                n, m = diff(x, y)
                n_leaf[i], mx = n_leaf[i] + n, max(mx, m)
            for x, y in zip(l1, leaves(outU[b])):
                n_u += diff(x, y)[0]
        print(f"TRACE {name} B={B} differ_vs_B1 {sum(n_leaf)} max_abs {mx:.9g} "
              f"differ_B1_vs_unbatched {n_u} per_output {n_leaf}", flush=True)


def cam_projections(ts, odom, cfg):
    """``track_frame``'s reference and current projection matrices."""
    c = tracking.constants(cfg, odom.device)
    d_ref = se2.minus(ts.ref_odom, odom)
    Tcr = c["Tcb"] @ se2.to_se3(d_ref) @ c["Tbc"]
    K3 = c["cam"].K
    P_ref = torch.cat([K3, torch.zeros_like(K3[:, :1])], dim=1)
    return P_ref[None], (K3 @ Tcr[:3, :])[None]


if __name__ == "__main__":
    main()
