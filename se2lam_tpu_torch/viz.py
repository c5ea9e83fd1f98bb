"""Offline visualization dumps (port of se2lam_tpu.viz).

The reference's ROS observability surface, rviz markers from MapPublish
(keyframe frusta, map points, covisibility, feature and odometry edges,
src/MapPublish.cpp:207-456) and the FramePublish debug image (the current
frame and its matches, src/FramePublish.cpp:152-203), as static
matplotlib and PIL renderings written to files: the port runs headless.
matplotlib and PIL are imported when a function is called, never when the
module is imported. Inputs may be torch tensors on any device, or arrays.
"""
from __future__ import annotations

import numpy as np
import torch

__all__ = ["plot_trajectories", "plot_map", "draw_frame_debug", "compose_debug_image"]


def _np(x) -> np.ndarray:
    return x.detach().cpu().numpy() if torch.is_tensor(x) else np.asarray(x)


def _pyplot():
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    return plt


def plot_trajectories(path: str, named_xy: dict, title: str = "trajectories"):
    """Top-view overlay of named (n, 2)+ arrays (e.g. gt / odometry / slam)."""
    plt = _pyplot()
    fig, ax = plt.subplots(figsize=(7, 7))
    for name, xy in named_xy.items():
        xy = _np(xy)
        ax.plot(xy[:, 0], xy[:, 1], label=name, lw=1.2)
        ax.plot(xy[0, 0], xy[0, 1], "o", ms=4)
    ax.set_aspect("equal")
    ax.grid(True, alpha=0.3)
    ax.legend()
    ax.set_title(title)
    fig.savefig(path, dpi=120, bbox_inches="tight")
    plt.close(fig)


def plot_map(path: str, ms, title: str = "map"):
    """Top view of the map: valid map points, keyframe poses with heading
    ticks, covisibility and feature edges (the MapPublish marker set,
    flattened to 2D)."""
    plt = _pyplot()
    mp, mv, kf, kv, covis = (_np(x) for x in (ms.mp_pos, ms.mp_valid, ms.kf_pose,
                                              ms.kf_valid, ms.covis))
    fig, ax = plt.subplots(figsize=(8, 8))
    if mv.any():
        ax.scatter(mp[mv, 0], mp[mv, 1], s=2, c="gray", alpha=0.5,
                   label=f"map points ({mv.sum()})")
    ks = np.nonzero(kv)[0]
    for i in ks:
        for j in ks[ks > i]:
            if covis[i, j]:
                ax.plot([kf[i, 0], kf[j, 0]], [kf[i, 1], kf[j, 1]], c="lightblue", lw=0.5,
                        zorder=1)
    if len(ks):
        ax.plot(kf[ks, 0], kf[ks, 1], "b.-", ms=5, lw=1, label=f"keyframes ({len(ks)})",
                zorder=2)
        d = 0.3                                       # heading ticks
        ax.quiver(kf[ks, 0], kf[ks, 1], d * np.cos(kf[ks, 2]), d * np.sin(kf[ks, 2]),
                  color="red", width=0.003, zorder=3)
    edges = np.nonzero(_np(ms.ftr_valid))[0]
    fi, fj = _np(ms.ftr_i), _np(ms.ftr_j)
    for e in edges:
        ax.plot([kf[fi[e], 0], kf[fj[e], 0]], [kf[fi[e], 1], kf[fj[e], 1]], c="green", lw=1.5,
                zorder=2, label="loop/feature edge" if e == edges[0] else None)
    ax.set_aspect("equal")
    ax.grid(True, alpha=0.3)
    ax.legend(loc="best")
    ax.set_title(title)
    # bound the view to the trajectory: a few bad-geometry points awaiting
    # culling would otherwise stretch the autoscale by orders of magnitude
    if len(ks):
        x0, x1 = kf[ks, 0].min(), kf[ks, 0].max()
        y0, y1 = kf[ks, 1].min(), kf[ks, 1].max()
        mx = max(x1 - x0, y1 - y0, 1.0)
        ax.set_xlim(x0 - 0.6 * mx, x1 + 0.6 * mx)
        ax.set_ylim(y0 - 0.6 * mx, y1 + 0.6 * mx)
    fig.savefig(path, dpi=120, bbox_inches="tight")
    plt.close(fig)


def _draw_matches(draw, xy, match_idx, ref_xy, color):
    if match_idx is None or ref_xy is None:
        return
    midx, rxy = _np(match_idx), _np(ref_xy)
    for i in np.nonzero(midx >= 0)[0]:
        x1, y1 = rxy[i]
        x2, y2 = xy[midx[i]]
        draw.line([x1, y1, x2, y2], fill=color)


def _frame_pane(img, feats, match_idx, ref_xy):
    """The current frame in RGB with its keypoints (green) and match lines
    to the reference positions (red)."""
    from PIL import Image, ImageDraw

    arr = np.clip(_np(img), 0, 255).astype(np.uint8)
    im = Image.fromarray(arr).convert("RGB")
    d = ImageDraw.Draw(im)
    xy, valid = _np(feats.xy), _np(feats.valid)
    for i in np.nonzero(valid)[0]:
        x, y = xy[i]
        d.ellipse([x - 2, y - 2, x + 2, y + 2], outline=(0, 255, 0))
    _draw_matches(d, xy, match_idx, ref_xy, (255, 0, 0))
    return im, xy


def _keypoint_pane(base, pts, color, W, H):
    from PIL import ImageDraw

    d = ImageDraw.Draw(base)
    if pts is not None:
        for x, y in _np(pts):
            if 0 <= x < W and 0 <= y < H:
                d.ellipse([x - 2, y - 2, x + 2, y + 2], outline=color)
    return d


def compose_debug_image(path: str, img_cur, feats_cur, match_idx=None, ref_img=None,
                        ref_xy=None, loop_xy=None, loop_match=None, label: str = ""):
    """The FramePublish-style debug canvas (src/FramePublish.cpp:152-203), a
    2x2 grid of::

        [ current frame + match lines | reference keyframe ]
        [ loop-match panel            | (reserved)          ]

    The loop panel draws the loop keyframe's keypoints and the verified
    correspondences from stored geometry (the map keeps keypoints, not
    pixels: no keyframe image is ever stored)."""
    from PIL import Image, ImageDraw

    cur, xy = _frame_pane(img_cur, feats_cur, match_idx, ref_xy)
    W, H = cur.size
    canvas = Image.new("RGB", (2 * W, 2 * H), (16, 16, 16))
    canvas.paste(cur, (0, 0))

    # the reference keyframe: its image if the caller kept one, else black
    if ref_img is not None:
        ref = Image.fromarray(np.clip(_np(ref_img), 0, 255).astype(np.uint8)).convert("RGB")
    else:
        ref = Image.new("RGB", (W, H), (0, 0, 0))
    _keypoint_pane(ref, ref_xy, (0, 200, 255), W, H)
    canvas.paste(ref, (W, 0))

    # the loop panel: keypoint geometry and correspondences
    loop = Image.new("RGB", (W, H), (0, 0, 0))
    dl = _keypoint_pane(loop, loop_xy, (255, 200, 0), W, H)
    if loop_xy is not None:
        _draw_matches(dl, xy, loop_match, loop_xy, (255, 0, 255))
    canvas.paste(loop, (0, H))

    if label:
        ImageDraw.Draw(canvas).text((2 * W - 8 * len(label) - 10, 2 * H - 20), label,
                                    fill=(255, 255, 255))
    canvas.save(path)


def draw_frame_debug(path: str, img, feats, match_idx=None, ref_xy=None):
    """Debug image: keypoints (green), matches as lines to the reference
    positions (red), the FramePublish composition in one pane."""
    _frame_pane(img, feats, match_idx, ref_xy)[0].save(path)
