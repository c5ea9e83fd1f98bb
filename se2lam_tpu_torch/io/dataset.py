"""DatasetRoom-format reader and writer (port of se2lam_tpu.io.dataset).

Reads the reference demo dataset layout (test/test_vn.cpp:33-55):
``<root>/image/<i>.bmp`` grayscale frames plus ``<root>/odo_raw.txt`` with
one ``x y theta`` line per frame, fed in lock-step. ``write_dataset_room``
writes the same layout with the two OpenCV-YAML config files the reference
reads (src/Config.cpp:83-186), so rendered sequences run the whole
disk, decode, YAML and SLAM path.

The writer needs no imaging library: it writes 8-bit grayscale BMPs with
numpy, in the layout PIL writes for a mode-"L" image (a 256-entry gray
palette, bottom-up rows padded to 4 bytes). The reader decodes with the
native worker pool (``native_loader``); PIL is imported only to decode a
frame the native decoder rejects, or when the native path is off.
"""
from __future__ import annotations

import os
import struct

import numpy as np

__all__ = ["DatasetRoom", "write_dataset_room", "write_gray_bmp"]

_GRAY_PALETTE = bytes(np.repeat(np.arange(256, dtype=np.uint8), 4).reshape(256, 4)
                      * np.array([1, 1, 1, 0], np.uint8))
_PPM = 3780          # 96 dpi in pixels per metre, as PIL writes it


def write_gray_bmp(path: str, img) -> None:
    """Write an (H, W) uint8 image as an uncompressed 8-bit BMP with a gray
    palette."""
    a = np.asarray(img, np.uint8)
    if a.ndim != 2:
        raise ValueError(f"write_gray_bmp: want an (H, W) image, got shape {a.shape}")
    h, w = a.shape
    stride = (w + 3) & ~3
    offset = 14 + 40 + len(_GRAY_PALETTE)
    rows = np.zeros((h, stride), np.uint8)
    rows[:, :w] = a[::-1]                       # bottom-up
    with open(path, "wb") as f:
        f.write(b"BM" + struct.pack("<III", offset + rows.size, 0, offset))
        f.write(struct.pack("<IiiHHIIiiII", 40, w, h, 1, 8, 0, rows.size, _PPM, _PPM,
                            256, 256))
        f.write(_GRAY_PALETTE)
        f.write(rows.tobytes())


def _cv_yaml_matrix(name: str, arr: np.ndarray) -> str:
    a = np.asarray(arr, np.float64)
    rows, cols = (a.shape + (1,))[:2] if a.ndim > 1 else (a.size, 1)
    flat = ", ".join(f"{v:.10g}" for v in a.ravel())
    return (f"{name}: !!opencv-matrix\n   rows: {rows}\n   cols: {cols}\n"
            f"   dt: d\n   data: [ {flat} ]\n")


def _rodrigues(R: np.ndarray) -> np.ndarray:
    """The rotation vector of a rotation matrix (the inverse of what
    ``SystemConfig.from_yaml`` applies to ``rvec_b_c``)."""
    cos_t = (np.trace(R) - 1.0) / 2.0
    theta = float(np.arccos(np.clip(cos_t, -1.0, 1.0)))
    if theta < 1e-12:
        return np.zeros(3)
    if theta > np.pi - 1e-6:
        # near pi the off-diagonal formula divides by 2 sin(theta) ~ 0:
        # |axis| from the diagonal of R = 2 a a^T - I, the signs from the
        # off-diagonals
        axis = np.sqrt(np.maximum((np.diag(R) + 1.0) / 2.0, 0.0))
        i = int(np.argmax(axis))                 # largest, sign anchor
        for j in range(3):
            if j != i and axis[j] > 0:
                axis[j] *= np.sign(R[i, j] + R[j, i]) or 1.0
        axis /= max(np.linalg.norm(axis), 1e-12)
        return axis * theta
    axis = np.array([R[2, 1] - R[1, 2], R[0, 2] - R[2, 0], R[1, 0] - R[0, 1]]) / (
        2.0 * np.sin(theta))
    return axis * theta


def _write_rows(path: str, rows: np.ndarray, n: int):
    rows = np.asarray(rows, np.float64)
    with open(path, "w") as f:
        for i in range(min(n, len(rows))):
            f.write(f"{rows[i, 0]:.6f} {rows[i, 1]:.6f} {rows[i, 2]:.6f}\n")


def write_dataset_room(parent: str, frames, odo: np.ndarray, cfg,
                       dataset_name: str = "DatasetRoom", gt: np.ndarray | None = None) -> str:
    """Write a DatasetRoom-format dataset to disk::

        <parent>/CamConfig.yml          intrinsics, distortion, extrinsic
        <parent>/Settings.yml           runtime settings (the reference's
                                        keys, with its 'scale_facotr' [sic])
        <parent>/<name>/image/<i>.bmp   8-bit grayscale frames
        <parent>/<name>/odo_raw.txt     one 'x y theta' line per frame
        <parent>/<name>/gt.txt          ground truth, when ``gt`` is given

    ``frames`` is an iterable of (H, W) arrays, clipped to [0, 255] and
    cast to uint8; ``odo`` and ``gt`` are (n, 3). Returns the dataset root
    (``<parent>/<name>``)."""
    root = os.path.join(parent, dataset_name)
    img_dir = os.path.join(root, "image")
    os.makedirs(img_dir, exist_ok=True)
    n = 0
    for i, frame in enumerate(frames):
        write_gray_bmp(os.path.join(img_dir, f"{i}.bmp"),
                       np.clip(np.asarray(frame), 0, 255).astype(np.uint8))
        n += 1
    _write_rows(os.path.join(root, "odo_raw.txt"), odo, n)
    if gt is not None:
        _write_rows(os.path.join(root, "gt.txt"), gt, n)

    K = np.array([[cfg.fx, 0, cfg.cx], [0, cfg.fy, cfg.cy], [0, 0, 1]], np.float64)
    Tbc = np.asarray(cfg.Tbc_mat, np.float64)
    with open(os.path.join(parent, "CamConfig.yml"), "w") as f:
        f.write("%YAML:1.0\n---\n")
        f.write(f"image_width: {cfg.width}\n")
        f.write(f"image_height: {cfg.height}\n")
        f.write(_cv_yaml_matrix("camera_matrix", K))
        f.write(_cv_yaml_matrix("distortion_coefficients", np.asarray(cfg.dist, np.float64)))
        f.write(_cv_yaml_matrix("rvec_b_c", _rodrigues(Tbc[:3, :3])))
        f.write(_cv_yaml_matrix("tvec_b_c", Tbc[:3, 3]))

    with open(os.path.join(parent, "Settings.yml"), "w") as f:
        f.write("%YAML:1.0\n---\n")
        for key, val in (
            ("fps", cfg.fps),
            ("upper_depth", cfg.upper_depth),
            ("lower_depth", cfg.lower_depth),
            ("odo_x_uncertain", cfg.odo_x_uncertain),
            ("odo_y_uncertain", cfg.odo_y_uncertain),
            ("odo_theta_uncertain", cfg.odo_t_uncertain),
            ("odo_x_steady_noise", cfg.odo_x_noise),
            ("odo_y_steady_noise", cfg.odo_y_noise),
            ("odo_theta_steady_noise", cfg.odo_t_noise),
            ("plane_motion_xrot_info", cfg.plane_motion_xrot_info),
            ("plane_motion_yrot_info", cfg.plane_motion_yrot_info),
            ("plane_motion_z_info", cfg.plane_motion_z_info),
            ("th_huber2", cfg.th_huber2),
            ("local_iter", cfg.local_iter),
            ("global_iter", cfg.global_iter),
            ("max_feature_num", cfg.max_feature_num),
            ("scale_facotr", cfg.scale_factor),   # [sic] Config.cpp:137
            ("max_level", cfg.max_level),
        ):
            f.write(f"{key}: {val}\n")
    return root


def _pil_gray(path: str) -> np.ndarray:
    from PIL import Image

    return np.asarray(Image.open(path).convert("L"), np.uint8)


class DatasetRoom:
    """Iterator over (gray image uint8 (H, W), odometry (3,) float32) pairs.

    Frames are decoded by the native worker pool by default (decode and
    file IO off the Python thread while the device works); a frame the
    native decoder rejects is decoded with PIL, and ``use_native=False``
    (or no toolchain) decodes every frame with PIL. Frames stay uint8: the
    extractor casts them on the device. The length is the lock-step
    minimum of odometry rows and contiguous frames on disk, so a truncated
    dataset ends the stream instead of failing in the middle of it.
    """

    def __init__(self, root: str, start: int = 0, count: int | None = None,
                 use_native: bool | None = None):
        self.root = root
        rows = []
        with open(os.path.join(root, "odo_raw.txt")) as f:
            for ln in f:
                parts = ln.split()
                if len(parts) >= 3:
                    rows.append([float(p) for p in parts[:3]])
        self.odo = np.asarray(rows, np.float32).reshape(-1, 3)
        n = max(0, len(self.odo) - start)   # a start past the end is empty
        n_img = 0
        while n_img < n and os.path.exists(self.image_path(start + n_img)):
            n_img += 1
        n = min(n, n_img)
        self.start = start
        self.count = n if count is None else min(count, n)
        if use_native is None:
            from .native_loader import native_available

            use_native = native_available()
        self.use_native = use_native

    def __len__(self):
        return self.count

    def image_path(self, i: int) -> str:
        return os.path.join(self.root, "image", f"{i}.bmp")

    def _iter_native(self):
        from .native_loader import NativeDecodeError, NativePrefetcher

        pf = NativePrefetcher(os.path.join(self.root, "image"), self.start, self.count)
        try:
            for i in range(self.start, self.start + self.count):
                try:
                    img = next(pf)
                except NativeDecodeError:
                    # a BMP variant the native decoder does not handle (RLE,
                    # 1/4/16-bit): PIL decodes this frame alone
                    try:
                        img = _pil_gray(self.image_path(i))
                    except FileNotFoundError:
                        return      # the frame vanished mid-run: end cleanly
                except StopIteration:
                    return
                yield img, self.odo[i]
        finally:
            pf.close()

    def __iter__(self):
        if self.use_native:
            yield from self._iter_native()
            return
        for i in range(self.start, self.start + self.count):
            try:
                img = _pil_gray(self.image_path(i))
            except FileNotFoundError:
                return              # the frame vanished mid-run: end cleanly
            yield img, self.odo[i]
