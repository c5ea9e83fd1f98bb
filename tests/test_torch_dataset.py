"""The port's DatasetRoom reader and writer and its native decoder, against
the JAX package's.

Both writers write the same bytes: every BMP (the port with numpy, the JAX
package with PIL), odo_raw.txt, gt.txt, CamConfig.yml and Settings.yml. A
dataset written by either reads identically in both, through the native
decoder and through PIL. ``SystemConfig.from_yaml`` gives back every field
the reference's YAML carries: Tbc through its Rodrigues vector, printed to
10 digits, within 1e-9; the keyframe cadence, which the format derives
from fps (fps // 3 and fps), is not carried.
"""
import dataclasses
import filecmp
import os

import numpy as np
import pytest
from PIL import Image

from se2lam_tpu.io import DatasetRoom as JaxRoom
from se2lam_tpu.io import write_dataset_room as jax_write
from se2lam_tpu_torch.config import SystemConfig
from se2lam_tpu_torch.convert import config_from_fields
from se2lam_tpu_torch.drivers.run_dataset import synthetic_cfg
from se2lam_tpu_torch.io import DatasetRoom, write_dataset_room
from se2lam_tpu_torch.io import native_loader as nl
from se2lam_tpu_torch.io.dataset import write_gray_bmp

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
N = 5


def _jax_cfg(cfg):
    from se2lam_tpu.config import SystemConfig as JaxConfig
    from se2lam_tpu.config import Capacity as JaxCapacity

    d = dataclasses.asdict(cfg)
    d["cap"] = JaxCapacity(**d["cap"])
    return JaxConfig(**d)


@pytest.fixture(scope="module")
def data():
    rng = np.random.default_rng(0)
    frames = [rng.uniform(-20, 280, (37, 53)) for _ in range(N)]   # clipped on write
    odo = rng.uniform(-1, 1, (N, 3))
    gt = rng.uniform(-1, 1, (N, 3))
    return frames, odo, gt, [np.clip(f, 0, 255).astype(np.uint8) for f in frames]


@pytest.fixture(scope="module")
def both(tmp_path_factory, data):
    frames, odo, gt, _ = data
    cfg = synthetic_cfg()
    pt = str(tmp_path_factory.mktemp("port"))
    jx = str(tmp_path_factory.mktemp("jax"))
    return (write_dataset_room(pt, frames, odo, cfg, gt=gt),
            jax_write(jx, frames, odo, _jax_cfg(cfg), gt=gt), cfg)


def test_writers_write_the_same_bytes(both):
    pt, jx, _ = both
    for name in ["odo_raw.txt", "gt.txt"] + [f"image/{i}.bmp" for i in range(N)]:
        assert filecmp.cmp(os.path.join(pt, name), os.path.join(jx, name), shallow=False), name
    for name in ("CamConfig.yml", "Settings.yml"):
        assert filecmp.cmp(os.path.join(pt, "..", name), os.path.join(jx, "..", name),
                           shallow=False), name


@pytest.mark.parametrize("writer", ["port", "jax"])
@pytest.mark.parametrize("native", [True, False], ids=["native", "pil"])
def test_either_dataset_reads_the_same_in_both(both, data, writer, native):
    root = both[0] if writer == "port" else both[1]
    want = data[3]
    got_t = list(DatasetRoom(root, use_native=native))
    got_j = list(JaxRoom(root, use_native=native))
    assert len(got_t) == len(got_j) == N
    for (ti, to), (ji, jo), w in zip(got_t, got_j, want):
        assert ti.dtype == np.uint8 and ti.shape == w.shape
        np.testing.assert_array_equal(ti, w)
        np.testing.assert_array_equal(ti, ji)
        np.testing.assert_array_equal(to, jo)


def test_start_and_count(both, data):
    ds = DatasetRoom(both[0], start=1, count=3)
    got = list(ds)
    assert len(ds) == 3 and len(got) == 3
    np.testing.assert_array_equal(got[0][0], data[3][1])


def test_yaml_round_trip(both):
    pt, _, cfg = both
    got = SystemConfig.from_yaml(os.path.join(pt, "..", "CamConfig.yml"),
                                 os.path.join(pt, "..", "Settings.yml"))
    np.testing.assert_allclose(got.Tbc, cfg.Tbc, rtol=0, atol=1e-9)
    assert (got.min_frames_between_kf, got.max_frames_between_kf) == (cfg.fps // 3, cfg.fps)
    assert got.replace(Tbc=cfg.Tbc, min_frames_between_kf=cfg.min_frames_between_kf,
                       max_frames_between_kf=cfg.max_frames_between_kf) == cfg


def test_yaml_round_trip_of_a_rotated_extrinsic(tmp_path):
    """A near-pi extrinsic rotation takes the writer's diagonal branch."""
    cfg = synthetic_cfg()
    Tbc = np.diag([1.0, -1.0, -1.0, 1.0])          # pi about x
    Tbc[:3, 3] = (0.1, -0.2, 0.3)
    cfg = cfg.replace(Tbc=tuple(Tbc.ravel()))
    write_dataset_room(str(tmp_path), [np.zeros((4, 4))], np.zeros((1, 3)), cfg)
    got = SystemConfig.from_yaml(str(tmp_path / "CamConfig.yml"), str(tmp_path / "Settings.yml"))
    np.testing.assert_allclose(got.Tbc, cfg.Tbc, rtol=0, atol=1e-9)


def test_config_fields_match_the_jax_reader(both):
    from se2lam_tpu.config import SystemConfig as JaxConfig

    pt = both[0]
    args = (os.path.join(pt, "..", "CamConfig.yml"), os.path.join(pt, "..", "Settings.yml"))
    want = config_from_fields(dataclasses.asdict(JaxConfig.from_yaml(*args)))
    assert SystemConfig.from_yaml(*args) == want


@pytest.mark.parametrize("native", [True, False], ids=["native", "pil"])
def test_truncated_datasets_end_cleanly(tmp_path, data, native):
    frames, odo, gt, want = data
    root = write_dataset_room(str(tmp_path), frames, odo, synthetic_cfg())
    os.remove(os.path.join(root, "image", "3.bmp"))          # a gap at frame 3
    got = list(DatasetRoom(root, use_native=native))
    assert len(got) == 3
    with open(os.path.join(root, "odo_raw.txt"), "w") as f:  # odometry shorter
        f.write("0 0 0\n1 1 1\n")
    ds = DatasetRoom(root, use_native=native)
    assert len(ds) == 2 and len(list(ds)) == 2
    assert len(DatasetRoom(root, start=5, use_native=native)) == 0


def test_native_decode_matches_pil(tmp_path):
    """The native decoder against PIL on the port's gray BMPs (exact) and
    on PIL's 24-bit RGB ones (one gray level of rounding)."""
    rng = np.random.default_rng(1)
    for i, shape in enumerate([(37, 53), (1, 1), (480, 640), (7, 4)]):
        a = rng.integers(0, 256, shape).astype(np.uint8)
        p = str(tmp_path / f"g{i}.bmp")
        write_gray_bmp(p, a)
        np.testing.assert_array_equal(nl.decode_bmp(p), a)
        np.testing.assert_array_equal(np.asarray(Image.open(p).convert("L")), a)
        rgb = rng.integers(0, 256, shape + (3,)).astype(np.uint8)
        q = str(tmp_path / f"c{i}.bmp")
        Image.fromarray(rgb, mode="RGB").save(q)
        ref = np.asarray(Image.open(q).convert("L"), np.int32)
        assert np.abs(nl.decode_bmp(q).astype(np.int32) - ref).max() <= 1


def test_malformed_bmp_is_rejected(tmp_path):
    p = tmp_path / "bad.bmp"
    p.write_bytes(b"BM" + b"\x00" * 10)
    assert nl.decode_bmp(str(p)) is None
    write_gray_bmp(str(p), np.zeros((8, 8), np.uint8))
    p.write_bytes(p.read_bytes()[:-10])                      # pixel rows cut short
    assert nl.decode_bmp(str(p)) is None
    assert nl.decode_bmp(str(tmp_path / "missing.bmp")) is None


def test_rejected_frame_falls_back_to_pil(tmp_path, data):
    """A 1-bit BMP (which the native decoder does not handle) in the middle
    of a native stream is decoded by PIL, and the stream goes on."""
    frames, odo, _, want = data
    root = write_dataset_room(str(tmp_path), frames, odo, synthetic_cfg())
    bw = (want[2] > 127).astype(np.uint8) * 255
    Image.fromarray(bw, mode="L").convert("1").save(os.path.join(root, "image", "2.bmp"))
    with pytest.raises(nl.NativeDecodeError):
        pf = nl.NativePrefetcher(os.path.join(root, "image"), 2, 1)
        try:
            next(pf)
        finally:
            pf.close()
    ds = DatasetRoom(root)
    assert ds.use_native
    got = [img for img, _ in ds]
    assert len(got) == N
    np.testing.assert_array_equal(got[2], bw)
    np.testing.assert_array_equal(got[3], want[3])


def test_prefetcher_order(both, data):
    got = list(nl.NativePrefetcher(os.path.join(both[0], "image"), 0, N, threads=3))
    assert len(got) == N
    for g, w in zip(got, data[3]):
        np.testing.assert_array_equal(g, w)


def test_native_source_is_the_jax_package_copy_built_under_build():
    ref = os.path.join(REPO, "se2lam_tpu", "native", "se2lam_native.cpp")
    assert filecmp.cmp(str(nl.SOURCE), ref, shallow=False)
    assert nl.native_available()
    assert nl.LIB_PATH.is_file()
    assert nl.LIB_PATH.parent == nl.PKG.parent / "build" / "se2lam_tpu_torch" / "native"
