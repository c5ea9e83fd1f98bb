"""The port's live TCP server and client.

On the CPU, at the 160x120 configuration of ``tests/test_mapmerge.py``:
the replies of a served ``SlamSystem`` equal, frame for frame and bit for
bit, ``process_chunk`` in chunks of the server's size on a fresh system
(the f32 poses cross the wire unchanged; the feeds are whole chunks and
the flush timeout long, so the server's chunks are those chunks); a
pipelined server equals ``process_async`` (on the CPU every feed gives
``process``'s bits, so the quiet-feed flushes change nothing); a served
``Localizer`` equals its ``process_chunk``.
Then the protocol's edges: the flush timeout answers a quiet feed, a
client that dies mid-message or an estimator error leaves the server
serving the next client, and the wire crosses both ways between the JAX
package's client and server and the port's, around a stub estimator.
"""
import dataclasses
import socket
import types

import numpy as np
import pytest
import torch

from se2lam_tpu.io import liveserver as jls
from se2lam_tpu_torch.convert import config_from_fields
from se2lam_tpu_torch.io import SyntheticWorld, load_map
from se2lam_tpu_torch.io import liveserver as tls
from se2lam_tpu_torch.localizer import Localizer
from se2lam_tpu_torch.system import SlamSystem

from test_mapmerge import _cfg

torch.set_num_threads(2)
N_FRAMES, CHUNK = 24, 8


@pytest.fixture(scope="module")
def feed():
    cfg = config_from_fields(dataclasses.asdict(_cfg()))
    world = SyntheticWorld(cfg, n_landmarks=400, room=10.0, seed=2)
    gt = np.asarray(world.circle_trajectory(80))[:N_FRAMES]
    imgs = [np.clip(world.render(g), 0, 255).astype(np.uint8) for g in gt]
    return cfg, imgs, np.asarray(gt, np.float32)


def _slam(cfg):
    return SlamSystem(cfg, enable_loops=False, device="cpu",
                      generator=torch.Generator().manual_seed(0))


def _serve(system, imgs, odos, **kw):
    """Stream every frame through a server on 127.0.0.1; the replies."""
    srv = tls.SlamServer(system, **kw).start()
    try:
        cl = tls.LiveClient(srv.address, imgs[0].shape[0], imgs[0].shape[1], timeout_s=60)
        for img, o in zip(imgs, odos):
            cl.send_frame(img, o)
        replies = cl.drain()
        cl.close()
    finally:
        srv.stop()
    assert srv.frames_served == len(imgs)
    return replies


def test_served_slam_equals_process_chunk(feed):
    cfg, imgs, odo = feed
    replies = _serve(_slam(cfg), imgs, odo, chunk=CHUNK, flush_ms=10_000)
    ref = _slam(cfg)
    want = np.concatenate([ref.process_chunk(imgs[i:i + CHUNK], odo[i:i + CHUNK])
                           for i in range(0, N_FRAMES, CHUNK)])
    assert [r[0] for r in replies] == list(range(N_FRAMES))
    assert all(r[2] for r in replies)
    np.testing.assert_array_equal(np.stack([r[1] for r in replies]), want)
    assert ref.n_keyframes() >= 2


def test_pipelined_server_equals_process_async(feed):
    cfg, imgs, odo = feed
    replies = _serve(_slam(cfg), imgs, odo, pipeline=2, flush_ms=200)
    ref = _slam(cfg)
    ref.pipeline_depth = 2
    for img, o in zip(imgs, odo):
        ref.process_async(img, o)
    ref.flush_async()
    assert [r[0] for r in replies] == list(range(N_FRAMES))
    np.testing.assert_array_equal(np.stack([r[1] for r in replies]),
                                  np.stack([p for _, p in ref.trajectory]))


def test_served_localizer_equals_process_chunk(feed, tmp_path):
    cfg, imgs, odo = feed
    slam = _slam(cfg)
    for img, o in zip(imgs, odo):
        slam.process(img, o)
    slam.save_map(str(tmp_path / "map"))
    ms, vocab, _ = load_map(str(tmp_path / "map"), "cpu")

    def loc():
        return Localizer(cfg, ms, vocab, device="cpu", generator=torch.Generator().manual_seed(7))

    frames = list(range(4, 4 + 2 * CHUNK))        # whole chunks: no flush by timeout
    li, lo = [imgs[i] for i in frames], odo[frames]
    replies = _serve(loc(), li, lo, chunk=CHUNK, flush_ms=10_000)
    ref = loc()
    want = []
    for c in range(0, len(frames), CHUNK):
        want.extend(ref.process_chunk(li[c:c + CHUNK], lo[c:c + CHUNK]))
    assert [r[2] for r in replies] == [p is not None for p in want]
    assert sum(r[2] for r in replies) >= len(frames) // 2
    for r, w in zip(replies, want):
        if w is not None:
            np.testing.assert_array_equal(r[1], w)


class _Stub:
    """An estimator stand-in: a frame's pose is its odometry plus its first
    pixel; an all-zero frame is lost; a frame whose first pixel is 255
    raises (an estimator error)."""

    def __init__(self, H=6, W=5):
        self.cfg = types.SimpleNamespace(height=H, width=W)
        self.calls = 0

    def process_chunk(self, imgs, odos):
        self.calls += 1
        out = []
        for img, o in zip(imgs, odos):
            if img[0, 0] == 255:
                raise RuntimeError("estimator failure")
            out.append(None if not img.any() else np.asarray(o, np.float32) + img[0, 0])
        return out


def _stub_frames(n=11, H=6, W=5):
    rng = np.random.default_rng(3)
    imgs = [rng.integers(1, 200, (H, W)).astype(np.uint8) for _ in range(n)]
    if n > 4:
        imgs[4][:] = 0                               # a lost frame
    odos = rng.uniform(-1, 1, (n, 3)).astype(np.float32)
    return imgs, odos


def _expect(imgs, odos):
    return [(i, None if not im.any() else o + im[0, 0]) for i, (im, o) in
            enumerate(zip(imgs, odos))]


@pytest.mark.parametrize("server_mod, client_mod", [(tls, jls), (jls, tls), (tls, tls)],
                         ids=["jax_client_port_server", "port_client_jax_server", "port_both"])
def test_wire_crosses_between_packages(server_mod, client_mod):
    imgs, odos = _stub_frames()
    srv = server_mod.SlamServer(_Stub(), chunk=4, flush_ms=50).start()
    try:
        cl = client_mod.LiveClient(srv.address, 6, 5, timeout_s=30)
        for img, o in zip(imgs, odos):
            cl.send_frame(img, o)
        got = cl.drain()
        cl.close()
    finally:
        srv.stop()
    for (fid, pose, ok), (i, want) in zip(got, _expect(imgs, odos)):
        assert fid == i and ok == (want is not None)
        np.testing.assert_array_equal(pose, np.zeros(3, np.float32) if want is None else want)
    assert len(got) == len(imgs)


def test_flush_timeout_answers_a_quiet_feed():
    imgs, odos = _stub_frames(3)
    srv = tls.SlamServer(_Stub(), chunk=8, flush_ms=50).start()
    try:
        cl = tls.LiveClient(srv.address, 6, 5, timeout_s=30)
        for img, o in zip(imgs, odos):
            cl.send_frame(img, o)
        got = [cl.recv_pose() for _ in range(3)]     # no more frames: the timeout flushes
        cl.close()
    finally:
        srv.stop()
    assert [g[0] for g in got] == [0, 1, 2]


def _second_client_is_served(srv):
    imgs, odos = _stub_frames(4)
    cl = tls.LiveClient(srv.address, 6, 5, timeout_s=30)
    for img, o in zip(imgs, odos):
        cl.send_frame(img, o)
    got = cl.drain()
    cl.close()
    return [g[0] for g in got] == [0, 1, 2, 3]


def test_dead_client_leaves_the_server_serving():
    stub = _Stub()
    srv = tls.SlamServer(stub, chunk=2, flush_ms=50).start()
    try:
        conn = socket.create_connection(srv.address, timeout=10)
        conn.sendall(tls._HELLO.pack(tls._MAGIC, 1, 6, 5))
        assert tls._HELLO_ACK.unpack(tls._recv_exact(conn, tls._HELLO_ACK.size))[0] == tls._MAGIC
        conn.sendall(tls._FRAME_HDR.pack(0, 0.0, 0.0, 0.0) + b"\x01" * 7)   # half a frame
        conn.close()
        assert _second_client_is_served(srv)
    finally:
        srv.stop()
    assert not srv._thread.is_alive()


def test_estimator_error_drops_the_client_and_keeps_serving():
    srv = tls.SlamServer(_Stub(), chunk=1, flush_ms=50).start()
    try:
        cl = tls.LiveClient(srv.address, 6, 5, timeout_s=30)
        cl.send_frame(np.full((6, 5), 255, np.uint8), np.zeros(3))
        with pytest.raises(ConnectionError):
            cl.recv_pose()                           # dropped: no reply, a closed socket
        cl.close()
        assert _second_client_is_served(srv)
    finally:
        srv.stop()


def test_wrong_frame_size_is_refused():
    srv = tls.SlamServer(_Stub(), chunk=1).start()
    try:
        with pytest.raises(ConnectionError):
            tls.LiveClient(srv.address, 7, 5, timeout_s=30)
        assert _second_client_is_served(srv)
    finally:
        srv.stop()
