"""Live SLAM serving over a TCP socket, the reference's ``test_ros`` node
(port of se2lam_tpu.io.liveserver; test/test_ros.cpp:61-105: odometry and
image topics in, vehicle poses out).

A plain length-framed TCP stream feeds the port's ``SlamSystem`` or
``Localizer``: frames buffer up to ``chunk`` deep (or ``flush_ms`` of
silence) before one ``process_chunk`` call, or with ``pipeline=d`` go one
by one through ``process_async`` and come back about d frames later.

Wire protocol (little-endian), byte for byte the JAX package's, so either
package's client talks to either package's server:
  client hello :  b"SE2L" u16 version=1  u32 H  u32 W
  server hello :  b"SE2L" u16 version=1
  frame        :  u32 frame_id  3*f32 odo(x,y,theta)  H*W u8 gray image
                  (frame_id 0xFFFFFFFF = end of stream)
  reply        :  u32 frame_id  3*f32 pose(x,y,theta)  u8 flags
                  (flags bit0: pose valid)

Replies come in frame order, one per frame, possibly delayed by up to
``chunk`` frames: the chunk adds latency, not loss.

The serving thread runs the system's device work on the CUDA device and
stream that were current where the server was made, as the caller's own
calls would.
"""
from __future__ import annotations

import contextlib
import logging
import socket
import struct
import threading
import time
from collections import deque

import numpy as np

__all__ = ["SlamServer", "LiveClient"]

log = logging.getLogger(__name__)

_MAGIC = b"SE2L"
_HELLO = struct.Struct("<4sHII")
_HELLO_ACK = struct.Struct("<4sH")
_FRAME_HDR = struct.Struct("<Ifff")
_REPLY = struct.Struct("<IfffB")
_END_ID = 0xFFFFFFFF


def _recv_exact(conn, n: int, stop=None, deadline=None) -> bytearray:
    """Read exactly n bytes. A socket timeout in the middle of a message
    keeps waiting (the flush timeout polls message boundaries only: once a
    message has started, its rest is in flight and must not be dropped); a
    set ``stop`` event or a passed monotonic ``deadline`` aborts."""
    buf = bytearray()
    while len(buf) < n:
        try:
            part = conn.recv(n - len(buf))
        except socket.timeout:
            if stop is not None and stop.is_set():
                raise ConnectionError("server stopping")
            if deadline is not None and time.monotonic() > deadline:
                raise ConnectionError("peer timed out mid-message")
            continue
        if not part:
            raise ConnectionError("peer closed mid-message")
        buf.extend(part)
    return buf


def _reply(fid: int, p) -> bytes:
    """One reply; a lost frame (None) goes out as flags=0 with a zero pose,
    never dropped."""
    if p is None:
        return _REPLY.pack(fid, 0.0, 0.0, 0.0, 0)
    return _REPLY.pack(fid, float(p[0]), float(p[1]), float(p[2]), 1)


class SlamServer:
    """Serve ONE ``SlamSystem`` (or ``Localizer``) over TCP.

    ``system`` must have ``process_chunk(imgs, odos)`` returning k poses
    (None for a lost frame), or, with ``pipeline`` set, the pipelined feed
    ``process_async``/``flush_async``/``trajectory``: both the port's
    ``SlamSystem`` and ``Localizer`` have both. One client at a time: the
    map is one sequential estimator, as the reference runs one OdoSLAM
    instance per process (src/OdoSLAM.cpp:75-157).
    """

    def __init__(self, system, host: str = "127.0.0.1", port: int = 0, chunk: int = 8,
                 flush_ms: float = 50.0, pipeline: int | None = None):
        """``pipeline``: serve with the depth-d pipelined per-frame feed
        (``process_async``) instead of chunk batching; each reply lags about
        ``pipeline`` frames instead of up to ``chunk``."""
        self.system = system
        self.chunk = max(1, int(chunk))
        self.pipeline = pipeline
        self.flush_s = flush_ms / 1e3
        self._cuda = self._caller_cuda(system)
        self._sock = socket.create_server((host, port))
        self._sock.settimeout(1.0)
        self.address = self._sock.getsockname()
        self._stop = threading.Event()
        self._thread: threading.Thread | None = None
        self.frames_served = 0

    @staticmethod
    def _caller_cuda(system):
        """The (device, stream) the serving thread runs on: the caller's
        current ones, for a system on the card; None otherwise."""
        dev = getattr(system, "device", None)
        if dev is None or getattr(dev, "type", None) != "cuda":
            return None
        import torch

        return dev, torch.cuda.current_stream(dev)

    def _device_context(self):
        if self._cuda is None:
            return contextlib.nullcontext()
        import torch

        dev, stream = self._cuda
        stack = contextlib.ExitStack()
        stack.enter_context(torch.cuda.device(dev))
        stack.enter_context(torch.cuda.stream(stream))
        return stack

    # -- lifecycle --

    def serve_forever(self):
        """Accept clients until ``stop()``; each client streams to its end."""
        with self._device_context():
            while not self._stop.is_set():
                try:
                    conn, _addr = self._sock.accept()
                except socket.timeout:
                    continue
                except OSError:
                    break
                with conn:
                    try:
                        self._serve_client(conn)
                    except (ConnectionError, OSError) as e:
                        # the client vanished: keep the map, await the next,
                        # and say why
                        log.warning("client dropped: %s", e)
                    except Exception:
                        # an estimator error must not kill the serving
                        # thread (clients would hang until their timeout):
                        # drop this client, record the traceback, keep serving
                        log.exception("estimator error while serving client")
        self._sock.close()

    def start(self):
        self._thread = threading.Thread(target=self.serve_forever, daemon=True)
        self._thread.start()
        return self

    def stop(self):
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=10.0)

    # -- one client --

    def _read_frame(self, conn, first: bytes, H: int, W: int):
        """The rest of a frame message whose first byte arrived: (frame id,
        image, odometry), or None at the end-of-stream id. A client that
        dies without closing (a partition, a power loss) must not wedge
        the server: the rest of the message has a 10 s deadline."""
        deadline = time.monotonic() + 10.0
        hdr = first + _recv_exact(conn, _FRAME_HDR.size - 1, self._stop, deadline=deadline)
        fid, x, y, th = _FRAME_HDR.unpack(hdr)
        if fid == _END_ID:
            return None
        img = np.frombuffer(_recv_exact(conn, H * W, self._stop, deadline=deadline),
                            np.uint8).reshape(H, W)
        return fid, img, np.asarray([x, y, th], np.float32)

    def _send(self, conn, out: bytes):
        # the connection's flush timeout is a receive poll: a client slow to
        # drain replies gets a real write deadline, not the poll interval
        conn.settimeout(10.0)
        try:
            conn.sendall(out)
        finally:
            conn.settimeout(self.flush_s)

    def _serve_client(self, conn: socket.socket):
        # a 1 s poll and a 10 s hello deadline: a connection that never
        # speaks must not wedge the accept loop, and stop() must interrupt
        conn.settimeout(1.0)
        magic, ver, H, W = _HELLO.unpack(
            _recv_exact(conn, _HELLO.size, self._stop, deadline=time.monotonic() + 10.0))
        if magic != _MAGIC or ver != 1:
            raise ConnectionError(f"bad hello {magic!r} v{ver}")
        cfg = self.system.cfg
        if (H, W) != (cfg.height, cfg.width):
            raise ConnectionError(f"frame size {H}x{W} != configured {cfg.height}x{cfg.width}")
        conn.sendall(_HELLO_ACK.pack(_MAGIC, 1))
        if self.pipeline is not None:
            self._serve_client_pipelined(conn, H, W)
            return

        ids: list[int] = []
        imgs: list[np.ndarray] = []
        odos: list[np.ndarray] = []
        conn.settimeout(self.flush_s)

        def flush():
            if not ids:
                return
            poses = self.system.process_chunk(imgs, odos)
            self._send(conn, b"".join(_reply(fid, p) for fid, p in zip(ids, list(poses))))
            self.frames_served += len(ids)
            ids.clear()
            imgs.clear()
            odos.clear()

        while not self._stop.is_set():
            # poll ONE byte at the message boundary: a quiet feed flushes the
            # buffered frames (the latency cap)
            try:
                first = conn.recv(1)
            except socket.timeout:
                flush()
                continue
            if not first:
                flush()
                return
            msg = self._read_frame(conn, first, H, W)
            if msg is None:
                flush()
                return
            ids.append(msg[0])
            imgs.append(msg[1])
            odos.append(msg[2])
            if len(ids) >= self.chunk:
                flush()
        # stop() during a stream: reply to everything buffered, one reply
        # a frame (latency, not loss)
        flush()

    def _serve_client_pipelined(self, conn: socket.socket, H: int, W: int):
        """Depth-d pipelined serving: one ``process_async`` a received frame,
        replies drained from the estimator's trajectory as frames resolve."""
        sys_ = self.system
        sys_.pipeline_depth = max(0, int(self.pipeline))
        # a previous client's abnormal exit can leave frames in flight: they
        # resolve before this client's trajectory baseline is taken, or
        # every reply below would pair with the wrong frame
        sys_.flush_async()
        outstanding: deque[int] = deque()   # wire frame ids in feed order
        traj_base = len(sys_.trajectory)
        conn.settimeout(self.flush_s)

        def reply_resolved():
            nonlocal traj_base
            traj = sys_.trajectory
            out = bytearray()
            while traj_base < len(traj) and outstanding:
                out += _reply(outstanding.popleft(), traj[traj_base][1])
                traj_base += 1
                self.frames_served += 1
            if out:
                self._send(conn, bytes(out))

        def flush_all():
            sys_.flush_async()
            reply_resolved()

        try:
            while not self._stop.is_set():
                try:
                    first = conn.recv(1)
                except socket.timeout:
                    flush_all()          # quiet feed: resolve the frames in flight
                    continue
                if not first:
                    flush_all()
                    return
                msg = self._read_frame(conn, first, H, W)
                if msg is None:
                    flush_all()
                    return
                outstanding.append(msg[0])
                sys_.process_async(msg[1], msg[2])
                reply_resolved()
            flush_all()
        finally:
            # an abnormal exit must not carry this client's unresolved
            # frames into the next session
            sys_.flush_async()


class LiveClient:
    """Minimal feed client (the datapub / test_ros feed loop,
    test/test_vn.cpp:43-55, over a socket instead of ROS topics)."""

    def __init__(self, address, height: int, width: int, timeout_s: float = 120.0):
        self.h, self.w = height, width
        self._conn = socket.create_connection(address, timeout=timeout_s)
        self._conn.sendall(_HELLO.pack(_MAGIC, 1, height, width))
        magic, ver = _HELLO_ACK.unpack(_recv_exact(self._conn, _HELLO_ACK.size))
        if magic != _MAGIC or ver != 1:
            raise ConnectionError("bad server hello")
        self._next_id = 0
        self._pending = 0

    def send_frame(self, img, odo) -> int:
        img = np.ascontiguousarray(np.asarray(img, np.uint8))
        if img.shape != (self.h, self.w):
            raise ValueError(f"frame shape {img.shape} != ({self.h}, {self.w})")
        fid = self._next_id
        self._next_id += 1
        self._conn.sendall(_FRAME_HDR.pack(fid, float(odo[0]), float(odo[1]), float(odo[2]))
                           + img.tobytes())
        self._pending += 1
        return fid

    def recv_pose(self):
        """Blocking: (frame_id, (3,) pose, tracked) of the next reply."""
        fid, x, y, th, flags = _REPLY.unpack(_recv_exact(self._conn, _REPLY.size))
        self._pending -= 1
        return fid, np.asarray([x, y, th], np.float32), bool(flags & 1)

    def drain(self):
        """Every outstanding reply, in order."""
        out = []
        while self._pending > 0:
            out.append(self.recv_pose())
        return out

    def close(self):
        try:
            self._conn.sendall(_FRAME_HDR.pack(_END_ID, 0.0, 0.0, 0.0))
        except OSError:
            pass
        self._conn.close()
