"""Framing for the device-server socket: JSON header + raw numpy bodies.

A copy of the JAX package's ``phylonium_tpu/serve/wire.py``, frame for
frame, so both servers speak the same bytes; it also sends empty arrays
(an overlay with no entries), which the JAX sender cannot. One message = magic, u32
header length, JSON header, then each array's raw bytes back to back.
The header carries ``arrays`` specs as ``[dtype_str, shape]`` pairs so
the receiver reconstructs views without pickling (no code execution on
received bytes; a magic check rejects foreign traffic). Big buffers move
as single ``sendall``/``recv_into`` calls.

Beside the frames, what the client and the daemon agree on before the
first frame: the protocol they speak (``PROTOCOL``) and the socket of a
device's daemon (``sock_path``). They live here, in a module without
torch, so that the CLI's client never imports it.
"""

from __future__ import annotations

import json
import os
import socket
import struct

import numpy as np

from phylonium_tpu_torch.ops import _build

MAGIC = b"PHYD1"
_MAX_HEADER = 1 << 20
# single-buffer cap: a 600 x 5 Mbp panel's 2-bit codes are < 1 GB; 8 GB
# rejects only protocol corruption, not any real workload
_MAX_BODY = 8 << 30


# the port's own stamp, bumped on every protocol change, and the hash of
# the kernel library this tree builds: a daemon from another tree, with
# other kernels, answers ping with another protocol and is replaced
PROTOCOL_STAMP = "phyd-torch-1"
PROTOCOL = f"{PROTOCOL_STAMP}+{_build.library_digest()}"


def sock_path(device: str = "cuda") -> str:
    """The socket of the daemon for ``device``: ``PHYLONIUM_TPU_DEVD_SOCK``,
    else ``~/.cache/phylonium_tpu_torch/devd-<device>.sock``."""
    override = os.environ.get("PHYLONIUM_TPU_DEVD_SOCK")
    if override:
        return override
    name = str(device).replace(":", "-")
    return os.path.expanduser(f"~/.cache/phylonium_tpu_torch/devd-{name}.sock")


class WireError(ConnectionError):
    pass


def send_msg(sock: socket.socket, header: dict, arrays=()) -> None:
    arrays = [np.ascontiguousarray(a) for a in arrays]
    header = dict(header)
    header["arrays"] = [[str(a.dtype), list(a.shape)] for a in arrays]
    hdr = json.dumps(header).encode()
    sock.sendall(MAGIC + struct.pack("<I", len(hdr)) + hdr)
    for a in arrays:
        # an empty body is no bytes (and a memoryview of a zero-size array
        # cannot be cast): the frame is the JAX package's all the same
        if a.nbytes:
            sock.sendall(memoryview(a).cast("B"))


def _recv_exact(sock: socket.socket, n: int) -> memoryview:
    buf = bytearray(n)
    view = memoryview(buf)
    got = 0
    while got < n:
        r = sock.recv_into(view[got:], n - got)
        if r == 0:
            raise WireError("device server connection closed mid-frame")
        got += r
    return memoryview(buf)


def recv_msg(sock: socket.socket) -> tuple[dict, list[np.ndarray]]:
    head = _recv_exact(sock, len(MAGIC) + 4)
    if bytes(head[: len(MAGIC)]) != MAGIC:
        raise WireError("bad magic on device-server socket")
    (hlen,) = struct.unpack("<I", head[len(MAGIC) :])
    if hlen > _MAX_HEADER:
        raise WireError(f"oversized header ({hlen} bytes)")
    header = json.loads(bytes(_recv_exact(sock, hlen)))
    arrays = []
    for dtype_str, shape in header.get("arrays", []):
        dt = np.dtype(dtype_str)
        count = int(np.prod(shape, dtype=np.int64)) if shape else 1
        nbytes = count * dt.itemsize
        if nbytes > _MAX_BODY:
            raise WireError(f"oversized body ({nbytes} bytes)")
        raw = _recv_exact(sock, nbytes)
        arrays.append(np.frombuffer(raw, dtype=dt).reshape(shape))
    return header, arrays
