"""ctypes binding for the native transport (crypto + reliable UDP).

The port's copy of ``crdt_tpu.net.transport``. The transport is the
shared C++ source ``native/transport/transport.cc`` (it imports no
Python module), built with ``g++`` at first use by
:mod:`crdt_tpu_torch.ops._build` into the port's own build directory,
``crdt_tpu_torch/build/transport/`` (``libtransport_torch-<hash>.so``),
and driven through its flat C ABI. The
wire bytes are the same, so a port endpoint and a reference endpoint
talk to each other, and a box sealed by either package opens in the
other.

The reference's swarm stack bottoms out in `udx-native` (C reliable
streams over UDP) and `sodium-native` (libsodium crypto) underneath
Hyperswarm. This module is the equivalent seam, exposing

- :func:`keypair` / :class:`SecureBox` — X25519 key agreement +
  XChaCha20-Poly1305 authenticated encryption (the libsodium
  crypto_box primitive family), for the encrypted peer links;
- :class:`UdpEndpoint` — arbitrary-size messages over UDP with
  fragmentation, per-fragment acks, retransmit, reassembly and
  duplicate suppression, pumped by ``poll()`` the way udx rides its
  event loop (no background threads).

A missing compiler does not break the import: the first call that
needs the library raises, naming the build command.
"""

from __future__ import annotations

import ctypes
from pathlib import Path
from typing import List, Optional, Tuple

from crdt_tpu_torch.ops import _build

_PKG = Path(__file__).resolve().parent.parent
_SRC = _PKG.parent / "native" / "transport" / "transport.cc"
_RECIPE = _build.Recipe(
    "transport_torch", _SRC, _PKG / "build" / "transport", _build.GXX_FLAGS)

_u8p = ctypes.POINTER(ctypes.c_uint8)


def _load() -> ctypes.CDLL:
    return _build.load(_RECIPE, _bind)


def _bind(path: Path) -> ctypes.CDLL:
    lib = ctypes.CDLL(str(path))

    lib.ct_hchacha20.argtypes = [_u8p, _u8p, _u8p]
    lib.ct_aead_encrypt.restype = ctypes.c_int
    lib.ct_aead_encrypt.argtypes = [
        _u8p, _u8p, _u8p, ctypes.c_uint32, _u8p, ctypes.c_uint32, _u8p,
    ]
    lib.ct_aead_decrypt.restype = ctypes.c_int
    lib.ct_aead_decrypt.argtypes = lib.ct_aead_encrypt.argtypes
    lib.ct_xaead_encrypt.restype = ctypes.c_int
    lib.ct_xaead_encrypt.argtypes = lib.ct_aead_encrypt.argtypes
    lib.ct_xaead_decrypt.restype = ctypes.c_int
    lib.ct_xaead_decrypt.argtypes = lib.ct_aead_encrypt.argtypes
    lib.ct_x25519.restype = ctypes.c_int
    lib.ct_x25519.argtypes = [_u8p, _u8p, _u8p]
    lib.ct_x25519_base.argtypes = [_u8p, _u8p]
    lib.ct_randombytes.argtypes = [_u8p, ctypes.c_uint32]
    lib.ct_free.argtypes = [_u8p]

    lib.udp_create.restype = ctypes.c_void_p
    lib.udp_create.argtypes = [
        ctypes.c_char_p, ctypes.c_int, ctypes.c_char_p, ctypes.c_int,
    ]
    lib.udp_port.restype = ctypes.c_int
    lib.udp_port.argtypes = [ctypes.c_void_p]
    lib.udp_close.argtypes = [ctypes.c_void_p]
    lib.udp_set_loss.argtypes = [
        ctypes.c_void_p, ctypes.c_int, ctypes.c_uint64,
    ]
    lib.udp_send.restype = ctypes.c_long
    lib.udp_send.argtypes = [
        ctypes.c_void_p, ctypes.c_char_p, ctypes.c_int, _u8p,
        ctypes.c_uint32,
    ]
    lib.udp_send_unreliable.restype = ctypes.c_long
    lib.udp_send_unreliable.argtypes = lib.udp_send.argtypes
    lib.udp_poll.restype = ctypes.c_int
    lib.udp_poll.argtypes = [ctypes.c_void_p]
    lib.udp_recv.restype = ctypes.c_int
    lib.udp_recv.argtypes = [
        ctypes.c_void_p, ctypes.c_char_p, ctypes.POINTER(ctypes.c_int),
        ctypes.POINTER(_u8p), ctypes.POINTER(ctypes.c_uint32),
    ]
    lib.udp_pending.restype = ctypes.c_int
    lib.udp_pending.argtypes = [ctypes.c_void_p]
    lib.udp_failed.restype = ctypes.c_uint64
    lib.udp_failed.argtypes = [ctypes.c_void_p]
    return lib


def _as_u8p(data: bytes):
    return ctypes.cast(ctypes.c_char_p(bytes(data)), _u8p)


def _buf(n: int):
    return (ctypes.c_uint8 * max(n, 1))()


# ---------------------------------------------------------------------------
# crypto surface
# ---------------------------------------------------------------------------


def random_bytes(n: int) -> bytes:
    lib = _load()
    out = _buf(n)
    lib.ct_randombytes(out, n)
    return bytes(out[:n])


def keypair(seed: Optional[bytes] = None) -> Tuple[bytes, bytes]:
    """(public, secret) X25519 keypair; 32-byte seed = secret key."""
    lib = _load()
    sk = bytes(seed) if seed is not None else random_bytes(32)
    if len(sk) != 32:
        raise ValueError("seed must be 32 bytes")
    pub = _buf(32)
    lib.ct_x25519_base(pub, _as_u8p(sk))
    return bytes(pub[:32]), sk


def x25519(secret: bytes, public: bytes) -> bytes:
    """Raw scalar multiplication (RFC 7748). Raises on the all-zero
    output of low-order points, like libsodium."""
    lib = _load()
    out = _buf(32)
    if lib.ct_x25519(out, _as_u8p(secret), _as_u8p(public)):
        raise ValueError("x25519: low-order public key")
    return bytes(out[:32])


def hchacha20(key: bytes, nonce16: bytes) -> bytes:
    lib = _load()
    out = _buf(32)
    lib.ct_hchacha20(out, _as_u8p(key), _as_u8p(nonce16))
    return bytes(out[:32])


def aead_encrypt(key: bytes, nonce12: bytes, plaintext: bytes,
                 aad: bytes = b"") -> bytes:
    """ChaCha20-Poly1305 (RFC 8439): returns ciphertext || 16-byte tag."""
    lib = _load()
    out = _buf(len(plaintext) + 16)
    lib.ct_aead_encrypt(
        _as_u8p(key), _as_u8p(nonce12), _as_u8p(aad), len(aad),
        _as_u8p(plaintext), len(plaintext), out,
    )
    return bytes(out[: len(plaintext) + 16])


def aead_decrypt(key: bytes, nonce12: bytes, ciphertext: bytes,
                 aad: bytes = b"") -> bytes:
    lib = _load()
    if len(ciphertext) < 16:
        raise ValueError("ciphertext too short")
    out = _buf(len(ciphertext) - 16)
    rc = lib.ct_aead_decrypt(
        _as_u8p(key), _as_u8p(nonce12), _as_u8p(aad), len(aad),
        _as_u8p(ciphertext), len(ciphertext), out,
    )
    if rc:
        raise ValueError("aead: authentication failed")
    return bytes(out[: len(ciphertext) - 16])


def xaead_encrypt(key: bytes, nonce24: bytes, plaintext: bytes,
                  aad: bytes = b"") -> bytes:
    """XChaCha20-Poly1305 (24-byte nonce, safe to draw at random)."""
    lib = _load()
    out = _buf(len(plaintext) + 16)
    lib.ct_xaead_encrypt(
        _as_u8p(key), _as_u8p(nonce24), _as_u8p(aad), len(aad),
        _as_u8p(plaintext), len(plaintext), out,
    )
    return bytes(out[: len(plaintext) + 16])


def xaead_decrypt(key: bytes, nonce24: bytes, ciphertext: bytes,
                  aad: bytes = b"") -> bytes:
    lib = _load()
    if len(ciphertext) < 16:
        raise ValueError("ciphertext too short")
    out = _buf(len(ciphertext) - 16)
    rc = lib.ct_xaead_decrypt(
        _as_u8p(key), _as_u8p(nonce24), _as_u8p(aad), len(aad),
        _as_u8p(ciphertext), len(ciphertext), out,
    )
    if rc:
        raise ValueError("aead: authentication failed")
    return bytes(out[: len(ciphertext) - 16])


class SecureBox:
    """Authenticated encryption between two static X25519 identities —
    the libsodium crypto_box construction shape: session key =
    HChaCha20(X25519(my_secret, their_public)), then per-message
    XChaCha20-Poly1305 under a random 24-byte nonce (prepended).

    Both directions derive the same key (ECDH commutes), so one box
    per peer serves send and receive; random extended nonces make
    direction/counter bookkeeping unnecessary.
    """

    def __init__(self, my_secret: bytes, their_public: bytes):
        shared = x25519(my_secret, their_public)
        self.key = hchacha20(shared, bytes(16))

    def encrypt(self, plaintext: bytes, aad: bytes = b"") -> bytes:
        nonce = random_bytes(24)
        return nonce + xaead_encrypt(self.key, nonce, plaintext, aad)

    def decrypt(self, payload: bytes, aad: bytes = b"") -> bytes:
        if len(payload) < 24 + 16:
            raise ValueError("payload too short")
        return xaead_decrypt(self.key, payload[:24], payload[24:], aad)


# ---------------------------------------------------------------------------
# transport surface
# ---------------------------------------------------------------------------


class UdpEndpoint:
    """One bound UDP socket carrying reliable, arbitrary-size messages.

    ``send`` fragments and queues for retransmit until acked; ``poll``
    pumps receive/ack/retransmit (call it regularly — event-loop
    style, the way udx drives its socket from libuv); ``recv`` pops
    fully reassembled inbound messages as (src_ip, src_port, bytes).
    """

    def __init__(self, bind_ip: str = "127.0.0.1", port: int = 0):
        self._lib = _load()
        err = ctypes.create_string_buffer(256)
        self._h = self._lib.udp_create(bind_ip.encode(), port, err, 256)
        if not self._h:
            raise OSError(f"udp_create({bind_ip}:{port}): {err.value.decode()}")
        self.bind_ip = bind_ip
        self.port = int(self._lib.udp_port(self._h))

    @property
    def _handle(self):
        if not self._h:
            raise RuntimeError("endpoint is closed")
        return self._h

    def send(self, ip: str, port: int, data: bytes) -> int:
        mid = self._lib.udp_send(
            self._handle, ip.encode(), port, _as_u8p(data), len(data)
        )
        if mid < 0:
            raise OSError(f"udp_send to {ip}:{port} failed")
        return int(mid)

    def send_unreliable(self, ip: str, port: int, data: bytes) -> int:
        """Fire-and-forget send: framed like :meth:`send` (receivers
        reassemble/dedup identically) but never retransmitted, never
        counted in ``pending``/``failed``. The NAT-traversal probe
        path — callers that need delivery retry at their own layer."""
        mid = self._lib.udp_send_unreliable(
            self._handle, ip.encode(), port, _as_u8p(data), len(data)
        )
        if mid < 0:
            raise OSError(f"udp_send_unreliable to {ip}:{port} failed")
        return int(mid)

    def poll(self) -> int:
        """One pump: drain socket, ack, retransmit. Returns datagrams
        processed."""
        return int(self._lib.udp_poll(self._handle))

    def recv(self) -> Optional[Tuple[str, int, bytes]]:  # crdtlint: taints
        ip = ctypes.create_string_buffer(64)
        port = ctypes.c_int()
        out = _u8p()
        n = ctypes.c_uint32()
        rc = self._lib.udp_recv(
            self._handle, ip, ctypes.byref(port), ctypes.byref(out),
            ctypes.byref(n),
        )
        if rc == 1:
            return None
        try:
            data = ctypes.string_at(out, n.value)
        finally:
            self._lib.ct_free(out)
        return ip.value.decode(), int(port.value), data

    def recv_all(self) -> List[Tuple[str, int, bytes]]:
        out = []
        while (m := self.recv()) is not None:
            out.append(m)
        return out

    @property
    def pending(self) -> int:
        """Outbound messages not yet fully acked."""
        return int(self._lib.udp_pending(self._handle))

    @property
    def failed(self) -> int:
        """Messages dropped after exhausting retransmits."""
        return int(self._lib.udp_failed(self._handle))

    def set_loss(self, permille: int, seed: int = 0) -> None:
        """Test knob: drop this fraction (0-1000) of OUTBOUND datagrams."""
        self._lib.udp_set_loss(self._handle, permille, seed)

    def close(self) -> None:
        if self._h:
            self._lib.udp_close(self._h)
            self._h = None

    def __enter__(self) -> "UdpEndpoint":
        return self

    def __exit__(self, *exc) -> None:
        self.close()
