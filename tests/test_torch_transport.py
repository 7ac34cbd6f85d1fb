"""The port's transport binding (``crdt_tpu_torch.net.transport``)
against the reference's (``crdt_tpu.net.transport``).

Both bind the shared ``native/transport/transport.cc``, each built into
its own library (the port's under ``crdt_tpu_torch/build/transport/``),
and both load in this one process. The port's binding must meet the
published vectors (RFC 8439 ChaCha20-Poly1305, RFC 7748 X25519, the
draft-irtf-cfrg-xchacha HChaCha20 input), give the reference's bytes on
the same seeded inputs, open the reference's boxes and be opened by
them, and carry messages to and from a reference endpoint.
"""

import random
import time

import pytest

from crdt_tpu.net import transport as ref
from crdt_tpu_torch.net import transport as t

PACKAGES = {"port": t, "reference": ref}


def _rng_bytes(rng, n):
    return bytes(rng.getrandbits(8) for _ in range(n))


# ---------------------------------------------------------------------------
# the build
# ---------------------------------------------------------------------------


def test_port_builds_its_own_library():
    t._load()
    ref._load()
    assert t._SO.name == "libtransport_torch.so"
    assert t._SO.parent.parts[-3:] == ("crdt_tpu_torch", "build", "transport")
    assert t._SO.exists()
    assert t._SO != ref._SO
    assert t._SRC == ref._SRC


def test_missing_compiler_raises_at_use_not_import(monkeypatch, tmp_path):
    monkeypatch.setattr(t, "_BUILD_DIR", tmp_path)
    monkeypatch.setattr(t, "_SO", tmp_path / "libtransport_torch.so")
    monkeypatch.setattr(t, "_lib", None)
    monkeypatch.setenv("PATH", str(tmp_path))
    with pytest.raises(RuntimeError, match="native transport build failed"):
        t.random_bytes(4)
    assert not list(tmp_path.glob("*.tmp.*"))


# ---------------------------------------------------------------------------
# crypto vectors
# ---------------------------------------------------------------------------


class TestVectors:
    KEY = bytes(range(0x80, 0xA0))
    NONCE = bytes.fromhex("070000004041424344454647")
    AAD = bytes.fromhex("50515253c0c1c2c3c4c5c6c7")
    PT = (
        b"Ladies and Gentlemen of the class of '99: If I could offer you "
        b"only one tip for the future, sunscreen would be it."
    )
    CT = bytes.fromhex(
        "d31a8d34648e60db7b86afbc53ef7ec2"
        "a4aded51296e08fea9e2b5a736ee62d6"
        "3dbea45e8ca9671282fafb69da92728b"
        "1a71de0a9e060b2905d6a5b67ecd3b36"
        "92ddbd7f2d778b8c9803aee328091b58"
        "fab324e4fad675945585808b4831d7bc"
        "3ff4def08e4b7a9de576d26586cec64b"
        "6116"
    )
    TAG = bytes.fromhex("1ae10b594f09e26a7e902ecbd0600691")

    def test_rfc8439_aead(self):
        out = t.aead_encrypt(self.KEY, self.NONCE, self.PT, aad=self.AAD)
        assert out == self.CT + self.TAG
        assert t.aead_decrypt(self.KEY, self.NONCE, out, aad=self.AAD) \
            == self.PT
        sealed = bytearray(out)
        sealed[3] ^= 1
        with pytest.raises(ValueError, match="authentication"):
            t.aead_decrypt(self.KEY, self.NONCE, bytes(sealed), aad=self.AAD)
        with pytest.raises(ValueError, match="authentication"):
            t.aead_decrypt(self.KEY, self.NONCE, out, aad=b"x")
        assert len(t.aead_encrypt(self.KEY, self.NONCE, b"")) == 16

    def test_rfc7748_x25519(self):
        k = bytes.fromhex(
            "a546e36bf0527c9d3b16154b82465edd62144c0ac1fc5a18506a2244ba449ac4")
        u = bytes.fromhex(
            "e6db6867583030db3594c1a424b15f7c726624ec26b3353b10a903a6d0ab1c4c")
        assert t.x25519(k, u) == bytes.fromhex(
            "c3da55379de9c6908e94ea4df28d084f32eccf03491c71f754b4075577a28552")
        a_priv = bytes.fromhex(
            "77076d0a7318a57d3c16c17251b26645df4c2f87ebc0992ab177fba51db92c2a")
        b_priv = bytes.fromhex(
            "5dab087e624a8a4b79e17f8b83800ee66f3bb1292618b6fd1c2f8b27ff88e0eb")
        a_pub, _ = t.keypair(a_priv)
        b_pub, _ = t.keypair(b_priv)
        assert a_pub == bytes.fromhex(
            "8520f0098930a754748b7ddcb43ef75a0dbf3a0d26381af4eba4a98eaa9b4e6a")
        assert b_pub == bytes.fromhex(
            "de9edb7d7b7dc1b4d35b61c2ece435373f8343c85b78674dadfc7e146f882b4f")
        shared = bytes.fromhex(
            "4a5d9d5ba4ce2de1728e3bf480350f25e07e21c947d19e3376f09b3c1e161742")
        assert t.x25519(a_priv, b_pub) == shared == t.x25519(b_priv, a_pub)
        with pytest.raises(ValueError, match="low-order"):
            t.x25519(a_priv, bytes(32))

    def test_hchacha20_draft_input(self):
        out = t.hchacha20(bytes(range(32)),
                          bytes.fromhex("000000090000004a0000000031415927"))
        assert out == bytes.fromhex(
            "82413b4227b27bfed30e42508a877d73a0f9e4d58a74a853c12ec41326d3ecdc")

    @pytest.mark.parametrize("seed", range(4))
    def test_primitives_equal_reference(self, seed):
        rng = random.Random(seed)
        key, sk, other = (_rng_bytes(rng, 32) for _ in range(3))
        n16, n12, n24 = (_rng_bytes(rng, n) for n in (16, 12, 24))
        pt, aad = _rng_bytes(rng, 1 + seed * 700), _rng_bytes(rng, seed * 5)
        assert t.hchacha20(key, n16) == ref.hchacha20(key, n16)
        assert t.keypair(sk) == ref.keypair(sk)
        pub, _ = ref.keypair(other)
        assert t.x25519(sk, pub) == ref.x25519(sk, pub)
        assert t.aead_encrypt(key, n12, pt, aad) == \
            ref.aead_encrypt(key, n12, pt, aad)
        assert t.xaead_encrypt(key, n24, pt, aad) == \
            ref.xaead_encrypt(key, n24, pt, aad)
        assert t.xaead_decrypt(key, n24, ref.xaead_encrypt(
            key, n24, pt, aad), aad) == pt


# ---------------------------------------------------------------------------
# SecureBox interop
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("sealer,opener", [("port", "reference"),
                                           ("reference", "port"),
                                           ("port", "port")])
def test_securebox_interop(sealer, opener):
    a_pub, a_sec = PACKAGES[sealer].keypair()
    b_pub, b_sec = PACKAGES[opener].keypair()
    box_ab = PACKAGES[sealer].SecureBox(a_sec, b_pub)
    box_ba = PACKAGES[opener].SecureBox(b_sec, a_pub)
    assert box_ab.key == box_ba.key
    msg = b"swarm update \x00\x01" * 100
    assert box_ba.decrypt(box_ab.encrypt(msg)) == msg
    assert box_ab.decrypt(box_ba.encrypt(msg, aad=b"id"), aad=b"id") == msg
    _, eve_sec = PACKAGES[opener].keypair()
    with pytest.raises(ValueError):
        PACKAGES[opener].SecureBox(eve_sec, a_pub).decrypt(
            box_ab.encrypt(b"secret"))
    assert box_ab.encrypt(b"x") != box_ab.encrypt(b"x")


# ---------------------------------------------------------------------------
# reliable UDP endpoint
# ---------------------------------------------------------------------------


def _pump(endpoints, *, until, timeout_s=10.0):
    deadline = time.monotonic() + timeout_s
    while not until():
        if time.monotonic() > deadline:
            raise TimeoutError("endpoints did not settle")
        for ep in endpoints:
            ep.poll()
        time.sleep(0.002)


def _deliver(a, b, msgs, timeout_s=10.0):
    """Send ``msgs`` from ``a`` to ``b``; pump until all arrive and
    ``a`` holds nothing unacked. Returns what ``b`` received."""
    for m in msgs:
        a.send("127.0.0.1", b.port, m)
    got = []

    def arrived():
        got.extend(b.recv_all())
        return len(got) >= len(msgs) and a.pending == 0

    _pump([a, b], until=arrived, timeout_s=timeout_s)
    return got


ENDPOINT_PAIRS = [("port", "port"), ("port", "reference"),
                  ("reference", "port")]


@pytest.mark.parametrize("src,dst", ENDPOINT_PAIRS)
@pytest.mark.parametrize("case", ["small", "fragmented", "empty"])
def test_endpoint_delivers(src, dst, case):
    payload = {"small": b"hello swarm",
               "fragmented": random.Random(3).randbytes(300_000),
               "empty": b""}[case]
    with PACKAGES[src].UdpEndpoint() as a, \
            PACKAGES[dst].UdpEndpoint() as b:
        ((ip, port, data),) = _deliver(a, b, [payload])
        assert (ip, port, data) == ("127.0.0.1", a.port, payload)
        assert a.failed == 0


@pytest.mark.parametrize("src,dst", ENDPOINT_PAIRS)
def test_endpoint_delivery_under_heavy_loss(src, dst):
    """25% of outbound datagrams dropped on both sides (data and acks):
    retransmit delivers everything exactly once."""
    rng = random.Random(5)
    msgs = [rng.randbytes(5000) for _ in range(10)]
    with PACKAGES[src].UdpEndpoint() as a, \
            PACKAGES[dst].UdpEndpoint() as b:
        a.set_loss(250, seed=1)
        b.set_loss(250, seed=2)
        got = _deliver(a, b, msgs, timeout_s=30.0)
        assert sorted(d for _, _, d in got) == sorted(msgs)
        assert a.failed == 0


@pytest.mark.parametrize("src,dst", ENDPOINT_PAIRS)
def test_endpoint_duplicate_suppression(src, dst):
    """Re-sent datagrams (the receiver's acks dropped) do not duplicate
    the message."""
    with PACKAGES[src].UdpEndpoint() as a, \
            PACKAGES[dst].UdpEndpoint() as b:
        b.set_loss(400, seed=7)
        a.send("127.0.0.1", b.port, b"once only")
        got = []
        deadline = time.monotonic() + 20
        while a.pending and time.monotonic() < deadline:
            a.poll(), b.poll()
            got.extend(b.recv_all())
            time.sleep(0.002)
        got.extend(b.recv_all())
        assert [d for _, _, d in got] == [b"once only"]


def test_unreliable_send_and_close():
    with t.UdpEndpoint() as a, ref.UdpEndpoint() as b:
        a.send_unreliable("127.0.0.1", b.port, b"probe")
        got = []
        _pump([a, b], until=lambda: bool(got.extend(b.recv_all()) or got))
        assert got[0][2] == b"probe"
        assert a.pending == 0 and a.failed == 0
    with pytest.raises(RuntimeError, match="closed"):
        a.send("127.0.0.1", 9, b"x")
