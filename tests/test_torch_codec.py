"""The port's native codec is its own: built from
``crdt_tpu_torch/csrc/v1codec.cc``, it takes the ``undefined`` sentinel
of the port's ``lib0`` and imports nothing of the reference package, so
values round-trip between the port's native and Python codecs."""

import re
from pathlib import Path

import numpy as np
import pytest

from crdt_tpu_torch.codec import lib0, native, v1
from crdt_tpu_torch.core.ids import DeleteSet
from crdt_tpu_torch.core.records import ItemRecord
from crdt_tpu_torch.core.store import K_ANY

ROOT = Path(__file__).resolve().parent.parent
CSRC = ROOT / "crdt_tpu_torch" / "csrc"


def _undefined_blob() -> bytes:
    rec = ItemRecord(client=1, clock=0, kind=K_ANY, content=lib0.UNDEFINED,
                     parent_root="a", key="k")
    return v1.encode_update([rec], DeleteSet())


def test_native_codec_builds_from_the_ports_source():
    assert native.available()
    assert native._SRC == CSRC / "v1codec.cc"
    assert native._load().__name__ == "_v1codec_torch"


def test_undefined_native_decode_then_python_encode():
    blob = _undefined_blob()
    dec = native.decode_updates_columns([blob])
    assert dec["contents"][0] is lib0.UNDEFINED
    recs, _ = native.decoded_to_records(dec, range(len(dec["client"])))
    assert v1.encode_update(recs, DeleteSet()) == blob


def test_undefined_python_decode_then_native_encode():
    blob = _undefined_blob()
    dec = native._decode_py([blob])
    assert dec["contents"][0] is lib0.UNDEFINED
    assert native.encode_from_columns(
        dec, native.ds_from_triples(dec["ds"])) == blob


@pytest.mark.parametrize("src", sorted(p.name for p in CSRC.glob("*.cc")))
def test_csrc_names_no_reference_module(src):
    text = (CSRC / src).read_text()
    bad = sorted(set(re.findall(r"\bcrdt_tpu\.[A-Za-z_.]+", text)))
    assert not bad, f"{src} names reference modules {bad}"


def test_native_and_python_decode_agree_on_a_mixed_trace():
    from crdt_tpu_torch.models.traces import build_trace

    blobs = build_trace(6, 20, seed=4)
    a = native.decode_updates_columns(blobs)
    b = native._decode_py(blobs)
    for k in ("client", "clock", "key_id", "origin_client", "kind"):
        np.testing.assert_array_equal(a[k], b[k])
    assert a["contents"] == b["contents"]
