"""The port's native codec is its own: built from
``crdt_tpu_torch/csrc/v1codec.cc``, it takes the ``undefined`` sentinel
of the port's ``lib0`` and imports nothing of the reference package, so
values round-trip between the port's native and Python codecs."""

import importlib.util
import os
import re
from pathlib import Path

import numpy as np
import pytest

from crdt_tpu_torch.codec import lib0, native, v1
from crdt_tpu_torch.core.ids import DeleteSet
from crdt_tpu_torch.core.records import ItemRecord
from crdt_tpu_torch.core.store import K_ANY
from crdt_tpu_torch.ops import _build

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


def test_missing_compiler_raises_at_use_not_import(monkeypatch, tmp_path):
    # a failed build is remembered: the codec falls back to Python
    # without running g++ again on every call
    path = os.environ["PATH"]
    monkeypatch.setattr(native, "_RECIPE",
                        native._RECIPE._replace(out_dir=tmp_path))
    monkeypatch.delitem(_build._loaded, native._RECIPE.name, raising=False)
    monkeypatch.setattr(native, "_build_error", None)
    monkeypatch.setenv("PATH", str(tmp_path))
    with pytest.raises(RuntimeError, match="native build failed"):
        native.decode_updates_columns([_undefined_blob()])
    assert not native.available()
    assert not list(tmp_path.glob("*.tmp.*"))
    monkeypatch.setenv("PATH", path)
    assert not native.available()
    assert not list(tmp_path.glob("*.so"))
    spec = importlib.util.find_spec(native.__name__)
    spec.loader.exec_module(importlib.util.module_from_spec(spec))


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


def _blob_set():
    """Peers' overlapping views, the same view twice, an empty blob and
    a delete-only blob: duplicate ids across blobs, and blobs of no
    rows."""
    from benchmark.gen import swarm as gen_swarm

    blobs = gen_swarm.build(12, 10, 4, 10, seed=23)[0]
    _, ds = v1.decode_update(blobs[0])
    return (blobs[:5] + [v1.encode_update([], DeleteSet())] + blobs[5:]
            + [blobs[2], v1.encode_update([], ds)])


def test_blob_rows_are_each_blobs_rows_in_the_union():
    blobs = _blob_set()
    got = native.decode_updates_columns(blobs)
    alone = [len(native.decode_updates_columns([b])["client"])
             for b in blobs]
    assert got["blob_rows"].dtype == np.int64
    assert got["blob_rows"].tolist() == alone
    assert 0 in alone and got["blob_rows"].sum() == len(got["client"])
    np.testing.assert_array_equal(native._decode_py(blobs)["blob_rows"],
                                  got["blob_rows"])
    # each blob's rows are its own decode's, in the same order
    start = np.cumsum(got["blob_rows"]) - got["blob_rows"]
    for b, s, k in zip(blobs, start, alone):
        one = native.decode_updates_columns([b])
        for col in ("client", "clock"):
            np.testing.assert_array_equal(got[col][s:s + k], one[col])
    assert native.decode_updates_columns([])["blob_rows"].size == 0


def test_merge_decoded_concatenates_the_chunks_blob_rows():
    blobs = _blob_set()
    chunks = [native.decode_updates_columns_any(blobs[i:i + 4])
              for i in range(0, len(blobs), 4)]
    merged = native.merge_decoded(chunks)
    np.testing.assert_array_equal(
        merged["blob_rows"], native.decode_updates_columns(blobs)["blob_rows"])
    assert native.merge_decoded(chunks[:1])["blob_rows"] is \
        chunks[0]["blob_rows"]
    assert native.merge_decoded([])["blob_rows"].size == 0


def test_dedup_maps_every_parsed_row_to_its_ids_first_occurrence():
    blobs = _blob_set()
    parsed = native.decode_updates_columns(blobs)
    dec = native.dedup_columns(parsed)
    assert len(dec["client"]) < len(parsed["client"])
    assert dec["blob_rows"] is parsed["blob_rows"]
    surv = dec["survivor"]
    assert surv.dtype == np.int64 and len(surv) == len(parsed["client"])
    for col in ("client", "clock"):
        np.testing.assert_array_equal(dec[col][surv], parsed[col])
    ids = list(zip(parsed["client"].tolist(), parsed["clock"].tolist()))
    first = {}
    for i, key in enumerate(ids):
        first.setdefault(key, i)
    kept = sorted(first.values())
    want = [kept.index(first[key]) for key in ids]
    assert surv.tolist() == want
    # nothing drops: the parse comes back as it is, with no map
    unique = native.decode_updates_columns(blobs[:1])
    assert native.dedup_columns(unique) is unique
    assert "survivor" not in unique
