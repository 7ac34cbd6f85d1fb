// Native v1 update codec — CPython extension, the port's own copy.
//
// The native equivalent of crdt_tpu_torch/codec/v1.py's hot paths,
// built by crdt_tpu_torch/codec/native.py at first use:
//
//   decode_updates(list[bytes]) -> dict of numpy columns + contents
//     one pass over a batch of v1 blobs: lib0 primitives, struct
//     grammar, run splitting into unit rows, string/key/root
//     interning, implicit-parent resolution via origin chains (the
//     Python path's decode_update + resolve_parents +
//     records_to_columns collapsed into one C pass).
//
//   encode_update(columns..., contents, roots, keys, ds...) -> bytes
//     byte-identical to crdt_tpu_torch.codec.v1.encode_update on the
//     same logical rows: clients descending, maximal runs, Skip structs
//     for clock gaps, the exact lib0 `any` type dispatch.
//
//   conflict_ranks(offsets, client, right, anchor) -> numpy ranks
//     staging's conflict-scan replay of right-origin groups, every
//     group in one call; the same order as ops/yata.py:_simulate_group.
//
// The module is _v1codec_torch and takes its `undefined` sentinel from
// crdt_tpu_torch.codec.lib0, so that a value decoded here is the one
// the port's Python codec encodes (and the port imports no other
// package). Round trips against the Python codec agree byte for byte
// (tests/test_torch_codec.py).

#define PY_SSIZE_T_CLEAN
#include <Python.h>
#define NPY_NO_DEPRECATED_API NPY_1_7_API_VERSION
#include <numpy/arrayobject.h>

#include <cstdint>
#include <algorithm>
#include <cmath>
#include <cstring>
#include <map>
#include <string>
#include <unordered_map>
#include <vector>

// content kinds (crdt_tpu_torch/core/store.py)
static const int K_GC = 0, K_DELETED = 1, K_JSON = 2, K_BINARY = 3,
                 K_STRING = 4, K_ANY = 5, K_TYPE = 6, K_EMBED = 7,
                 K_FORMAT = 8, K_DOC = 9;
// wire refs (crdt_tpu_torch/codec/v1.py)
// wire sanity bound shared with the Python codec's _MAX_CLOCK (and the
// kernels' 40-bit clock packing): declared clocks/run ends past this
// are hostile, and GC/Deleted expansion is budgeted per blob byte so a
// few declared bytes can never buy unbounded allocation
static const int64_t MAX_CLOCK = (int64_t)1 << 40;
// client-id bound (mirrors v1.py _MAX_ID): [2^63, 2^64) would wrap
// negative through the int64 cast and bypass every downstream check
// (2^64-1 even collides with the -1 "absent" sentinel)
static const uint64_t MAX_ID = (uint64_t)1 << 62;

static const int REF_GC = 0, REF_DELETED = 1, REF_JSON = 2, REF_BINARY = 3,
                 REF_STRING = 4, REF_EMBED = 5, REF_FORMAT = 6, REF_TYPE = 7,
                 REF_ANY = 8, REF_DOC = 9, REF_SKIP = 10;

static int kind_of_ref(int ref) {
  switch (ref) {
    case REF_GC: return K_GC;
    case REF_DELETED: return K_DELETED;
    case REF_JSON: return K_JSON;
    case REF_BINARY: return K_BINARY;
    case REF_STRING: return K_STRING;
    case REF_EMBED: return K_EMBED;
    case REF_FORMAT: return K_FORMAT;
    case REF_TYPE: return K_TYPE;
    case REF_ANY: return K_ANY;
    case REF_DOC: return K_DOC;
  }
  return -1;
}

static int ref_of_kind(int kind) {
  switch (kind) {
    case K_GC: return REF_GC;
    case K_DELETED: return REF_DELETED;
    case K_JSON: return REF_JSON;
    case K_BINARY: return REF_BINARY;
    case K_STRING: return REF_STRING;
    case K_EMBED: return REF_EMBED;
    case K_FORMAT: return REF_FORMAT;
    case K_TYPE: return REF_TYPE;
    case K_ANY: return REF_ANY;
    case K_DOC: return REF_DOC;
  }
  return -1;
}

// module-level cached Python callables / sentinels (set in init)
static PyObject* g_undefined = nullptr;   // crdt_tpu_torch.codec.lib0.UNDEFINED
static PyObject* g_json_dumps = nullptr;  // json.dumps
static PyObject* g_json_loads = nullptr;  // json.loads

// ---------------------------------------------------------------------------
// lib0 reader
// ---------------------------------------------------------------------------

struct Reader {
  const uint8_t* p;
  const uint8_t* end;
  bool ok = true;

  bool need(size_t n) {
    if ((size_t)(end - p) < n) { ok = false; return false; }
    return true;
  }
  uint8_t u8() {
    if (!need(1)) return 0;
    return *p++;
  }
  // bounded identity/clock/length field: validated against the cap
  // BEFORE the signed cast (see MAX_ID) — rejection semantics shared
  // with the Python codec's _read_client_id/_read_clock_val
  int64_t field(uint64_t cap) {
    uint64_t v = varuint();
    if (!ok) return 0;
    if (v >= cap) { ok = false; return 0; }
    return (int64_t)v;
  }
  uint64_t varuint() {
    uint64_t n = 0; int shift = 0;
    while (true) {
      if (!need(1)) return 0;
      uint8_t b = *p++;
      uint64_t part = (uint64_t)(b & 0x7F);
      // overflow must REJECT, not wrap: a silently wrapped length
      // would sail under every downstream sanity cap (the Python
      // codec's arbitrary-precision ints reject the same bytes)
      if (shift >= 64 || (shift > 0 && part > (UINT64_MAX >> shift))) {
        ok = false;
        return 0;
      }
      n |= part << shift;
      if (!(b & 0x80)) return n;
      shift += 7;
    }
  }
  int64_t varint() {
    if (!need(1)) return 0;
    uint8_t b = *p++;
    int64_t sign = (b & 0x40) ? -1 : 1;
    uint64_t n = b & 0x3F;
    int shift = 6;
    while (b & 0x80) {
      if (!need(1)) return 0;
      b = *p++;
      uint64_t part = (uint64_t)(b & 0x7F);
      if (shift >= 64 || part > (UINT64_MAX >> shift)) {
        ok = false;  // overflow rejects, never wraps (see varuint)
        return 0;
      }
      n |= part << shift;
      shift += 7;
    }
    // int64-representability (mirrors lib0.py read_var_int):
    // magnitudes in [2^63, 2^64) would wrap negative through the
    // cast below and silently diverge from the Python codec
    if (n >= ((uint64_t)1 << 63)) { ok = false; return 0; }
    return sign * (int64_t)n;
  }
  bool raw(size_t n, const uint8_t** out) {
    if (!need(n)) return false;
    *out = p;
    p += n;
    return true;
  }
  // UTF-8 string -> PyUnicode (new ref), nullptr on error
  PyObject* pystring() {
    uint64_t len = varuint();
    const uint8_t* s;
    if (!ok || !raw(len, &s)) { ok = false; return nullptr; }
    PyObject* u = PyUnicode_DecodeUTF8((const char*)s, len, nullptr);
    if (!u) ok = false;
    return u;
  }
  // UTF-8 string -> std::string (for interning)
  bool cstring(std::string* out) {
    uint64_t len = varuint();
    const uint8_t* s;
    if (!ok || !raw(len, &s)) { ok = false; return false; }
    out->assign((const char*)s, len);
    return true;
  }
  PyObject* pybytes() {
    uint64_t len = varuint();
    const uint8_t* s;
    if (!ok || !raw(len, &s)) { ok = false; return nullptr; }
    return PyBytes_FromStringAndSize((const char*)s, len);
  }
  double f32be() {
    const uint8_t* s;
    if (!raw(4, &s)) return 0;
    uint32_t v = ((uint32_t)s[0] << 24) | ((uint32_t)s[1] << 16) |
                 ((uint32_t)s[2] << 8) | s[3];
    float f;
    memcpy(&f, &v, 4);
    return (double)f;
  }
  double f64be() {
    const uint8_t* s;
    if (!raw(8, &s)) return 0;
    uint64_t v = 0;
    for (int i = 0; i < 8; i++) v = (v << 8) | s[i];
    double d;
    memcpy(&d, &v, 8);
    return d;
  }
  int64_t i64be() {
    const uint8_t* s;
    if (!raw(8, &s)) return 0;
    uint64_t v = 0;
    for (int i = 0; i < 8; i++) v = (v << 8) | s[i];
    return (int64_t)v;
  }
  PyObject* any();  // defined below
};

PyObject* Reader::any() {
  uint8_t t = u8();
  if (!ok) return nullptr;
  switch (t) {
    case 127: Py_INCREF(g_undefined); return g_undefined;
    case 126: Py_RETURN_NONE;
    case 125: { int64_t v = varint(); if (!ok) return nullptr;
                return PyLong_FromLongLong(v); }
    case 124: { double v = f32be(); if (!ok) return nullptr;
                return PyFloat_FromDouble(v); }
    case 123: { double v = f64be(); if (!ok) return nullptr;
                return PyFloat_FromDouble(v); }
    case 122: { int64_t v = i64be(); if (!ok) return nullptr;
                return PyLong_FromLongLong(v); }
    case 121: Py_RETURN_FALSE;
    case 120: Py_RETURN_TRUE;
    case 119: return pystring();
    case 118: {
      uint64_t n = varuint();
      if (!ok) return nullptr;
      PyObject* d = PyDict_New();
      if (!d) { ok = false; return nullptr; }
      for (uint64_t i = 0; i < n; i++) {
        PyObject* k = pystring();
        if (!k) { Py_DECREF(d); return nullptr; }
        PyObject* v = any();
        if (!v) { Py_DECREF(k); Py_DECREF(d); return nullptr; }
        if (PyDict_SetItem(d, k, v) < 0) {
          Py_DECREF(k); Py_DECREF(v); Py_DECREF(d);
          ok = false; return nullptr;
        }
        Py_DECREF(k); Py_DECREF(v);
      }
      return d;
    }
    case 117: {
      uint64_t n = varuint();
      if (!ok) return nullptr;
      PyObject* l = PyList_New(n);
      if (!l) { ok = false; return nullptr; }
      for (uint64_t i = 0; i < n; i++) {
        PyObject* v = any();
        if (!v) { Py_DECREF(l); return nullptr; }
        PyList_SET_ITEM(l, i, v);
      }
      return l;
    }
    case 116: { PyObject* b = pybytes(); if (!b) ok = false; return b; }
  }
  ok = false;
  return nullptr;
}

// ---------------------------------------------------------------------------
// decode_updates
// ---------------------------------------------------------------------------

struct PairHash {
  size_t operator()(const std::pair<int64_t, int64_t>& p) const {
    return std::hash<int64_t>()(p.first * 1000003 ^ p.second);
  }
};

struct Columns {
  std::vector<int64_t> client, clock;
  std::vector<int32_t> parent_root;   // interned root id, -1
  std::vector<int64_t> pclient, pclock;  // parent item id, -1
  std::vector<int32_t> key_id;        // interned key, -1
  std::vector<int64_t> oclient, oclock;  // left origin, -1
  std::vector<int64_t> rclient, rclock;  // right origin, -1
  std::vector<int32_t> kind, type_ref;
  std::vector<PyObject*> contents;    // owned refs (may be nullptr->None)

  std::unordered_map<std::string, int32_t> root_ids, key_ids;
  std::vector<std::string> roots, keys;

  int32_t intern_root(const std::string& s) {
    auto it = root_ids.find(s);
    if (it != root_ids.end()) return it->second;
    int32_t id = (int32_t)roots.size();
    roots.push_back(s);
    root_ids.emplace(s, id);
    return id;
  }
  int32_t intern_key(const std::string& s) {
    auto it = key_ids.find(s);
    if (it != key_ids.end()) return it->second;
    int32_t id = (int32_t)keys.size();
    keys.push_back(s);
    key_ids.emplace(s, id);
    return id;
  }
  size_t n() const { return client.size(); }
  void push(int64_t cl, int64_t ck, int32_t pr, int64_t pc, int64_t pk,
            int32_t kid, int64_t oc, int64_t ok_, int64_t rc, int64_t rk,
            int32_t kd, int32_t tr, PyObject* content /* stolen */) {
    client.push_back(cl); clock.push_back(ck);
    parent_root.push_back(pr); pclient.push_back(pc); pclock.push_back(pk);
    key_id.push_back(kid); oclient.push_back(oc); oclock.push_back(ok_);
    rclient.push_back(rc); rclock.push_back(rk);
    kind.push_back(kd); type_ref.push_back(tr);
    contents.push_back(content);
  }
  void free_contents() {
    for (PyObject* o : contents) Py_XDECREF(o);
    contents.clear();
  }
};

// split a decoded wire struct covering `len` clocks into unit rows,
// exactly like v1._split_units: part j>0 gets origin (client, clock+j-1)
// and inherits the run's right origin; parent/key only on part 0 (later
// resolved from the origin chain).
static void push_run(Columns& C, int64_t client, int64_t clock, int64_t len,
                     int32_t pr, int64_t pc, int64_t pk, int32_t kid,
                     bool has_origin, int64_t oc, int64_t ok_,
                     bool has_right, int64_t rc, int64_t rk,
                     int32_t kind, int32_t tref,
                     std::vector<PyObject*>* contents /* stolen or null */) {
  for (int64_t j = 0; j < len; j++) {
    PyObject* content = nullptr;
    if (contents) content = (*contents)[j];
    if (j == 0) {
      C.push(client, clock, pr, pc, pk, kid,
             has_origin ? oc : -1, has_origin ? ok_ : -1,
             has_right ? rc : -1, has_right ? rk : -1, kind, tref, content);
    } else {
      C.push(client, clock + j, -1, -1, -1, -1,
             client, clock + j - 1,
             has_right ? rc : -1, has_right ? rk : -1, kind, tref, content);
    }
  }
}

static bool decode_one(Reader& r, Columns& C,
                       std::vector<int64_t>& ds_out /* triples */) {
  // expansion budget (mirrors v1.py): GC/Deleted runs expand to unit
  // rows; bound the total against the blob's byte size
  const int64_t budget =
      std::max((int64_t)1 << 20, 4096 * (int64_t)(r.end - r.p));
  const int64_t n0 = (int64_t)C.n();
  uint64_t num_clients = r.varuint();
  if (!r.ok) return false;
  for (uint64_t ci = 0; ci < num_clients; ci++) {
    uint64_t num_structs = r.varuint();
    int64_t client = r.field(MAX_ID);
    int64_t clock = r.field((uint64_t)MAX_CLOCK);
    if (!r.ok) return false;
    for (uint64_t si = 0; si < num_structs; si++) {
      uint8_t info = r.u8();
      if (!r.ok) return false;
      int ref = info & 0x1F;
      if (ref == REF_SKIP) {
        clock += r.field((uint64_t)MAX_CLOCK);
        if (!r.ok || clock >= MAX_CLOCK) { r.ok = false; return false; }
        continue;
      }
      if (ref == REF_GC) {
        int64_t len = r.field((uint64_t)MAX_CLOCK);
        if (!r.ok) return false;
        if (clock + len >= MAX_CLOCK ||
            (int64_t)C.n() - n0 + len > budget) { r.ok = false; return false; }
        // parts after the first carry chain origins, mirroring the
        // Python _split_units (the engine ignores them for GC)
        for (int64_t j = 0; j < len; j++)
          C.push(client, clock + j, -1, -1, -1, -1,
                 j == 0 ? -1 : client, j == 0 ? -1 : clock + j - 1,
                 -1, -1, K_GC, -1, nullptr);
        clock += len;
        continue;
      }
      int kind = kind_of_ref(ref);
      if (kind < 0) { r.ok = false; return false; }
      bool has_origin = info & 0x80, has_right = info & 0x40;
      int64_t oc = -1, ok_ = -1, rc = -1, rk = -1;
      if (has_origin) {
        oc = r.field(MAX_ID); ok_ = r.field((uint64_t)MAX_CLOCK);
      }
      if (has_right) {
        rc = r.field(MAX_ID); rk = r.field((uint64_t)MAX_CLOCK);
      }
      int32_t pr = -1, kid = -1;
      int64_t pc = -1, pk = -1;
      if (!(info & 0xC0)) {
        if (r.varuint() == 1) {
          std::string name;
          if (!r.cstring(&name)) return false;
          pr = C.intern_root(name);
        } else {
          pc = r.field(MAX_ID);
          pk = r.field((uint64_t)MAX_CLOCK);
        }
        if (info & 0x20) {
          std::string key;
          if (!r.cstring(&key)) return false;
          kid = C.intern_key(key);
        }
      }
      if (!r.ok) return false;

      int64_t len = 1;
      std::vector<PyObject*> contents;  // stolen into C on push_run
      int32_t tref = -1;
      switch (ref) {
        case REF_DELETED:
          len = r.field((uint64_t)MAX_CLOCK);
          if (!r.ok || clock + len >= MAX_CLOCK ||
              (int64_t)C.n() - n0 + len > budget) { r.ok = false; return false; }
          contents.assign(len, nullptr);
          break;
        case REF_JSON: {
          len = r.field((uint64_t)MAX_CLOCK);
          for (int64_t j = 0; r.ok && j < len; j++) {
            PyObject* s = r.pystring();
            if (!s) break;
            PyObject* v;
            if (PyUnicode_CompareWithASCIIString(s, "undefined") == 0) {
              Py_INCREF(g_undefined);
              v = g_undefined;
            } else {
              v = PyObject_CallFunctionObjArgs(g_json_loads, s, nullptr);
            }
            Py_DECREF(s);
            if (!v) { r.ok = false; break; }
            contents.push_back(v);
          }
          break;
        }
        case REF_BINARY: {
          PyObject* b = r.pybytes();
          if (!b) r.ok = false;
          contents.push_back(b);
          break;
        }
        case REF_STRING: {
          // UTF-8 -> UTF-16 code units, one unit row per clock
          std::string raw;
          if (!r.cstring(&raw)) break;
          size_t i = 0;
          while (i < raw.size()) {
            uint32_t cp; int nb;
            uint8_t b0 = raw[i];
            if (b0 < 0x80) { cp = b0; nb = 1; }
            else if ((b0 & 0xE0) == 0xC0) { cp = b0 & 0x1F; nb = 2; }
            else if ((b0 & 0xF0) == 0xE0) { cp = b0 & 0x0F; nb = 3; }
            else if ((b0 & 0xF8) == 0xF0) { cp = b0 & 0x07; nb = 4; }
            else { r.ok = false; break; }
            if (i + nb > raw.size()) { r.ok = false; break; }
            for (int j = 1; j < nb; j++)
              cp = (cp << 6) | (raw[i + j] & 0x3F);
            i += nb;
            if (cp >= 0x10000) {
              uint32_t v = cp - 0x10000;
              uint16_t hi = 0xD800 + (v >> 10), lo = 0xDC00 + (v & 0x3FF);
              Py_UCS2 a = hi, b = lo;
              contents.push_back(
                  PyUnicode_FromKindAndData(PyUnicode_2BYTE_KIND, &a, 1));
              contents.push_back(
                  PyUnicode_FromKindAndData(PyUnicode_2BYTE_KIND, &b, 1));
            } else {
              Py_UCS2 u = (Py_UCS2)cp;
              contents.push_back(
                  PyUnicode_FromKindAndData(PyUnicode_2BYTE_KIND, &u, 1));
            }
          }
          len = (int64_t)contents.size();
          break;
        }
        case REF_EMBED: {
          PyObject* s = r.pystring();
          if (!s) break;
          PyObject* v = PyObject_CallFunctionObjArgs(g_json_loads, s, nullptr);
          Py_DECREF(s);
          if (!v) { r.ok = false; break; }
          contents.push_back(v);
          break;
        }
        case REF_FORMAT: {
          PyObject* k = r.pystring();
          if (!k) break;
          PyObject* s = r.pystring();
          if (!s) { Py_DECREF(k); break; }
          PyObject* v = PyObject_CallFunctionObjArgs(g_json_loads, s, nullptr);
          Py_DECREF(s);
          if (!v) { Py_DECREF(k); r.ok = false; break; }
          contents.push_back(PyTuple_Pack(2, k, v));
          Py_DECREF(k); Py_DECREF(v);
          break;
        }
        case REF_TYPE:
          tref = (int32_t)r.field((uint64_t)1 << 31);
          contents.push_back(nullptr);
          break;
        case REF_ANY: {
          len = r.field((uint64_t)MAX_CLOCK);
          for (int64_t j = 0; r.ok && j < len; j++) {
            PyObject* v = r.any();
            if (!v) break;
            contents.push_back(v);
          }
          break;
        }
        case REF_DOC: {
          PyObject* guid = r.pystring();
          if (!guid) break;
          PyObject* opts = r.any();
          if (!opts) { Py_DECREF(guid); break; }
          contents.push_back(PyTuple_Pack(2, guid, opts));
          Py_DECREF(guid); Py_DECREF(opts);
          break;
        }
      }
      if (!r.ok || (int64_t)contents.size() != len) {
        for (PyObject* o : contents) Py_XDECREF(o);
        r.ok = false;
        return false;
      }
      push_run(C, client, clock, len, pr, pc, pk, kid,
               has_origin, oc, ok_, has_right, rc, rk, kind, tref,
               &contents);
      clock += len;
    }
  }
  // delete set
  uint64_t ds_clients = r.varuint();
  if (!r.ok) return false;
  for (uint64_t i = 0; i < ds_clients; i++) {
    int64_t client = r.field(MAX_ID);
    uint64_t nr = r.varuint();
    if (!r.ok) return false;
    for (uint64_t j = 0; j < nr; j++) {
      int64_t clk = (int64_t)r.varuint();
      int64_t len = (int64_t)r.varuint();
      if (!r.ok) return false;
      if ((uint64_t)clk >= (uint64_t)MAX_CLOCK ||
          (uint64_t)len >= (uint64_t)MAX_CLOCK) {
        r.ok = false; return false;
      }
      if (clk + len >= MAX_CLOCK) { r.ok = false; return false; }
      if (len) {
        ds_out.push_back(client);
        ds_out.push_back(clk);
        ds_out.push_back(len);
      }
    }
  }
  if (r.p != r.end) { r.ok = false; return false; }  // trailing bytes
  return true;
}

// implicit parents: walk the origin (else right) chain until a row with
// explicit parent info; copy its parent columns (and key when absent).
// Port of v1.resolve_parents.
static void resolve_parents(Columns& C) {
  std::unordered_map<std::pair<int64_t, int64_t>, int, PairHash> index;
  size_t n = C.n();
  index.reserve(n * 2);
  for (size_t i = 0; i < n; i++)
    index.emplace(std::make_pair(C.client[i], C.clock[i]), (int)i);
  for (size_t i = 0; i < n; i++) {
    if (C.parent_root[i] != -1 || C.pclient[i] != -1 || C.kind[i] == K_GC)
      continue;
    int cur = (int)i;
    size_t steps = 0;
    while (cur >= 0 && C.parent_root[cur] == -1 && C.pclient[cur] == -1) {
      if (++steps > n) { cur = -1; break; }  // cycle guard
      int64_t nc = C.oclient[cur] != -1 ? C.oclient[cur] : C.rclient[cur];
      int64_t nk = C.oclient[cur] != -1 ? C.oclock[cur] : C.rclock[cur];
      if (nc == -1) { cur = -1; break; }
      auto it = index.find(std::make_pair(nc, nk));
      cur = it == index.end() ? -1 : it->second;
    }
    if (cur >= 0) {
      C.parent_root[i] = C.parent_root[cur];
      C.pclient[i] = C.pclient[cur];
      C.pclock[i] = C.pclock[cur];
      if (C.key_id[i] == -1) C.key_id[i] = C.key_id[cur];
    }
  }
}

template <typename T>
static PyObject* np_from_vec(const std::vector<T>& v, int typenum) {
  npy_intp dims[1] = {(npy_intp)v.size()};
  PyObject* arr = PyArray_SimpleNew(1, dims, typenum);
  if (!arr) return nullptr;
  if (!v.empty())
    memcpy(PyArray_DATA((PyArrayObject*)arr), v.data(), v.size() * sizeof(T));
  return arr;
}

static PyObject* py_string_list(const std::vector<std::string>& v) {
  PyObject* l = PyList_New(v.size());
  if (!l) return nullptr;
  for (size_t i = 0; i < v.size(); i++) {
    PyObject* s = PyUnicode_DecodeUTF8(v[i].data(), v[i].size(), nullptr);
    if (!s) { Py_DECREF(l); return nullptr; }
    PyList_SET_ITEM(l, i, s);
  }
  return l;
}

static PyObject* decode_updates(PyObject*, PyObject* args) {
  PyObject* blobs;
  if (!PyArg_ParseTuple(args, "O", &blobs)) return nullptr;
  PyObject* seq = PySequence_Fast(blobs, "expected a sequence of bytes");
  if (!seq) return nullptr;

  Columns C;
  std::vector<int64_t> ds;
  Py_ssize_t nblobs = PySequence_Fast_GET_SIZE(seq);
  // rows each blob appended, in input order: blob i's rows are the
  // union's rows [sum(blob_rows[:i]), sum(blob_rows[:i + 1]))
  std::vector<int64_t> blob_rows;
  blob_rows.reserve(nblobs);
  for (Py_ssize_t i = 0; i < nblobs; i++) {
    PyObject* b = PySequence_Fast_GET_ITEM(seq, i);
    char* buf;
    Py_ssize_t blen;
    if (PyBytes_AsStringAndSize(b, &buf, &blen) < 0) {
      C.free_contents();
      Py_DECREF(seq);
      return nullptr;
    }
    Reader r{(const uint8_t*)buf, (const uint8_t*)buf + blen};
    const int64_t rows_before = (int64_t)C.n();
    if (!decode_one(r, C, ds) || !r.ok) {
      C.free_contents();
      Py_DECREF(seq);
      if (!PyErr_Occurred())
        PyErr_SetString(PyExc_ValueError, "malformed v1 update");
      return nullptr;
    }
    blob_rows.push_back((int64_t)C.n() - rows_before);
  }
  Py_DECREF(seq);
  resolve_parents(C);

  size_t n = C.n();
  PyObject* contents = PyList_New(n);
  if (!contents) { C.free_contents(); return nullptr; }
  for (size_t i = 0; i < n; i++) {
    PyObject* o = C.contents[i];
    if (!o) { Py_INCREF(Py_None); o = Py_None; }
    PyList_SET_ITEM(contents, i, o);  // steals our ref
  }
  C.contents.clear();  // ownership moved

  PyObject* out = PyDict_New();
  if (!out) { Py_DECREF(contents); return nullptr; }
  bool fail = false;
  auto set = [&](const char* name, PyObject* v) {
    if (!v || PyDict_SetItemString(out, name, v) < 0) fail = true;
    Py_XDECREF(v);
  };
  set("client", np_from_vec(C.client, NPY_INT64));
  set("clock", np_from_vec(C.clock, NPY_INT64));
  set("parent_root", np_from_vec(C.parent_root, NPY_INT32));
  set("parent_client", np_from_vec(C.pclient, NPY_INT64));
  set("parent_clock", np_from_vec(C.pclock, NPY_INT64));
  set("key_id", np_from_vec(C.key_id, NPY_INT32));
  set("origin_client", np_from_vec(C.oclient, NPY_INT64));
  set("origin_clock", np_from_vec(C.oclock, NPY_INT64));
  set("right_client", np_from_vec(C.rclient, NPY_INT64));
  set("right_clock", np_from_vec(C.rclock, NPY_INT64));
  set("kind", np_from_vec(C.kind, NPY_INT32));
  set("type_ref", np_from_vec(C.type_ref, NPY_INT32));
  set("ds", np_from_vec(ds, NPY_INT64));
  set("blob_rows", np_from_vec(blob_rows, NPY_INT64));
  set("roots", py_string_list(C.roots));
  set("keys", py_string_list(C.keys));
  if (PyDict_SetItemString(out, "contents", contents) < 0) fail = true;
  Py_DECREF(contents);
  if (fail) { Py_DECREF(out); return nullptr; }
  return out;
}

// ---------------------------------------------------------------------------
// encode_update (byte-identical to crdt_tpu_torch.codec.v1.encode_update)
// ---------------------------------------------------------------------------

struct Writer {
  std::vector<uint8_t> buf;
  void u8(uint8_t b) { buf.push_back(b); }
  void varuint(uint64_t n) {
    while (true) {
      uint8_t b = n & 0x7F;
      n >>= 7;
      if (n) buf.push_back(0x80 | b);
      else { buf.push_back(b); break; }
    }
  }
  void varint(int64_t v) {
    bool neg = v < 0;
    uint64_t n = neg ? (uint64_t)(-v) : (uint64_t)v;
    uint8_t first = (neg ? 0x40 : 0) | (n & 0x3F);
    n >>= 6;
    if (n) {
      buf.push_back(0x80 | first);
      while (true) {
        uint8_t b = n & 0x7F;
        n >>= 7;
        if (n) buf.push_back(0x80 | b);
        else { buf.push_back(b); break; }
      }
    } else {
      buf.push_back(first);
    }
  }
  void raw(const char* d, size_t n) { buf.insert(buf.end(), d, d + n); }
  bool pystr(PyObject* s) {  // varstring from a PyUnicode
    Py_ssize_t len;
    const char* data = PyUnicode_AsUTF8AndSize(s, &len);
    if (!data) return false;
    varuint(len);
    raw(data, len);
    return true;
  }
  void cstr(const std::string& s) {
    varuint(s.size());
    raw(s.data(), s.size());
  }
  void f32be(double d) {
    float f = (float)d;
    uint32_t v;
    memcpy(&v, &f, 4);
    for (int i = 3; i >= 0; i--) buf.push_back((v >> (8 * i)) & 0xFF);
  }
  void f64be(double d) {
    uint64_t v;
    memcpy(&v, &d, 8);
    for (int i = 7; i >= 0; i--) buf.push_back((v >> (8 * i)) & 0xFF);
  }
  void i64be(int64_t x) {
    uint64_t v = (uint64_t)x;
    for (int i = 7; i >= 0; i--) buf.push_back((v >> (8 * i)) & 0xFF);
  }
  bool any(PyObject* v);  // defined below
};

bool Writer::any(PyObject* v) {
  if (v == g_undefined) { u8(127); return true; }
  if (v == Py_None) { u8(126); return true; }
  if (PyBool_Check(v)) { u8(v == Py_True ? 120 : 121); return true; }
  if (PyLong_Check(v)) {
    int overflow = 0;
    long long x = PyLong_AsLongLongAndOverflow(v, &overflow);
    if (overflow) {
      PyErr_SetString(PyExc_TypeError, "integer out of lib0 int64 range");
      return false;
    }
    const int64_t SAFE = 9007199254740992LL;  // 2**53
    if (x > -SAFE && x < SAFE) { u8(125); varint(x); }
    else { u8(122); i64be(x); }
    return true;
  }
  if (PyFloat_Check(v)) {
    double d = PyFloat_AS_DOUBLE(v);
    if (std::isfinite(d) && (double)(float)d == d) { u8(124); f32be(d); }
    else { u8(123); f64be(d); }
    return true;
  }
  if (PyUnicode_Check(v)) { u8(119); return pystr(v); }
  if (PyDict_Check(v)) {
    u8(118);
    varuint(PyDict_Size(v));
    PyObject *key, *val;
    Py_ssize_t pos = 0;
    while (PyDict_Next(v, &pos, &key, &val)) {
      PyObject* ks = PyObject_Str(key);
      if (!ks) return false;
      bool ok_ = pystr(ks);
      Py_DECREF(ks);
      if (!ok_ || !any(val)) return false;
    }
    return true;
  }
  if (PyList_Check(v) || PyTuple_Check(v)) {
    PyObject* seq = PySequence_Fast(v, "");
    if (!seq) return false;
    Py_ssize_t n = PySequence_Fast_GET_SIZE(seq);
    u8(117);
    varuint(n);
    for (Py_ssize_t i = 0; i < n; i++) {
      if (!any(PySequence_Fast_GET_ITEM(seq, i))) { Py_DECREF(seq); return false; }
    }
    Py_DECREF(seq);
    return true;
  }
  if (PyBytes_Check(v) || PyByteArray_Check(v)) {
    PyObject* b = PyBytes_FromObject(v);
    if (!b) return false;
    u8(116);
    varuint(PyBytes_GET_SIZE(b));
    raw(PyBytes_AS_STRING(b), PyBytes_GET_SIZE(b));
    Py_DECREF(b);
    return true;
  }
  PyErr_Format(PyExc_TypeError, "cannot encode %R as lib0 any", v);
  return false;
}

// dump JSON via the cached json.dumps (byte-identical to the Python path)
static bool write_json_content(Writer& w, PyObject* content) {
  if (content == g_undefined) {
    w.cstr("undefined");
    return true;
  }
  PyObject* s = PyObject_CallFunctionObjArgs(g_json_dumps, content, nullptr);
  if (!s) return false;
  bool ok_ = w.pystr(s);
  Py_DECREF(s);
  return ok_;
}

// UTF-16 unit contents -> UTF-8, pairing surrogates (v1._join_utf16)
static bool write_string_run(Writer& w, PyObject* contents_list,
                             const int* rows, int count) {
  std::vector<uint16_t> units;
  units.reserve(count);
  for (int i = 0; i < count; i++) {
    PyObject* s = PyList_GET_ITEM(contents_list, rows[i]);
    if (!PyUnicode_Check(s) || PyUnicode_GET_LENGTH(s) != 1) {
      PyErr_SetString(PyExc_TypeError, "string content must be one UTF-16 unit");
      return false;
    }
    Py_UCS4 ch = PyUnicode_READ_CHAR(s, 0);
    if (ch >= 0x10000) {  // tolerate a pre-paired astral char
      Py_UCS4 v = ch - 0x10000;
      units.push_back(0xD800 + (v >> 10));
      units.push_back(0xDC00 + (v & 0x3FF));
    } else {
      units.push_back((uint16_t)ch);
    }
  }
  std::string utf8;
  utf8.reserve(units.size() * 3);
  for (size_t i = 0; i < units.size(); i++) {
    uint32_t cp = units[i];
    if (cp >= 0xD800 && cp < 0xDC00 && i + 1 < units.size() &&
        units[i + 1] >= 0xDC00 && units[i + 1] < 0xE000) {
      cp = 0x10000 + ((cp - 0xD800) << 10) + (units[i + 1] - 0xDC00);
      i++;
    }
    if (cp < 0x80) utf8 += (char)cp;
    else if (cp < 0x800) {
      utf8 += (char)(0xC0 | (cp >> 6));
      utf8 += (char)(0x80 | (cp & 0x3F));
    } else if (cp < 0x10000) {
      utf8 += (char)(0xE0 | (cp >> 12));
      utf8 += (char)(0x80 | ((cp >> 6) & 0x3F));
      utf8 += (char)(0x80 | (cp & 0x3F));
    } else {
      utf8 += (char)(0xF0 | (cp >> 18));
      utf8 += (char)(0x80 | ((cp >> 12) & 0x3F));
      utf8 += (char)(0x80 | ((cp >> 6) & 0x3F));
      utf8 += (char)(0x80 | (cp & 0x3F));
    }
  }
  w.cstr(utf8);
  return true;
}

struct EncodeInput {
  const int64_t *client, *clock, *pclient, *pclock;
  const int64_t *oclient, *oclock, *rclient, *rclock;
  const int32_t *parent_root, *key_id, *kind, *type_ref;
  PyObject* contents;  // list
  std::vector<std::string> roots, keys;
  npy_intp n;
};

static bool same_parent(const EncodeInput& E, int a, int prev) {
  bool absent = E.parent_root[a] == -1 && E.pclient[a] == -1 &&
                E.key_id[a] == -1;
  if (absent) return true;
  return E.parent_root[a] == E.parent_root[prev] &&
         E.pclient[a] == E.pclient[prev] && E.pclock[a] == E.pclock[prev] &&
         E.key_id[a] == E.key_id[prev];
}

static bool encode_rows(Writer& w, const EncodeInput& E,
                        const int64_t* ds, npy_intp nds) {
  // group rows by client, clock-ascending; clients descending
  std::map<int64_t, std::vector<int>> by_client;
  for (npy_intp i = 0; i < E.n; i++) by_client[E.client[i]].push_back((int)i);
  for (auto& kv : by_client) {
    auto& rows = kv.second;
    std::stable_sort(rows.begin(), rows.end(), [&](int a, int b) {
      return E.clock[a] < E.clock[b];
    });
  }

  w.varuint(by_client.size());
  for (auto it = by_client.rbegin(); it != by_client.rend(); ++it) {
    const std::vector<int>& rows = it->second;
    // build runs (port of v1._coalesce) + skip markers
    struct Run { int start, count; bool skip; int64_t skip_len; };
    std::vector<Run> runs;
    size_t i = 0;
    int64_t prev_end = -1;
    while (i < rows.size()) {
      int head = rows[i];
      if (prev_end >= 0 && E.clock[head] > prev_end)
        runs.push_back({0, 0, true, E.clock[head] - prev_end});
      size_t j = i + 1;
      int kind = E.kind[head];
      bool mergeable = kind == K_ANY || kind == K_JSON || kind == K_STRING ||
                       kind == K_DELETED;
      while (j < rows.size()) {
        int r = rows[j], p = rows[j - 1];
        bool plain = kind == K_GC && E.kind[r] == K_GC &&
                     E.clock[r] == E.clock[p] + 1;
        bool chained = E.clock[r] == E.clock[p] + 1 &&
                       E.oclient[r] == E.client[p] &&
                       E.oclock[r] == E.clock[p] &&
                       E.rclient[r] == E.rclient[head] &&
                       E.rclock[r] == E.rclock[head];
        if (plain ||
            (mergeable && E.kind[r] == kind && same_parent(E, r, p) && chained))
          j++;
        else
          break;
      }
      runs.push_back({(int)i, (int)(j - i), false, 0});
      prev_end = E.clock[rows[j - 1]] + 1;
      i = j;
    }

    w.varuint(runs.size());
    w.varuint((uint64_t)it->first);
    // start clock of first entry
    const Run& first = runs.front();
    w.varuint(first.skip ? (uint64_t)(E.clock[rows[0]] - first.skip_len)
                         : (uint64_t)E.clock[rows[first.start]]);

    for (const Run& run : runs) {
      if (run.skip) {
        w.u8(REF_SKIP);
        w.varuint((uint64_t)run.skip_len);
        continue;
      }
      int head = rows[run.start];
      if (E.kind[head] == K_GC) {
        w.u8(REF_GC);
        w.varuint(run.count);
        continue;
      }
      int ref = ref_of_kind(E.kind[head]);
      if (ref < 0) {
        PyErr_Format(PyExc_ValueError, "cannot encode kind %d", E.kind[head]);
        return false;
      }
      bool has_origin = E.oclient[head] != -1;
      bool has_right = E.rclient[head] != -1;
      bool write_parent = !has_origin && !has_right;
      bool has_sub = write_parent && E.key_id[head] != -1;
      w.u8(ref | (has_origin ? 0x80 : 0) | (has_right ? 0x40 : 0) |
           (has_sub ? 0x20 : 0));
      if (has_origin) {
        w.varuint((uint64_t)E.oclient[head]);
        w.varuint((uint64_t)E.oclock[head]);
      }
      if (has_right) {
        w.varuint((uint64_t)E.rclient[head]);
        w.varuint((uint64_t)E.rclock[head]);
      }
      if (write_parent) {
        if (E.parent_root[head] != -1) {
          w.varuint(1);
          w.cstr(E.roots[E.parent_root[head]]);
        } else if (E.pclient[head] != -1) {
          w.varuint(0);
          w.varuint((uint64_t)E.pclient[head]);
          w.varuint((uint64_t)E.pclock[head]);
        } else {
          PyErr_SetString(PyExc_ValueError,
                          "row needs parent_root, parent item, or an origin");
          return false;
        }
        if (has_sub) w.cstr(E.keys[E.key_id[head]]);
      }
      // content
      switch (E.kind[head]) {
        case K_DELETED:
          w.varuint(run.count);
          break;
        case K_JSON:
          w.varuint(run.count);
          for (int k = 0; k < run.count; k++)
            if (!write_json_content(
                    w, PyList_GET_ITEM(E.contents, rows[run.start + k])))
              return false;
          break;
        case K_BINARY: {
          PyObject* b = PyList_GET_ITEM(E.contents, head);
          PyObject* bb = PyBytes_FromObject(b);
          if (!bb) return false;
          w.varuint(PyBytes_GET_SIZE(bb));
          w.raw(PyBytes_AS_STRING(bb), PyBytes_GET_SIZE(bb));
          Py_DECREF(bb);
          break;
        }
        case K_STRING: {
          std::vector<int> rws(run.count);
          for (int k = 0; k < run.count; k++) rws[k] = rows[run.start + k];
          if (!write_string_run(w, E.contents, rws.data(), run.count))
            return false;
          break;
        }
        case K_EMBED: {
          PyObject* s = PyObject_CallFunctionObjArgs(
              g_json_dumps, PyList_GET_ITEM(E.contents, head), nullptr);
          if (!s) return false;
          bool ok_ = w.pystr(s);
          Py_DECREF(s);
          if (!ok_) return false;
          break;
        }
        case K_FORMAT: {
          PyObject* t = PyList_GET_ITEM(E.contents, head);
          if (!PyTuple_Check(t) || PyTuple_GET_SIZE(t) != 2) {
            PyErr_SetString(PyExc_TypeError, "format content must be (k, v)");
            return false;
          }
          if (!w.pystr(PyTuple_GET_ITEM(t, 0))) return false;
          PyObject* s = PyObject_CallFunctionObjArgs(
              g_json_dumps, PyTuple_GET_ITEM(t, 1), nullptr);
          if (!s) return false;
          bool ok_ = w.pystr(s);
          Py_DECREF(s);
          if (!ok_) return false;
          break;
        }
        case K_TYPE:
          w.varuint((uint64_t)E.type_ref[head]);
          break;
        case K_ANY:
          w.varuint(run.count);
          for (int k = 0; k < run.count; k++)
            if (!w.any(PyList_GET_ITEM(E.contents, rows[run.start + k])))
              return false;
          break;
        case K_DOC: {
          PyObject* t = PyList_GET_ITEM(E.contents, head);
          if (!PyTuple_Check(t) || PyTuple_GET_SIZE(t) != 2) {
            PyErr_SetString(PyExc_TypeError, "doc content must be (guid, opts)");
            return false;
          }
          if (!w.pystr(PyTuple_GET_ITEM(t, 0))) return false;
          if (!w.any(PyTuple_GET_ITEM(t, 1))) return false;
          break;
        }
      }
    }
  }

  // delete set: triples (client, start, len) pre-ordered by the caller
  // (clients descending, ranges ascending within a client)
  std::vector<std::pair<int64_t, std::pair<npy_intp, npy_intp>>> groups;
  npy_intp i3 = 0;
  while (i3 < nds) {
    int64_t c = ds[i3 * 3];
    npy_intp start = i3;
    while (i3 < nds && ds[i3 * 3] == c) i3++;
    groups.push_back({c, {start, i3}});
  }
  w.varuint(groups.size());
  for (auto& g : groups) {
    w.varuint((uint64_t)g.first);
    w.varuint((uint64_t)(g.second.second - g.second.first));
    for (npy_intp k = g.second.first; k < g.second.second; k++) {
      w.varuint((uint64_t)ds[k * 3 + 1]);
      w.varuint((uint64_t)ds[k * 3 + 2]);
    }
  }
  return true;
}

static const int64_t* i64_data(PyObject* arr, const char* name, npy_intp* n) {
  if (!PyArray_Check(arr)) {
    PyErr_Format(PyExc_TypeError, "%s must be an int64 numpy array", name);
    return nullptr;
  }
  PyArrayObject* a = (PyArrayObject*)arr;
  if (PyArray_TYPE(a) != NPY_INT64 || !PyArray_IS_C_CONTIGUOUS(a)) {
    PyErr_Format(PyExc_TypeError, "%s must be contiguous int64", name);
    return nullptr;
  }
  if (n) *n = PyArray_SIZE(a);
  return (const int64_t*)PyArray_DATA(a);
}

static const int32_t* i32_data(PyObject* arr, const char* name, npy_intp* n) {
  if (!PyArray_Check(arr)) {
    PyErr_Format(PyExc_TypeError, "%s must be an int32 numpy array", name);
    return nullptr;
  }
  PyArrayObject* a = (PyArrayObject*)arr;
  if (PyArray_TYPE(a) != NPY_INT32 || !PyArray_IS_C_CONTIGUOUS(a)) {
    PyErr_Format(PyExc_TypeError, "%s must be contiguous int32", name);
    return nullptr;
  }
  if (n) *n = PyArray_SIZE(a);
  return (const int32_t*)PyArray_DATA(a);
}

static bool fill_strings(PyObject* list, std::vector<std::string>* out) {
  PyObject* seq = PySequence_Fast(list, "expected a list of strings");
  if (!seq) return false;
  Py_ssize_t n = PySequence_Fast_GET_SIZE(seq);
  out->reserve(n);
  for (Py_ssize_t i = 0; i < n; i++) {
    Py_ssize_t len;
    const char* d =
        PyUnicode_AsUTF8AndSize(PySequence_Fast_GET_ITEM(seq, i), &len);
    if (!d) { Py_DECREF(seq); return false; }
    out->emplace_back(d, len);
  }
  Py_DECREF(seq);
  return true;
}

static PyObject* encode_update(PyObject*, PyObject* args) {
  PyObject *client, *clock, *parent_root, *pclient, *pclock, *key_id;
  PyObject *oclient, *oclock, *rclient, *rclock, *kind, *type_ref;
  PyObject *contents, *roots, *keys, *dsarr;
  if (!PyArg_ParseTuple(args, "OOOOOOOOOOOOOOOO", &client, &clock,
                        &parent_root, &pclient, &pclock, &key_id, &oclient,
                        &oclock, &rclient, &rclock, &kind, &type_ref,
                        &contents, &roots, &keys, &dsarr))
    return nullptr;
  EncodeInput E;
  npy_intp n = 0, nds3 = 0;
  E.client = i64_data(client, "client", &n);
  E.clock = i64_data(clock, "clock", nullptr);
  E.parent_root = i32_data(parent_root, "parent_root", nullptr);
  E.pclient = i64_data(pclient, "parent_client", nullptr);
  E.pclock = i64_data(pclock, "parent_clock", nullptr);
  E.key_id = i32_data(key_id, "key_id", nullptr);
  E.oclient = i64_data(oclient, "origin_client", nullptr);
  E.oclock = i64_data(oclock, "origin_clock", nullptr);
  E.rclient = i64_data(rclient, "right_client", nullptr);
  E.rclock = i64_data(rclock, "right_clock", nullptr);
  E.kind = i32_data(kind, "kind", nullptr);
  E.type_ref = i32_data(type_ref, "type_ref", nullptr);
  const int64_t* ds = i64_data(dsarr, "ds", &nds3);
  if (!E.client || !E.clock || !E.parent_root || !E.pclient || !E.pclock ||
      !E.key_id || !E.oclient || !E.oclock || !E.rclient || !E.rclock ||
      !E.kind || !E.type_ref || !ds)
    return nullptr;
  if (!PyList_Check(contents) || PyList_GET_SIZE(contents) != n) {
    PyErr_SetString(PyExc_TypeError, "contents must be a list of length n");
    return nullptr;
  }
  if (!fill_strings(roots, &E.roots) || !fill_strings(keys, &E.keys))
    return nullptr;
  E.contents = contents;
  E.n = n;

  Writer w;
  if (!encode_rows(w, E, ds, nds3 / 3)) return nullptr;
  return PyBytes_FromStringAndSize((const char*)w.buf.data(), w.buf.size());
}

// ---------------------------------------------------------------------------
// conflict_ranks (the Yjs conflict scan of ops/yata.py:_simulate_group)
// ---------------------------------------------------------------------------

// One origin group, members 0..k-1 in (client, clock) order: integrate
// in causal rounds (a member whose anchor is an unplaced member waits;
// one placed earlier in the same round counts as placed), scan the
// placed list from its start for the insertion point, and append an
// anchor cycle's members in order. Writes each member's final position.
static void scan_group(int64_t k, const int64_t* cl, const int64_t* rt,
                       const int64_t* anc, int64_t* rank) {
  std::vector<int64_t> placed, rem(k), still;
  std::vector<char> done(k, 0);
  placed.reserve(k);
  for (int64_t i = 0; i < k; i++) rem[i] = i;
  while (!rem.empty()) {
    bool progress = false;
    still.clear();
    for (int64_t s : rem) {
      int64_t a = anc[s];
      if (a >= 0 && !done[a]) {
        still.push_back(s);
        continue;
      }
      int64_t left = -1;
      for (int64_t i = 0; i < (int64_t)placed.size(); i++) {
        int64_t t = placed[i];
        if (t == a) break;
        if (cl[t] < cl[s]) left = i;
        else if (cl[t] > cl[s] && rt[t] == rt[s]) break;
      }
      placed.insert(placed.begin() + (left + 1), s);
      done[s] = 1;
      progress = true;
    }
    if (!progress) {
      for (int64_t s : still) placed.push_back(s);
      still.clear();
    }
    rem.swap(still);
  }
  for (int64_t i = 0; i < k; i++) rank[placed[i]] = i;
}

// conflict_ranks(offsets, client, right, anchor) -> int64 ranks
//   Groups laid out as CSR: group g is rows offsets[g]..offsets[g+1]-1,
//   each sorted by (client, clock). right: the right origin's id key
//   (-1 for none); anchor: the in-group index of the member the right
//   origin names (-1 for none). Returns each row's rank in its group.
static PyObject* conflict_ranks(PyObject*, PyObject* args) {
  PyObject *offs, *client, *right, *anchor;
  if (!PyArg_ParseTuple(args, "OOOO", &offs, &client, &right, &anchor))
    return nullptr;
  npy_intp ng1 = 0, m = 0, mr = 0, ma = 0;
  const int64_t* off = i64_data(offs, "offsets", &ng1);
  const int64_t* cl = i64_data(client, "client", &m);
  const int64_t* rt = i64_data(right, "right", &mr);
  const int64_t* anc = i64_data(anchor, "anchor", &ma);
  if (!off || !cl || !rt || !anc) return nullptr;
  if (ng1 < 1 || off[0] != 0 || off[ng1 - 1] != m || mr != m || ma != m) {
    PyErr_SetString(PyExc_ValueError,
                    "offsets must run from 0 to the row count, and "
                    "client, right and anchor must share that length");
    return nullptr;
  }
  for (npy_intp g = 0; g + 1 < ng1; g++) {
    int64_t k = off[g + 1] - off[g];
    if (k < 0) {
      PyErr_SetString(PyExc_ValueError, "offsets must not decrease");
      return nullptr;
    }
    for (int64_t i = off[g]; i < off[g + 1]; i++) {
      if (anc[i] < -1 || anc[i] >= k) {
        PyErr_SetString(PyExc_ValueError,
                        "an anchor lies outside its group");
        return nullptr;
      }
    }
  }
  npy_intp dims[1] = {m};
  PyObject* out = PyArray_SimpleNew(1, dims, NPY_INT64);
  if (!out) return nullptr;
  int64_t* rank = (int64_t*)PyArray_DATA((PyArrayObject*)out);
  Py_BEGIN_ALLOW_THREADS
  for (npy_intp g = 0; g + 1 < ng1; g++) {
    int64_t a = off[g];
    scan_group(off[g + 1] - a, cl + a, rt + a, anc + a, rank + a);
  }
  Py_END_ALLOW_THREADS
  return out;
}

// ---------------------------------------------------------------------------

static PyMethodDef methods[] = {
    {"decode_updates", decode_updates, METH_VARARGS,
     "Decode a sequence of v1 update blobs into columnar arrays."},
    {"encode_update", encode_update, METH_VARARGS,
     "Encode columnar rows + delete set into one v1 update blob."},
    {"conflict_ranks", conflict_ranks, METH_VARARGS,
     "Replay the Yjs conflict scan over CSR origin groups."},
    {nullptr, nullptr, 0, nullptr},
};

static struct PyModuleDef moduledef = {
    PyModuleDef_HEAD_INIT, "_v1codec_torch",
    "Native v1 update codec (see crdt_tpu_torch/codec/native.py).", -1,
    methods,
};

PyMODINIT_FUNC PyInit__v1codec_torch(void) {
  import_array();
  PyObject* json = PyImport_ImportModule("json");
  if (!json) return nullptr;
  g_json_dumps = PyObject_GetAttrString(json, "dumps");
  g_json_loads = PyObject_GetAttrString(json, "loads");
  Py_DECREF(json);
  if (!g_json_dumps || !g_json_loads) return nullptr;
  PyObject* lib0 = PyImport_ImportModule("crdt_tpu_torch.codec.lib0");
  if (!lib0) return nullptr;
  g_undefined = PyObject_GetAttrString(lib0, "UNDEFINED");
  Py_DECREF(lib0);
  if (!g_undefined) return nullptr;
  return PyModule_Create(&moduledef);
}
