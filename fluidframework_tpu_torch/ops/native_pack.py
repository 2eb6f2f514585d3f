"""Native op packing: binary record streams + the liboppack C++ packer.

The port's copy of ``fluidframework_tpu/ops/native_pack.py``: the same
encoder, packer and extractor, building the port's own copy of the C++
source (``csrc/oppack.cpp``) into the port's ``build/`` directory.

The ingestion side (sequencer/scriptorium, bench synthesis, or the catch-up
service's flatten step) encodes each string-channel op stream ONCE into the
flat binary record format documented in ``csrc/oppack.cpp``; packing a
10k-document batch for the device then runs entirely in C++ — one pass per
document filling the padded (D, T) arrays and the shared text arena, no
Python objects in the loop.

It also hosts the extraction fast path: ``oppack_extract`` turns the fused
final-state export buffer into canonical summary-body JSON bytes for a whole
chunk in one C++ pass (see ``extract_bodies``).

Build: the library compiles on demand from ``csrc/oppack.cpp`` with g++.
The artifact is keyed by a content hash of the source
(``liboppack-<hash>.so``) so a stale binary can never shadow newer source —
mtimes are meaningless after a git checkout.  If no toolchain is available
the pure-Python encoder/packer pair keeps everything working — the native
path is a strictly optional accelerator with bit-identical output (asserted
for the port by tests/test_torch_pack.py and tests/test_torch_pipeline.py).
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import struct
import subprocess
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from ..protocol.messages import MessageType, SequencedMessage

_PKG_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
#: build outputs (listed in .gitignore), shared with the CUDA kernels
BUILD_DIR = os.path.join(_PKG_ROOT, "build")

_KINDS = {"insert": 1, "remove": 2, "annotate": 3, "obliterate": 4}
_HEADER = struct.Struct("<B8i")
_PAIR = struct.Struct("<2i")


# -- encoder (ingestion side; pure Python by design — runs once per op) -------


def encode_string_ops(
    ops: Sequence[SequencedMessage],
    client_intern,
    prop_key_intern=None,
    value_intern=None,
) -> bytes:
    """Sequence-channel ops → the flat binary record stream.

    ``client_intern`` / ``prop_key_intern`` / ``value_intern`` are
    ``Interner``-likes (callables via ``.intern``); symbol interning stays
    host-side so records carry dense ids only."""
    out = bytearray()
    for msg in ops:
        if msg.type is not MessageType.OP:
            continue
        op = msg.contents
        kind = _KINDS[op["kind"]]
        client = client_intern.intern(msg.client_id) \
            if msg.client_id is not None else -1
        if kind == 1:
            text = op["text"].encode("utf-8")
            a, b = op["pos"], 0
        else:
            text = b""
            a, b = op["start"], op["end"]
        props = op.get("props") or {}
        pairs = []
        for key, value in props.items():
            if prop_key_intern is None:
                raise ValueError("props present but no prop interner given")
            k = prop_key_intern.intern(key)
            v = -1 if value is None else value_intern.intern(value)
            pairs.append((k, v))
        out += _HEADER.pack(kind, msg.seq, msg.ref_seq, msg.min_seq,
                            client, a, b, len(pairs), len(text))
        for pair in pairs:
            out += _PAIR.pack(*pair)
        out += text
    return bytes(out)


def decode_string_ops(
    blob: bytes, clients: Sequence[str],
    prop_keys: Optional[Sequence[str]] = None,
    values: Optional[Sequence] = None,
) -> List[SequencedMessage]:
    """Inverse of :func:`encode_string_ops` — the oracle-fallback escape
    hatch for binary-only documents (rare; correctness over speed)."""
    out: List[SequencedMessage] = []
    off = 0
    kinds = {v: k for k, v in _KINDS.items()}
    while off < len(blob):
        kind, seq, ref, min_seq, client, a, b, n_props, text_len = \
            _HEADER.unpack_from(blob, off)
        off += _HEADER.size
        props = {}
        for _ in range(n_props):
            k, v = _PAIR.unpack_from(blob, off)
            off += 8
            props[prop_keys[k]] = None if v == -1 else values[v]
        text = blob[off:off + text_len].decode("utf-8")
        off += text_len
        name = kinds[kind]
        if name == "insert":
            contents = {"kind": "insert", "pos": a, "text": text}
            if props:
                contents["props"] = props
        else:
            contents = {"kind": name, "start": a, "end": b}
            if props:
                contents["props"] = props
        out.append(SequencedMessage(
            seq=seq, client_id=clients[client] if client >= 0 else None,
            client_seq=seq, ref_seq=ref, min_seq=min_seq,
            type=MessageType.OP, contents=contents,
        ))
    return out


# -- the native library --------------------------------------------------------


_lib_handle: Optional[ctypes.CDLL] = None
_lib_tried = False


def _build_library() -> Optional[str]:
    return build_native("oppack")


def build_native(stem: str) -> Optional[str]:
    """Compile ``csrc/<stem>.cpp`` with g++ into
    ``build/lib<stem>-<hash>.so`` unless that library exists (the hash of
    the source names it); its path, or None without a source or a
    toolchain."""
    src = os.path.join(_PKG_ROOT, "csrc", f"{stem}.cpp")
    if not os.path.exists(src):
        return None
    with open(src, "rb") as f:
        digest = hashlib.sha256(f.read()).hexdigest()[:16]
    os.makedirs(BUILD_DIR, exist_ok=True)
    lib_path = os.path.join(BUILD_DIR, f"lib{stem}-{digest}.so")
    if os.path.exists(lib_path):
        return lib_path
    tmp = lib_path + f".tmp{os.getpid()}"
    try:
        subprocess.run(
            ["g++", "-O3", "-shared", "-fPIC", "-std=c++17",
             "-o", tmp, src],
            check=True, capture_output=True, timeout=120,
        )
        # g++ wrote the artifact through its own descriptors: reopen and
        # fsync before publishing, or a crash can install a torn .so.
        fd = os.open(tmp, os.O_RDONLY)
        try:
            os.fsync(fd)
        finally:
            os.close(fd)
        os.replace(tmp, lib_path)  # commit-point: native library publish
    except (OSError, subprocess.SubprocessError):
        return None
    finally:
        if os.path.exists(tmp):
            try:
                os.unlink(tmp)
            except OSError:
                pass
    # Superseded hash builds: safe to drop (an mmap'd inode survives the
    # unlink for any process still using it).
    import glob

    for old in glob.glob(os.path.join(BUILD_DIR, f"lib{stem}-*.so")):
        if old != lib_path:
            try:
                os.unlink(old)
            except OSError:
                pass
    return lib_path


def load_library() -> Optional[ctypes.CDLL]:
    """The compiled packer, or None (pure-Python fallback)."""
    global _lib_handle, _lib_tried
    if _lib_tried:
        return _lib_handle
    _lib_tried = True
    path = _build_library()
    if path is None:
        return None
    try:
        lib = ctypes.CDLL(path)
    except OSError:
        return None
    lib.oppack_count.restype = ctypes.c_int
    lib.oppack_count.argtypes = [
        ctypes.c_char_p, ctypes.c_int64,
        ctypes.POINTER(ctypes.c_int32), ctypes.POINTER(ctypes.c_int64),
        ctypes.POINTER(ctypes.c_int64),
    ]
    lib.oppack_scan.restype = ctypes.c_int32
    lib.oppack_scan.argtypes = [
        ctypes.c_int32, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
    ]
    lib.oppack_fill.restype = ctypes.c_int32
    lib.oppack_fill.argtypes = [
        ctypes.c_int32, ctypes.c_void_p, ctypes.c_void_p,   # D, blobs, lens
        ctypes.c_int32, ctypes.c_int32, ctypes.c_int32,     # T, K, narrow
        ctypes.c_void_p, ctypes.c_void_p,                   # doc_base, planes
        ctypes.c_void_p, ctypes.c_void_p,                   # key_map, offs
        ctypes.c_void_p, ctypes.c_void_p,                   # val_map, offs
        ctypes.c_void_p, ctypes.c_int64,                    # arena, capacity
    ]
    lib.oppack_extract.restype = ctypes.c_int64
    lib.oppack_extract.argtypes = [
        np.ctypeslib.ndpointer(np.int32, flags="C_CONTIGUOUS"),  # export
        ctypes.c_int32, ctypes.c_int32, ctypes.c_int32, ctypes.c_int32,
        ctypes.c_char_p, ctypes.c_int64, ctypes.c_int64,   # arena
        ctypes.c_char_p,                                   # client_json
        np.ctypeslib.ndpointer(np.int64, flags="C_CONTIGUOUS"),
        np.ctypeslib.ndpointer(np.int32, flags="C_CONTIGUOUS"),
        ctypes.c_char_p,                                   # key_json
        np.ctypeslib.ndpointer(np.int64, flags="C_CONTIGUOUS"),
        np.ctypeslib.ndpointer(np.int32, flags="C_CONTIGUOUS"),
        ctypes.c_char_p,                                   # val_json
        np.ctypeslib.ndpointer(np.int64, flags="C_CONTIGUOUS"),
        ctypes.c_int32,
        np.ctypeslib.ndpointer(np.int32, flags="C_CONTIGUOUS"),  # msn
        np.ctypeslib.ndpointer(np.uint8, flags="C_CONTIGUOUS"),  # skip
        ctypes.c_int32,
        np.ctypeslib.ndpointer(np.uint8, flags="C_CONTIGUOUS"),  # out
        ctypes.c_int64,
        np.ctypeslib.ndpointer(np.int64, flags="C_CONTIGUOUS"),  # out_offs
    ]
    lib.oppack_widen.restype = ctypes.c_int32
    lib.oppack_widen.argtypes = [
        np.ctypeslib.ndpointer(np.int16, flags="C_CONTIGUOUS"),  # src
        ctypes.c_int32, ctypes.c_int32,                          # D, S
        ctypes.c_int32, ctypes.c_int32,                          # R_src/canon
        ctypes.c_void_p, ctypes.c_int32,                         # misc, cols
        np.ctypeslib.ndpointer(np.int32, flags="C_CONTIGUOUS"),  # desc
        ctypes.c_void_p,                                         # doc_base
        ctypes.c_int32, ctypes.c_int32,                          # sentinels
        np.ctypeslib.ndpointer(np.int32, flags="C_CONTIGUOUS"),  # dst
    ]
    _lib_handle = lib
    return lib


def count_stream(blob: bytes) -> Tuple[int, int, int]:
    """(n_ops, text_bytes, text_chars) for one binary stream."""
    lib = load_library()
    if lib is not None:
        n_ops = ctypes.c_int32()
        text_bytes = ctypes.c_int64()
        text_chars = ctypes.c_int64()
        rc = lib.oppack_count(blob, len(blob), ctypes.byref(n_ops),
                              ctypes.byref(text_bytes),
                              ctypes.byref(text_chars))
        if rc != 0:
            raise ValueError("malformed binary op stream")
        return n_ops.value, text_bytes.value, text_chars.value
    return _count_py(blob)


def _count_py(blob: bytes) -> Tuple[int, int, int]:
    off, n, tb, tc = 0, 0, 0, 0
    while off < len(blob):
        (_kind, _seq, _ref, _msn, _cl, _a, _b, n_props,
         text_len) = _HEADER.unpack_from(blob, off)
        off += _HEADER.size + 8 * n_props
        text = blob[off:off + text_len]
        if len(text) != text_len:
            raise ValueError("malformed binary op stream")
        off += text_len
        tb += text_len
        tc += len(text.decode("utf-8"))
        n += 1
    return n, tb, tc


def binary_has_obliterate(blob: bytes) -> bool:
    """Header-only scan: does the stream contain an obliterate record?"""
    off = 0
    while off < len(blob):
        kind, _s, _r, _m, _c, _a, _b, n_props, text_len = \
            _HEADER.unpack_from(blob, off)
        if kind == _KINDS["obliterate"]:
            return True
        off += _HEADER.size + 8 * n_props + text_len
    return False


#: the ten op planes in ``oppack_fill``'s order
_OP_PLANES = ("kind", "seq", "client", "ref_seq", "min_seq", "a", "b",
              "tstart", "tlen", "pvals")


def pack_doc_row(
    blob: bytes,
    op: Dict[str, np.ndarray],
    d: int,
    arena_base_chars: int,
    arena: bytearray,
    text_bytes: int,
    key_map: Optional[np.ndarray] = None,
    val_map: Optional[np.ndarray] = None,
) -> None:
    """Fill document ``d``'s rows of a batch's int32 op planes ``op``
    (field name → ``[D, T]``, ``pvals`` ``[D, T, K]``) from its binary
    stream, and append its text (utf-8 bytes, ``text_bytes`` of them) to
    ``arena``: ``oppack_fill`` over the one document, or the pure-Python
    packer without the library.  ``key_map`` / ``val_map`` (int32 arrays)
    translate encoder-local property key / value ids into the
    batch-global intern spaces."""
    lib = load_library()
    if lib is None:
        row = {f: op[f][d] for f in _OP_PLANES}
        _pack_py(blob, row, int(op["pvals"].shape[2]), arena_base_chars,
                 arena, key_map, val_map)
        return
    T, K = (int(n) for n in op["pvals"].shape[1:])
    # Every array behind a pointer below is held by a name for the call.
    maps = [np.zeros(0, np.int32) if m is None
            else np.ascontiguousarray(m, np.int32) for m in (key_map, val_map)]
    offs = [np.asarray([0, len(m)], np.int64) for m in maps]
    blobs = (ctypes.c_char_p * 1)(blob)
    lens = np.asarray([len(blob)], np.int64)
    base = np.asarray([arena_base_chars], np.int32)
    planes = (ctypes.c_void_p * len(_OP_PLANES))(
        *[op[f][d:].ctypes.data for f in _OP_PLANES])
    text = np.empty(max(text_bytes, 1), np.uint8)
    rc = lib.oppack_fill(1, blobs, lens.ctypes.data, T, K, 0,
                         base.ctypes.data, planes, maps[0].ctypes.data,
                         offs[0].ctypes.data, maps[1].ctypes.data,
                         offs[1].ctypes.data, text.ctypes.data, text_bytes)
    if rc != 0:
        raise ValueError("malformed binary op stream")
    arena += text[:text_bytes].tobytes()


def _pack_py(blob: bytes, row: Dict[str, np.ndarray], K: int,
             arena_base_chars: int, arena: bytearray,
             key_map: Optional[np.ndarray] = None,
             val_map: Optional[np.ndarray] = None) -> int:
    off, t, chars = 0, 0, 0
    while off < len(blob):
        kind, seq, ref, min_seq, client, a, b, n_props, text_len = \
            _HEADER.unpack_from(blob, off)
        off += _HEADER.size
        row["kind"][t] = kind
        row["seq"][t] = seq
        row["ref_seq"][t] = ref
        row["min_seq"][t] = min_seq
        row["client"][t] = client
        row["a"][t] = a
        row["b"][t] = b
        for _ in range(n_props):
            k, v = _PAIR.unpack_from(blob, off)
            off += 8
            if key_map is not None:
                k = int(key_map[k])
            if val_map is not None and v >= 0:
                v = int(val_map[v])
            row["pvals"][t, k] = v
        if text_len:
            text = blob[off:off + text_len]
            off += text_len
            n_chars = len(text.decode("utf-8"))
            row["tstart"][t] = arena_base_chars + chars
            row["tlen"][t] = n_chars
            arena += text
            chars += n_chars
        else:
            row["tstart"][t] = 0
            row["tlen"][t] = 0
        t += 1
    return t


# -- the record pack of a batch, by document ranges ----------------------------


#: ``oppack_scan``'s facts a document (``csrc/oppack.cpp`` ``ScanFact``):
#: ops, text bytes and chars; the least and greatest (from 0) kind, seq,
#: client, ref_seq, min_seq, a, b; the longest text; the furthest insert
#: text offset; the least and greatest property value id; the flags
(_F_OPS, _F_BYTES, _F_CHARS, _F_KIND, _F_SEQ, _F_CLIENT, _F_REF, _F_MSN,
 _F_A, _F_B) = (0, 1, 2, 3, 5, 7, 9, 11, 13, 15)
_F_TLEN_HI, _F_INS_AT_HI, _F_VAL, _F_FLAGS, _N_FACTS = 17, 18, 19, 21, 22
(_HAS_OBLITERATE, _NOT_SEQUENTIAL, _EMPTY_INSERT, _OTHER_TEXT_PAST0,
 _OTHER_TEXT_AT0) = (1, 2, 4, 8, 16)
#: the narrow upload encoding's bound of each op field's facts
_NARROW_BOUNDS = {_F_KIND: np.int8, _F_CLIENT: np.int8, _F_SEQ: np.int16,
                  _F_REF: np.int16, _F_MSN: np.int16, _F_A: np.int16,
                  _F_B: np.int16}


class RecordPack:
    """``pack_mergetree_batch`` of a batch whose documents all carry
    binary streams and no base, cut into ``k`` document ranges and run a
    step at a time, so that the ranges' steps can run on several threads
    (``oppack_scan`` and ``oppack_fill`` release the interpreter lock):

    1. ``intern()``: the batch-global property-key and value tables, in
       first-appearance order, each document's maps into them (one flat
       table each), and its client table;
    2. ``begin(j)``: range ``j``'s sizes and value facts (``oppack_scan``);
    3. ``size()``: the buckets ``T``, ``S``, ``K``, each document's
       ``doc_base`` (chars), the chunk-wide facts, and every plane
       allocated once, unfilled;
    4. ``finish(j)``: range ``j``'s rows of every plane, defaults included
       (``oppack_fill`` writes the op rows), and its documents' text;
    5. ``join()``: ``pack_mergetree_batch``'s ``(state, ops, meta)``.

    With ``narrow`` the op rows are written in the upload encoding
    wherever the chunk-wide facts allow it, and ``join()``'s ops equal
    ``narrow_ops_for_upload`` of the whole pack's (which passes them
    through); else, and always without ``narrow``, they are the whole
    pack's int32 rows.  Steps 2 and 4 of different ranges may run at once;
    every step 2 ends before step 3, and every step 4 before step 5.  A
    malformed stream raises what the whole pack raises.  ``close()`` drops
    what the steps hold."""

    def __init__(self, lib, docs, k: int, narrow: bool) -> None:
        self.lib, self.docs, self.want_narrow = lib, docs, narrow
        D = len(docs)
        self.cuts = [D * j // k for j in range(k + 1)]
        self.blobs: List[Optional[ctypes.Array]] = [None] * k
        self.scan_rcs = [0] * k
        self.errors: List[Optional[Exception]] = [None] * k
        self.texts: List[List[str]] = [[] for _ in range(k)]

    def intern(self) -> None:
        from .interning import Interner
        from .mergetree_kernel import _DocPack, known_oracle_fallback

        docs = self.docs
        D = len(docs)
        self.prop_keys, self.values = Interner(), Interner()
        key_id, value_id = self.prop_keys.intern, self.values.intern
        key_map: List[int] = []
        val_map: List[int] = []
        self.key_offs = np.zeros(D + 1, np.int64)
        self.val_offs = np.zeros(D + 1, np.int64)
        self.doc_packs = []
        for d, doc in enumerate(docs):
            if doc.binary_prop_keys:
                key_map.extend(map(key_id, doc.binary_prop_keys))
            if doc.binary_values:
                val_map.extend(map(value_id, doc.binary_values))
            self.key_offs[d + 1] = len(key_map)
            self.val_offs[d + 1] = len(val_map)
            pack = _DocPack()
            for client in (doc.binary_clients or []):
                pack.client_idx(client)
            pack.needs_fallback = bool(known_oracle_fallback(doc))
            self.doc_packs.append(pack)
        self.key_map = np.asarray(key_map, np.int32)
        self.val_map = np.asarray(val_map, np.int32)
        self.lens = np.fromiter((len(doc.binary_ops) for doc in docs),
                                np.int64, D)
        self.facts = np.empty((D, _N_FACTS), np.int64)

    def begin(self, j: int) -> None:
        lo, hi = self.cuts[j], self.cuts[j + 1]
        self.blobs[j] = (ctypes.c_char_p * (hi - lo))(
            *[doc.binary_ops for doc in self.docs[lo:hi]])
        self.scan_rcs[j] = self.lib.oppack_scan(
            hi - lo, self.blobs[j], self.lens[lo:].ctypes.data,
            self.facts[lo:].ctypes.data)

    def size(self) -> None:
        from .interning import next_bucket, next_bucket_fine
        from .mergetree_kernel import (_UPLOAD_NARROW_DTYPES, I8_LIMIT,
                                       I16_LIMIT, MTOps, MTState)

        if any(rc != 0 for rc in self.scan_rcs):
            raise ValueError("malformed binary op stream")
        docs, f = self.docs, self.facts
        D = len(docs)
        n_ops = f[:, _F_OPS]
        self.T = T = next_bucket_fine(int(n_ops.max()), floor=16)
        self.S = S = next_bucket_fine(max(2 * int(n_ops.max()), 1), floor=32)
        self.K = K = next_bucket(max(len(self.prop_keys), 1), floor=1)
        chars = f[:, _F_CHARS]
        self.doc_base = np.zeros(D, np.int32)
        np.cumsum(chars[:-1], out=self.doc_base[1:])
        self.byte_offs = np.zeros(D + 1, np.int64)
        np.cumsum(f[:, _F_BYTES], out=self.byte_offs[1:])
        flags = np.bitwise_or.reduce(f[:, _F_FLAGS])
        # The whole pack's facts, from the documents' maxima and flags.
        max_seq = max(int(f[:, _F_SEQ + 1].max()),
                      max(doc.final_seq for doc in docs),
                      max(doc.base_seq for doc in docs))
        max_clients = max(len(p.clients) for p in self.doc_packs)
        n_values = len(self.values)
        self.i16_ok = (max_seq < I16_LIMIT
                       and int(chars.max()) < I16_LIMIT
                       and S < I16_LIMIT
                       and n_values < I16_LIMIT
                       and max_clients < I16_LIMIT)
        self.i8_ok = (self.i16_ok
                      and max_seq < I8_LIMIT
                      and int(f[:, _F_TLEN_HI].max()) < I8_LIMIT
                      and n_values < I8_LIMIT
                      and max_clients < I8_LIMIT)
        self.sequential = not flags & _NOT_SEQUENTIAL
        self.has_ob = bool(flags & _HAS_OBLITERATE)
        self.narrow = self.want_narrow and self.i16_ok \
            and self._fits_narrow(flags)
        st = {name: np.empty((D, S), np.int32)
              for name in MTState._fields[:12]}
        st["props"] = np.empty((D, S, K), np.int32)
        st["n"] = np.zeros((D,), np.int32)
        st["overflow"] = np.zeros((D,), np.bool_)
        self.st = st
        self.op = {name: np.empty(
            (D, T, K) if name == "pvals" else (D, T),
            _UPLOAD_NARROW_DTYPES[name] if self.narrow else np.int32)
            for name in MTOps._fields}
        self.planes = [self.op[name] for name in MTOps._fields]
        self.arena = np.empty(max(int(self.byte_offs[-1]), 1), np.uint8)

    def _fits_narrow(self, flags: int) -> bool:
        """Whether ``narrow_ops_for_upload`` narrows this chunk (its
        ``i16_ok`` holding): every non-insert row's ``tstart`` 0 and every
        field, ``tstart`` rebased, inside its narrow type."""
        f = self.facts
        if flags & _OTHER_TEXT_PAST0:
            return False
        if flags & _OTHER_TEXT_AT0 and bool(
                (self.doc_base[(f[:, _F_FLAGS] & _OTHER_TEXT_AT0) != 0]
                 != 0).any()):
            return False
        for col, dt in _NARROW_BOUNDS.items():
            info = np.iinfo(dt)
            if int(f[:, col].min()) < info.min \
                    or int(f[:, col + 1].max()) > info.max:
                return False
        i16 = np.iinfo(np.int16)
        empty = (f[:, _F_FLAGS] & _EMPTY_INSERT) != 0
        rebased_lo = -int(self.doc_base[empty].max(initial=0))
        unmapped = self.val_offs[1:] == self.val_offs[:-1]
        return (rebased_lo >= i16.min
                and int(f[:, _F_INS_AT_HI].max()) <= i16.max
                and int(f[:, _F_TLEN_HI].max()) <= i16.max
                and int(f[:, _F_VAL].min()) >= i16.min
                and int(f[unmapped, _F_VAL + 1].max(initial=0)) <= i16.max)

    def finish(self, j: int) -> None:
        from .mergetree_kernel import NOT_REMOVED, PROP_ABSENT

        lo, hi = self.cuts[j], self.cuts[j + 1]
        st = self.st
        for name in ("tstart", "tlen", "ins_seq"):
            st[name][lo:hi] = 0
        for name in ("ins_client", "rem_client", "rem2_client",
                     "ob1_client", "ob2_client"):
            st[name][lo:hi] = -1
        for name in ("rem_seq", "rem2_seq", "ob1_seq", "ob2_seq"):
            st[name][lo:hi] = NOT_REMOVED
        st["props"][lo:hi] = PROP_ABSENT
        planes = (ctypes.c_void_p * len(self.planes))(
            *[a[lo:].ctypes.data for a in self.planes])
        b0 = int(self.byte_offs[lo])
        rc = self.lib.oppack_fill(
            hi - lo, self.blobs[j], self.lens[lo:].ctypes.data, self.T,
            self.K, int(self.narrow), self.doc_base[lo:].ctypes.data, planes,
            self.key_map.ctypes.data, self.key_offs[lo:].ctypes.data,
            self.val_map.ctypes.data, self.val_offs[lo:].ctypes.data,
            self.arena[b0:].ctypes.data, int(self.byte_offs[hi]) - b0)
        # Each document's text decodes on its own, as the whole pack
        # decodes it; the first failure of the range is join's to raise.
        filled = hi - lo if rc >= 0 else -1 - rc
        text = memoryview(self.arena)
        offs = self.byte_offs.tolist()
        try:
            self.texts[j] = [str(text[offs[d]:offs[d + 1]], "utf-8")
                             for d in range(lo, lo + filled)]
        except UnicodeDecodeError as err:
            self.errors[j] = err
        else:
            if rc < 0:
                self.errors[j] = ValueError("malformed binary op stream")

    def join(self):
        from .interning import TextArena
        from .mergetree_kernel import MTOps, MTState

        for err in self.errors:
            if err is not None:
                raise err
        arena = TextArena()
        for texts in self.texts:
            for text in texts:
                arena.append(text)
        meta = {
            "doc_packs": self.doc_packs,
            "prop_keys": list(self.prop_keys.values),
            "values": self.values,
            "arena": arena,
            "docs": self.docs,
            "doc_base": self.doc_base,
            "_S": self.S,
            "i16_ok": self.i16_ok,
            "i8_ok": self.i8_ok,
            "props_K": self.K,
            "ob_rows": self.has_ob,
            "ov_rows": not self.sequential,
            "has_props": len(self.prop_keys) > 0,
            "sequential": self.sequential,
        }
        return MTState(**self.st), MTOps(**self.op), meta

    def close(self) -> None:
        self.blobs = [None] * len(self.blobs)


# -- native summary-body extraction -------------------------------------------


def extract_bodies(
    export_np: np.ndarray,
    arena_text: str,
    doc_clients: Sequence[Sequence[str]],
    prop_keys: Sequence[str],
    values: Sequence,
    msn: np.ndarray,
    skip: np.ndarray,
    not_removed: int,
) -> Optional[List[bytes]]:
    """Canonical summary-body JSON bytes for every doc of a chunk, via the
    C++ extractor; None when the native library is unavailable (callers
    fall back to the per-slot Python extraction).

    ``export_np``: the fused [D, F, S] int32 export buffer;
    ``doc_clients``: per-doc client-id tables in intern order;
    ``prop_keys`` / ``values``: the chunk-global intern tables;
    ``msn`` int32[D]; ``skip`` uint8[D] flags oracle-fallback docs."""
    from ..protocol.summary import canonical_json

    lib = load_library()
    if lib is None:
        return None
    D, F, S = export_np.shape
    K = F - 13
    export_np = np.ascontiguousarray(export_np, np.int32)

    def flatten(tokens: Sequence[bytes]):
        offs = np.zeros(len(tokens) + 1, np.int64)
        for i, tok in enumerate(tokens):
            offs[i + 1] = offs[i] + len(tok)
        return b"".join(tokens), offs

    def json_str(s) -> bytes:
        # Fast path for the overwhelmingly common simple client id: no
        # char needing JSON escaping (quote, backslash, controls) and
        # pure ASCII — byte-equal to canonical_json then.  Anything else
        # takes the canonical serializer.
        if isinstance(s, str) and s.isascii() and '"' not in s \
                and "\\" not in s and (not s or min(s) >= " "):
            return b'"%s"' % s.encode()
        return canonical_json(s)

    client_tokens: List[bytes] = []
    doc_start = np.zeros(D + 1, np.int32)
    for d, clients in enumerate(doc_clients):
        client_tokens.extend(json_str(c) for c in clients)
        doc_start[d + 1] = len(client_tokens)
    client_blob, client_offs = flatten(client_tokens)

    order = sorted(range(len(prop_keys)), key=lambda i: prop_keys[i])
    key_cols = np.asarray(order, np.int32) if order else \
        np.zeros(0, np.int32)
    key_blob, key_offs = flatten(
        [canonical_json(prop_keys[i]) for i in order]
    )
    # The export carries K (bucketed) property rows but only
    # len(prop_keys) real columns; pad key_cols so k indexes stay aligned.
    if K > len(order):
        # Point the padding at the unused bucket columns themselves —
        # they are always PROP_ABSENT in the export, so they emit nothing.
        pad = np.zeros(K, np.int32)
        pad[:len(order)] = key_cols
        pad[len(order):] = np.arange(len(order), K, dtype=np.int32)
        key_cols = pad
        key_offs = np.concatenate(
            [key_offs,
             np.full(K - len(order), key_offs[-1], np.int64)]
        )
    val_blob, val_offs = flatten([canonical_json(v) for v in values])

    arena_bytes = arena_text.encode("utf-8")
    msn = np.ascontiguousarray(msn, np.int32)
    skip = np.ascontiguousarray(skip, np.uint8)
    out_offs = np.zeros(D + 1, np.int64)
    cap = max(len(arena_bytes) * 2 + D * 64 + int(export_np.shape[2]) * D * 8,
              1 << 16)
    for _attempt in range(3):
        out = np.empty(cap, np.uint8)  # C++ writes [0, out_offs[D])
        rc = lib.oppack_extract(
            export_np, D, F, S, K,
            arena_bytes, len(arena_bytes), len(arena_text),
            client_blob, client_offs, doc_start,
            key_blob, key_offs, key_cols,
            val_blob, val_offs, len(values),
            msn, skip, not_removed,
            out, cap, out_offs,
        )
        if rc == 0:
            buf = out[:out_offs[D]].tobytes()  # copy used extent only
            return [
                buf[out_offs[d]:out_offs[d + 1]] for d in range(D)
            ]
        if rc == -1:
            raise ValueError("oppack_extract: malformed export buffer")
        cap = int(-rc - 2) + 1024
    raise RuntimeError("oppack_extract: capacity negotiation failed")
