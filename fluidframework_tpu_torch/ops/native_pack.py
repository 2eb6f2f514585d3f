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
    lib.oppack_pack.restype = ctypes.c_int32
    lib.oppack_pack.argtypes = [
        ctypes.c_char_p, ctypes.c_int64,
        ctypes.c_int32, ctypes.c_int32, ctypes.c_int64,
    ] + [np.ctypeslib.ndpointer(np.int32, flags="C_CONTIGUOUS")] * 10 + [
        np.ctypeslib.ndpointer(np.uint8, flags="C_CONTIGUOUS"),
        ctypes.c_int64,
        ctypes.POINTER(ctypes.c_int64), ctypes.POINTER(ctypes.c_int64),
        ctypes.c_void_p, ctypes.c_int32,   # key_map, n_keys
        ctypes.c_void_p, ctypes.c_int32,   # val_map, n_vals
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


#: the nine [D, T] op fields in oppack_pack's argument order
_ROW_FIELDS = ("kind", "seq", "client", "ref_seq", "min_seq", "a", "b",
               "tstart", "tlen")


def _raw_pack(lib):
    """A second prototype for the SAME ``oppack_pack`` symbol taking raw
    ``c_void_p`` row pointers.  The ndpointer prototype re-marshals every
    ndarray argument on every call (~40% of chunk pack time at 11 arrays
    × 1024 docs — profiled round 5); the batch packer precomputes each
    field's base address once per chunk and passes ``base + d*row_bytes``
    as plain ints instead."""
    fn = getattr(lib, "_oppack_pack_raw", None)
    if fn is None:
        proto = ctypes.CFUNCTYPE(
            ctypes.c_int32,
            ctypes.c_char_p, ctypes.c_int64,
            ctypes.c_int32, ctypes.c_int32, ctypes.c_int64,
            *([ctypes.c_void_p] * 10),
            ctypes.c_void_p, ctypes.c_int64,
            ctypes.POINTER(ctypes.c_int64), ctypes.POINTER(ctypes.c_int64),
            ctypes.c_void_p, ctypes.c_int32,
            ctypes.c_void_p, ctypes.c_int32,
        )
        fn = proto(("oppack_pack", lib))
        lib._oppack_pack_raw = fn
    return fn


class ChunkPacker:
    """Per-chunk fast row packer: base addresses captured once from the
    batch op arrays (which must outlive the packer), one shared text
    scratch reused across docs."""

    def __init__(self, op: Dict[str, np.ndarray], lib):
        self._fn = _raw_pack(lib)
        self._T = int(op["kind"].shape[1])
        self._K = int(op["pvals"].shape[2])
        self._bases = [op[f].ctypes.data for f in _ROW_FIELDS]
        self._pvals_base = op["pvals"].ctypes.data
        self._keepalive = op  # pin the arrays behind the raw pointers
        self._scratch = np.zeros(1, np.uint8)

    def pack(self, blob: bytes, d: int, arena_base_chars: int,
             arena: bytearray, text_bytes: int,
             key_map: Optional[np.ndarray] = None,
             val_map: Optional[np.ndarray] = None) -> int:
        T, K = self._T, self._K
        if self._scratch.nbytes < max(text_bytes, 1):
            self._scratch = np.zeros(max(text_bytes, 1), np.uint8)
        arena_bytes = ctypes.c_int64()
        arena_chars = ctypes.c_int64()
        row_off = d * T * 4
        ptrs = [b + row_off for b in self._bases]
        ptrs.append(self._pvals_base + d * T * K * 4)
        km = None if key_map is None else \
            np.ascontiguousarray(key_map, np.int32)
        vm = None if val_map is None else \
            np.ascontiguousarray(val_map, np.int32)
        packed = self._fn(
            blob, len(blob), T, K, arena_base_chars, *ptrs,
            self._scratch.ctypes.data, self._scratch.nbytes,
            ctypes.byref(arena_bytes), ctypes.byref(arena_chars),
            None if km is None else km.ctypes.data,
            0 if km is None else len(km),
            None if vm is None else vm.ctypes.data,
            0 if vm is None else len(vm),
        )
        if packed < 0:
            raise ValueError("malformed binary op stream")
        arena += self._scratch[:arena_bytes.value].tobytes()
        return packed


def chunk_packer(op: Dict[str, np.ndarray]) -> Optional["ChunkPacker"]:
    """A ChunkPacker when liboppack is available, else None (callers fall
    back to the per-doc ``pack_doc_row`` pure-Python path)."""
    lib = load_library()
    return None if lib is None else ChunkPacker(op, lib)


def pack_doc_row(
    blob: bytes,
    row: Dict[str, np.ndarray],
    K: int,
    arena_base_chars: int,
    arena: bytearray,
    text_bytes: Optional[int] = None,
    key_map: Optional[np.ndarray] = None,
    val_map: Optional[np.ndarray] = None,
) -> int:
    """Fill one document's row of the batch arrays from its binary stream;
    appends text to ``arena`` (utf-8 bytes) and returns ops packed.

    ``row`` maps field name → the 1-D row views (``op['kind'][d]`` etc.,
    C-contiguous); ``pvals`` is the (T, K) row.  ``key_map``/``val_map``
    (int32 arrays) translate encoder-local property key / value ids into
    the batch-global intern spaces."""
    T = row["kind"].shape[0]
    lib = load_library()
    if lib is not None:
        if text_bytes is None:
            _n, text_bytes, _tc = count_stream(blob)
        scratch = np.zeros(max(text_bytes, 1), np.uint8)
        arena_bytes = ctypes.c_int64()
        arena_chars = ctypes.c_int64()
        km = None if key_map is None else \
            np.ascontiguousarray(key_map, np.int32)
        vm = None if val_map is None else \
            np.ascontiguousarray(val_map, np.int32)
        packed = lib.oppack_pack(
            blob, len(blob), T, K, arena_base_chars,
            row["kind"], row["seq"], row["client"], row["ref_seq"],
            row["min_seq"], row["a"], row["b"], row["tstart"], row["tlen"],
            row["pvals"].reshape(-1),
            scratch, len(scratch),
            ctypes.byref(arena_bytes), ctypes.byref(arena_chars),
            None if km is None else km.ctypes.data,
            0 if km is None else len(km),
            None if vm is None else vm.ctypes.data,
            0 if vm is None else len(vm),
        )
        if packed < 0:
            raise ValueError("malformed binary op stream")
        arena += scratch[:arena_bytes.value].tobytes()
        return packed
    return _pack_py(blob, row, K, arena_base_chars, arena, key_map, val_map)


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
