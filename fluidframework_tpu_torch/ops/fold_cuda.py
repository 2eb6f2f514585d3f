"""The merge-tree fold kernel for Hopper and its wrappers.

``fold(state, ops)`` folds every document's op tail into its state, and
``fold_export(state, ops, doc_base, layout, digest)`` does the same and
writes the transfer buffer (and the state digest) instead of the state:

- on CPU tensors they are the plain versions,
  ``mergetree_kernel.fold_reference`` and ``export_reference``;
- on CUDA tensors they launch the hand-written kernel in
  ``csrc/mergetree_fold.cu`` on the current stream, or raise.  There is
  no fall back to a plain version, to the CPU or to a wider layout on
  the card.

The kernel replaces the TPU kernel ``fluidframework_tpu/ops/pallas_fold.py``
(``_fold_kernel``, entry ``replay_vmapped_pallas``) and, in its
fold+export build, the reference's XLA prologue and epilogue around it
(``_cold_start``, ``_widen_ops``, ``_widen_state``, ``_export_state``,
``_doc_digests``).  One warp folds one document.  ``placement(S, K)``
picks where its working set lives: in shared memory when it fits a block
(several documents to a block, rows moved by bulk asynchronous copies in
the state-out build), else in the document's slice of a device-memory
scratch buffer the wrapper allocates.  Neither raises for size.  The bulk
copies move whole rows, so ``_check`` refuses shapes whose int32 rows are
not 16-byte multiples (the packer never makes one).  The source's header
note says what bounds it on the card and what the design does about that.

``fold.launches`` / ``fold_export.launches`` count each entry's launches
(and nothing else), and ``.placements`` splits them by placement, so a run
can show which builds the main path went through; ``occupancy(S, K)``
reports the launch a build takes.
"""

from __future__ import annotations

import ctypes

import torch

from .mergetree_kernel import (
    EXPORT_SLOT_FIELDS,
    OP_FIELDS,
    MTOps,
    MTState,
    _export_fields,
    _layout_rows,
    export_reference,
    fold_reference,
    upload_encoding,
)

#: shared memory one thread block can address on Hopper (bytes)
SMEM_LIMIT = 232448
#: bulk copies move whole rows of 16-byte multiples, from 16-byte addresses
_ROW_ALIGN = 16
_N_PTRS = len(OP_FIELDS) + 1 + 2 * (len(EXPORT_SLOT_FIELDS) + 3)
#: fold+export pointers: ops, state (null when cold), doc_base, the export
#: buffer, the misc leaf, the digest, the scratch
_N_EXPORT_PTRS = len(OP_FIELDS) + 1 + len(EXPORT_SLOT_FIELDS) + 3 + 5
#: the kernel builds, as ``mergetree_fold_occupancy_of`` numbers them
_VARIANTS = {("fold", "smem"): 0, ("fold", "gmem"): 1,
             ("fold_export", "smem"): 2, ("fold_export", "gmem"): 3}
_lib = None


def bind(lib: ctypes.CDLL) -> ctypes.CDLL:
    """Declare the signatures of the fold library's state-out C entries in
    shared memory, ``mergetree_fold`` and ``mergetree_fold_smem_bytes``,
    on a loaded build of ``csrc/mergetree_fold.cu`` (any version of it);
    returns ``lib``."""
    lib.mergetree_fold.restype = ctypes.c_int
    lib.mergetree_fold.argtypes = [
        ctypes.POINTER(ctypes.c_void_p), ctypes.c_int, ctypes.c_int,
        ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
    lib.mergetree_fold_smem_bytes.restype = ctypes.c_longlong
    lib.mergetree_fold_smem_bytes.argtypes = [ctypes.c_int, ctypes.c_int]
    return lib


def bind_all(lib: ctypes.CDLL) -> ctypes.CDLL:
    """``bind`` plus this source's device-memory, fold+export and
    occupancy entries (``mergetree_fold_occupancy_of`` answers for every
    build); returns ``lib``."""
    bind(lib)
    lib.mergetree_fold_gmem.restype = ctypes.c_int
    lib.mergetree_fold_gmem.argtypes = [
        ctypes.POINTER(ctypes.c_void_p), ctypes.c_int, ctypes.c_int,
        ctypes.c_int, ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p]
    lib.mergetree_fold_export.restype = ctypes.c_int
    lib.mergetree_fold_export.argtypes = [
        ctypes.POINTER(ctypes.c_void_p), ctypes.POINTER(ctypes.c_int),
        ctypes.c_int, ctypes.c_void_p]
    lib.mergetree_fold_occupancy_of.restype = ctypes.c_int
    lib.mergetree_fold_occupancy_of.argtypes = [
        ctypes.c_int, ctypes.c_int, ctypes.c_int,
        ctypes.POINTER(ctypes.c_int)]
    return lib


def _library():
    global _lib
    if _lib is None:
        from ._cuda_build import load

        _lib = bind_all(load("mergetree_fold"))
    return _lib


def placement(S: int, K: int, lib: ctypes.CDLL = None) -> str:
    """Where a document of S slots and K props keys folds: ``"smem"``
    when its working set fits a block's shared memory, else ``"gmem"``
    (its slice of a device-memory scratch buffer)."""
    lib = lib or _library()
    return "smem" if _doc_bytes(S, K, lib) <= SMEM_LIMIT else "gmem"


def _doc_bytes(S: int, K: int, lib: ctypes.CDLL) -> int:
    return int(lib.mergetree_fold_smem_bytes(S, K))


def occupancy(S: int, K: int, lib: ctypes.CDLL = None,
              kernel: str = "fold") -> dict:
    """The launch a build of the kernel takes at (S, K) on the current
    card, in the placement ``placement(S, K)`` picks: documents (warps)
    per block, and blocks and documents per SM as
    ``cudaOccupancyMaxActiveBlocksPerMultiprocessor`` reports them.
    ``kernel`` is ``"fold"`` (state out) or ``"fold_export"``.  ``lib`` is
    the kernel's library unless another build of this source is given
    (``bind_all`` it first)."""
    lib = lib or _library()
    where = placement(S, K, lib)
    per_block = ctypes.c_int(0)
    blocks = int(lib.mergetree_fold_occupancy_of(
        _VARIANTS[kernel, where], S, K, ctypes.byref(per_block)))
    if blocks < 0:
        raise RuntimeError(f"mergetree_fold occupancy: CUDA error {-blocks}")
    return {"S": S, "K": K, "kernel": kernel, "placement": where,
            "docs_per_block": per_block.value, "blocks_per_sm": blocks,
            "docs_per_sm": blocks * per_block.value,
            "bytes_per_doc": _doc_bytes(S, K, lib)}


def _check_rows(S: int, T: int) -> None:
    for dim, size in (("S", S), ("T", T)):
        if size * 4 % _ROW_ALIGN:
            raise ValueError(
                f"{dim}={size}: a row of {size} int32 is not a multiple of "
                f"{_ROW_ALIGN} bytes, which the kernel's bulk copies need "
                f"(the packer's shapes always are)")


def _check_tensors(kind: str, tup, want: dict, dtypes: dict,
                   device: torch.device, aligned: bool = True) -> None:
    """Device, dtype, shape and contiguity of every leaf of ``tup``, and
    16-byte starts of the rows a bulk copy may move."""
    for name, x in tup._asdict().items():
        where = f"{kind}.{name}"
        if x.device != device:
            raise ValueError(f"{where} lies on {x.device}, not {device}")
        if x.dtype != dtypes[name]:
            raise ValueError(f"{where} is {x.dtype}, expected "
                             f"{dtypes[name]}")
        if tuple(x.shape) != want[name]:
            raise ValueError(f"{where} has shape {tuple(x.shape)}, "
                             f"expected {want[name]}")
        if not x.is_contiguous():
            raise ValueError(f"{where} is not contiguous")
        if aligned and name not in ("n", "overflow") \
                and x.data_ptr() % _ROW_ALIGN:
            raise ValueError(f"{where} does not start on a "
                             f"{_ROW_ALIGN}-byte boundary")


def _shapes(D: int, S: int, T: int, K: int):
    want_state = {f: (D, S) for f in EXPORT_SLOT_FIELDS}
    want_state.update(props=(D, S, K), n=(D,), overflow=(D,))
    want_ops = {f: (D, T) for f in OP_FIELDS}
    want_ops["pvals"] = (D, T, K)
    return want_state, want_ops


def _check(state: MTState, ops: MTOps, device: torch.device):
    """Validate what the state-out kernel reads: device, dtype, shape,
    contiguity, and rows the bulk copies can move (16-byte multiples and
    addresses)."""
    D, S = state.tstart.shape
    K = state.props.shape[2]
    T = ops.kind.shape[1]
    _check_rows(S, T)
    want_state, want_ops = _shapes(D, S, T, K)
    int32 = {f: torch.int32 for f in MTState._fields + MTOps._fields}
    _check_tensors("state", state, want_state,
                   dict(int32, overflow=torch.bool), device)
    _check_tensors("ops", ops, want_ops, int32, device)
    return D, S, T, K


def _launch_stream(device: torch.device) -> ctypes.c_void_p:
    return ctypes.c_void_p(torch.cuda.current_stream(device).cuda_stream)


def fold(state: MTState, ops: MTOps, lib: ctypes.CDLL = None) -> MTState:
    """Fold ``ops`` into ``state``: the plain fold for CPU tensors, the
    CUDA kernel for CUDA tensors (same ``MTState`` layout out), in shared
    or device memory as ``placement`` says.  ``lib`` is the kernel's
    library unless another build of the same C interface is given
    (``bind`` it first), as a measurement compares builds."""
    device = state.tstart.device
    if device.type == "cpu":
        return fold_reference(state, ops)
    if device.type != "cuda":
        raise ValueError(f"fold runs on cpu or cuda tensors, not {device}")
    D, S, T, K = _check(state, ops, device)
    lib = lib or _library()
    where = placement(S, K, lib)
    out = MTState(
        **{f: torch.empty((D, S), dtype=torch.int32, device=device)
           for f in EXPORT_SLOT_FIELDS},
        props=torch.empty((D, S, K), dtype=torch.int32, device=device),
        n=torch.empty((D,), dtype=torch.int32, device=device),
        overflow=torch.empty((D,), dtype=torch.bool, device=device),
    )
    tensors = [getattr(ops, f) for f in OP_FIELDS] + [ops.pvals]
    for st in (state, out):
        tensors += [getattr(st, f) for f in EXPORT_SLOT_FIELDS]
        tensors += [st.props, st.n, st.overflow]
    assert len(tensors) == _N_PTRS
    ptrs = (ctypes.c_void_p * _N_PTRS)(*[t.data_ptr() for t in tensors])
    if D == 0:
        return out
    with torch.cuda.device(device):
        stream = _launch_stream(device)
        scratch = None if where == "smem" else torch.empty(
            (D, _doc_bytes(S, K, lib) // 4), dtype=torch.int32,
            device=device)
        extra = [] if scratch is None else [
            ctypes.c_void_p(scratch.data_ptr())]
        c_entry = lib.mergetree_fold if where == "smem" \
            else lib.mergetree_fold_gmem
        rc = c_entry(ptrs, D, S, T, K, *extra, stream)
    if rc != 0:
        raise RuntimeError(f"mergetree_fold launch failed ({where}): CUDA "
                           f"error {rc}")
    fold.launches += 1
    fold.placements[where] += 1
    return out


fold.launches = 0
fold.placements = {"smem": 0, "gmem": 0}


def fold_export(state, ops: MTOps, doc_base: torch.Tensor, layout,
                digest: bool = False, S: int = None):
    """Fold a chunk and return its export leaves, as the reference's
    ``replay_export`` does: the transfer buffer (``[D, rows, S]``, int16
    when ``i16`` else int32), ``(buffer, misc [D, 4])`` for i8 layouts,
    and with ``digest`` the ``[D, 2]`` int32 digest as the last leaf.

    ``state`` is None for a cold chunk (``S`` slots, the empty state built
    in the kernel), or an ``MTState`` in int32 or the int16 upload
    encoding; ``ops`` is int32 or the narrow upload encoding;
    ``doc_base`` the ``[D]`` int32 arena bases; ``layout`` the
    ``(i16, ob_rows, ov_rows, i8, props_rows)`` facts of
    ``mergetree_kernel._export_flags``.  CPU tensors take the plain
    ``export_reference``; CUDA tensors the kernel's fold+export build."""
    device = ops.kind.device
    if device.type == "cpu":
        return export_reference(state, ops, doc_base, layout, digest, S=S)
    if device.type != "cuda":
        raise ValueError(
            f"fold_export runs on cpu or cuda tensors, not {device}")
    i16, ob_rows, ov_rows, i8, props_rows = (bool(x) for x in layout)
    i8 = i8 and i16
    D, T = ops.kind.shape
    K = ops.pvals.shape[2]
    S = int(S) if state is None else state.tstart.shape[1]
    _check_rows(S, T)
    narrow_ops = upload_encoding(ops)
    want_state, want_ops = _shapes(D, S, T, K)
    _check_tensors("ops", ops, want_ops,
                   {f: getattr(ops, f).dtype for f in MTOps._fields},
                   device, aligned=False)
    st_mode = 0
    if state is not None:
        st_mode = 2 if upload_encoding(state) else 1
        _check_tensors("state", state, want_state,
                       {f: getattr(state, f).dtype for f in MTState._fields},
                       device, aligned=False)
    if doc_base.device != device or doc_base.dtype != torch.int32 \
            or tuple(doc_base.shape) != (D,) or not doc_base.is_contiguous():
        raise ValueError(f"doc_base must be a contiguous int32 [{D}] tensor "
                         f"on {device}; got {doc_base.dtype} "
                         f"{tuple(doc_base.shape)} on {doc_base.device}")
    fields = _export_fields(ob_rows, ov_rows)
    n_props_rows = K if props_rows else 0
    rows = _layout_rows(ob_rows, ov_rows, i8, n_props_rows)
    out = torch.empty((D, rows, S), device=device,
                      dtype=torch.int16 if i16 else torch.int32)
    misc = torch.empty((D, 4), dtype=torch.int32, device=device) \
        if i8 else None
    dig = torch.empty((D, 2), dtype=torch.int32, device=device) \
        if digest else None
    ex = (out, misc) if i8 else out
    if digest:
        ex = ex + (dig,) if isinstance(ex, tuple) else (ex, dig)
    if D == 0:
        return ex
    lib = _library()
    where = placement(S, K, lib)
    scratch = torch.empty((D, _doc_bytes(S, K, lib) // 4), dtype=torch.int32,
                          device=device) if where == "gmem" else None
    tensors = [getattr(ops, f) for f in OP_FIELDS] + [ops.pvals]
    if state is None:
        tensors += [None] * (len(EXPORT_SLOT_FIELDS) + 3)
    else:
        tensors += [getattr(state, f) for f in EXPORT_SLOT_FIELDS]
        tensors += [state.props, state.n, state.overflow]
    tensors += [doc_base, out, misc, dig, scratch]
    assert len(tensors) == _N_EXPORT_PTRS
    ptrs = (ctypes.c_void_p * _N_EXPORT_PTRS)(
        *[None if t is None else t.data_ptr() for t in tensors])
    plane = {f: i for i, f in enumerate(EXPORT_SLOT_FIELDS)}
    iargs = [D, S, T, K, int(narrow_ops), st_mode, rows, int(i16), int(i8),
             n_props_rows, len(fields)] + [plane[f] for f in fields]
    iargs = (ctypes.c_int * len(iargs))(*iargs)
    with torch.cuda.device(device):
        rc = lib.mergetree_fold_export(ptrs, iargs, int(where == "gmem"),
                                       _launch_stream(device))
    if rc != 0:
        raise RuntimeError(f"mergetree_fold_export launch failed ({where}): "
                           f"CUDA error {rc}")
    fold_export.launches += 1
    fold_export.placements[where] += 1
    return ex


fold_export.launches = 0
fold_export.placements = {"smem": 0, "gmem": 0}


def reset_launches() -> None:
    """Set every launch count to 0 (before the run they should count)."""
    for entry in (fold, fold_export):
        entry.launches = 0
        entry.placements = {"smem": 0, "gmem": 0}
