"""The resident-buffer kernels of the device tier (tier 2.5) and their
wrappers.

``splice_rows(resident, rows, start, count)`` writes each document's new
op rows into a namedtuple of resident planes IN PLACE,
``out[d, start[d] + j] = rows[d, j]`` for ``j < count[d]``
(``splice_row_groups`` does several such tuples in one launch);
``widen_resident(tree, doc_base)`` migrates a resident ``MTOps`` or
``MTState`` from the int16/int8 upload encoding to new int32 planes:

- on CPU tensors they are the plain versions, ``splice_rows_reference``
  (the reference's per-plane masked take-along-axis, written back in
  place) and ``mergetree_kernel._widen_ops`` / ``_widen_state``;
- on CUDA tensors they launch the hand-written kernels in
  ``csrc/resident.cu`` on the current stream — the stream the folds that
  read these buffers run on — or raise.  There is no fall back to a
  plain version or to the CPU on the card.

The kernels replace the reference's XLA-traced device code K6,
``fluidframework_tpu/ops/device_cache.py`` (``_splice_jit``,
``_widen_resident_ops``, ``_widen_resident_state``).  The encoding rule
stays in ``mergetree_kernel.upload_encoding``: ``widen_resident`` asks it
first, raises on an encoding it refuses, and returns a wide tree as it
is.  ``splice_rows.launches`` / ``widen_resident.launches`` count the
launches (and nothing else); ``reset_launches()`` zeroes them.
"""

from __future__ import annotations

import ctypes

import torch

from .mergetree_kernel import (
    EXPORT_SLOT_FIELDS,
    SENTINEL_SEQ_FIELDS,
    MTOps,
    MTState,
    _widen_ops,
    _widen_state,
    upload_encoding,
)

#: planes and row groups one splice launch takes (the kernel's descriptor
#: table)
MAX_PLANES, MAX_GROUPS = 32, 4
#: bytes an element for the dtypes the kernels move
_ESIZE = {torch.int8: 1, torch.bool: 1, torch.int16: 2, torch.int32: 4}
#: the widen kernel's per-plane decode (see csrc/resident.cu)
_CAST, _OP_TSTART, _STATE_TSTART, _SENTINEL = 0, 1, 2, 3
_lib = None


def bind(lib: ctypes.CDLL) -> ctypes.CDLL:
    """Declare the signatures of ``resident_splice_rows``,
    ``resident_splice_groups`` and ``resident_widen`` on a loaded build of
    ``csrc/resident.cu``; returns ``lib``."""
    lib.resident_splice_rows.restype = ctypes.c_int
    lib.resident_splice_rows.argtypes = [
        ctypes.POINTER(ctypes.c_void_p), ctypes.POINTER(ctypes.c_void_p),
        ctypes.POINTER(ctypes.c_int), ctypes.POINTER(ctypes.c_int),
        ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,
        ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
    lib.resident_widen.restype = ctypes.c_int
    lib.resident_widen.argtypes = [
        ctypes.POINTER(ctypes.c_void_p), ctypes.POINTER(ctypes.c_void_p),
        ctypes.POINTER(ctypes.c_int), ctypes.POINTER(ctypes.c_int),
        ctypes.POINTER(ctypes.c_longlong), ctypes.c_int,
        ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p, ctypes.c_int,
        ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p]
    lib.resident_splice_groups.restype = ctypes.c_int
    lib.resident_splice_groups.argtypes = [
        ctypes.POINTER(ctypes.c_void_p), ctypes.POINTER(ctypes.c_void_p),
        ctypes.POINTER(ctypes.c_int), ctypes.POINTER(ctypes.c_int),
        ctypes.POINTER(ctypes.c_int), ctypes.c_int,
        ctypes.POINTER(ctypes.c_void_p), ctypes.POINTER(ctypes.c_void_p),
        ctypes.POINTER(ctypes.c_int), ctypes.POINTER(ctypes.c_int),
        ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
    return lib


def _library() -> ctypes.CDLL:
    global _lib
    if _lib is None:
        from ._cuda_build import load

        _lib = bind(load("resident"))
    return _lib


def _stream(device: torch.device) -> ctypes.c_void_p:
    return ctypes.c_void_p(torch.cuda.current_stream(device).cuda_stream)


def _check_plane(where: str, x: torch.Tensor, device: torch.device,
                 shape: tuple, dtype=None) -> None:
    if x.device != device:
        raise ValueError(f"{where} lies on {x.device}, not {device}")
    if x.dtype not in _ESIZE or (dtype is not None and x.dtype != dtype):
        raise ValueError(f"{where} is {x.dtype}, expected "
                         f"{dtype or 'int8, bool, int16 or int32'}")
    if tuple(x.shape) != shape:
        raise ValueError(f"{where} has shape {tuple(x.shape)}, expected "
                         f"{shape}")
    if not x.is_contiguous():
        raise ValueError(f"{where} is not contiguous")


# ---------------------------------------------------------------------------
# The in-place suffix splice
# ---------------------------------------------------------------------------


def splice_rows_reference(resident, rows, start: torch.Tensor,
                          count: torch.Tensor):
    """The plain splice, as the reference's ``_splice_jit`` computes it: a
    clipped take-along-axis of ``rows`` masked to ``start[d] <= t <
    start[d] + count[d]``, per plane, written back into ``resident`` in
    place.  Returns ``resident``."""
    fields = type(resident)._fields
    lead = getattr(resident, fields[0])
    T = lead.shape[1]
    L = getattr(rows, fields[0]).shape[1]
    rel = torch.arange(T, device=lead.device)[None, :] \
        - start.long()[:, None]
    take = rel.clamp(0, L - 1)
    mask = (rel >= 0) & (rel < count.long()[:, None])
    for f in fields:
        field, r = getattr(resident, f), getattr(rows, f)
        if field.ndim == 2:
            new = torch.where(mask, torch.gather(r, 1, take), field)
        else:
            idx = take[:, :, None].expand(-1, -1, r.shape[2])
            new = torch.where(mask[:, :, None], torch.gather(r, 1, idx),
                              field)
        field.copy_(new)
    return resident


def _splice_group(resident, rows, start, count, device):
    """Check one row group on ``device``; returns its ``(D, T, L, planes)``
    with ``planes`` the ``(dst, src, esize, K)`` of each field."""
    fields = type(resident)._fields
    D, T = getattr(resident, fields[0]).shape[:2]
    L = getattr(rows, fields[0]).shape[1]
    planes = []
    for f in fields:
        dst, src = getattr(resident, f), getattr(rows, f)
        tail = tuple(dst.shape[2:])
        _check_plane(f"resident.{f}", dst, device, (D, T) + tail)
        _check_plane(f"rows.{f}", src, device, (D, L) + tail, dst.dtype)
        planes.append((dst, src, _ESIZE[dst.dtype], tail[0] if tail else 1))
    for name, x in (("start", start), ("count", count)):
        _check_plane(name, x, device, (D,), torch.int32)
    return D, T, L, planes


def splice_row_groups(groups, lib: ctypes.CDLL = None) -> None:
    """``splice_rows`` for several row groups in ONE launch: ``groups`` is
    a sequence of ``(resident, rows, start, count)``, each as
    ``splice_rows`` takes them (its own namedtuple, row count T and L),
    all with the same documents; ``MAX_PLANES`` planes in all.  The tree
    family splices its edit, node and container axes so.  The plain
    version for CPU tensors, the kernel for CUDA tensors."""
    groups = list(groups)
    if not groups:
        return
    device = getattr(groups[0][0], type(groups[0][0])._fields[0]).device
    if device.type == "cpu":
        for resident, rows, start, count in groups:
            splice_rows_reference(resident, rows, start, count)
        return
    if device.type != "cuda":
        raise ValueError(f"splice_rows runs on cpu or cuda tensors, not "
                         f"{device}")
    checked = [_splice_group(*g, device) for g in groups]
    n = sum(len(planes) for _D, _T, _L, planes in checked)
    if n > MAX_PLANES or len(groups) > MAX_GROUPS:
        raise ValueError(f"{n} planes in {len(groups)} groups: one launch "
                         f"takes at most {MAX_PLANES} in {MAX_GROUPS}")
    D = checked[0][0]
    if any(c[0] != D for c in checked):
        raise ValueError(f"row groups of {[c[0] for c in checked]} "
                         f"documents: one launch splices one set")
    live = [(g, c) for g, c in zip(groups, checked) if c[2] > 0]
    if D == 0 or not live:
        return
    planes = [(i, p) for i, (_g, c) in enumerate(live) for p in c[3]]
    lib = lib or _library()

    def ints(values):
        return (ctypes.c_int * len(values))(*values)

    def ptrs(values):
        return (ctypes.c_void_p * len(values))(*values)

    args = (ptrs([p[0].data_ptr() for _i, p in planes]),
            ptrs([p[1].data_ptr() for _i, p in planes]),
            ints([p[2] for _i, p in planes]), ints([p[3] for _i, p in planes]))
    with torch.cuda.device(device):
        if len(live) == 1:
            (_r, _w, start, count), (_D, T, L, _p) = live[0]
            rc = lib.resident_splice_rows(
                *args, len(planes), ctypes.c_void_p(start.data_ptr()),
                ctypes.c_void_p(count.data_ptr()), D, T, L, _stream(device))
        else:
            rc = lib.resident_splice_groups(
                *args, ints([i for i, _p in planes]), len(planes),
                ptrs([g[2].data_ptr() for g, _c in live]),
                ptrs([g[3].data_ptr() for g, _c in live]),
                ints([c[1] for _g, c in live]),
                ints([c[2] for _g, c in live]), len(live), D,
                _stream(device))
    if rc != 0:
        raise RuntimeError(f"resident_splice_rows launch failed: CUDA "
                           f"error {rc}")
    splice_rows.launches += 1


def splice_rows(resident, rows, start: torch.Tensor, count: torch.Tensor,
                lib: ctypes.CDLL = None):
    """Write ``rows[d, j]`` to ``resident[d, start[d] + j]`` for ``j <
    count[d]``, in place, for every plane of the namedtuple ``resident``
    (``[D, T]`` or ``[D, T, K]`` planes; ``rows`` the same fields as
    ``[D, L(, K)]``, same dtypes; ``start`` / ``count`` int32 ``[D]`` with
    ``0 <= count[d] <= L``).  Returns ``resident``, whose tensors keep
    their storage.  The plain version for CPU tensors, the kernel (one
    launch for the whole tuple) for CUDA tensors.  ``lib`` is the
    kernels' library unless another build is given (``bind`` it first);
    ``splice_rows.launches`` counts the splice kernel's launches from
    either wrapper."""
    splice_row_groups([(resident, rows, start, count)], lib=lib)
    return resident


splice_rows.launches = 0


# ---------------------------------------------------------------------------
# The narrow-to-wide migration
# ---------------------------------------------------------------------------


def _widen_planes(tree):
    """(field, source plane, decode mode) for every plane the widen
    writes; ``overflow`` (bool in both encodings) is kept as it is."""
    if isinstance(tree, MTOps):
        return [(f, getattr(tree, f),
                 _OP_TSTART if f == "tstart" else _CAST)
                for f in MTOps._fields]
    planes = []
    for f in EXPORT_SLOT_FIELDS:
        mode = _STATE_TSTART if f == "tstart" else \
            _SENTINEL if f in SENTINEL_SEQ_FIELDS else _CAST
        planes.append((f, getattr(tree, f), mode))
    return planes + [("props", tree.props, _CAST), ("n", tree.n, _CAST)]


def widen_resident(tree, doc_base: torch.Tensor, lib: ctypes.CDLL = None):
    """An ``MTOps`` or ``MTState`` in the narrow upload encoding as new
    int32 planes (``overflow`` stays the same bool tensor), bit for bit
    ``_widen_ops`` / ``_widen_state``; a wide tree is returned as it is,
    and an encoding ``upload_encoding`` refuses raises ``TypeError``.
    The plain version for CPU tensors, the kernel (one launch for the
    whole tuple) for CUDA tensors; ``lib`` as for ``splice_rows``."""
    if not isinstance(tree, (MTOps, MTState)):
        raise TypeError(f"widen_resident takes MTOps or MTState, not "
                        f"{type(tree).__name__}")
    if not upload_encoding(tree):
        return tree
    device = doc_base.device
    if device.type == "cpu":
        return _widen_ops(tree, doc_base) if isinstance(tree, MTOps) \
            else _widen_state(tree, doc_base)
    if device.type != "cuda":
        raise ValueError(f"widen_resident runs on cpu or cuda tensors, not "
                         f"{device}")
    planes = _widen_planes(tree)
    lead = planes[0][1]
    D, W = lead.shape
    _check_plane("doc_base", doc_base, device, (D,), torch.int32)
    for f, x, _mode in planes:
        _check_plane(f, x, device, tuple(x.shape))
        if x.shape[0] != D:
            raise ValueError(f"{f} has {x.shape[0]} documents, not {D}")
    out = {f: torch.empty(x.shape, dtype=torch.int32, device=device)
           for f, x, _mode in planes}
    if isinstance(tree, MTState):
        out["overflow"] = tree.overflow
    widened = type(tree)(**out)
    if D == 0:
        return widened
    kind, n = (tree.kind, None) if isinstance(tree, MTOps) \
        else (None, tree.n)
    m = len(planes)
    lib = lib or _library()
    with torch.cuda.device(device):
        rc = lib.resident_widen(
            (ctypes.c_void_p * m)(*[x.data_ptr() for _f, x, _ in planes]),
            (ctypes.c_void_p * m)(*[out[f].data_ptr()
                                    for f, _x, _ in planes]),
            (ctypes.c_int * m)(*[_ESIZE[x.dtype] for _f, x, _ in planes]),
            (ctypes.c_int * m)(*[mode for _f, _x, mode in planes]),
            (ctypes.c_longlong * m)(*[x.numel() for _f, x, _ in planes]),
            m,
            ctypes.c_void_p(kind.data_ptr() if kind is not None else None),
            _ESIZE[kind.dtype] if kind is not None else 0,
            ctypes.c_void_p(n.data_ptr() if n is not None else None),
            _ESIZE[n.dtype] if n is not None else 0,
            ctypes.c_void_p(doc_base.data_ptr()), W, _stream(device))
    if rc != 0:
        raise RuntimeError(f"resident_widen launch failed: CUDA error {rc}")
    widen_resident.launches += 1
    return widened


widen_resident.launches = 0


def reset_launches() -> None:
    """Set both launch counts to 0 (before the run they should count)."""
    splice_rows.launches = 0
    widen_resident.launches = 0
