"""The SharedMatrix resolving axis fold (K4) for Hopper and its wrapper.

``fold_resolving(state, ops, cold=False, S=None)`` folds every axis stream
of a packed matrix batch and reads each ``K_RESOLVE`` row's handle on the
state before it, as ``matrix_kernel.replay_scan_resolving`` does:

- on CPU tensors it checks the matrix stream's facts on the host (raising
  ``ValueError`` on a violated one) and runs that plain version;
- on CUDA tensors it launches the hand-written kernel in
  ``csrc/matrix_fold.cu`` on the current stream, or raises.  There is no
  fall back to a plain version, to the CPU or to another build.

The kernel replaces the reference's XLA-traced K4
(``fluidframework_tpu/ops/matrix_kernel.py``, ``replay_scan_resolving``
with ``_resolve_handle``).  It holds the facts every stream
``pack_matrix_batch`` makes satisfies, the reference's ``has_ob=False``:
rows of kinds 0, 1, 2 and 5 only, every ``pvals`` entry
``PROP_NOT_TOUCHED`` (K = 1), the four obliterate planes at their fill on
every live slot.  It never reads or writes an obliterate plane: the
result's are the input's (a cold batch's, their fill as broadcast views).
It counts each stream's violated facts into the ``[D]`` int32
``violations`` it returns with the result; ``check_facts`` raises on a
non-zero count (``replay_matrix_batch`` does, on the copy it downloads),
since such a stream's result is not the fold's.  ``cold=True`` (no
document had a base summary: every plane its pack fill, ``n = 0``) reads
no state at all: ``state`` may then be None, with ``S`` the slot count.

``placement(S)`` says where a stream's working area lives (shared memory
when it fits a block, else device memory); ``launch_shape(S)`` and
``occupancy(S)`` report the launch.  ``fold_resolving.launches`` counts
the launches (and nothing else) and ``.placements`` splits them by
placement; ``reset_launches()`` zeroes them.
"""

from __future__ import annotations

import ctypes

import torch

from .fold_cuda import _check_rows, _check_tensors, _launch_stream
from .matrix_kernel import (
    K_RESOLVE,
    MATRIX_OB_FILL,
    matrix_fill_state,
    replay_scan_resolving,
)
from .mergetree_kernel import (
    EXPORT_SLOT_FIELDS,
    K_INSERT,
    K_REMOVE,
    PROP_NOT_TOUCHED,
    MTOps,
    MTState,
)

#: the slot planes the kernel reads and writes, in its order (then props)
FOLD_FIELDS = EXPORT_SLOT_FIELDS[:8]
#: the obliterate planes, never read or written by it
OB_FIELDS = EXPORT_SLOT_FIELDS[8:]
#: the op fields it reads (``min_seq`` drives only the obliterate expiry)
OP_READ = ("kind", "seq", "client", "ref_seq", "a", "b", "tstart", "tlen",
           "pvals")
#: the row kinds of a matrix stream: padding, insert, remove, resolve
MATRIX_KINDS = (0, K_INSERT, K_REMOVE, K_RESOLVE)
_N_PTRS = len(OP_READ) + 2 * (len(FOLD_FIELDS) + 3) + len(OB_FIELDS) + 3
_MODES = ("warp", "block", "block")
_lib = None


def bind(lib: ctypes.CDLL) -> ctypes.CDLL:
    """Declare the C entries' signatures on a loaded build of
    ``csrc/matrix_fold.cu``; returns ``lib``."""
    lib.matrix_fold_resolve.restype = ctypes.c_int
    lib.matrix_fold_resolve.argtypes = [
        ctypes.POINTER(ctypes.c_void_p), ctypes.POINTER(ctypes.c_int),
        ctypes.c_void_p]
    lib.matrix_fold_launch_shape.restype = ctypes.c_int
    lib.matrix_fold_launch_shape.argtypes = [ctypes.c_int,
                                             ctypes.POINTER(ctypes.c_int)]
    lib.matrix_fold_area_bytes.restype = ctypes.c_longlong
    lib.matrix_fold_area_bytes.argtypes = [ctypes.c_int]
    return lib


def _library() -> ctypes.CDLL:
    global _lib
    if _lib is None:
        from ._cuda_build import load

        _lib = bind(load("matrix_fold"))
    return _lib


def launch_shape(S: int, lib: ctypes.CDLL = None) -> dict:
    """The launch the kernel takes at S slots on the current card: the
    team that folds a stream (a warp, or the block), threads and streams a
    block, blocks per SM as ``cudaOccupancyMaxActiveBlocksPerMultiprocessor``
    reports them, dynamic shared memory a block, and the placement."""
    lib = lib or _library()
    out = (ctypes.c_int * 5)()
    rc = lib.matrix_fold_launch_shape(int(S), out)
    if rc != 0:
        raise RuntimeError(f"matrix_fold launch shape at S={S}: CUDA error "
                           f"{rc}")
    mode, threads, streams, blocks, smem = list(out)
    return {"S": int(S), "team": _MODES[mode], "threads": threads,
            "streams_per_block": streams, "blocks_per_sm": blocks,
            "smem_bytes": smem, "placement": "gmem" if mode == 2 else "smem"}


def placement(S: int, lib: ctypes.CDLL = None) -> str:
    """``"smem"`` when a stream of S slots folds in shared memory, else
    ``"gmem"`` (its slice of a device-memory scratch buffer)."""
    return launch_shape(S, lib)["placement"]


def occupancy(S: int, lib: ctypes.CDLL = None) -> dict:
    """``launch_shape`` with the streams and warps resident on an SM."""
    shape = launch_shape(S, lib)
    shape["streams_per_sm"] = shape["blocks_per_sm"] \
        * shape["streams_per_block"]
    shape["warps_per_sm"] = shape["blocks_per_sm"] * shape["threads"] // 32
    return shape


def fact_violations(state, ops: MTOps, cold: bool = False) -> list:
    """The matrix stream's facts that ``state`` / ``ops`` break, as
    messages (empty when they hold): a row kind outside 0, 1, 2, 5; a
    ``pvals`` entry other than ``PROP_NOT_TOUCHED`` or a K other than 1;
    an obliterate plane off its fill on a live slot (warm only)."""
    bad = []
    kind = ops.kind
    off = ~torch.isin(kind, torch.tensor(MATRIX_KINDS, dtype=kind.dtype,
                                         device=kind.device))
    if off.any():
        d, t = (int(i) for i in off.nonzero()[0])
        bad.append(f"stream {d} row {t} has kind {int(kind[d, t])} "
                   f"(a matrix stream has kinds {MATRIX_KINDS})")
    if ops.pvals.ndim != 3 or ops.pvals.shape[2] != 1:
        bad.append(f"pvals has shape {tuple(ops.pvals.shape)}; a matrix "
                   f"stream has K = 1")
    elif (ops.pvals != PROP_NOT_TOUCHED).any():
        d, t, _k = (int(i) for i in (ops.pvals != PROP_NOT_TOUCHED)
                    .nonzero()[0])
        bad.append(f"stream {d} row {t} touches props (pvals "
                   f"{int(ops.pvals[d, t, 0])})")
    if not cold:
        S = state.tstart.shape[1]
        live = torch.arange(S, device=kind.device)[None, :] \
            < state.n.to(torch.int64)[:, None]
        for f in OB_FIELDS:
            wrong = live & (getattr(state, f) != MATRIX_OB_FILL[f])
            if wrong.any():
                d, s = (int(i) for i in wrong.nonzero()[0])
                bad.append(f"stream {d} slot {s} has {f} "
                           f"{int(getattr(state, f)[d, s])} (an obliterate "
                           f"stamp)")
    return bad


def check_facts(violations) -> None:
    """Raise ``ValueError`` when the kernel counted a violated fact on any
    stream (``violations``: the ``[D]`` counts it returned, as a tensor or
    a numpy array; a CUDA tensor is copied to the host)."""
    if isinstance(violations, torch.Tensor):
        violations = violations.cpu().numpy()
    bad = violations.nonzero()[0]
    if len(bad):
        raise ValueError(
            f"the matrix fold's facts do not hold on {len(bad)} streams "
            f"(first {bad[:8].tolist()}): a row of another kind than 0, 1, "
            f"2, 5, a props write or an obliterate stamp; its result is not "
            f"the fold's")


def fold_resolving(state, ops: MTOps, cold: bool = False, S: int = None,
                   lib: ctypes.CDLL = None):
    """The SharedMatrix axis fold: ``(MTState, resolved [D, T] int32,
    violations [D] int32)``.  A ``K_RESOLVE`` row reads the handle at its
    position in its view on the state before it; every other row gives -1.
    ``cold``: fold from the pack's fill state (``state`` unread, may be
    None; ``S`` slots, else ``state``'s).  CPU tensors take the host fact
    check and the plain ``replay_scan_resolving``; CUDA tensors the kernel
    (whose caller checks ``violations`` with ``check_facts``).  ``lib`` is
    the kernel's library unless another build of the source is given
    (``bind`` it first)."""
    device = ops.kind.device
    D, T = ops.kind.shape
    if cold:
        S = state.tstart.shape[1] if state is not None else int(S)
    else:
        S = state.tstart.shape[1]
    if device.type == "cpu":
        bad = fact_violations(state, ops, cold)
        if bad:
            raise ValueError("the matrix fold's facts do not hold: "
                             + "; ".join(bad))
        final, resolved = replay_scan_resolving(state, ops, cold=cold, S=S)
        return final, resolved, torch.zeros(D, dtype=torch.int32)
    if device.type != "cuda":
        raise ValueError(
            f"fold_resolving runs on cpu or cuda tensors, not {device}")
    _check_rows(S, T)
    int32 = {f: torch.int32 for f in MTOps._fields}
    want_ops = {f: (D, T) for f in MTOps._fields}
    want_ops["pvals"] = (D, T, 1)
    _check_tensors("ops", ops, want_ops, int32, device)
    if not cold:
        want_state = {f: (D, S) for f in EXPORT_SLOT_FIELDS}
        want_state.update(props=(D, S, 1), n=(D,), overflow=(D,))
        _check_tensors("state", state, want_state,
                       dict({f: torch.int32 for f in MTState._fields},
                            overflow=torch.bool), device)
    lib = lib or _library()
    shape = launch_shape(S, lib)
    where = shape["placement"]

    def planes(shape_):
        return torch.empty(shape_, dtype=torch.int32, device=device)

    out = {f: planes((D, S)) for f in FOLD_FIELDS}
    out.update(props=planes((D, S, 1)), n=planes((D,)),
               overflow=torch.empty((D,), dtype=torch.bool, device=device))
    if cold:
        fill = matrix_fill_state(1, 1, device)
        out.update({f: getattr(fill, f).expand(D, S) for f in OB_FIELDS})
    else:
        out.update({f: getattr(state, f) for f in OB_FIELDS})
    final = MTState(**out)
    resolved, violations = planes((D, T)), planes((D,))
    if D == 0:
        return final, resolved, violations
    scratch = planes((D, int(lib.matrix_fold_area_bytes(S)) // 4)) \
        if where == "gmem" else None
    tensors = [getattr(ops, f) for f in OP_READ]
    ins = FOLD_FIELDS + ("props", "n", "overflow")
    tensors += [None] * (len(ins) + len(OB_FIELDS)) if cold else \
        [getattr(state, f) for f in ins + OB_FIELDS]
    tensors += [out[f] for f in ins] + [resolved, violations, scratch]
    assert len(tensors) == _N_PTRS
    ptrs = (ctypes.c_void_p * _N_PTRS)(
        *[None if x is None else x.data_ptr() for x in tensors])
    iargs = (ctypes.c_int * 4)(D, S, T, int(bool(cold)))
    with torch.cuda.device(device):
        rc = lib.matrix_fold_resolve(ptrs, iargs, _launch_stream(device))
    if rc != 0:
        raise RuntimeError(f"matrix_fold launch failed ({where}): CUDA "
                           f"error {rc}")
    fold_resolving.launches += 1
    fold_resolving.placements[where] += 1
    return final, resolved, violations


fold_resolving.launches = 0
fold_resolving.placements = {"smem": 0, "gmem": 0}


def reset_launches() -> None:
    """Set the launch counts to 0 (before the run they should count)."""
    fold_resolving.launches = 0
    fold_resolving.placements = {"smem": 0, "gmem": 0}
