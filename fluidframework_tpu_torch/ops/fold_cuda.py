"""The merge-tree fold kernel for Hopper and its wrapper.

``fold(state, ops)`` folds every document's op tail into its state:

- on CPU tensors it is the plain fold, ``mergetree_kernel.fold_reference``;
- on CUDA tensors it launches the hand-written kernel in
  ``csrc/mergetree_fold.cu`` on the current stream, or raises.  There is
  no fall back to the plain fold on the card.

The kernel replaces the TPU kernel ``fluidframework_tpu/ops/pallas_fold.py``
(``_fold_kernel``, entry ``replay_vmapped_pallas``).  One warp folds one
document with one copy of its state in shared memory, several documents
to a block (derived from S and K at launch), and the rows move between
device and shared memory as bulk asynchronous copies; so every row of a
document (a plane ``[S]``, ``props [S, K]``, an op field ``[T]``,
``pvals [T, K]``) must be a multiple of 16 bytes, and ``_check`` refuses
shapes whose rows are not.  The source's header note says what bounds it
on the card and what the design does about that.  ``fold.launches``
counts the kernel's launches (and nothing else), so a run can show that
the main path went through it; ``occupancy(S, K)`` reports the launch
the kernel takes.
"""

from __future__ import annotations

import ctypes

import torch

from .mergetree_kernel import (
    EXPORT_SLOT_FIELDS,
    OP_FIELDS,
    MTOps,
    MTState,
    fold_reference,
)

#: shared memory one thread block can address on Hopper (bytes)
SMEM_LIMIT = 232448
#: bulk copies move whole rows of 16-byte multiples, from 16-byte addresses
_ROW_ALIGN = 16
_N_PTRS = len(OP_FIELDS) + 1 + 2 * (len(EXPORT_SLOT_FIELDS) + 3)
_lib = None


def bind(lib: ctypes.CDLL) -> ctypes.CDLL:
    """Declare the signatures of the fold library's two launch-side C
    entries, ``mergetree_fold`` and ``mergetree_fold_smem_bytes``, on a
    loaded build of ``csrc/mergetree_fold.cu``; returns ``lib``."""
    lib.mergetree_fold.restype = ctypes.c_int
    lib.mergetree_fold.argtypes = [
        ctypes.POINTER(ctypes.c_void_p), ctypes.c_int, ctypes.c_int,
        ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
    lib.mergetree_fold_smem_bytes.restype = ctypes.c_longlong
    lib.mergetree_fold_smem_bytes.argtypes = [ctypes.c_int, ctypes.c_int]
    return lib


def _library():
    global _lib
    if _lib is None:
        from ._cuda_build import load

        _lib = bind(load("mergetree_fold"))
    return _lib


def occupancy(S: int, K: int, lib: ctypes.CDLL = None) -> dict:
    """The launch the kernel takes at (S, K) on the current card:
    documents (warps) per block, and blocks and documents per SM as
    ``cudaOccupancyMaxActiveBlocksPerMultiprocessor`` reports them.
    ``lib`` is the kernel's library unless another build is given."""
    lib = lib or _library()
    query = lib.mergetree_fold_occupancy
    query.restype = ctypes.c_int
    query.argtypes = [ctypes.c_int, ctypes.c_int,
                      ctypes.POINTER(ctypes.c_int)]
    per_block = ctypes.c_int(0)
    blocks = int(query(S, K, ctypes.byref(per_block)))
    if blocks < 0:
        raise RuntimeError(f"mergetree_fold occupancy: CUDA error {-blocks}")
    return {"S": S, "K": K, "docs_per_block": per_block.value,
            "blocks_per_sm": blocks,
            "docs_per_sm": blocks * per_block.value,
            "smem_bytes_per_doc": int(lib.mergetree_fold_smem_bytes(S, K))}


def _check(state: MTState, ops: MTOps, device: torch.device):
    """Validate what the kernel reads: device, dtype, shape, contiguity,
    and rows the bulk copies can move (16-byte multiples and addresses)."""
    D, S = state.tstart.shape
    K = state.props.shape[2]
    T = ops.kind.shape[1]
    for dim, size in (("S", S), ("T", T)):
        if size * 4 % _ROW_ALIGN:
            raise ValueError(
                f"{dim}={size}: a row of {size} int32 is not a multiple of "
                f"{_ROW_ALIGN} bytes, which the kernel's bulk copies need "
                f"(the packer's shapes always are)")
    want_state = {f: (D, S) for f in EXPORT_SLOT_FIELDS}
    want_state.update(props=(D, S, K), n=(D,), overflow=(D,))
    want_ops = {f: (D, T) for f in OP_FIELDS}
    want_ops["pvals"] = (D, T, K)
    for kind, tup, want in (("state", state, want_state),
                            ("ops", ops, want_ops)):
        for name, x in tup._asdict().items():
            dtype = torch.bool if name == "overflow" else torch.int32
            where = f"{kind}.{name}"
            if x.device != device:
                raise ValueError(f"{where} lies on {x.device}, not {device}")
            if x.dtype != dtype:
                raise ValueError(f"{where} is {x.dtype}, expected {dtype}")
            if tuple(x.shape) != want[name]:
                raise ValueError(f"{where} has shape {tuple(x.shape)}, "
                                 f"expected {want[name]}")
            if not x.is_contiguous():
                raise ValueError(f"{where} is not contiguous")
            if name not in ("n", "overflow") \
                    and x.data_ptr() % _ROW_ALIGN:
                raise ValueError(f"{where} does not start on a "
                                 f"{_ROW_ALIGN}-byte boundary")
    return D, S, T, K


def fold(state: MTState, ops: MTOps, lib: ctypes.CDLL = None) -> MTState:
    """Fold ``ops`` into ``state``: the plain fold for CPU tensors, the
    CUDA kernel for CUDA tensors (same ``MTState`` layout out).  ``lib``
    is the kernel's library unless another build of the same C interface
    is given (``bind`` it first), as a measurement compares builds."""
    device = state.tstart.device
    if device.type == "cpu":
        return fold_reference(state, ops)
    if device.type != "cuda":
        raise ValueError(f"fold runs on cpu or cuda tensors, not {device}")
    D, S, T, K = _check(state, ops, device)
    lib = lib or _library()
    need = int(lib.mergetree_fold_smem_bytes(S, K))  # per document
    if need > SMEM_LIMIT:
        raise ValueError(
            f"a document of S={S} slots and K={K} props keys needs {need} "
            f"bytes of shared memory; a Hopper block addresses at most "
            f"{SMEM_LIMIT}")
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
        stream = torch.cuda.current_stream(device).cuda_stream
        rc = lib.mergetree_fold(ptrs, D, S, T, K, ctypes.c_void_p(stream))
    if rc != 0:
        raise RuntimeError(f"mergetree_fold launch failed: CUDA error {rc}")
    fold.launches += 1
    return out


fold.launches = 0
