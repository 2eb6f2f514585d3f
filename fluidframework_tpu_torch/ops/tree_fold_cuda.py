"""The SharedTree edit-fold kernel for Hopper and its wrappers.

``fold(state, edits)`` applies every document's edit rows to its forest
and returns the final ``TreeState``; ``fold_digest(state, edits, n_nodes,
n_cont)`` does the same and also returns the ``[D, 2]`` int32 forest
digest of tier 0:

- on CPU tensors they are the plain versions,
  ``tree_kernel.tree_fold_reference`` and
  ``tree_pipeline.tree_doc_digests``;
- on CUDA tensors they launch the hand-written kernel in
  ``csrc/tree_fold.cu`` on the current stream, or raise.  There is no
  fall back to a plain version or to the CPU on the card.

The kernel replaces the reference's XLA-traced device code K5
(``fluidframework_tpu/ops/tree_kernel.py`` ``_apply_edit`` under
``replay_vmapped``, and ``tree_pipeline.tree_doc_digests``).  One warp
folds one document; ``placement(N, C)`` says where its forest lives: in
shared memory when it fits a block, else in its slice of the output
planes in device memory.  Neither raises for size.  The source's header
note says what bounds it on the card and what the design does about that.

``fold.launches`` / ``fold_digest.launches`` count each entry's launches
(and nothing else), ``.placements`` splits them by placement, and
``reset_launches()`` zeroes them.
"""

from __future__ import annotations

import ctypes

import torch

from .tree_kernel import CONT_FIELDS, TreeEdits, TreeState, \
    tree_fold_reference

#: shared memory one thread block can address on Hopper (bytes)
SMEM_LIMIT = 232448
#: documents (warps) a block, at most
MAX_DOCS_PER_BLOCK = 4
#: the C entry's pointers: state in (10), edits (8), state out (10),
#: n_nodes, n_cont, digest
_N_PTRS = 2 * len(TreeState._fields) + len(TreeEdits._fields) + 3
_lib = None


def _library() -> ctypes.CDLL:
    global _lib
    if _lib is None:
        from ._cuda_build import load

        lib = load("tree_fold")
        lib.tree_fold.restype = ctypes.c_int
        lib.tree_fold.argtypes = [
            ctypes.POINTER(ctypes.c_void_p), ctypes.c_int, ctypes.c_int,
            ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
            ctypes.c_void_p]
        _lib = lib
    return _lib


def doc_bytes(N: int, C: int) -> int:
    """Bytes of one document's forest in the kernel's working set: 7
    node planes of N and 2 container planes of C int32 (the source's
    ``doc_words``)."""
    return 4 * (7 * N + 2 * C)


def placement(N: int, C: int) -> str:
    """``"smem"`` when a document's forest fits a block's shared memory,
    else ``"gmem"`` (its slice of the output planes)."""
    return "smem" if doc_bytes(N, C) <= SMEM_LIMIT else "gmem"


def docs_per_block(N: int, C: int, where: str) -> int:
    """Warps a block: up to ``MAX_DOCS_PER_BLOCK``, as many forests as
    fit a block's shared memory in the shared-memory placement."""
    if where == "gmem":
        return MAX_DOCS_PER_BLOCK
    return max(1, min(MAX_DOCS_PER_BLOCK, SMEM_LIMIT // doc_bytes(N, C)))


def _check(state: TreeState, edits: TreeEdits, device: torch.device):
    """Device, dtype, shape and contiguity of every plane the kernel
    reads; returns ``(D, N, C, T)``."""
    D, N = state.next.shape
    C = state.head.shape[1]
    T = edits.kind.shape[1]
    for kind, tup in (("state", state), ("edits", edits)):
        for name, x in tup._asdict().items():
            where = f"{kind}.{name}"
            want = (D,) if name == "overflow" else \
                (D, C) if kind == "state" and name in CONT_FIELDS else \
                (D, N) if kind == "state" else (D, T)
            dtype = torch.bool if name == "overflow" else torch.int32
            if x.device != device:
                raise ValueError(f"{where} lies on {x.device}, not {device}")
            if x.dtype != dtype:
                raise ValueError(f"{where} is {x.dtype}, expected {dtype}")
            if tuple(x.shape) != want:
                raise ValueError(f"{where} has shape {tuple(x.shape)}, "
                                 f"expected {want}")
            if not x.is_contiguous():
                raise ValueError(f"{where} is not contiguous")
    return D, N, C, T


def _check_counts(n_nodes, n_cont, D: int, device: torch.device) -> None:
    for name, x in (("n_nodes", n_nodes), ("n_cont", n_cont)):
        if x.device != device or x.dtype != torch.int32 \
                or tuple(x.shape) != (D,) or not x.is_contiguous():
            raise ValueError(f"{name} must be a contiguous int32 [{D}] "
                             f"tensor on {device}; got {x.dtype} "
                             f"{tuple(x.shape)} on {x.device}")


def _launch(state: TreeState, edits: TreeEdits, counts, entry):
    """Validate, allocate the outputs, launch in the placement
    ``placement(N, C)`` picks and count the launch on ``entry`` (a chunk
    of no documents launches nothing and counts nothing); returns
    ``(final, digest or None)``."""
    device = state.next.device
    D, N, C, T = _check(state, edits, device)
    if counts is not None:
        _check_counts(*counts, D, device)
    where = placement(N, C)
    out = TreeState(**{f: torch.empty_like(x)
                       for f, x in state._asdict().items()})
    dig = torch.empty((D, 2), dtype=torch.int32, device=device) \
        if counts is not None else None
    if D == 0:
        return out, dig
    tensors = list(state) + list(edits) + list(out) \
        + list(counts or (None, None)) + [dig]
    assert len(tensors) == _N_PTRS
    ptrs = (ctypes.c_void_p * _N_PTRS)(
        *[None if t is None else t.data_ptr() for t in tensors])
    lib = _library()
    with torch.cuda.device(device):
        rc = lib.tree_fold(
            ptrs, D, N, C, T, int(where == "gmem"),
            docs_per_block(N, C, where),
            ctypes.c_void_p(torch.cuda.current_stream(device).cuda_stream))
    if rc != 0:
        raise RuntimeError(f"tree_fold launch failed ({where}): CUDA error "
                           f"{rc}")
    entry.launches += 1
    entry.placements[where] += 1
    return out, dig


def _on(device: torch.device, entry: str) -> bool:
    """True for CUDA tensors, False for CPU ones; raises otherwise."""
    if device.type not in ("cpu", "cuda"):
        raise ValueError(f"{entry} runs on cpu or cuda tensors, not {device}")
    return device.type == "cuda"


def fold(state: TreeState, edits: TreeEdits) -> TreeState:
    """The final forest of every document (new tensors; the inputs are
    not written): the plain fold for CPU tensors, the kernel for CUDA
    tensors."""
    if not _on(state.next.device, "fold"):
        return tree_fold_reference(state, edits)
    out, _dig = _launch(state, edits, None, fold)
    return out


def fold_digest(state: TreeState, edits: TreeEdits, n_nodes: torch.Tensor,
                n_cont: torch.Tensor):
    """``(final forest, [D, 2] int32 digest)``: ``fold`` with the
    reference's ``tree_doc_digests`` of the final forest (``n_nodes`` /
    ``n_cont`` the int32 ``[D]`` used-row counts it masks by), fused
    into the kernel's epilogue on the card."""
    if not _on(state.next.device, "fold_digest"):
        from .tree_pipeline import tree_doc_digests

        final = tree_fold_reference(state, edits)
        return final, tree_doc_digests(final, n_nodes, n_cont)
    return _launch(state, edits, (n_nodes, n_cont), fold_digest)


def reset_launches() -> None:
    """Set every launch count to 0 (before the run they should count)."""
    for entry in (fold, fold_digest):
        entry.launches = 0
        entry.placements = {"smem": 0, "gmem": 0}


reset_launches()
