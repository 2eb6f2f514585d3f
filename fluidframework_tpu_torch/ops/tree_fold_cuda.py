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
folds one document, one document a block; ``placement(N, C)`` says where
its forest lives: in shared memory when its working set fits a block
(``smem_layout``: with the walk table and a 64-row edit tile, or in the
lean layout without the table and with a smaller tile), else in its slice
of the output planes in device memory.  Neither raises for size.  The source's header note says what bounds it on the card and
what the design does about that.  ``earlier_library()`` loads the earlier
design (``csrc/tree_fold_earlier.cu``), the yardstick the kernel is timed
against; no entry point launches it.

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
#: edit rows a document stages in shared memory at a time (``kTile``)
EDIT_TILE = 64
#: the C entry's pointers: state in (10), edits (8), state out (10),
#: n_nodes, n_cont, digest
_N_PTRS = 2 * len(TreeState._fields) + len(TreeEdits._fields) + 3
_lib = None
_earlier = None


def bind(lib: ctypes.CDLL) -> ctypes.CDLL:
    """Declare the C entry's signature on a loaded build of
    ``csrc/tree_fold.cu`` (or of another source with the same
    ``tree_fold`` entry)."""
    lib.tree_fold.restype = ctypes.c_int
    lib.tree_fold.argtypes = [
        ctypes.POINTER(ctypes.c_void_p), ctypes.c_int, ctypes.c_int,
        ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
        ctypes.c_void_p]
    return lib


def _library() -> ctypes.CDLL:
    global _lib
    if _lib is None:
        from ._cuda_build import load

        _lib = bind(load("tree_fold"))
    return _lib


class EarlierLaunch:
    """A build of the earlier design (``csrc/tree_fold_earlier.cu``, or
    another source with its launch rule) behind the C entry ``fold``
    calls: it launches the way its own wrapper did, the forest alone in
    shared memory when it fits a block and as many forests a block as fit,
    at most 4, in place of the placement and the one document a block
    ``fold`` passes.  Give it to ``fold`` / ``fold_digest`` as ``lib``."""

    def __init__(self, lib: ctypes.CDLL):
        self.lib = lib

    def tree_fold(self, ptrs, D, N, C, T, gmem, docs_per_block, stream):
        forest = 4 * (7 * N + 2 * C)
        fits = forest <= SMEM_LIMIT
        per_block = max(1, min(4, SMEM_LIMIT // forest)) if fits else 4
        return self.lib.tree_fold(ptrs, D, N, C, T, int(not fits),
                                  per_block, stream)


def earlier_library() -> EarlierLaunch:
    """The earlier design of the kernel, built from
    ``csrc/tree_fold_earlier.cu`` at first use and launched by its own
    rule: the yardstick for measurements, never an entry point's."""
    global _earlier
    if _earlier is None:
        from ._cuda_build import load

        _earlier = EarlierLaunch(bind(load("tree_fold_earlier")))
    return _earlier


def doc_bytes(N: int, C: int, where: str = "smem", tile: int = EDIT_TILE,
              table: bool = True) -> int:
    """Shared memory one document takes (the source's ``doc_words``): the
    mbarrier (16 B), the raw edit tile (8 planes of ``tile`` int32) and
    the decoded rows (``tile + 1`` of 16 int32); in the shared-memory
    placement also its forest (7 node planes of N and 2 container planes
    of C int32, rounded up to an even count) and, with ``table``, the
    walk table (N + 2 entries of two int32).  Rounded up to 16 bytes."""
    words = 4 + 8 * tile + 16 * (tile + 1)
    if where == "smem":
        words += (7 * N + 2 * C + 1) // 2 * 2 + (2 * (N + 2) if table else 0)
    return 4 * ((words + 3) // 4 * 4)


def smem_layout(N: int, C: int):
    """``(tile, table)`` of the shared-memory placement (the source's
    ``smem_layout``): ``EDIT_TILE`` rows and the walk table when both fit
    a block beside the forest; else the lean layout, no walk table and the
    most rows, a multiple of 4, that fit; None when none does."""
    if doc_bytes(N, C) <= SMEM_LIMIT:
        return EDIT_TILE, True
    for tile in range(EDIT_TILE, 0, -4):
        if doc_bytes(N, C, "smem", tile, False) <= SMEM_LIMIT:
            return tile, False
    return None


def placement(N: int, C: int) -> str:
    """``"smem"`` when a document's working set fits a block's shared
    memory in either layout, else ``"gmem"`` (its forest in its slice of
    the output planes)."""
    return "smem" if smem_layout(N, C) else "gmem"


def launch_shape(D: int, N: int, C: int) -> dict:
    """The launch ``fold`` / ``fold_digest`` make for ``D`` documents:
    one block of one warp a document, the placement and layout
    ``smem_layout`` picks (``edit_tile`` rows staged at a time, the walk
    table or not) and ``doc_bytes`` of shared memory a block."""
    layout = smem_layout(N, C)
    where = "smem" if layout else "gmem"
    tile, table = layout or (EDIT_TILE, False)
    return {"placement": where, "docs_per_block": 1, "blocks": D,
            "threads_per_block": 32, "edit_tile": tile, "walk_table": table,
            "smem_bytes": doc_bytes(N, C, where, tile, table)}


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


def _launch(state: TreeState, edits: TreeEdits, counts, entry, lib=None):
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
    lib = lib or _library()
    with torch.cuda.device(device):
        rc = lib.tree_fold(
            ptrs, D, N, C, T, int(where == "gmem"), 1,
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


def fold(state: TreeState, edits: TreeEdits, *, lib=None) -> TreeState:
    """The final forest of every document (new tensors; the inputs are
    not written): the plain fold for CPU tensors, the kernel for CUDA
    tensors.  ``lib`` (another build with the same C entry, ``bind`` it
    first, or ``earlier_library()``) overrides the kernel's library, for
    measurements and tests."""
    if not _on(state.next.device, "fold"):
        return tree_fold_reference(state, edits)
    out, _dig = _launch(state, edits, None, fold, lib)
    return out


def fold_digest(state: TreeState, edits: TreeEdits, n_nodes: torch.Tensor,
                n_cont: torch.Tensor, *, lib=None):
    """``(final forest, [D, 2] int32 digest)``: ``fold`` with the
    reference's ``tree_doc_digests`` of the final forest (``n_nodes`` /
    ``n_cont`` the int32 ``[D]`` used-row counts it masks by), fused
    into the kernel's epilogue on the card; ``lib`` as for ``fold``."""
    if not _on(state.next.device, "fold_digest"):
        from .tree_pipeline import tree_doc_digests

        final = tree_fold_reference(state, edits)
        return final, tree_doc_digests(final, n_nodes, n_cont)
    return _launch(state, edits, (n_nodes, n_cont), fold_digest, lib)


def reset_launches() -> None:
    """Set every launch count to 0 (before the run they should count)."""
    for entry in (fold, fold_digest):
        entry.launches = 0
        entry.placements = {"smem": 0, "gmem": 0}


reset_launches()
