"""The SharedMap last-writer-wins reduction kernel for Hopper and its
wrapper.

``lww(inputs, num_docs)`` computes ``(present [G] bool, win_val [G]
int32)`` from the packed batch's seven int32 tensors
(``map_kernel.LWWInputs``):

- on CPU tensors it is the plain version, ``map_kernel.map_lww_reference``
  (``scatter_reduce_`` with ``"amax"``);
- on CUDA tensors it launches the hand-written kernel in
  ``csrc/map_lww.cu`` on the current stream, or raises.  There is no fall
  back to the plain version or to the CPU on the card.

The kernel replaces the reference's XLA-traced device code K7,
``fluidframework_tpu/ops/map_kernel.py`` (``_map_lww_kernel``): one
memset and two launches behind one C entry (a pass over the rows, each
warp grouping its rows by key and issuing three atomics a group, then
one thread a key).  The source's header note says what bounds it on the
card and what the design does about that.  ``lww.launches`` counts the
calls that launched it (a batch of no keys launches nothing and counts
nothing); ``reset_launches()`` zeroes it.
"""

from __future__ import annotations

import ctypes

import torch

from .map_kernel import LWWInputs, map_lww_reference

#: the C entry's threads a block and grid cap (``kThreads``,
#: ``kMaxBlocks``)
THREADS, MAX_BLOCKS = 256, 132 * 16
_lib = None


def bind(lib: ctypes.CDLL) -> ctypes.CDLL:
    """Declare the C entry's signature on a loaded build of
    ``csrc/map_lww.cu`` (or of another source with the same entry)."""
    lib.map_lww.restype = ctypes.c_int
    lib.map_lww.argtypes = [ctypes.POINTER(ctypes.c_void_p), ctypes.c_int,
                            ctypes.c_int, ctypes.c_int, ctypes.c_int,
                            ctypes.c_void_p]
    return lib


def _library() -> ctypes.CDLL:
    global _lib
    if _lib is None:
        from ._cuda_build import load

        _lib = bind(load("map_lww"))
    return _lib


def _check(inputs: LWWInputs, device: torch.device):
    """Device, dtype, rank, contiguity and matching lengths of the seven
    inputs; returns (N, G, M)."""
    N = inputs.key_gid.shape[0]
    G = inputs.key_doc.shape[0]
    M = inputs.clear_doc.shape[0]
    want = {"key_gid": N, "op_seq": N, "is_set": N, "val_idx": N,
            "key_doc": G, "clear_doc": M, "clear_seq": M}
    for name, x in inputs._asdict().items():
        if x.device != device:
            raise ValueError(f"{name} lies on {x.device}, not {device}")
        if x.dtype != torch.int32:
            raise ValueError(f"{name} is {x.dtype}, expected torch.int32")
        if tuple(x.shape) != (want[name],):
            raise ValueError(f"{name} has shape {tuple(x.shape)}, expected "
                             f"({want[name]},)")
        if not x.is_contiguous():
            raise ValueError(f"{name} is not contiguous")
    return N, G, M


def launch_shape(N: int, G: int, M: int, num_docs: int) -> dict:
    """The launches the C entry makes for a batch: the memset of its
    scratch (``scratch_bytes``), the row pass (``row_blocks`` over the
    ``max(N, M)`` rows) and the key pass (``key_blocks``), both of
    ``THREADS`` threads and no shared memory."""
    def blocks(n):
        return min(max(-(-n // THREADS), 1), MAX_BLOCKS)

    return {"threads_per_block": THREADS, "row_blocks": blocks(max(N, M)),
            "key_blocks": blocks(G), "smem_bytes": 0,
            "scratch_bytes": 20 * G + 4 * num_docs}


def lww(inputs: LWWInputs, num_docs: int, *, lib=None):
    """The LWW reduction: the plain version for CPU tensors, the CUDA
    kernel for CUDA tensors (same outputs, bit for bit).  ``lib`` (another
    build with the same C entry, ``bind`` it first) overrides the kernel's
    library, for measurements and tests."""
    device = inputs.key_gid.device
    if device.type == "cpu":
        return map_lww_reference(inputs, num_docs)
    if device.type != "cuda":
        raise ValueError(f"lww runs on cpu or cuda tensors, not {device}")
    N, G, M = _check(inputs, device)
    present = torch.empty((G,), dtype=torch.bool, device=device)
    win_val = torch.empty((G,), dtype=torch.int32, device=device)
    if G == 0:
        return present, win_val
    if num_docs < 1:
        raise ValueError(f"{G} keys need at least one document, got "
                         f"num_docs={num_docs}")
    # the C entry's three scratch parts, back to back (one memset): two
    # [G] 64-bit words and [G + num_docs] 32-bit words
    scratch = torch.empty((5 * G + num_docs,), dtype=torch.int32,
                          device=device)
    parts = [scratch[:2 * G], scratch[2 * G:4 * G], scratch[4 * G:]]
    tensors = list(inputs) + parts + [win_val, present]
    ptrs = (ctypes.c_void_p * len(tensors))(*[t.data_ptr() for t in tensors])
    lib = lib or _library()
    with torch.cuda.device(device):
        rc = lib.map_lww(ptrs, N, G, M, int(num_docs), ctypes.c_void_p(
            torch.cuda.current_stream(device).cuda_stream))
    if rc != 0:
        raise RuntimeError(f"map_lww launch failed: CUDA error {rc}")
    lww.launches += 1
    return present, win_val


lww.launches = 0


def reset_launches() -> None:
    """Set the launch count to 0 (before the run it should count)."""
    lww.launches = 0
