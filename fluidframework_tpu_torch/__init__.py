"""fluidframework_tpu_torch — the PyTorch/CUDA port of ``fluidframework_tpu``.

The JAX package beside it stays the reference; this package re-expresses
its catch-up replay path in PyTorch for an NVIDIA H100, one slice at a
time (ROADMAP.md).  It imports ``torch``, numpy and the standard library,
never ``jax`` and nothing of ``fluidframework_tpu``: the host modules it
needs are kept here as copies.

Layout:

- ``protocol/``, ``utils/``, ``dds/``, ``runtime/`` — copies of the op
  model, the canonical summary tree, the SharedString and SharedTree CPU
  oracles and the op attributor (fallback documents and byte-identity
  checks);
- ``ops/`` — packing (``native_pack`` with ``csrc/oppack.cpp``), the
  merge-tree fold and export (``mergetree_kernel``), the hand-written
  Hopper fold kernel (``fold_cuda`` with ``csrc/mergetree_fold.cu``), the
  pipeline and its cache tiers (``pipeline``, ``device_cache``, with the
  resident kernels ``resident_cuda`` / ``csrc/resident.cu``), and the
  SharedTree family (``tree_kernel``, ``tree_pipeline``, with the
  edit-fold kernel ``tree_fold_cuda`` / ``csrc/tree_fold.cu``);
- ``convert`` — carries the JAX package's packed arrays and doc inputs
  across by attribute name;
- ``testing/`` — the pinned synthetic workloads (SharedString and
  SharedTree) and the hard-semantics fixture that ``chip_smoke.py``
  drives.

Entry points run on the card (``device="cuda"``) unless the caller passes
``device="cpu"``; without a CUDA device a call that names none raises.
"""
