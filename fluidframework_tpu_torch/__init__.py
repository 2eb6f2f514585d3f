"""fluidframework_tpu_torch — the PyTorch/CUDA port of ``fluidframework_tpu``.

The JAX package beside it stays the reference; this package re-expresses
its catch-up replay path in PyTorch for an NVIDIA H100, one slice at a
time (ROADMAP.md).  It imports ``torch``, numpy and the standard library,
never ``jax`` and nothing of ``fluidframework_tpu``: the host modules it
needs are kept here as copies.

Layout:

- ``protocol/``, ``utils/``, ``dds/``, ``runtime/`` — copies of the op
  model, the sequencer, the canonical summary tree, the CPU oracles of
  every channel type, the container runtime and the op attributor
  (fallback documents, the service's CPU fold and byte-identity checks);
- ``service/`` — the catch-up service (``CatchupService``: one call
  routes every channel family to its entry on the card) with its cache
  tiers and the ordering service and op log it reads; the TCP ordering
  server (``server``, ``python -m fluidframework_tpu_torch.service.server``)
  whose ``catchup`` RPC and streaming fold (``streamfold``) run on the
  card, with the broadcaster, retry policy and host-side orderer shards;
- ``drivers/``, ``loader/`` — copies of the client side (the network
  driver, ``Loader`` / ``Container`` / ``DeltaManager``) that reaches
  the server over TCP;
- ``ops/`` — packing (``native_pack`` with ``csrc/oppack.cpp``), the
  merge-tree fold and export (``mergetree_kernel``), the hand-written
  Hopper fold kernel (``fold_cuda`` with ``csrc/mergetree_fold.cu``), the
  pipeline and its cache tiers (``pipeline``, ``device_cache``, with the
  resident kernels ``resident_cuda`` / ``csrc/resident.cu``), and the
  SharedTree family (``tree_kernel``, ``tree_pipeline``, with the
  edit-fold kernel ``tree_fold_cuda`` / ``csrc/tree_fold.cu``);
- ``convert`` — carries the JAX package's packed arrays and doc inputs
  across by attribute name, and a service's store and log as plain data;
- ``testing/`` — the pinned synthetic workloads (SharedString,
  SharedTree, the service corpora) and the hard-semantics fixtures that
  ``chip_smoke.py`` drives.

Entry points run on the card (``device="cuda"``) unless the caller passes
``device="cpu"``; without a CUDA device a call that names none raises.
"""
