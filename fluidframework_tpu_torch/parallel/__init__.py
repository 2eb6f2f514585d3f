"""Device-list parallelism: document sharding over GPUs.

The port of ``fluidframework_tpu/parallel``.  Catch-up replay is
document-parallel, so a batch's document axis splits over an ordered
device list (:func:`doc_mesh`, every visible card by default) and each
part folds on its own device with no communication during the fold; the
host reassembles the parts in order.  :func:`dcn_mesh` keeps the
reference's two-level ``(slice, docs)`` grid and its validation.  The
``*_sharded_replay_step`` names are the port's per-part step functions.
"""

from .shard import (
    DocMesh,
    dcn_mesh,
    doc_mesh,
    map_sharded_replay_step,
    matrix_sharded_replay_step,
    replay_map_sharded,
    replay_matrix_sharded,
    replay_mergetree_sharded,
    replay_tree_sharded,
    tree_sharded_replay_step,
)

__all__ = [
    "DocMesh",
    "dcn_mesh",
    "doc_mesh",
    "map_sharded_replay_step",
    "matrix_sharded_replay_step",
    "replay_map_sharded",
    "replay_matrix_sharded",
    "replay_mergetree_sharded",
    "replay_tree_sharded",
    "tree_sharded_replay_step",
]
