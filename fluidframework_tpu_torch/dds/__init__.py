"""CPU oracles (copies of the JAX package's merge-tree, interval, shared-
object and SharedTree modules): the byte-identity judges and the fallback
path for documents the device folds do not take."""
