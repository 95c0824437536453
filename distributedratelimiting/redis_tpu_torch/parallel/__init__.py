"""Key-sharded scale-out: the mesh, key-sharded tables, the global tier.

The JAX package's ``parallel/`` on PyTorch. Bucket and window state shard
along the key axis of a mesh of shards (keys never interact, so the hot
path needs no cross-shard traffic), and the one cross-shard computation is
the two-level approximate algorithm's global tier: the consumed counts of
every shard, summed and folded into one replicated decaying counter.

The mesh is one process over an ordered list of devices, one per shard, as
JAX's single controller drives every device of its ``Mesh``. A device may
repeat: every shard of a mesh on one card lives in one shard-major table
there, each batch of all shards is one decision launch, and the global tier
is one kernel over that launch's results (``csrc/mesh.cu``) where JAX runs
a ``lax.psum``. A mesh over several distinct cards raises ``ValueError``
(``mesh.py``).
"""
