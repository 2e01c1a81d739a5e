"""Tensor parallelism and multi-host serving over `torch.distributed`
(the port of the JAX package's `parallel/`).

The JAX package runs one controller over a GSPMD mesh: `sharding.py`
gives every leaf a PartitionSpec and XLA inserts the collectives. The port
runs one process per card instead, as the reference does (reference:
server/.../utils/dist.py:70-96, utils/layers.py:215-357):

  comm.py       the rank's process group and its three collectives
                (all-reduce sum, all-gather on the last dim, broadcast)
  sharding.py   the JAX package's sharding rules, cutting the full params
                into rank r's shard, and the rank's layout (`TPShard`)
                that the layer code reads to place its collectives
  multihost.py  rank 0 serves and publishes every engine op over the
                group; the other ranks replay them (`follower_loop`)
  launch.py     one process per card: the ranks' env contract, their
                process groups, and `serve`'s spawn
"""
