"""The multi-device layer (PyTorch port of speedyml/parallel/) on
torch.distributed.

The JAX package runs one controller over a device mesh: NamedShardings, one
shard_map, and the all-gathers XLA inserts. Here every rank is a process of
its own (`launch.run_ranks`, or torchrun), a `DeviceMesh` supplies the
process groups (`mesh.Mesh`), and every collective is written out and
counted (`comm.Communicator`: all_reduce and all_gather only):

  * mesh: the (dp, tp) mesh of the batched reservoirs, placements of whole
    tensors and the shard/gather pair over them;
  * reservoir: the reservoir predict step and training drive with regions
    over dp and nodes over tp;
  * spatial: the latitude-sharded dycore and physics step;
  * composed: the whole hybrid step over one mesh axis;
  * dryrun: the six-phase multi-device dry run.
"""
