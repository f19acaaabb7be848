"""Data parallelism (counterpart of faststyle_tpu/parallel/): the training
step over torch.distributed, batch-sharded (`data_parallel.ShardedStylizer`)
and row-sharded (`spatial.SpatialStylizer`) serving over a device list, and
the multi-device dry run (`dryrun`)."""
