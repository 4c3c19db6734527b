"""Multi-device paths of the port: the row-partitioned hierarchy over torch.distributed."""
