"""The multi-device layer on ``torch.distributed``: one process per
rank, the mesh a ``DeviceMesh`` whose axes are process groups, every
sharded class built on every rank with the same arguments and holding
its own shard only (counterpart of gnnpe_tpu/parallel/)."""
