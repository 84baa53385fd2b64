"""Graph partitioning helpers, re-exported from gnnpe_tpu (host numpy).

The single-GPU port does not partition: partitions only shard work and
the candidate union does not depend on them.  ``partition_graph`` and
``write_membership`` serve the CLI's ``prepare`` mode."""

from gnnpe_tpu.graph.partition import (degree_sorted_nodes, partition_graph,
                                       write_membership)

__all__ = ["degree_sorted_nodes", "partition_graph", "write_membership"]
