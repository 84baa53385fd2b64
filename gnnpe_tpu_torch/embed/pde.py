"""Path dominance embeddings and PGE path groups, re-exported from
gnnpe_tpu (host numpy gathers and folds over f64 VDE)."""

from gnnpe_tpu.embed.pde import (PathEmbeddings, gen_pde,
                                 gen_query_pde_table, path_groups)

__all__ = ["PathEmbeddings", "gen_pde", "gen_query_pde_table",
           "path_groups"]
