"""Label-seeded feature table, re-exported from gnnpe_tpu (host numpy,
bit-exact with the reference's std::mt19937 features)."""

from gnnpe_tpu.ops.mt19937 import label_feature_table

__all__ = ["label_feature_table"]
