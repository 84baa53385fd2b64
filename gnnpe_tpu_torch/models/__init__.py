from gnnpe_tpu_torch.models.gnn import PathGNN, dominance_loss

__all__ = ["PathGNN", "dominance_loss"]
