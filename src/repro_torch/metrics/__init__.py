from repro_torch.metrics.auc import StreamingAUC, auc

__all__ = ["StreamingAUC", "auc"]
