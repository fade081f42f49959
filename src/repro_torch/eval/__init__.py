from repro_torch.eval.cv import FoldResult, cross_validate, kfold_masks, summarize
from repro_torch.eval.metrics import (
    auc_score,
    aupr_score,
    best_accuracy,
    evaluate_predictions,
)

__all__ = [
    "FoldResult",
    "auc_score",
    "aupr_score",
    "best_accuracy",
    "cross_validate",
    "evaluate_predictions",
    "kfold_masks",
    "summarize",
]
