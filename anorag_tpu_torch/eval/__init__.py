from anorag_tpu_torch.eval.evaluator import EnhancedEvaluator
from anorag_tpu_torch.eval.musique import (
    convert_to_official_format, evaluate_dataset, evaluate_item, extract_dev_subset,
)

__all__ = ["EnhancedEvaluator", "convert_to_official_format",
           "evaluate_dataset", "evaluate_item", "extract_dev_subset"]
