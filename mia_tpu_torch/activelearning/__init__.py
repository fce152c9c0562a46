from .selection import kcenter_greedy, kmeans_plusplus
from .scorers import (
    ModelScorer,
    confidence_score,
    entropy_score,
    margin_score,
    sweep_pool,
)
from .selectors import (
    SELECTORS,
    ActiveSelector,
    BADGESelector,
    ConfidenceSelector,
    CoresetSelector,
    EntropySelector,
    KMeanSelector,
    MarginSelector,
    RandomSelector,
)

__all__ = [
    "kcenter_greedy",
    "kmeans_plusplus",
    "ModelScorer",
    "entropy_score",
    "confidence_score",
    "margin_score",
    "sweep_pool",
    "SELECTORS",
    "ActiveSelector",
    "RandomSelector",
    "EntropySelector",
    "ConfidenceSelector",
    "MarginSelector",
    "CoresetSelector",
    "KMeanSelector",
    "BADGESelector",
]
