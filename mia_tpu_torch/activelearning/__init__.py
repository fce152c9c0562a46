from .scorers import ModelScorer, entropy_score, sweep_pool
from .selectors import SELECTORS, ActiveSelector, EntropySelector, RandomSelector

__all__ = [
    "SELECTORS",
    "ActiveSelector",
    "EntropySelector",
    "ModelScorer",
    "RandomSelector",
    "entropy_score",
    "sweep_pool",
]
