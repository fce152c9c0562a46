from .metrics import dice_coefficient, jaccard, metric_percase

__all__ = ["dice_coefficient", "jaccard", "metric_percase"]
