from .metrics import dice_coefficient, jaccard, metric_percase, metric_percase_hd95

__all__ = ["dice_coefficient", "jaccard", "metric_percase", "metric_percase_hd95"]
