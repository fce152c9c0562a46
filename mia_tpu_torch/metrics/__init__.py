from .hd_module import HD, cal_hd
from .metrics import (dice_coefficient, jaccard, metric_percase, metric_percase_hd95,
                      per_class_metrics)

__all__ = ["HD", "cal_hd", "dice_coefficient", "jaccard", "metric_percase", "metric_percase_hd95",
           "per_class_metrics"]
