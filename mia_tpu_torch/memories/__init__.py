from .feature_memory import FeatureMemoryState, init_feature_memory, update_feature_memory

__all__ = ["FeatureMemoryState", "init_feature_memory", "update_feature_memory"]
