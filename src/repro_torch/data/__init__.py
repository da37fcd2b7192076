"""Deterministic, host-sharded, resumable synthetic data (numpy) and the
task/data-source registry."""
from repro_torch.data.pipeline import (ArraySpec, DataConfig, DataSourceBase,
                                       SyntheticClassification, SyntheticLM, batches,
                                       zipf_class_probs)
from repro_torch.data.sources import (ClassificationConfig, SourceEntry,
                                      SyntheticClassificationSource,
                                      SyntheticVisionSource, TaskAdapter, VisionConfig,
                                      available_sources, derive_config,
                                      entry_for_config, get_source, register_source,
                                      source_name_of)

__all__ = ["ArraySpec", "DataConfig", "DataSourceBase", "SyntheticLM",
           "SyntheticClassification", "batches", "zipf_class_probs",
           "SourceEntry", "TaskAdapter", "register_source", "get_source",
           "available_sources", "entry_for_config", "source_name_of",
           "derive_config", "ClassificationConfig", "SyntheticClassificationSource",
           "VisionConfig", "SyntheticVisionSource"]
