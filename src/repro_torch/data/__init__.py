"""Deterministic, host-sharded, resumable synthetic data (numpy) and the
task/data-source registry."""
from repro_torch.data.pipeline import (ArraySpec, DataConfig, DataSourceBase,
                                       SyntheticLM)
from repro_torch.data.sources import (SourceEntry, TaskAdapter,
                                      available_sources,
                                      derive_config, entry_for_config,
                                      get_source, register_source,
                                      source_name_of)

__all__ = ["ArraySpec", "DataConfig", "DataSourceBase", "SyntheticLM",
           "SourceEntry", "TaskAdapter", "register_source", "get_source",
           "available_sources", "entry_for_config", "source_name_of",
           "derive_config"]
