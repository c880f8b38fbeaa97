"""Run-time support: device choice, the YAML config reader, checkpoints and
training logs."""
from .checkpoint import CheckpointManager, load_states, save_states
from .config import (DEFAULT_BASIC_CONFIG, DictConfig, get_basic_config,
                     get_config, load_yaml, parse_yaml)
from .device import resolve_device
from .logging import MetricLogger

__all__ = ["CheckpointManager", "DEFAULT_BASIC_CONFIG", "DictConfig",
           "MetricLogger", "get_basic_config", "get_config",
           "load_states", "load_yaml", "parse_yaml", "resolve_device",
           "save_states"]
