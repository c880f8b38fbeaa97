"""Run-time support: device choice, the YAML config reader, checkpoints and
training logs."""
from .checkpoint import CheckpointManager, load_states, save_states
from .config import DictConfig, get_config, load_yaml, parse_yaml
from .device import resolve_device
from .logging import MetricLogger

__all__ = ["CheckpointManager", "DictConfig", "MetricLogger", "get_config",
           "load_states", "load_yaml", "parse_yaml", "resolve_device",
           "save_states"]
