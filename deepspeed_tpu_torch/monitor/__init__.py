"""Experiment monitors (port of deepspeed_tpu/monitor)."""

from .config import DeepSpeedMonitorConfig, get_monitor_config  # noqa: F401
from .monitor import MonitorMaster  # noqa: F401
