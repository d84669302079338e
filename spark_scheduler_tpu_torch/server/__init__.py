"""Serving layer: install config, dependency wiring, extender-protocol HTTP
front-end, conversion webhook. Rebuilds cmd/ + config/ of the reference."""

from spark_scheduler_tpu_torch.server.config import InstallConfig  # noqa: F401
from spark_scheduler_tpu_torch.server.app import SchedulerApp, build_scheduler_app  # noqa: F401
