"""Training UI and metrics bus: the stats storages, the graph log, and the
web server with the serving tier's HTTP front door (``POST /api/infer``).
``StatsListener`` and the TensorBoard storages wait for ROADMAP A8."""

from .stats import FileStatsStorage, InMemoryStatsStorage, StatsStorage
from .server import RemoteUIStatsStorageRouter, UIServer, prometheus_text

__all__ = ["FileStatsStorage", "InMemoryStatsStorage", "StatsStorage",
           "UIServer", "RemoteUIStatsStorageRouter", "prometheus_text"]
