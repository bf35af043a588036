"""Training UI and metrics bus (reference: deeplearning4j-ui, SURVEY §5.5).

``StatsListener`` routes the training metrics into a storage: TensorBoard
event files (``TensorBoardStatsStorage``), an in-memory store for
programmatic queries, or JSONL. The web server carries the health and
Prometheus endpoints, the incidents, and the serving tier's HTTP front
door (``POST /api/infer``)."""

from .stats import (FileStatsStorage, InMemoryStatsStorage, StatsListener,
                    StatsStorage, TensorBoardStatsStorage)
from .tensorboard import (TensorBoardEventWriter, read_histogram_events,
                          read_scalar_events)
from .server import RemoteUIStatsStorageRouter, UIServer, prometheus_text
# the device half of the metrics bus (in-step telemetry) lives in
# optimize.telemetry; re-exported so listener -> storage is one import
from ..optimize.telemetry import NanSentinelListener, TelemetrySink

__all__ = [
    "FileStatsStorage", "InMemoryStatsStorage", "StatsListener",
    "StatsStorage", "TensorBoardStatsStorage", "TensorBoardEventWriter",
    "read_scalar_events", "read_histogram_events", "UIServer",
    "RemoteUIStatsStorageRouter", "TelemetrySink", "NanSentinelListener",
    "prometheus_text",
]
