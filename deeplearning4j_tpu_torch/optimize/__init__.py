from .listeners import (CheckpointListener, CollectScoresIterationListener,
                        EvaluativeListener, PerformanceListener,
                        PipelineMetricsListener, ScoreIterationListener,
                        TimeIterationListener, TrainingListener)
from .telemetry import NanSentinelListener, TelemetryConfig, TelemetrySink
from .earlystopping import (DataSetLossCalculator, EarlyStoppingConfiguration,
                            EarlyStoppingResult, EarlyStoppingTrainer,
                            InMemoryModelSaver, LocalFileModelSaver,
                            MaxEpochsTerminationCondition,
                            MaxScoreIterationTerminationCondition,
                            MaxTimeIterationTerminationCondition,
                            ScoreImprovementEpochTerminationCondition)
