from .listeners import (CheckpointListener, CollectScoresIterationListener,
                        EvaluativeListener, PerformanceListener,
                        PipelineMetricsListener, ScoreIterationListener,
                        TimeIterationListener, TrainingListener)
