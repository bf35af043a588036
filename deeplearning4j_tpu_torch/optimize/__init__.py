from .listeners import (CollectScoresIterationListener, EvaluativeListener,
                        PerformanceListener, ScoreIterationListener,
                        TimeIterationListener, TrainingListener)
