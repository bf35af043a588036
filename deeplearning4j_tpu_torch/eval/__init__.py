from .evaluation import (Evaluation, EvaluationBinary, EvaluationCalibration,
                         ROC, ROCBinary, ROCMultiClass, RegressionEvaluation)
