from .evaluation import Evaluation, RegressionEvaluation
