from .inference import ParallelInference
