from .dataset import DataSet
from .iterators import (DataSetIterator, ExistingDataSetIterator,
                        MnistDataSetIterator, MultipleEpochsIterator,
                        NDArrayDataSetIterator)
from .normalizers import (ImagePreProcessingScaler, NormalizerMinMaxScaler,
                          NormalizerStandardize)
