from .dataset import DataSet, MultiDataSet
from .iterators import (DataSetIterator, ExistingDataSetIterator,
                        MnistDataSetIterator, MultipleEpochsIterator,
                        NDArrayDataSetIterator)
from .normalizers import (ImagePreProcessingScaler, NormalizerMinMaxScaler,
                          NormalizerStandardize)
