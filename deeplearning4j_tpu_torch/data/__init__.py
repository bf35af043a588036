from .dataset import DataSet, MultiDataSet
from .iterators import (Cifar10DataSetIterator, DataSetIterator,
                        EmnistDataSetIterator, ExistingDataSetIterator,
                        IrisDataSetIterator, LFWDataSetIterator,
                        MnistDataSetIterator, MultipleEpochsIterator,
                        NDArrayDataSetIterator, TinyImageNetDataSetIterator,
                        UciSequenceDataSetIterator)
from .normalizers import (ImagePreProcessingScaler, NormalizerMinMaxScaler,
                          NormalizerStandardize, normalizer_from_json)
from .records import (CollectionInputSplit, CollectionRecordReader,
                      CSVRecordReader, CSVSequenceRecordReader, FileSplit,
                      InputSplit, LineRecordReader, RecordReader,
                      SequenceRecordReader)
from .schema import ColumnType, Schema, TransformProcess
from .image import (CropImageTransform, FlipImageTransform, ImageRecordReader,
                    ImageTransform, PipelineImageTransform,
                    ResizeImageTransform, RotateImageTransform)
from .record_iterator import (AsyncDataSetIterator,
                              RecordReaderDataSetIterator,
                              SequenceRecordReaderDataSetIterator)
from .reducers import Join, Reducer
from .sequence import (convert_to_sequence, reduce_sequence, window_sequence,
                       window_sequences)
from .analysis import AnalyzeLocal, ColumnAnalysis, DataAnalysis
from .binary_records import (BinaryRecordDataSetIterator, BinaryRecordReader,
                             BinaryRecordWriter, write_records)
from .pipeline import chunked, device_feed, pad_dataset, resolve_batch_size, \
    stable_batches
