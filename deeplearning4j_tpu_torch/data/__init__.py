from .dataset import DataSet
