from .zoo import ResNet50, ZooModel
