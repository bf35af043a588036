from .zoo import LeNet, ResNet50, VGG16, ZooModel
