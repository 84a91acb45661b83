from .backbone import BackboneSpec, build_backbone
from .resnet import Bottleneck, ResNet, ResNetHead, ResStage, Stem

__all__ = ["BackboneSpec", "build_backbone", "Bottleneck", "ResNet",
           "ResNetHead", "ResStage", "Stem"]
