from .resnet import (ResNet, resnet18, resnet34, resnet50, resnet101,
                     resnet152, resnext50_32x4d, resnext101_32x4d,
                     resnext101_64x4d, wide_resnet50_2, wide_resnet101_2)
from .vision_transformer import (VisionTransformer, vit_base_patch16_224,
                                 vit_base_patch16_384, vit_base_patch32_384,
                                 vit_large_patch16_224, vit_large_patch16_384,
                                 vit_large_patch32_384, vit_small_patch16_224)

__all__ = ["ResNet", "resnet18", "resnet34", "resnet50", "resnet101",
           "resnet152", "wide_resnet50_2", "wide_resnet101_2",
           "resnext50_32x4d", "resnext101_32x4d", "resnext101_64x4d",
           "VisionTransformer", "vit_small_patch16_224",
           "vit_base_patch16_224", "vit_base_patch16_384",
           "vit_base_patch32_384", "vit_large_patch16_224",
           "vit_large_patch16_384", "vit_large_patch32_384"]
