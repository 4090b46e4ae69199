from .deit import (DistilledVisionTransformer, deit_base, deit_small,
                   deit_tiny, distilled_vision_transformer, dvt)
from .mobilenetv1 import MobileNetV1, mobilenet_v1
from .pp_lcnet import PPLCNet, pp_lcnet
from .resnet import (ResNet, resnet18, resnet34, resnet50, resnet101,
                     resnet152, resnext50_32x4d, resnext101_32x4d,
                     resnext101_64x4d, wide_resnet50_2, wide_resnet101_2)
from .swin_transformer import (SwinTransformer, set_window_pack, swin_base,
                               swin_large, swin_small, swin_tiny,
                               swin_transformer_base)
from .vision_transformer import (VisionTransformer, vit_base_patch16_224,
                                 vit_base_patch16_384, vit_base_patch32_384,
                                 vit_large_patch16_224, vit_large_patch16_384,
                                 vit_large_patch32_384, vit_small_patch16_224)

# the model factories, which the registry (``config.create_model``) lists
MODELS = ["resnet18", "resnet34", "resnet50", "resnet101", "resnet152",
          "wide_resnet50_2", "wide_resnet101_2", "resnext50_32x4d",
          "resnext101_32x4d", "resnext101_64x4d", "vit_small_patch16_224",
          "vit_base_patch16_224", "vit_base_patch16_384",
          "vit_base_patch32_384", "vit_large_patch16_224",
          "vit_large_patch16_384", "vit_large_patch32_384", "deit_tiny",
          "deit_small", "deit_base", "dvt", "distilled_vision_transformer",
          "swin_tiny", "swin_small", "swin_base", "swin_large",
          "swin_transformer_base", "mobilenet_v1", "pp_lcnet"]

__all__ = ["ResNet", "MobileNetV1", "PPLCNet", "VisionTransformer", "DistilledVisionTransformer",
           "SwinTransformer", "set_window_pack", *MODELS]
