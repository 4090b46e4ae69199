from .vision_transformer import (VisionTransformer, vit_base_patch16_224,
                                 vit_base_patch16_384, vit_base_patch32_384,
                                 vit_large_patch16_224, vit_large_patch16_384,
                                 vit_large_patch32_384, vit_small_patch16_224)

__all__ = ["VisionTransformer", "vit_small_patch16_224",
           "vit_base_patch16_224", "vit_base_patch16_384",
           "vit_base_patch32_384", "vit_large_patch16_224",
           "vit_large_patch16_384", "vit_large_patch32_384"]
