from .alexnet import AlexNet, alexnet
from .convnext import (ConvNeXt, convnext_base, convnext_large,
                       convnext_small, convnext_tiny)
from .cspdarknet import CSPDarkNet, DarkNet53, cspdarknet53, darknet53_cls
from .cswin import CSWinTransformer, cswin_small, cswin_tiny
from .deit import (DistilledVisionTransformer, deit_base, deit_small,
                   deit_tiny, distilled_vision_transformer, dvt)
from .densenet import (DenseNet, densenet121, densenet161, densenet169,
                       densenet201, densenet264)
from .dpn_dla import DLA, DPN, dla34, dla102, dpn68, dpn107
from .efficientnet import (EfficientNet, efficientnet_b0, efficientnet_b1,
                           efficientnet_b2, efficientnet_b3, efficientnet_b4,
                           efficientnet_b5, efficientnet_b6, efficientnet_b7)
from .esnet import ESNet, PPLCNetV2, esnet_x0_5, esnet_x1_0, pp_lcnet_v2
from .ghostnet import GhostNet, ghostnet
from .googlenet import GoogLeNet, googlenet
from .gvt import (ALTGVT, CPVTV2, alt_gvt_base, alt_gvt_large,
                  alt_gvt_small, pcpvt_base, pcpvt_large, pcpvt_small)
from .inceptionv3 import InceptionV3, inception_v3
from .levit import (LeViT, levit_128, levit_128s, levit_192, levit_256,
                    levit_384)
from .mixnet import MixNet, mixnet_m, mixnet_s
from .mobilenetv1 import MobileNetV1, mobilenet_v1
from .mobilenetv2 import MobileNetV2, mobilenet_v2
from .mobilenetv3 import MobileNetV3, mobilenet_v3_large, mobilenet_v3_small
from .peleenet import (HarDNet, PeleeNet, hardnet39, hardnet68, hardnet85,
                       peleenet)
from .pp_lcnet import PPLCNet, pp_lcnet
from .pvt_v2 import PVTv2, pvt_v2_b0, pvt_v2_b1, pvt_v2_b2
from .rednet import RedNet, rednet26, rednet50, rednet101
from .regnet import RegNet, regnetx_4gf, regnety_4gf
from .res2net import Res2Net, res2net50_26w_4s, res2net101_26w_4s
from .rexnet import ReXNet, rexnet_1_0, rexnet_1_3
from .resnet import (ResNet, resnet18, resnet34, resnet50, resnet101,
                     resnet152, resnext50_32x4d, resnext101_32x4d,
                     resnext101_64x4d, wide_resnet50_2, wide_resnet101_2)
from .se_resnext import ResNeSt, SEResNeXt, resnest50, se_resnext50_32x4d
from .shufflenetv2 import (ShuffleNetV2, shufflenet_v2_x0_5,
                           shufflenet_v2_x0_25, shufflenet_v2_x0_33,
                           shufflenet_v2_x1_0, shufflenet_v2_x1_5,
                           shufflenet_v2_x2_0)
from .squeezenet import SqueezeNet, squeezenet1_0, squeezenet1_1
from .swin_transformer import (SwinTransformer, set_window_pack, swin_base,
                               swin_large, swin_small, swin_tiny,
                               swin_transformer_base)
from .tnt import TNT, PPHGNet, pp_hgnet_small, tnt_s
from .van import VAN, van_b0, van_b1
from .vgg import VGG, vgg11, vgg13, vgg16, vgg19
from .vision_transformer import (VisionTransformer, vit_base_patch16_224,
                                 vit_base_patch16_384, vit_base_patch32_384,
                                 vit_large_patch16_224, vit_large_patch16_384,
                                 vit_large_patch32_384, vit_small_patch16_224)
from .xception import Xception, xception, xception41, xception65
from .xception_deeplab import (XceptionDeeplab, xception41_deeplab,
                               xception65_deeplab, xception_deeplab)

gvt_small = alt_gvt_small  # the JAX package's alias

# the model factories, which the registry (``config.create_model``) lists
# under the JAX package's names
MODELS = ["resnet18", "resnet34", "resnet50", "resnet101", "resnet152",
          "wide_resnet50_2", "wide_resnet101_2", "resnext50_32x4d",
          "resnext101_32x4d", "resnext101_64x4d", "vit_small_patch16_224",
          "vit_base_patch16_224", "vit_base_patch16_384",
          "vit_base_patch32_384", "vit_large_patch16_224",
          "vit_large_patch16_384", "vit_large_patch32_384", "deit_tiny",
          "deit_small", "deit_base", "dvt", "distilled_vision_transformer",
          "swin_tiny", "swin_small", "swin_base", "swin_large",
          "swin_transformer_base", "mobilenet_v1", "pp_lcnet",
          # the first half of the zoo's other models
          "tnt_s", "pp_hgnet_small", "pvt_v2_b0", "pvt_v2_b1", "pvt_v2_b2",
          "pcpvt_small", "pcpvt_base", "pcpvt_large", "alt_gvt_small",
          "alt_gvt_base", "alt_gvt_large", "gvt_small", "cswin_tiny",
          "cswin_small", "levit_128s", "levit_128", "levit_192", "levit_256",
          "levit_384", "convnext_tiny", "convnext_small", "convnext_base",
          "convnext_large", "van_b0", "van_b1", "rednet26", "rednet50",
          "rednet101", "se_resnext50_32x4d", "resnest50", "res2net50_26w_4s",
          "res2net101_26w_4s", "regnetx_4gf", "regnety_4gf", "mobilenet_v2",
          "mobilenet_v3_small", "mobilenet_v3_large",
          *(f"efficientnet_b{i}" for i in range(8)), "ghostnet",
          # the zoo's second half: the classic CNNs
          "alexnet", "vgg11", "vgg13", "vgg16", "vgg19", "googlenet",
          "squeezenet1_0", "squeezenet1_1", "densenet121", "densenet161",
          "densenet169", "densenet201", "densenet264", "inception_v3",
          "xception", "xception41", "xception65", "xception_deeplab",
          "xception41_deeplab", "xception65_deeplab", "shufflenet_v2_x0_25",
          "shufflenet_v2_x0_33", "shufflenet_v2_x0_5", "shufflenet_v2_x1_0",
          "shufflenet_v2_x1_5", "shufflenet_v2_x2_0", "esnet_x0_5",
          "esnet_x1_0", "pp_lcnet_v2", "mixnet_s", "mixnet_m", "rexnet_1_0",
          "rexnet_1_3", "peleenet", "hardnet39", "hardnet68", "hardnet85",
          "dpn68", "dpn107", "dla34", "dla102", "cspdarknet53",
          "darknet53_cls"]

__all__ = ["ResNet", "MobileNetV1", "PPLCNet", "VisionTransformer",
           "DistilledVisionTransformer", "SwinTransformer", "set_window_pack",
           "TNT", "PPHGNet", "PVTv2", "CPVTV2", "ALTGVT", "CSWinTransformer",
           "LeViT", "ConvNeXt", "VAN", "RedNet", "SEResNeXt", "ResNeSt",
           "Res2Net", "RegNet", "MobileNetV2", "MobileNetV3", "EfficientNet",
           "GhostNet", "AlexNet", "VGG", "GoogLeNet", "SqueezeNet",
           "DenseNet", "InceptionV3", "Xception", "XceptionDeeplab",
           "ShuffleNetV2", "ESNet", "PPLCNetV2", "MixNet", "ReXNet",
           "PeleeNet", "HarDNet", "DPN", "DLA", "CSPDarkNet", "DarkNet53",
           *MODELS]
