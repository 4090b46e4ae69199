from .hrnet import (HRNet, SpaceToDepthBranch, convert_hrnet_branches_to_s2d,
                    hrnet_w18, hrnet_w18_small_v1, hrnet_w18_small_v2,
                    hrnet_w30, hrnet_w32, hrnet_w40, hrnet_w44, hrnet_w48,
                    hrnet_w60, hrnet_w64)
from .resnet_vd import (ResNetVD, resnet18_vd, resnet34_vd, resnet50_vd,
                        resnet101_vd, resnet152_vd)

__all__ = ["HRNet", "SpaceToDepthBranch", "convert_hrnet_branches_to_s2d",
           "hrnet_w18", "hrnet_w18_small_v1", "hrnet_w18_small_v2",
           "hrnet_w30", "hrnet_w32", "hrnet_w40", "hrnet_w44", "hrnet_w48",
           "hrnet_w60", "hrnet_w64", "ResNetVD", "resnet18_vd",
           "resnet34_vd", "resnet50_vd", "resnet101_vd", "resnet152_vd"]
