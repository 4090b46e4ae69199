from .hrnet import (HRNet, SpaceToDepthBranch, convert_hrnet_branches_to_s2d,
                    hrnet_w18, hrnet_w18_small_v1, hrnet_w18_small_v2,
                    hrnet_w30, hrnet_w32, hrnet_w40, hrnet_w44, hrnet_w48,
                    hrnet_w60, hrnet_w64)

__all__ = ["HRNet", "SpaceToDepthBranch", "convert_hrnet_branches_to_s2d",
           "hrnet_w18", "hrnet_w18_small_v1", "hrnet_w18_small_v2",
           "hrnet_w30", "hrnet_w32", "hrnet_w40", "hrnet_w44", "hrnet_w48",
           "hrnet_w60", "hrnet_w64"]
