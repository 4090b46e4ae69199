from .hrnet import PoseHighResolutionNet, heatmap_mse_loss, pose_hrnet_w32

__all__ = ["PoseHighResolutionNet", "heatmap_mse_loss", "pose_hrnet_w32"]
