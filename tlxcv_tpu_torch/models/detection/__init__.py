from .mask_rcnn import FPN, MaskHead, MaskRCNN, RPNHead, TwoFCHead

__all__ = ["FPN", "MaskHead", "MaskRCNN", "RPNHead", "TwoFCHead"]
