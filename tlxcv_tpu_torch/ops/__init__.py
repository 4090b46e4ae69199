from .losses import (binary_cross_entropy, cross_entropy, dice_loss,
                     giou_loss, l1_loss, mse_loss, sigmoid_focal_loss,
                     smooth_l1_loss, softmax_cross_entropy, varifocal_loss,
                     wing_loss)

__all__ = ["binary_cross_entropy", "cross_entropy", "dice_loss", "giou_loss",
           "l1_loss", "mse_loss", "sigmoid_focal_loss", "smooth_l1_loss",
           "softmax_cross_entropy", "varifocal_loss", "wing_loss"]
