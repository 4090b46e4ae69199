from .pfld import PFLD, AuxiliaryNet, PFLDBackbone, pfld_loss

__all__ = ["PFLD", "AuxiliaryNet", "PFLDBackbone", "pfld_loss"]
