from .hrnet_seg import FCN, HRNetW48Contrast, hrnet_seg_w18, hrnet_seg_w48

# the model factories, which the registry (``config.create_model``) lists
MODELS = ["hrnet_seg_w18", "hrnet_seg_w48"]

__all__ = ["FCN", "HRNetW48Contrast", *MODELS]
