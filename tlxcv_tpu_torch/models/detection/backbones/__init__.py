from .darknet import (BasicBlock, Blocks, ConvBNLayer, DarkNet, DownSample,
                      darknet53)

__all__ = ["BasicBlock", "Blocks", "ConvBNLayer", "DarkNet", "DownSample",
           "darknet53"]
