from .i3d import InceptionI3d, InceptionModule, Unit3D

__all__ = ["InceptionI3d", "InceptionModule", "Unit3D"]
