"""Facial-landmark transforms (counterpart of
``tlxcv_tpu/data/landmark_transforms.py``): crop, resize, mirror-indexed
flip, rotate, occlude, normalize, and the PnP head pose that PFLD's
euler-weighted loss needs.  Host-side numpy and cv2, as the reference's
(cv2 is needed by the resize, flip, rotate and pose).  The ``rng``
arguments take what the reference's take (the ``random`` module by
default, or a seeded ``random.Random`` or ``numpy.random.Generator``), so
that both packages draw the same."""
from __future__ import annotations

import random

import numpy as np

try:
    import cv2
except Exception:  # pragma: no cover
    cv2 = None

__all__ = ["calculate_pitch_yaw_roll", "Crop", "LandmarkResize",
           "RandomHorizontalFlip", "RandomRotate", "RandomOcclude",
           "LandmarkNormalize", "CalculateEulerAngles", "ToTuple",
           "LandmarkCompose", "MIRROR_INDEXES_68", "TRACKED_POINTS_68"]

# dlib 68-point mirror permutation
MIRROR_INDEXES_68 = [
    16, 15, 14, 13, 12, 11, 10, 9, 8, 7, 6, 5, 4, 3, 2, 1, 0, 26, 25, 24,
    23, 22, 21, 20, 19, 18, 17, 27, 28, 29, 30, 35, 34, 33, 32, 31, 45, 44,
    43, 42, 47, 46, 39, 38, 37, 36, 41, 40, 54, 53, 52, 51, 50, 49, 48, 59,
    58, 57, 56, 55, 64, 63, 62, 61, 60, 67, 66, 65]

# the 14 PnP anchor landmarks
TRACKED_POINTS_68 = [17, 21, 22, 26, 36, 39, 42, 45, 31, 35, 48, 54, 57, 8]

# generic 3D face model for the 14 tracked points
_LANDMARKS_3D = np.float32([
    [6.825897, 6.760612, 4.402142], [1.330353, 7.122144, 6.903745],
    [-1.330353, 7.122144, 6.903745], [-6.825897, 6.760612, 4.402142],
    [5.311432, 5.485328, 3.987654], [1.789930, 5.393625, 4.413414],
    [-1.789930, 5.393625, 4.413414], [-5.311432, 5.485328, 3.987654],
    [-2.005628, 1.409845, 6.165652], [-2.005628, 1.409845, 6.165652],
    [2.774015, -2.080775, 5.048531], [-2.774015, -2.080775, 5.048531],
    [0.000000, -3.116408, 6.097667], [0.000000, -7.415691, 4.070434]])


def calculate_pitch_yaw_roll(landmarks_2d, cam_w=256, cam_h=256):
    """Head pose (pitch, yaw, roll) in degrees from the 14 tracked 2D
    landmarks via PnP."""
    c_x, c_y = cam_w / 2, cam_h / 2
    f_x = c_x / np.tan(60 / 2 * np.pi / 180)
    camera_matrix = np.float32([[f_x, 0.0, c_x], [0.0, f_x, c_y],
                                [0.0, 0.0, 1.0]])
    dist = np.zeros(5, np.float32)
    pts2d = np.asarray(landmarks_2d, np.float32).reshape(-1, 2)
    _, rvec, tvec = cv2.solvePnP(_LANDMARKS_3D, pts2d, camera_matrix, dist)
    rmat, _ = cv2.Rodrigues(rvec)
    pose_mat = cv2.hconcat((rmat, tvec))
    _, _, _, _, _, _, euler = cv2.decomposeProjectionMatrix(pose_mat)
    return tuple(float(k[0]) for k in euler)  # (pitch, yaw, roll)


class Crop:
    """Crop to the landmark bounding box."""

    def __call__(self, data):
        image, label = data
        lm = np.asarray(label["landmark"], np.float32).reshape(-1, 2)
        x0, y0 = np.floor(lm.min(0)).astype(int)
        x1, y1 = np.ceil(lm.max(0)).astype(int)
        lm = lm - [x0, y0]
        label = dict(label)
        label["landmark"] = lm
        return image[y0:y1, x0:x1, :], label


class LandmarkResize:
    def __init__(self, size):
        self.size = (size, size) if isinstance(size, int) else tuple(size)

    def __call__(self, data):
        image, label = data
        h, w = image.shape[:2]
        nw, nh = self.size
        label = dict(label)
        lm = np.asarray(label["landmark"], np.float32).copy()
        lm[:, 0] *= nw / w
        lm[:, 1] *= nh / h
        label["landmark"] = lm
        label["size"] = self.size
        return cv2.resize(image, self.size), label


class RandomHorizontalFlip:
    """Flip with the 68-point mirror permutation."""

    def __init__(self, mirror_indexes=None, rng=None):
        self.mirror_indexes = (MIRROR_INDEXES_68 if mirror_indexes is None
                               else list(mirror_indexes))
        self.rng = rng or random

    def __call__(self, data):
        image, label = data
        if self.rng.random() < 0.5:
            w = image.shape[1]
            image = cv2.flip(image, 1)
            label = dict(label)
            lm = np.asarray(label["landmark"], np.float32).copy()
            # cv2.flip maps column j -> (w-1)-j
            lm[:, 0] = (w - 1) - lm[:, 0]
            label["landmark"] = lm[self.mirror_indexes]
        return image, label


class RandomRotate:
    def __init__(self, angle_range, rng=None):
        self.angle_range = list(angle_range)
        self.rng = rng or random

    def __call__(self, data):
        image, label = data
        h, w = image.shape[:2]
        angle = self.rng.choice(self.angle_range)
        rot = cv2.getRotationMatrix2D((w / 2, h / 2), angle,
                                      1).astype(np.float32)
        image = cv2.warpAffine(image, rot, (w, h))
        label = dict(label)
        lm = np.asarray(label["landmark"], np.float32)
        label["landmark"] = (rot[:, :2] @ lm.T + rot[:, 2:]).T
        return image, label


class RandomOcclude:
    def __init__(self, occlude_size, rng=None):
        self.occlude_size = occlude_size
        self.rng = rng or random

    def __call__(self, data):
        image, label = data
        h, w = image.shape[:2]
        ow, oh = self.occlude_size
        x = self.rng.randint(0, w - ow)
        y = self.rng.randint(0, h - oh)
        image = image.copy()
        image[y:y + oh, x:x + ow, :] = 0
        return image, label


class LandmarkNormalize:
    """Image to [0,1]; landmarks to normalized coords."""

    def __call__(self, data):
        image, label = data
        label = dict(label)
        lm = np.asarray(label["landmark"], np.float32).copy()
        lm[:, 0] /= label["size"][0]
        lm[:, 1] /= label["size"][1]
        label["landmark"] = lm
        return image.astype(np.float32) / 255.0, label


class CalculateEulerAngles:
    """GT euler angles for PFLD's auxiliary pose head."""

    def __init__(self, tracked_points=None):
        self.tracked_points = (TRACKED_POINTS_68 if tracked_points is None
                               else list(tracked_points))

    def __call__(self, data):
        image, label = data
        label = dict(label)
        # pose is estimated in PIXEL coordinates — run before Normalize
        lm = np.asarray(label["landmark"], np.float32)
        label["euler_angles"] = np.asarray(
            calculate_pitch_yaw_roll(lm[self.tracked_points]), np.float32)
        return image, label


class ToTuple:
    def __call__(self, data):
        image, label = data
        return image, (np.asarray(label["landmark"], np.float32),
                       np.asarray(label["euler_angles"], np.float32))


class LandmarkCompose:
    def __init__(self, transforms):
        self.transforms = list(transforms)

    def __call__(self, image, label):
        data = (image, label)
        for t in self.transforms:
            data = t(data)
        return data
