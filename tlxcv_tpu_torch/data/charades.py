"""Charades video frames (counterpart of ``tlxcv_tpu/data/charades.py``):
``num_frames`` frames spaced evenly over a video's frame folder, RGB in
[-1, 1], and a per-frame multi-label matrix over the 157 classes from the
CSV's ``actions`` (``c012 3.1 8.0;...``, seconds at 24 frames a second).
OpenCV is imported only to read frames."""
from __future__ import annotations

import csv
import os

import numpy as np

from .vision import VisionDataset

__all__ = ["Charades", "NUM_CLASSES", "FPS"]

NUM_CLASSES = 157
FPS = 24


class Charades(VisionDataset):
    def __init__(self, root, csv_file, mode="rgb", num_frames=32,
                 transforms=None, transform=None, target_transform=None):
        super().__init__(root, transforms, transform, target_transform)
        self.mode = mode
        self.num_frames = num_frames
        self.videos = []
        with open(csv_file) as f:
            for row in csv.DictReader(f):
                actions = []
                if row.get("actions"):
                    for act in row["actions"].split(";"):
                        cls, start, end = act.split()
                        actions.append((int(cls[1:]), float(start),
                                        float(end)))
                self.videos.append((row["id"], actions))

    def _load_frames(self, vid):
        import cv2

        frame_dir = os.path.join(self.root, vid)
        files = sorted(os.listdir(frame_dir))
        idx = np.linspace(0, len(files) - 1, self.num_frames).astype(int)
        frames = []
        for i in idx:
            img = cv2.cvtColor(cv2.imread(os.path.join(frame_dir, files[i])),
                               cv2.COLOR_BGR2RGB)
            frames.append(img.astype(np.float32) / 127.5 - 1.0)
        return np.stack(frames), idx / FPS

    def __getitem__(self, index):
        vid, actions = self.videos[index]
        frames, times = self._load_frames(vid)
        label = np.zeros((len(times), NUM_CLASSES), np.float32)
        for cls, start, end in actions:
            label[(times >= start) & (times <= end), cls] = 1.0
        if self.transforms:
            frames, label = self.transforms(frames, label)
        return frames, label

    def __len__(self):
        return len(self.videos)
