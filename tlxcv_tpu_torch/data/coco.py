"""COCO datasets (counterpart of ``tlxcv_tpu/data/coco.py``): the index is
parsed from the annotation JSON itself (no pycocotools); images come back
as HWC uint8 RGB numpy arrays, JPEGs decoded by the native libjpeg route
(``tlxcv_tpu_torch.native``) where it built, other formats by PIL.
"""
from __future__ import annotations

import json
import os
from collections import defaultdict

import numpy as np

from .vision import VisionDataset


class CocoIndex:
    """The part of pycocotools' ``COCO`` the datasets use, over an
    instances or keypoints JSON."""

    def __init__(self, annotation_file):
        with open(annotation_file) as f:
            d = json.load(f)
        self.dataset = d
        self.imgs = {img["id"]: img for img in d.get("images", [])}
        self.anns = {a["id"]: a for a in d.get("annotations", [])}
        self.img_to_anns = defaultdict(list)
        for a in d.get("annotations", []):
            self.img_to_anns[a["image_id"]].append(a)
        self.cats = {c["id"]: c for c in d.get("categories", [])}

    def get_img_ids(self):
        return sorted(self.imgs)

    def load_anns(self, img_id):
        return self.img_to_anns.get(img_id, [])


class CocoDetection(VisionDataset):
    def __init__(self, root, annotation_file, transforms=None, transform=None,
                 target_transform=None, filter_crowd=True,
                 raw_annotations=False):
        """``raw_annotations=True`` yields the untouched COCO annotation
        list as ``{"annotations": [...]}`` for pipelines that start with
        data.det_transforms.LabelFormatConvert (the reference demo
        contract); default parses to boxes/class_labels directly."""
        super().__init__(root, transforms, transform, target_transform)
        self.raw_annotations = raw_annotations
        self.coco = CocoIndex(annotation_file)
        self.ids = []
        for img_id in self.coco.get_img_ids():
            anns = self.coco.load_anns(img_id)
            if not anns:
                continue
            if filter_crowd and all(a.get("iscrowd", 0) for a in anns):
                continue  # crowd-only images are left out
            self.ids.append(img_id)
        # contiguous category mapping
        cat_ids = sorted(self.coco.cats)
        self.cat_to_label = {c: i for i, c in enumerate(cat_ids)}
        self.label_to_cat = {i: c for c, i in self.cat_to_label.items()}

    def _load_image(self, img_id):
        info = self.coco.imgs[img_id]
        path = os.path.join(self.root, info["file_name"])
        if path.lower().endswith((".jpg", ".jpeg")):
            from .. import native

            if native.jpeg_available():
                with open(path, "rb") as f:
                    return native.decode_jpeg(f.read())
        from PIL import Image

        return np.asarray(Image.open(path).convert("RGB"))

    def __getitem__(self, index):
        img_id = self.ids[index]
        image = self._load_image(img_id)
        if self.raw_annotations:
            target = {"annotations": self.coco.load_anns(img_id),
                      "image_id": img_id}
            if self.transforms:
                image, target = self.transforms(image, target)
            return image, target
        anns = [a for a in self.coco.load_anns(img_id)
                if not a.get("iscrowd", 0)]
        boxes = np.asarray([a["bbox"] for a in anns], np.float32
                           ).reshape(-1, 4)  # xywh
        boxes[:, 2:] += boxes[:, :2]  # -> xyxy
        labels = np.asarray([self.cat_to_label[a["category_id"]]
                             for a in anns], np.int64)
        target = {"boxes": boxes, "class_labels": labels,
                  "image_id": img_id,
                  "orig_size": np.asarray(image.shape[:2], np.int64)}
        if self.transforms:
            image, target = self.transforms(image, target)
        return image, target

    def __len__(self):
        return len(self.ids)


class CocoHumanPoseEstimation(VisionDataset):
    """One item per (image, annotation with keypoints) pair."""

    def __init__(self, root, annotation_file, transforms=None, transform=None,
                 target_transform=None):
        super().__init__(root, transforms, transform, target_transform)
        self.coco = CocoIndex(annotation_file)
        self.items = []
        for img_id in self.coco.get_img_ids():
            for a in self.coco.load_anns(img_id):
                if a.get("num_keypoints", 0) > 0:
                    self.items.append((img_id, a))

    def __getitem__(self, index):
        img_id, ann = self.items[index]
        info = self.coco.imgs[img_id]
        from PIL import Image

        image = np.asarray(Image.open(
            os.path.join(self.root, info["file_name"])).convert("RGB"))
        kpts = np.asarray(ann["keypoints"], np.float32).reshape(-1, 3)
        bbox = np.asarray(ann["bbox"], np.float32)
        target = {"keypoints": kpts, "bbox": bbox, "image_id": img_id}
        if self.transforms:
            image, target = self.transforms(image, target)
        return image, target

    def __len__(self):
        return len(self.items)
