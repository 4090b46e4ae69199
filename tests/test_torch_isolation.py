"""The port stands alone: tlxcv_tpu_torch and chip_smoke.py import neither
JAX nor anything of the tlxcv_tpu package."""
import ast
import json
import pathlib
import subprocess
import sys

import pytest

ROOT = pathlib.Path(__file__).resolve().parents[1]
PORT_FILES = sorted((ROOT / "tlxcv_tpu_torch").rglob("*.py")) + [
    ROOT / "chip_smoke.py"]

_PROBE = """
import importlib, json, pkgutil, sys
import tlxcv_tpu_torch
names = [m.name for m in pkgutil.walk_packages(tlxcv_tpu_torch.__path__,
                                               "tlxcv_tpu_torch.")]
for name in names:
    importlib.import_module(name)
bad = [m for m in sys.modules
       if m == "jax" or m.startswith(("jax.", "jaxlib"))
       or m == "tlxcv_tpu" or m.startswith("tlxcv_tpu.")]
print(json.dumps({"imported": names, "bad": bad}))
"""


def test_importing_every_port_module_pulls_in_no_jax():
    out = subprocess.run([sys.executable, "-c", _PROBE], cwd=ROOT,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    got = json.loads(out.stdout.strip().splitlines()[-1])
    assert "tlxcv_tpu_torch.ops.cuda.attention" in got["imported"]
    assert "tlxcv_tpu_torch.utils.bridge" in got["imported"]
    for name in ("train.trainer", "train.optimizers", "data.loader",
                 "data.shapes_det", "ops.losses", "ops.yolo",
                 "models.detection.yolov3",
                 "models.detection.backbones.darknet",
                 "demo.image_classification.probe_int8_gemm",
                 "nn.attention", "ops.space_to_depth",
                 "models.backbones.hrnet", "models.segmentation.layers",
                 "models.segmentation.hrnet_seg",
                 "tasks.image_segmentation", "utils.metrics",
                 "models.classification.deit",
                 "models.classification.swin_transformer",
                 "models.classification.mobilenetv1", "ops.anchors",
                 "ops.post_process", "models.detection.ssd",
                 "models.detection.ppyoloe", "models.detection.detr",
                 "utils.checkpoint", "models.human_pose_estimation.hrnet",
                 "models.facial_landmark_detection.pfld",
                 "tasks.human_pose_estimation",
                 "tasks.facial_landmark_detection", "ops.quant",
                 "ops.hungarian", "train.bn_recal", "data.transforms",
                 "models.backbones.resnet_vd", "models.segmentation.bisenet",
                 "models.segmentation.unet", "models.segmentation.fast_scnn",
                 "models.segmentation.deeplab",
                 "models.segmentation.fastfcn", "models.segmentation.encnet",
                 "models.segmentation.enet", "models.rs.layers",
                 "models.rs.cd", "models.rs.seg", "models.detection.fcos",
                 "models.detection.deform", "models.detection.tood",
                 "config", "ops.image", "models.detection.retinanet",
                 "models.detection.gfl", "models.detection.cascade_rcnn",
                 "models.detection.yolox", "models.detection.centernet",
                 "models.detection.ttfnet", "models.detection.picodet",
                 "models.detection.solov2",
                 "models.classification.pp_lcnet",
                 *(f"models.classification.{m}" for m in (
                     "tnt", "pvt_v2", "gvt", "cswin", "levit", "convnext",
                     "van", "rednet", "se_resnext", "res2net", "regnet",
                     "mobilenetv2", "mobilenetv3", "efficientnet",
                     "ghostnet", "vgg", "alexnet", "squeezenet",
                     "googlenet", "inceptionv3", "densenet", "xception",
                     "xception_deeplab", "shufflenetv2", "esnet", "mixnet",
                     "rexnet", "peleenet", "dpn_dla", "cspdarknet")),
                 "models.face_recognition.retinaface",
                 "models.face_recognition.arcface",
                 "tasks.face_recognition",
                 "models.video_classification.i3d",
                 "tasks.video_classification", "models.ocr.transform",
                 "models.ocr.trocr", "tasks.ocr", "tasks.distillation",
                 "data.charades", "data.synth90k", "data.cifar",
                 "data.circles", "data.coco", "data.wider", "data.face300w",
                 "data.casiawebface", "data.det_transforms",
                 "data.landmark_transforms", "native", "ops.cuda.library",
                 "utils.coco_eval", "utils.convert", "utils.theseus",
                 "utils.profiler", "utils.export", "demo._accuracy",
                 "demo.object_detection.accuracy_sweep",
                 "demo.object_detection.accuracy_check",
                 "demo.object_detection.accuracy_check_instance_seg",
                 "demo.object_detection.accuracy_check_detr_r50",
                 "demo.human_pose_estimation.accuracy_check",
                 "demo.facial_landmark_detection.accuracy_check",
                 "demo.face_recognition.accuracy_check",
                 "demo.video_classification.accuracy_check",
                 "demo.ocr.accuracy_check",
                 "demo.image_classification.accuracy_check_qat"):
        assert f"tlxcv_tpu_torch.{name}" in got["imported"]
    assert got["bad"] == []


def _imported_roots(path):
    roots = set()
    for node in ast.walk(ast.parse(path.read_text(), str(path))):
        if isinstance(node, ast.Import):
            roots.update(a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            roots.add(node.module.split(".")[0])
    return roots


@pytest.mark.parametrize("path", PORT_FILES,
                         ids=[str(p.relative_to(ROOT)) for p in PORT_FILES])
def test_no_jax_import_in_source(path):
    assert not _imported_roots(path) & {"jax", "jaxlib", "tlxcv_tpu",
                                        "optax", "demo"}
