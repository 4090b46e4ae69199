"""The port's hermetic accuracy fixtures against the reference's: each
numpy fixture of ``tlxcv_tpu_torch/demo/*/accuracy_check*.py`` must equal,
bitwise, the function of ``demo/`` it copies, from the same
``default_rng`` seed.  The detection batches, the three target adapters
(on tensors made from the same arrays), the pose disks, the sketch face
with and without its transforms, the face identities, the video clips, the
OCR strips and the QAT labels.  Small draws: a few samples each."""
import numpy as np
import pytest
import torch

from demo.face_recognition import accuracy_check as RF
from demo.facial_landmark_detection import accuracy_check as RL
from demo.human_pose_estimation import accuracy_check as RP
from demo.image_classification import accuracy_check_qat as RQ
from demo.object_detection import accuracy_check_instance_seg as RI
from demo.object_detection import accuracy_sweep as RS
from demo.ocr import accuracy_check as RO
from demo.video_classification import accuracy_check as RV
from tests.test_torch_cls_attention import _few_threads  # noqa: F401
from tlxcv_tpu.data import ShapesDetection as JShapes
from tlxcv_tpu.models.ocr import CharTokenizer as JTok
from tlxcv_tpu_torch.data import ShapesDetection
from tlxcv_tpu_torch.demo.face_recognition import accuracy_check as PF
from tlxcv_tpu_torch.demo.facial_landmark_detection import \
    accuracy_check as PL
from tlxcv_tpu_torch.demo.human_pose_estimation import accuracy_check as PP
from tlxcv_tpu_torch.demo.image_classification import \
    accuracy_check_qat as PQ
from tlxcv_tpu_torch.demo.object_detection import \
    accuracy_check_instance_seg as PI
from tlxcv_tpu_torch.demo.object_detection import accuracy_sweep as PS
from tlxcv_tpu_torch.demo.ocr import accuracy_check as PO
from tlxcv_tpu_torch.demo.video_classification import accuracy_check as PV
from tlxcv_tpu_torch.models.ocr import CharTokenizer


def _same(got, want):
    """Bitwise equal arrays (or trees of them), dtypes' kinds alike."""
    if isinstance(want, dict):
        assert set(got) == set(want)
        for k in want:
            _same(got[k], want[k])
        return
    if isinstance(want, (tuple, list)) and not np.isscalar(want[0]):
        assert len(got) == len(want)
        for g, w in zip(got, want):
            _same(g, w)
        return
    got = got.numpy() if torch.is_tensor(got) else np.asarray(got)
    want = np.asarray(want)
    assert got.shape == want.shape
    assert got.dtype.kind == want.dtype.kind, (got.dtype, want.dtype)
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("seed", [0, 999])
def test_detection_batcher(seed):
    idxs = np.random.default_rng(seed).integers(0, 64, size=3)
    got = PS.batcher(ShapesDetection(num=64, size=128, seed=seed), idxs)
    want = RS.batcher(JShapes(num=64, size=128, seed=seed), idxs)
    _same(got[0], want[0])
    _same(got[1], want[1])


def test_instance_seg_batcher():
    idxs = [5, 0, 17]
    got = PI.batcher(ShapesDetection(num=32, size=128, seed=0,
                                     return_masks=True), idxs)
    want = RI.batcher(JShapes(num=32, size=128, seed=0, return_masks=True),
                      idxs)
    _same(got, want)


@pytest.mark.parametrize("adapter, size", [
    ("_tgt_norm_xyxy", 256), ("_tgt_norm_cxcywh", 128)])
def test_target_adapters(adapter, size):
    """SSD's normalised xyxy (at its 256^2), YOLOv3's and DETR's
    normalised cxcywh with w = h = 0 on padded rows."""
    import jax.numpy as jnp

    _, t = PS.batcher(ShapesDetection(num=8, size=size, seed=3), range(4))
    got = getattr(PS, adapter)({k: torch.from_numpy(v) for k, v in t.items()},
                               size)
    want = getattr(RS, adapter)({k: jnp.asarray(v) for k, v in t.items()},
                                size)
    _same(got, want)
    assert PS.TARGET_ADAPTERS.keys() == RS.TARGET_ADAPTERS.keys()
    for name, fn in PS.TARGET_ADAPTERS.items():
        assert fn.__name__ == RS.TARGET_ADAPTERS[name].__name__


def test_registry_matches_the_reference():
    """Every entry: steps, learning rate, floor and options."""
    assert list(PS.REGISTRY) == list(RS.REGISTRY)
    for name, entry in PS.REGISTRY.items():
        assert entry[1:] == RS.REGISTRY[name][1:], name
    assert (PS.SIZE, PS.M, PS.B, PS.NC) == (RS.SIZE, RS.M, RS.B, RS.NC)
    assert PI.FLOORS == RI.FLOORS


def test_pose_disks():
    _same(PP.sample(np.random.default_rng(0), 3),
          RP.sample(np.random.default_rng(0), 3))


@pytest.mark.parametrize("augment", [False, True])
def test_sketch_face_and_its_transforms(augment):
    got_rng, want_rng = np.random.default_rng(0), np.random.default_rng(0)
    got = PL.sample(got_rng, 4, augments=(PL.augment_pipeline(got_rng)
                                          if augment else None))
    want = RL.sample(want_rng, 4, augments=(RL._augment_pipeline(want_rng)
                                            if augment else None))
    _same(got, want)
    _same(PL.TEMPLATE, RL.TEMPLATE)


def test_face_identities():
    for seed in (0, 3, 10000):
        _same(PF.identity_template(seed), RF.identity_template(seed))
    _same(PF.render(5, np.random.default_rng(1)),
          RF.render(5, np.random.default_rng(1)))
    got = PF.batch(np.random.default_rng(0), 3, list(range(64)))
    want = RF.batch(np.random.default_rng(0), 3, list(range(64)))
    _same(got[0], want[0])
    _same(got[1], want[1])


def test_video_clips():
    got_rng, want_rng = np.random.default_rng(0), np.random.default_rng(0)
    for _ in range(2):
        frames, label = PV.clip(got_rng)
        want_frames, want_label = RV.clip(want_rng)
        _same(frames, want_frames)
        assert label == want_label


def test_ocr_strips():
    _same(PO.render(np.random.default_rng(2), "40917"),
          RO.render(np.random.default_rng(2), "40917"))
    got = PO.sample(np.random.default_rng(0), CharTokenizer(), 3)
    want = RO.sample(np.random.default_rng(0), JTok(), 3)
    _same(got[0], want[0])
    _same(got[1], want[1])
    assert got[2] == want[2]


def test_qat_labels():
    """The class of each image's largest box, through ``make_data``'s
    batches (the reference's ``label_of`` lives inside it)."""
    train, rq_as_xy, _, _ = RQ.make_data()
    idxs = np.random.default_rng(0).integers(0, 4096, size=6)
    got = PQ.as_xy(PQ.make_data(val_num=4)[0], idxs)
    _same(got, rq_as_xy(train, idxs))
