"""Pose HRNet and PFLD of the port against the JAX package on the CPU:
the forwards (weights and BatchNorm statistics carried across by the
bridge), the losses, the heatmap targets, the decode and the metrics, and
a short overfit of each, as tests/test_pose_landmark_training.py does in
JAX.

Tolerances: forwards within 2e-4 of the largest output (f32, summation
order through about 60 layers); losses within 1e-5 relative; heatmap
targets within 1e-6 (the two exponentials); the decode, PCK and NME exact
(numpy on the same arrays)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tlxcv_tpu import nn as jnn
from tlxcv_tpu.core import pure, split
from tlxcv_tpu.models.backbones.hrnet import HRNet as JHRNet
from tlxcv_tpu.models.facial_landmark_detection import PFLD as JPFLD
from tlxcv_tpu.models.facial_landmark_detection import pfld_loss as j_pfld_loss
from tlxcv_tpu.models.human_pose_estimation import PoseHighResolutionNet as JPose
from tlxcv_tpu.models.human_pose_estimation import \
    heatmap_mse_loss as j_heatmap_mse_loss
from tlxcv_tpu.tasks import NME as JNME
from tlxcv_tpu.tasks import PCK as JPCK
from tlxcv_tpu.tasks.human_pose_estimation import \
    GenerateTarget as JGenerateTarget
from tlxcv_tpu.tasks.human_pose_estimation import \
    generate_heatmap_target as j_generate_heatmap_target
from tlxcv_tpu.tasks.human_pose_estimation import \
    get_max_preds as j_get_max_preds
from tlxcv_tpu_torch import create_model, list_models
from tlxcv_tpu_torch.models.backbones.hrnet import HRNet
from tlxcv_tpu_torch.models.facial_landmark_detection import PFLD, pfld_loss
from tlxcv_tpu_torch.models.human_pose_estimation import (
    PoseHighResolutionNet, heatmap_mse_loss)
from tlxcv_tpu_torch.tasks import (NME, PCK, FacialLandmarkDetection,
                                   GenerateTarget, HumanPoseEstimation,
                                   generate_heatmap_target, get_max_preds)
from tlxcv_tpu_torch.train import Trainer, optimizers
from tlxcv_tpu_torch.utils import load_jax_params

MICRO = dict(stage1_num_modules=1, stage1_num_blocks=(1,),
             stage1_num_channels=(8,),
             stage2_num_modules=1, stage2_num_blocks=(1, 1),
             stage2_num_channels=(8, 16),
             stage3_num_modules=1, stage3_num_blocks=(1, 1, 1),
             stage3_num_channels=(8, 16, 32),
             stage4_num_modules=1, stage4_num_blocks=(1, 1, 1, 1),
             stage4_num_channels=(8, 16, 32, 64))


@pytest.fixture(autouse=True, scope="module")
def _two_torch_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _random_bn(jm, rng):
    for _, mod in jm.modules():
        if isinstance(mod, jnn.BatchNorm):
            c = mod.running_mean.value.shape[0]
            mod.running_mean.value = jnp.asarray(
                rng.normal(scale=0.2, size=(c,)), jnp.float32)
            mod.running_var.value = jnp.asarray(
                rng.uniform(0.5, 2.0, size=(c,)), jnp.float32)


def _carry(jm, tm):
    params, state = split(jm)
    load_jax_params(tm, {k: np.asarray(v) for k, v in
                         {**params, **state}.items()}, strict=True)
    return tm


def _close(got, want, rel=2e-4):
    want = np.asarray(want, np.float32)
    got = got.detach().numpy() if torch.is_tensor(got) else got
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=rel * np.abs(want).max())


def _pose_pair(rng, joints=4):
    jm = JPose(num_joints=joints, backbone=JHRNet(**MICRO))
    _random_bn(jm, rng)
    tm = PoseHighResolutionNet(num_joints=joints,
                               backbone=HRNet(**MICRO, device="cpu"),
                               device="cpu")
    return jm, _carry(jm, tm)


def _pfld_pair(rng):
    jm = JPFLD()
    _random_bn(jm, rng)
    return jm, _carry(jm, PFLD(device="cpu"))


@pytest.mark.parametrize("training", [False, True])
def test_pose_hrnet_forward_matches_jax(rng, training):
    jm, tm = _pose_pair(rng)
    x = rng.normal(size=(2, 64, 64, 3)).astype(np.float32)
    want, _ = pure(jm)(*split(jm), jnp.asarray(x), training=training)
    tm.train(training)
    with torch.no_grad():
        got = tm(torch.from_numpy(x))
    assert got.shape == (2, 16, 16, 4)
    _close(got, want)


def test_pose_final_layer_is_normal_0_001_from_the_generator():
    """MMPose's head init: normal(0.001) drawn from the caller's
    generator, zero bias; the W32 default backbone's first branch feeds
    it."""
    def build(seed):
        return PoseHighResolutionNet(
            num_joints=17, backbone=HRNet(**MICRO, device="cpu"),
            device="cpu", generator=torch.Generator().manual_seed(seed))

    a, b = build(3), build(3)
    w = a.final_layer.weight
    assert w.shape == (17, 8, 1, 1) and torch.equal(w, b.final_layer.weight)
    assert 0.0005 < w.std().item() < 0.0015
    assert not a.final_layer.bias.any()
    assert not torch.equal(w, build(4).final_layer.weight)


@pytest.mark.parametrize("training", [False, True])
def test_pfld_forward_matches_jax(rng, training):
    """Landmarks (``fc`` over the three scales flattened in NHWC order),
    the 28^2 features and the auxiliary net's angles at 112^2."""
    jm, tm = _pfld_pair(rng)
    x = rng.normal(size=(2, 112, 112, 3)).astype(np.float32)
    (want_lm, want_ft), _ = pure(jm)(*split(jm), jnp.asarray(x),
                                     training=training)
    want_ang, _ = pure(jm, lambda m, f: m.auxiliarynet(f))(
        *split(jm), want_ft, training=training)
    tm.train(training)
    with torch.no_grad():
        lm, ft = tm(torch.from_numpy(x))
        ang = tm.auxiliarynet(torch.from_numpy(np.array(want_ft)))
    assert lm.shape == (2, 136) and ft.shape == (2, 28, 28, 64)
    assert tm.backbone.fc.weight.shape == (136, 4832)
    _close(lm, want_lm)
    _close(ft, want_ft)
    _close(ang, want_ang)


def test_losses_match_jax(rng):
    out = rng.normal(size=(2, 16, 12, 5)).astype(np.float32)
    tgt = rng.random((2, 16, 12, 5)).astype(np.float32)
    tw = (rng.random((2, 5, 1)) > 0.3).astype(np.float32)
    for w in (None, tw, tw[..., 0]):
        want = float(j_heatmap_mse_loss(
            jnp.asarray(out), jnp.asarray(tgt),
            None if w is None else jnp.asarray(w)))
        got = heatmap_mse_loss(torch.from_numpy(out), torch.from_numpy(tgt),
                               None if w is None else torch.from_numpy(w))
        assert abs(got.item() - want) <= 1e-5 * abs(want)
    lm, lm_gt = (rng.random((4, 136)).astype(np.float32) for _ in range(2))
    ang, eul = (rng.normal(size=(4, 3)).astype(np.float32) for _ in range(2))
    attr = (rng.random((4, 6)) > 0.6).astype(np.int32)
    attr[:, 0] = 0  # an attribute no sample has: weight = the batch size
    for a in (None, attr):
        want = float(j_pfld_loss(*map(jnp.asarray, (lm, ang, lm_gt, eul)),
                                 None if a is None else jnp.asarray(a)))
        got = pfld_loss(*map(torch.from_numpy, (lm, ang, lm_gt, eul)),
                        None if a is None else torch.from_numpy(a))
        assert abs(got.item() - want) <= 1e-5 * abs(want)


def test_task_and_model_losses_take_every_target_form(rng):
    _, tm = _pose_pair(rng)
    task = HumanPoseEstimation(tm)
    out = torch.from_numpy(rng.normal(size=(2, 16, 16, 4)).astype(np.float32))
    tgt = torch.rand(2, 16, 16, 4)
    tw = torch.ones(2, 4)
    tw[0, 1] = 0.0
    want = heatmap_mse_loss(out, tgt, tw)
    for form in ((tgt, tw), [tgt, tw], {"target": tgt, "target_weight": tw}):
        assert torch.equal(tm.loss_fn(out, form), want)
    assert torch.equal(task.loss_fn(out, (tgt, tw)), want)
    assert torch.equal(tm.loss_fn(out, {"target": tgt}),
                       heatmap_mse_loss(out, tgt))
    x = torch.from_numpy(rng.normal(size=(1, 64, 64, 3)).astype(np.float32))
    with torch.no_grad():
        assert torch.equal(task.eval().predict(x), tm(x))


@pytest.mark.parametrize("hw", [(64, 48), (64, 64)])
def test_heatmap_targets_match_jax_and_the_host_transform(rng, hw):
    """The torch target on the keypoints' device against the JAX package's
    (1e-6) and against ``GenerateTarget`` in numpy, the reference's and the
    port's (equal), with joints outside, on the edge and invisible."""
    j, size = 17, (hw[0] * 4, hw[1] * 4)
    kp = np.concatenate([rng.uniform(-30, size[1] + 30, (3, j, 1)),
                         rng.uniform(-30, size[0] + 30, (3, j, 1)),
                         rng.integers(0, 3, (3, j, 1))], -1).astype(
        np.float32)
    kp[0, 0, :2] = [size[1] + 3 * 2 * 4 + 3, 10.0]  # just outside
    want_t, want_w = j_generate_heatmap_target(jnp.asarray(kp), size, hw, 2.0)
    got_t, got_w = generate_heatmap_target(torch.from_numpy(kp), size, hw, 2.0)
    assert got_t.shape == (3, *hw, j) and got_w.shape == (3, j)
    np.testing.assert_array_equal(got_w.numpy(), np.asarray(want_w))
    np.testing.assert_allclose(got_t.numpy(), np.asarray(want_t), rtol=0,
                               atol=1e-6)
    for i in range(3):
        _, (ht, hwt) = GenerateTarget(size, j, hw, 2)((None, kp[i]))
        _, (jt, jwt) = JGenerateTarget(size, j, hw, 2)((None, kp[i]))
        np.testing.assert_array_equal(ht, jt)
        np.testing.assert_array_equal(hwt, jwt)
        np.testing.assert_allclose(got_t[i].numpy(), ht, rtol=0, atol=1e-6)
    with pytest.raises(ValueError, match="joints"):
        GenerateTarget(size, j + 1, hw, 2)((None, kp[0]))


def test_decode_and_metrics_match_jax(rng):
    hm = rng.normal(size=(3, 16, 12, 5)).astype(np.float32)
    hm[0, :, :, 2] = -1.0  # no peak above 0: decoded as -1
    true = rng.normal(size=(3, 16, 12, 5)).astype(np.float32)
    got, gval = get_max_preds(torch.from_numpy(hm).numpy())
    want, wval = j_get_max_preds(hm)
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(gval, wval)
    for thr in (0.05, 0.2):
        p, jp = PCK(thr), JPCK(thr)
        p.update(torch.from_numpy(hm), (torch.from_numpy(true), None))
        jp.update(hm, (true, None))
        p.update(hm, true)
        jp.update(hm, true)
        assert p.result() == jp.result() and p.total == jp.total
        p.reset()
        assert p.result() == 0.0
    lm = rng.uniform(0, 112, size=(4, 136)).astype(np.float32)
    gt = rng.uniform(0, 112, size=(4, 136)).astype(np.float32)
    for points in (68, 20):
        n, jn = NME(points), JNME(points)
        n.update((torch.from_numpy(lm), None), torch.from_numpy(gt))
        jn.update((lm, None), gt)
        assert n.result() == jn.result()


def test_registry():
    assert "pose_hrnet_w32" in list_models() and "pfld" in list_models()
    pose = create_model("pose_hrnet_w32", device="cpu")
    assert isinstance(pose, PoseHighResolutionNet)
    assert pose.backbone.branch_channels == [32, 64, 128, 256]
    assert pose.final_layer.weight.shape == (17, 32, 1, 1)
    assert isinstance(create_model("pfld", device="cpu"), PFLD)


def test_draw_landmarks_matches_jax(rng):
    """Drawing needs OpenCV, imported lazily: skipped where it is
    absent."""
    cv2 = pytest.importorskip("cv2")
    from tlxcv_tpu.tasks.facial_landmark_detection import \
        draw_landmarks as j_draw
    from tlxcv_tpu_torch.tasks.facial_landmark_detection import \
        draw_landmarks

    img = np.zeros((32, 32, 3), np.uint8)
    pts = rng.uniform(0, 32, size=(10,)).astype(np.float32)
    assert cv2 is not None
    np.testing.assert_array_equal(draw_landmarks(img, pts), j_draw(img, pts))


def _gaussian_heatmaps(joints, hw, sigma=1.5):
    b, j, _ = joints.shape
    h, w = hw
    ys = np.arange(h)[:, None]
    xs = np.arange(w)[None, :]
    maps = np.zeros((b, h, w, j), np.float32)
    for bi in range(b):
        for ji in range(j):
            cx, cy = joints[bi, ji] * [w, h]
            maps[bi, :, :, ji] = np.exp(-((xs - cx) ** 2 + (ys - cy) ** 2)
                                        / (2 * sigma ** 2))
    return maps


def test_pose_hrnet_overfits_to_pck(rng):
    """The JAX package's overfit: the micro pose HRNet on 2 images, 160
    Adam(2e-3) steps through the port's Trainer, PCK@0.5 above 0.9 and the
    decoded peaks within 1.5 heatmap pixels."""
    torch.manual_seed(0)
    model = PoseHighResolutionNet(
        num_joints=4, backbone=HRNet(**MICRO, device="cpu",
                                     generator=torch.Generator()
                                     .manual_seed(0)), device="cpu",
        generator=torch.Generator().manual_seed(1))
    x = rng.normal(size=(2, 64, 64, 3)).astype(np.float32)
    joints = rng.uniform(0.2, 0.8, size=(2, 4, 2))
    target = _gaussian_heatmaps(joints, (16, 16))
    trainer = Trainer(HumanPoseEstimation(model),
                      optimizer=optimizers.Adam(2e-3), device="cpu")
    batch = trainer._put_batch((x, target))
    for _ in range(160):
        trainer._train_step(*batch)
    out = trainer.predict(x).numpy()
    pck = PCK(threshold=0.5)
    pck.update(out, target)
    assert pck.result() > 0.9, pck.result()
    pred_xy, _ = get_max_preds(out)
    gt_xy, _ = get_max_preds(target)
    assert np.abs(pred_xy - gt_xy).max() <= 1.5


def test_pfld_overfits_to_nme(rng):
    """The JAX package's overfit: PFLD with its auxiliary net in the loss
    on 2 images, Adam(3e-3) steps through the port's Trainer, NME below
    0.05 read in train mode, as there (eval-mode BatchNorm on a 2-image
    memorisation differs by the unbiased variance's n/(n-1)).  150 steps
    where the JAX test takes 250: on this seed the port's NME reads 0.039
    at step 125 and 0.011 at 150."""
    torch.manual_seed(0)
    task = FacialLandmarkDetection(PFLD(
        device="cpu", generator=torch.Generator().manual_seed(0)))
    x = rng.normal(size=(2, 112, 112, 3)).astype(np.float32)
    lm = rng.uniform(0.2, 0.8, size=(2, 68 * 2)).astype(np.float32)
    euler = rng.normal(size=(2, 3)).astype(np.float32) * 10
    trainer = Trainer(task, optimizer=optimizers.Adam(3e-3), device="cpu")
    batch = trainer._put_batch((x, (lm, euler)))
    for _ in range(150):
        trainer._train_step(*batch)
    with torch.no_grad():
        pred_lm, _ = torch.func.functional_call(
            task.train(), trainer.params, (batch[0],))
    nme = NME()
    nme.update(pred_lm.numpy(), lm)
    assert nme.result() < 0.05, nme.result()
