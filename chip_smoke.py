#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port on one NVIDIA GPU, end to end.

    python3 chip_smoke.py          # from the root of the repository
    python3 chip_smoke.py --profile   # adds per-kernel device-time profiles
                                      # and the idle shares of Mask R-CNN,
                                      # YOLOv3, ViT-B/16 int8, HRNet-W18
                                      # seg, Swin-B, DETR-R50, PP-YOLOE-L,
                                      # SSD, FCOS-R50 and FCOS-DCN-R50
                                      # (with the deformable sampler's
                                      # device time), the segmentation and
                                      # remote-sensing legs, pose
                                      # HRNet-W32, PFLD and the QAT-served
                                      # ResNet-50, served, and of the
                                      # training steps of Mask R-CNN and of
                                      # the training legs
    python3 chip_smoke.py --kernels   # only the flash-attention and bf16
                                      # GEMM kernels, checked, timed and
                                      # profiled, the GEMM probe, and
                                      # ViT-B/16; no contract line
    python3 chip_smoke.py --vit       # only ViT-B/16, checked and served
                                      # (to compare two trees: copy this
                                      # file into the other's root)
    python3 chip_smoke.py --int8      # only the int8 GEMM (both routes,
                                      # checked and timed), the int8
                                      # ResNet-50, YOLOv3 and ViT-B/16
                                      # legs, checked and served, and the
                                      # grouped int8 conv; with --profile,
                                      # their device-time profiles; no
                                      # contract line
    python3 chip_smoke.py --seg       # only HRNet-W18 segmentation, both
                                      # graphs checked and served
    python3 chip_smoke.py --segmentation  # only flash attention at the
                                      # head dims it pads (BIT's grids and
                                      # D from 2 to 112, forward and
                                      # backward) and the segmentation zoo
                                      # and BIT, checked and served; no
                                      # contract line
    python3 chip_smoke.py --remote-sensing  # only the remote-sensing
                                      # legs (FC-EF, CDNet, SNUNet, DSIFN,
                                      # STANet BAM and PAM, DSAMNet, FCCDN,
                                      # FarSeg, the PaddleRS UNet), checked
                                      # and served; no contract line
    python3 chip_smoke.py --transformers  # only DeiT-B and Swin-B
    python3 chip_smoke.py --detectors # only the flash kernel's checks and
                                      # times (DETR's grids among them) and
                                      # DETR-R50, PP-YOLOE-L, SSD, FCOS-R50
                                      # and FCOS-DCN-R50, checked and
                                      # served, then the --zoo legs; no
                                      # contract line
    python3 chip_smoke.py --classification  # only the first half of the
                                      # classification zoo (TNT-S through
                                      # flash, PP-HGNet, PVTv2, Twins, CSWin,
                                      # LeViT, ConvNeXt, VAN, RedNet,
                                      # SE-ResNeXt also in int8, ResNeSt,
                                      # Res2Net, RegNets, mobile nets),
                                      # checked and served, and flash at
                                      # TNT-S's grids; no contract line
    python3 chip_smoke.py --classic   # only the classic CNNs (AlexNet,
                                      # VGG-16, GoogLeNet, SqueezeNet 1.1,
                                      # DenseNet-121, ShuffleNetV2, ESNet,
                                      # PP-LCNetV2, MixNet-S, ReXNet,
                                      # PeleeNet, HarDNet-68, DPN-68,
                                      # DLA-34, Inception-v3, Xception-41,
                                      # Xception-65 DeepLab, CSPDarkNet-53),
                                      # checked and served; no contract line
    python3 chip_smoke.py --faces     # only RetinaFace-R50 (through the
                                      # upsample-add kernel) and ArcFace-R50,
                                      # checked and served; with
                                      # --classic, both; no contract line
    python3 chip_smoke.py --sequence  # only flash at the grids of TrOCR
                                      # and DeiT-B (forward and backward),
                                      # I3D, TrOCR (greedy, beam, teacher
                                      # forcing), DeiT-B distilled from
                                      # RegNetY-4GF, RetinaFace-R50 and
                                      # ArcFace-R50 trained; no contract
                                      # line
    python3 chip_smoke.py --zoo       # only the detection zoo (RetinaNet,
                                      # GFL, TOOD, Faster and Cascade
                                      # R-CNN, YOLOX-s, CenterNet, TTFNet,
                                      # PicoDet, SOLOv2), checked and
                                      # served, and FCOS-R50 trained; no
                                      # contract line
    python3 chip_smoke.py --mask-rcnn # only the row gather and the
                                      # upsample-add, checked and timed, and
                                      # Mask R-CNN, checked and served; with
                                      # --profile, its device time and idle
                                      # share (copy this file into another
                                      # tree's root to compare the two)
    python3 chip_smoke.py --training  # only the training legs: the flash
                                      # backward's checks and times, ViT-B/16,
                                      # DETR-R50, PP-YOLOE-L and SSD
                                      # trained, HRNet-W32 pose and PFLD
                                      # (checked, served, trained), a
                                      # train-state checkpoint resumed,
                                      # YOLOv3 training and the QAT-served
                                      # ResNet-50, and the int8 attention's
                                      # P.V product past 1040 keys; no
                                      # contract line
    python3 chip_smoke.py --train-attention  # only the flash backward's
                                      # checks and times and the ViT-B/16,
                                      # DETR-R50, PP-YOLOE-L and SSD
                                      # training legs; no contract line
    python3 chip_smoke.py --resize    # only the three resize kernels: the
                                      # upsample-add, the transposed resize
                                      # and the 2x upsample's forward and
                                      # VJP, checked; the 2x kernels timed
                                      # beside the transposed resize on the
                                      # 2x taps; no contract line
    python3 chip_smoke.py --data      # only the data and utility layers
                                      # (phase 20; with --profile, each
                                      # export profiled beside its eager
                                      # twin); no contract line
    python3 chip_smoke.py --dispatch  # only the flash wrapper's host cost
                                      # at TrOCR's decode grids and the
                                      # registration routes' dispatch cost
                                      # (builds only the flash kernel; copy
                                      # this file into another tree's root
                                      # to measure that tree)
    python3 chip_smoke.py --accuracy [name ...] [--out-dir DIR]
                                      # only the hermetic accuracy checks
                                      # (tlxcv_tpu_torch/demo/*/accuracy_
                                      # check*.py), trained from random
                                      # weights at the reference's
                                      # schedules: fcos maskrcnn solov2
                                      # pose pfld face video ocr qat (the
                                      # default), sweep:<entry>[,...],
                                      # sweep-int8:<entry>, detr_r50; one
                                      # JSON line a check (metric, value,
                                      # floor, steps, seconds, launches);
                                      # results files beside the scripts
                                      # or in DIR; exits non-zero if any
                                      # check misses its floor, raises or
                                      # does not reach its kernels; ends on
                                      # the contract line

Phases, one JSON line each; any failure raises and exits non-zero:

1. environment: the card (nvidia-smi name and power limit), torch and
   CUDA versions; every kernel under tlxcv_tpu_torch/csrc/ is built with
   nvcc for sm_90a, one nvcc per source, all started together.
2. kernels: each kernel against its plain PyTorch version on the card, at
   the main path's shapes and at the edge cases of its contract (flash
   attention also at the served DeiT-B b64 (S = 198) and int8 ViT-B/16
   b256 grids, at DETR-R50's three b8 grids as its layers hand them over
   ([64, 1050, 1050, 32] encoder, [64, 100, 100, 32] decoder self,
   [64, Sq = 100, Sk = 1050, 32] cross), at S = 1, 65, 129 and 577 for
   every head dim, and with a key length of its own, Sq in {1, 100} and
   Sk in {1, 63, 65, 1050} for every head dim with and without bias; the
   int8
   GEMM's fused epilogue bitwise for every output kind, with and without
   bias, N from 1 to 1000, Kp from 16 to 4608, ties), with the
   tolerance and its reason; then the kernel's, the plain version's and
   the library call's times beside the bound (flash attention and the
   bf16 GEMM: device time from CUDA-graph replays, and CUDA events around
   each call beside it, flash attention also at DETR's three grids beside
   ``F.scaled_dot_product_attention``; the others: CUDA events, medians).
3. model: ViT-B/16 at full width and depth, random weights from a seed,
   built by ``create_model`` on the card.  f32 and bf16 logits against
   the same weights run in f32 on the CPU; exactly 12 attention kernel
   launches per forward; then the ViT path, b64 bf16 ``predict``, is
   served and timed.
4. ResNet-50 (``create_model("resnet50")``, random weights and BatchNorm
   statistics from a seed): f32 and bf16 logits on the card against f32
   on the CPU; ``quantize_for_serving`` on the CPU in f32 with 4
   calibration images, as the JAX package's bench does; the int8 model on
   the card against the same int8 model on the CPU (plain int8 GEMM),
   with exactly 54 int8 GEMM launches per forward (each int8 layer one
   launch of the kernel with its requantize epilogue fused).  Then both
   paths, b256 bf16 ``predict`` on cuDNN and full int8 through the kernel,
   are served and timed, and the int8 GEMM is checked and timed at every
   shape of the int8 forward in both routes: the int32 contract beside
   ``torch._int_mm``, and the fused epilogue with each layer's own scale,
   bias, ReLU and output dtype beside ``torch._int_mm`` plus the PyTorch
   epilogue, each with its bound.
5. Mask R-CNN (``create_model("mask_rcnn")``: ResNet-50 + FPN, 80
   classes, random weights and BatchNorm statistics from a seed): the row
   gather and the upsample-add kernels against their plain versions first
   (phase 2); then f32 and bf16 at b2 640^2 against f32 on the CPU, stage
   by stage (FPN levels, RPN logits and deltas, box-head and mask logits
   on the CPU's proposals and detections, the share of the CPU's
   detections reproduced, a count > 0 per image); then the bench leg, b16
   640^2 bf16 ``predict``, served and timed with exactly 2 gather and 3
   upsample-add launches per forward, and both kernels timed on the inputs
   one served forward hands them (device time from CUDA-graph replays).
6. bf16_kernels and probe (run after phase 2's int8 GEMM): the bf16 GEMM
   (``csrc/bf16_matmul.cu``) against its plain version at 4096^3, ragged
   M and N, one row, one column and a padded K, within one bf16 ulp (plus
   the f32 reordering bound near zero; integer operands bitwise), and its
   time beside ``torch.matmul``'s and the bound; then the port of the
   demo's GEMM probe
   (``tlxcv_tpu_torch.demo.image_classification.probe_int8_gemm``) at the
   reference's sizes, which must launch both GEMM kernels.
7. YOLOv3 (``create_model("yolov3", num_classes=80, use_matrix_nms=True)``,
   random weights from a seed, BatchNorm statistics from one train-mode
   forward of 2 seeded images on the CPU): f32 and bf16 at
   b2 416^2 against f32 on the CPU, stage by stage (the three head
   outputs, the decoded boxes and scores, the NMS on the CPU's decoded
   boxes, the share of the CPU's detections reproduced, a count > 0 per
   image); int8 (``quantize_weights``, ``calibrate_activations`` through
   ``head_outputs``, on the CPU) on the card against int8 on the CPU at
   b1, every layer bitwise on the CPU's inputs, exactly 75 GEMM launches
   per forward; then the bench legs ``yolov3`` and ``yolov3_int8``, b128
   416^2 ``predict``, served and timed, and the int8 GEMM timed at every
   shape of the int8 forward.
8. train_kernels (run with phase 2): the transposed resize
   (``csrc/sep_resize.cu``, the FPN upsample-add's backward) against its
   plain version, bitwise, at the FPN backward's b8 shapes, 38 -> 75 at
   C = 3, 8 and 256, a stride-0 and a permuted gradient.  Then
   upsample2x_kernels: the 2x bilinear upsample's forward and VJP kernels
   (``csrc/upsample2x.cu``, on no model's path) against their plain
   versions, bitwise, at H, W in {1, 2, 3}, 5 x 7, C = 3, 4, 6, 8 and
   256, [8, 80, 80, 256], stride-0, permuted and sliced inputs, in bf16
   and f32; ``upsample2x_fused`` forward and backward at [8, 80, 80, 256]
   bf16 with the counts set to 0 just before (one launch of each kernel,
   nothing else); both timed at [8, 80, 80, 256] bf16 and f32 and
   [8, 160, 160, 256] bf16 (CUDA-graph replays, events, and with the L2
   flushed before each call) beside the generic route (``sep_resize`` on
   the 2x taps, which the 2x path used before its own kernels), the plain
   versions, the library calls and the bounds.
9. train_check: gradients on the card against f32 on the CPU, through the
   Trainer's compute policy: Mask R-CNN at b2 640^2 (the CPU's proposals
   substituted straight through) and ResNet-50 at b4, in f32 and bf16; the
   loss and one parameter of each part of the model within stated bounds,
   and every parameter with a CPU gradient given one on the card.
10. train: ``Trainer.train`` with bf16 compute and f32 masters.  Mask R-CNN
    b8 640^2 on ``ShapesDetection`` (20 steps on one batch, the loss must
    fall; then 3 warm-up and ``TRAIN_STEPS`` timed steps, exactly 3
    upsample-add, 3 transposed-resize and 2 gather launches per step) and
    ResNet-50 b256
    (the bench's training leg, the same counts, no kernel of ours); train
    img/s, step ms and peak memory; the transposed resize timed on the
    gradients one step hands it.
11. (run after phase 7) vit_int8: ViT-B/16 quantized as the JAX
    package's bench leg does (``quantize_weights``, then
    ``calibrate_activations`` on 4 images, on the CPU), checked against
    the CPU layer by layer and end to end (``vit_int8_check``) with float
    and with int8 attention, 50 int8 GEMM and 12 flash launches a
    forward; the int8 attention's products bitwise at [256, 12, 197, 64]
    with TF32 on globally; served at b256 with either attention, and the
    int8 GEMM timed at every shape of the forward.  grouped_int8: a
    grouped int8 conv at ResNeXt-50's 3x3 (32 groups, b32 56^2, bf16)
    bitwise against the CPU, 32 launches, timed.  hrnet_seg: HRNet-W18
    segmentation at b1 512^2 against the CPU, converted to space-to-depth
    branches and not, then both graphs served at b16 512^2 bf16.
    transformers: DeiT-B (12 flash launches a forward) and Swin-B (window
    packs 2 and 1, no launch of ours) at b2 against the CPU, served at
    b64 bf16.
12. (run after phase 11) detectors: DETR-R50 (b2 800x1344 against the
    CPU stage by stage: encoder memory, decoder output, logits and boxes;
    exactly 18 flash launches a forward: 6 encoder, 6 decoder self- and 6
    cross-attention), PP-YOLOE-L (b2 640^2) and SSD-MobileNetV1 (b2
    300^2; both: head outputs, decoded boxes, the decode and the NMS
    alone on the CPU's inputs, the matched share, a count > 0 per image),
    in f32 and bf16, then served in bf16: DETR-R50 b8 800x1344, PP-YOLOE-L
    b32 640^2, SSD b128 300^2 (``phase_detectors`` says how their random
    weights and statistics are drawn).  FCOS-R50 and FCOS-DCN-R50 (b2
    320x544 stage by stage as PP-YOLOE-L; ``loss_fn`` at b2 on seeded
    boxes and the FPN at an unpadded 800x1333 in f32; the card's bf16
    detections against the CPU's NMS of the card's own head outputs),
    served in bf16 at b8 800x1344; with ``--profile`` the deformable
    sampler's device time a forward (``fcos_legs``).  Then the rest of the
    detection zoo (``ZOO_LEGS``: RetinaNet, GFL and TOOD b8 800x1344,
    Faster and Cascade R-CNN b16 640^2, YOLOX-s b64 640^2, CenterNet and
    TTFNet b32 512^2, PicoDet b64 416^2, SOLOv2 b8 800x1344), each checked
    at b2 on a smaller frame (``zoo_check``: every head output under the
    chaotic-net rule in f32 and bf16, the CPU's decode and NMS of the
    card's own heads, a count > 0 an image) and served in bf16, with
    exactly 1 row gather a Faster R-CNN forward, 3 a Cascade one and 3
    upsample-adds a forward of each and of SOLOv2 (``zoo_legs``); and
    FCOS-R50 trained, gradients at b2 against the CPU, then b8 800x1344
    through ``Trainer.train`` (``leg_fcos_train``).

13. (run after phase 10) training legs: HRNet-W32 pose (17 joints,
    256x192, 64x48 heatmaps, sigma 2) and PFLD (68 landmarks, 112^2),
    each checked at b2 / b4 against the CPU in f32 and bf16 (the pose's
    argmax decode where it is decided), served in bf16 (b64, b256), its
    gradients against the CPU (``train_check``), its loss falling on one
    batch and trained through ``Trainer.train`` (b32, b256; PFLD with its
    auxiliary net in the loss), no kernel of ours; a full train-state
    checkpoint of the pose trainer saved after 5 steps, restored bitwise
    into a fresh Trainer and run on; YOLOv3 training (targets built on
    the card bitwise the CPU's, gradients, a falling loss, b32 416^2 on
    ``ShapesDetection``); ResNet-50 QAT (``enable_qat``,
    ``calibrate_activations``, a fine-tune at b64, ``qat_serving_convert``)
    served in full int8 at b256, 54 ``int8_matmul`` launches a forward,
    each int8 layer bitwise the CPU's.  The int8 attention's P.V product
    at DETR-R50's encoder grid (1050 keys) is checked with phase 11.

14. (right after phase 2) flash_backward: the flash-attention backward
    kernel (``csrc/flash_attention_bwd.cu``) against its plain version at
    ViT-B/16's b64 grid and DETR-R50's three training b4 grids and at the
    edges of its 64-row tiles (Sq and Sk from 1 to 197 each way, every
    head dim, ViT's packed views), bf16 and f32, without a bias, with one
    shared by the heads or one per head, and with a row masked at every
    key, in f32 also against SDPA's gradients; two runs bitwise; timed
    beside the plain version, SDPA's backward (its aten op, graph replays
    as the kernel, and one ``autograd.grad``, events) and the bound, each
    of its kernels profiled, and the forward with and without the
    log-sum-exp it writes for the backward.  (run after phase
    10) attention training legs: ViT-B/16 b64 224^2 (12 flash forward and
    12 backward launches a step), DETR-R50 b4 at 800x1344 with its
    Hungarian loss (18 and 18; the match's host time a step), PP-YOLOE-L
    b16 640^2 with both assigners and SSD-MobileNetV1 b32 300^2 (none of
    ours), each with gradients against the CPU (``train_check``), a loss
    falling on one batch and ``Trainer.train`` timed, bf16 over f32
    masters.

15. (run after phase 12) flash_padded: flash attention at head dims the
    kernel does not take, which its wrapper zero-pads to the next of 32,
    64, 96 and 128: BIT's two b32 grids ([256, 8, 8, 4] encoder, [256,
    1024 queries, 4 keys, 4] decoder) and D in {2, 4, 6, 8, 16, 24, 48,
    80, 112}, bf16 and f32, forward and backward against the plain
    versions at the real D, the backward bitwise over two runs; D = 129
    raises; BIT's grids timed beside SDPA and the bound of the unpadded
    bytes.  segmentation: the segmentation zoo built from the in-repo
    YAMLs by ``build_seg_model`` (BiSeNetV2, Fast-SCNN, ENet, UNet,
    DeepLabV3+ R50-vD, EncNet R101-vD, FastFCN R50-vD) and BIT, random
    weights from a seed, each checked at b1 on a reduced frame against
    the CPU in f32 and bf16, then served in bf16 (``phase_segmentation``
    gives the batches and frames); BIT with 17 flash launches a forward.

16. (run after phase 15) remote_sensing: FC-EF, CDNet, SNUNet (width
    32), DSIFN, STANet (BAM and PAM), DSAMNet and FCCDN as change
    detectors on pairs, FarSeg (ResNet-50, 16 classes) and the PaddleRS
    UNet, random weights from a seed, each checked at b1 on a frame of
    half the side against the CPU in f32 and bf16, then served in bf16
    (``phase_remote_sensing`` gives the batches and frames); no kernel of
    ours launched.

17. (run after phase 16) classification: flash attention at TNT-S's two
    b64 grids as its blocks hand them over (the inner one at head dim 6,
    padded to 32) against the plain version and timed beside SDPA; the
    first half of the classification zoo (``CLS_LEGS``: TNT-S, PP-HGNet,
    PVTv2-B2, Twins PCPVT-S and SVT-S, CSWin-T, LeViT-256, ConvNeXt-T,
    VAN-B1, RedNet-50, SE-ResNeXt-50, ResNeSt-50, Res2Net-50, RegNetX/Y-4GF
    at b64, MobileNetV2, V3-Large, EfficientNet-B0, GhostNet at b256, all
    224^2), random weights with their small starts drawn, each checked at
    b2 against the CPU (``float_logit_check``) and served in bf16, TNT-S
    with exactly 12 flash launches a forward; SE-ResNeXt-50 in full int8
    (``quantize_weights`` and ``calibrate_activations`` on the CPU), each
    int8 layer bitwise on the CPU's input, 582 int8 GEMM launches a
    forward (each 32-group 3x3 one a group), served at b64 and the GEMM
    timed at every shape of its forward (``phase_classification``).

18. (run after phase 17) classic: the classic CNNs (``CLASSIC_LEGS``:
    AlexNet, GoogLeNet, SqueezeNet 1.1, ShuffleNetV2 x1.0, ESNet x1.0,
    PP-LCNetV2, MixNet-S, ReXNet 1.0, PeleeNet at b256, VGG-16,
    DenseNet-121, HarDNet-68, DPN-68, DLA-34 at b64, all 224^2;
    Inception-v3, Xception-41 and Xception-65 DeepLab b64 299^2;
    CSPDarkNet-53 b64 256^2), random weights, BatchNorm statistics from
    data, each checked at b2 against the CPU and served in bf16, no launch
    of ours (``phase_classic``).  faces: RetinaFace-R50 checked at b1
    600^2 (the C4 -> C3 merge 38 -> 75, not 2x) against the CPU in f32 and
    bf16, its two FPN merges each one upsample-add launch, bitwise the
    plain version, the host's post-process (``tasks.face_recognition.
    post_process``) reproducing the CPU's faces both ways; served at b16
    640^2 in bf16, 2 launches a forward, the post-process of a served
    batch timed (its scores drawn for WIDER FACE's density, at random
    places) and the two merges timed beside their plain version,
    ``F.interpolate`` + add and the bound; ArcFace-R50's margin logits and
    loss at b2 128^2 against the CPU and its embeddings served at b256
    128^2 (``phase_faces``).

19. (run after phase 18) sequence: flash attention at the grids of this
    slice (``SEQUENCE_GRIDS``, bf16: TrOCR's encoder at b64, its teacher
    forcing at b32 under a shared causal bias and over the 577 memory
    tokens, its decode steps at b64, one query row over the 32-slot KV
    cache under a [1, 1, 32] bias and over the memory, DeiT-B's student
    at b64) against the plain version and timed beside SDPA; the backward
    at the training grids (``SEQUENCE_BACKWARD``, in the dtypes the
    Trainer's bf16 policy hands them).  I3D (157 classes): logits at b1
    16 x 112^2 against the CPU, served at b16 32 x 224^2, gradients at b1
    16 x 112^2, trained at b8 32 x 224^2 on the demo's loss.  TrOCR (the
    demo's: vocabulary 64,044, 384^2, 32 tokens): greedy (b4) and 4-beam
    (b2) tokens and the decode steps' logits along the CPU's tokens
    against the CPU (``trocr_check``), greedy served at b64 and beam at
    b16 (390 flash launches a generation), gradients at b2, trained by
    teacher forcing at b32 (18 + 18 launches a step).  DeiT-B distilled
    from RegNetY-4GF through ``teacher_labels`` at b64 (12 + 12).
    RetinaFace-R50 trained at b8 640^2 (2 upsample-add and 2 transposed
    resize launches a step, each timed alone) and ArcFace-R50 at b128
    128^2 with a margin warm-up; each training leg's gradients against
    the CPU first (``phase_sequence``).

20. (run last) data: the native resize/normalize (g++ at first use) at
    b256 uint8 500x375 -> 224^2 against its fallback, its host ms and the
    pinned copy to the card, the fused JPEG route where libjpeg built;
    ``Config``-built training with metrics (ResNet-50, 10 classes, b32 on
    CIFAR pickles the phase writes, with and without ``Accuracy``; the
    UNet of ``configs/unet_circles.yaml`` on Circles with ``MeanIoU``);
    ``configs/yolov3_coco.yaml``'s detector predicting at b8 on a 16-image
    COCO folder through the detection transforms, scored by
    ``CocoEvaluator`` (the ground truth as predictions scores 1.0), and the
    evaluator's host cost at 100 detections an image; ``torch.export``
    round trips on the card, bitwise the eager outputs (ViT-B/16 b64 bf16,
    12 flash launches a forward; full-int8 ResNet-50 b256, 54; SSD's
    predict at b128 300^2); ``record_features`` on ResNet-50 against the
    CPU, ``profiler.trace`` and ``benchmark_fn``; the flash wrapper's host
    cost at TrOCR's decode grids (``phase_data``).

Each path is driven with every kernel's launch count set to 0 just before
it and read just after.  The last three lines are the kernels' record, the
card, and the contract line ``{"ok": true, "device": {...}}``.  Without a
CUDA device the script exits non-zero before printing any result.
"""
from __future__ import annotations

import contextlib
import copy
import functools
import json
import math
import os
import statistics
import subprocess
import sys
import time

import torch

from tlxcv_tpu_torch.ops.cuda import launch_counts, reset_launches

HBM_BYTES_PER_S = 3.35e12       # H100 SXM data sheet
PEAK_OPS_PER_S = {torch.bfloat16: 989e12,  # dense tensor-core bf16
                  torch.float32: 67e12,    # f32 outside the tensor cores
                  torch.int8: 1979e12}     # dense tensor-core int8
# f32 attention runs its products on the tensor cores as split TF32
# (csrc/flash_attention.cuh): three TF32 products for each f32-accurate
# one, so its least time is three products at the dense TF32 rate, 495
# TFLOP/s.  Read only by the attention bounds; the FMA rate above stays
# the f32 rate of everything else and is recorded beside them
# (``fma_bound_ms``).
SPLIT_TF32_OPS_PER_S = 495e12 / 3


_STARTED = time.perf_counter()


def emit(obj):
    """One JSON line; a phase's line also carries the script's seconds so
    far (``elapsed_s``), which say where the run's time goes."""
    if "phase" in obj:
        obj = {**obj, "elapsed_s": round(time.perf_counter() - _STARTED, 1)}
    print(json.dumps(obj), flush=True)


def card_line():
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60).stdout
    return out.strip().splitlines()[0]


def time_ms(fn, reps=30, warmup=5):
    """Median device time of one call, from CUDA events around each call."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def graph_ms(fn, reps=20, calls=10):
    """Device time of one call without the host's launch cost: ``calls``
    calls captured in one CUDA graph, the graph replayed ``reps`` times
    between two CUDA events.  (``time_ms`` also counts the host's work when
    it is longer than the call's device work, as for a small kernel behind
    a Python wrapper.)"""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(3):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(calls):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        graph.replay()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / (reps * calls)


def attention_ops_per_s(dtype, fma=False):
    """The operations rate of the attention bounds: f32 at the split-TF32
    rate (with ``fma``, at the FMA units' rate), else the dtype's peak."""
    if dtype == torch.float32 and not fma:
        return SPLIT_TF32_OPS_PER_S
    return PEAK_OPS_PER_S[dtype]


def attention_bound_ms(bh, sq, sk, d, dtype, fma=False):
    """Least time for one call without bias: q and o over Sq rows, k and v
    over Sk rows, each read or written once, against the card's memory
    rate; 4*Sq*Sk*D*BH operations against ``attention_ops_per_s``.
    Returns (ms, what bounds it)."""
    elt = torch.finfo(dtype).bits // 8
    by_bytes = 2 * bh * (sq + sk) * d * elt / HBM_BYTES_PER_S
    by_ops = 4 * sq * sk * d * bh / attention_ops_per_s(dtype, fma)
    return (1e3 * max(by_bytes, by_ops),
            "bytes" if by_bytes >= by_ops else "operations")


def qkv(bh, s, d, dtype, seed, heads=None, sk=None):
    """q as a [bh, s, d] tensor and k, v as [bh, sk, d] (sk defaults to
    s); with ``heads``, q, k, v as the [B, H, S, D] views into one packed
    [B, S, 3, H, D] projection that a ViT block hands the kernel."""
    g = torch.Generator(device="cuda").manual_seed(seed)
    if heads is None:
        return [torch.randn(bh, n, d, generator=g, device="cuda").to(dtype)
                for n in (s, sk or s, sk or s)]
    packed = torch.randn(bh // heads, s, 3, heads, d, generator=g,
                         device="cuda").to(dtype)
    return list(packed.permute(2, 0, 3, 1, 4))


# DETR-R50 at b8 800x1344 (a 25 x 42 C5 grid): 8 heads of 32 over width
# 256; (name, Sq, Sk) of its encoder, decoder self- and cross-attention
DETR_BATCH, DETR_HEADS, DETR_HW = 8, 8, (800, 1344)
DETR_GRIDS = [("detr_encoder", 1050, 1050), ("detr_decoder_self", 100, 100),
              ("detr_cross", 100, 1050)]


def detr_qkv(sq, sk, dtype, seed, batch=DETR_BATCH, heads=DETR_HEADS, d=32):
    """q, k, v as DETR hands them over: [B, H, S, D] views into the
    [B, S, H*D] outputs of its q, k and v projections."""
    g = torch.Generator(device="cuda").manual_seed(seed)
    return [torch.randn(batch, n, heads * d, generator=g, device="cuda")
            .to(dtype).view(batch, n, heads, d).transpose(1, 2)
            for n in (sq, sk, sk)]


def phase_environment():
    from tlxcv_tpu_torch.ops.cuda import _build

    card = card_line()
    t0 = time.perf_counter()
    _build.build()  # every source under csrc/, in parallel
    seconds = time.perf_counter() - t0
    ptxas = {name: [ln.strip() for ln in log.splitlines()
                    if "entry function" in ln or "registers" in ln
                    or "spill" in ln or "arning" in ln or "C7515" in ln]
             for name, log in _build.build_logs.items()}
    emit({"phase": "environment", "card": card,
          "device": torch.cuda.get_device_name(0),
          "count": torch.cuda.device_count(), "torch": torch.__version__,
          "cuda": torch.version.cuda, "python": sys.version.split()[0]})
    emit({"phase": "build", "sources": _build.sources(),
          "seconds": seconds, "ptxas": ptxas})


def phase_kernels():
    """flash_attention against flash_attention_plain on the card."""
    from tlxcv_tpu_torch.ops.cuda.attention import (flash_attention,
                                                    flash_attention_plain)

    # f32: same arithmetic, other summation order -> 1e-4.  bf16: held
    # against the plain version run in f32 on the same bf16 inputs; P is
    # rounded to bf16 before P.V and the output to bf16 -> 2e-2.
    tol = {torch.float32: 1e-4, torch.bfloat16: 2e-2}
    bf, f32 = torch.bfloat16, torch.float32
    cases = []  # (name, bh, sq, sk, d, dtype, bias, layout)
    for dtype in (f32, bf):
        cases += [
            ("vit_b16_b64_packed", 768, 197, 197, 64, dtype, None, "packed"),
            ("vit_b16_b64", 768, 197, 197, 64, dtype, None, None),
            # the served DeiT-B b64 (S = 198, its distillation token) and
            # int8 ViT-B/16 b256 grids
            ("deit_b64_packed", 768, 198, 198, 64, dtype, None, "packed"),
            ("vit_int8_b256_packed", 3072, 197, 197, 64, dtype, None,
             "packed"),
            ("s577_d64", 96, 577, 577, 64, dtype, None, None),
            ("d32_bias_per_bh", 64, 197, 197, 32, dtype, "per_bh", None),
            ("d32_bias_shared", 64, 197, 197, 32, dtype, "shared", None),
            ("d96_vit_s16", 192, 197, 197, 96, dtype, None, None),
            ("d128", 32, 256, 256, 128, dtype, None, None),
            ("first_kv_tile_masked", 4, 128, 128, 32, dtype, "block_diag",
             None),
            ("row_fully_masked", 4, 100, 100, 64, dtype, "row0_masked",
             None),
        ]
        # DETR-R50's three grids at b8, as its layers hand them over
        cases += [(name, DETR_BATCH * DETR_HEADS, sq, sk, 32, dtype, None,
                   "detr") for name, sq, sk in DETR_GRIDS]
        # ragged S against the 64-row and 128-row tiles, at every head dim
        cases += [(f"s{s}_d{d}", 8, s, s, d, dtype, None, None)
                  for d in (32, 64, 96, 128) for s in (1, 65, 129, 577)]
        # a key length of its own about the 64-key tiles, at every head dim
        cases += [(f"sq{sq}_sk{sk}_d{d}_{bias or 'nobias'}", 8, sq, sk, d,
                   dtype, bias, None)
                  for d in (32, 64, 96, 128) for sq in (1, 100)
                  for sk in (1, 63, 65, 1050) for bias in (None, "per_bh")]
    results = []
    for i, (name, bh, sq, sk, d, dtype, bias_kind, layout) in \
            enumerate(cases):
        if layout == "detr":
            q, k, v = detr_qkv(sq, sk, dtype, seed=i)
        else:
            q, k, v = qkv(bh, sq, d, dtype, seed=i, sk=sk,
                          heads=12 if layout == "packed" else None)
        bias = None
        if bias_kind in ("per_bh", "shared"):
            g = torch.Generator(device="cuda").manual_seed(100 + i)
            bias = torch.randn(bh if bias_kind == "per_bh" else 1, sq, sk,
                               generator=g, device="cuda")
        elif bias_kind == "block_diag":
            # two 64-key segments: the second segment's queries see their
            # first k/v tile fully masked
            seg = torch.arange(sq, device="cuda") // 64
            bias = torch.where(seg[:, None] == seg[None, :], 0.0,
                               float("-inf"))[None]
        elif bias_kind == "row0_masked":
            bias = torch.zeros(1, sq, sk, device="cuda")
            bias[0, 0, :] = float("-inf")
        before = flash_attention.launches
        out = flash_attention(q, k, v, bias=bias)
        torch.cuda.synchronize()
        launched = flash_attention.launches - before
        ref = flash_attention_plain(q.float(), k.float(), v.float(), bias)
        err = (out.float() - ref).abs().max().item()
        finite = bool(torch.isfinite(out).all())
        results.append({"case": name, "dtype": str(dtype).split(".")[-1],
                        "shape": [bh, sq, sk, d], "bias": bias_kind,
                        "max_abs_err": err, "atol": tol[dtype],
                        "finite": finite, "launches": launched})
        if not finite or not err <= tol[dtype] or launched != 1:
            emit({"phase": "kernels", "failed": results[-1]})
            raise AssertionError(f"flash_attention {name} {dtype}: "
                                 f"max |err| {err} > {tol[dtype]} or "
                                 f"{launched} launches")
    emit({"phase": "kernels", "flash_attention": results})

    # ms and library_ms: device time from CUDA-graph replays; event_ms and
    # library_event_ms: CUDA events around each call, which also count the
    # host's launch cost where it exceeds the call's device time (the
    # wrapper's Python and ctypes here)
    def times(q, k, v, bh, sq, sk, dtype):
        bound, bound_by = attention_bound_ms(bh, sq, sk, q.shape[-1], dtype)

        def sdpa():
            return torch.nn.functional.scaled_dot_product_attention(q, k, v)

        return {"shape": [bh, sq, sk, q.shape[-1]],
                "ms": graph_ms(lambda: flash_attention(q, k, v)),
                "event_ms": time_ms(lambda: flash_attention(q, k, v)),
                "plain_ms": time_ms(lambda: flash_attention_plain(q, k, v)),
                "library_ms": graph_ms(sdpa),
                "library_event_ms": time_ms(sdpa),
                "bound_ms": bound, "bound_us": 1e3 * bound,
                "bound_by": bound_by}

    timings = {}
    for dtype in (bf, f32):
        q, k, v = qkv(768, 197, 64, dtype, seed=7, heads=12)  # as served
        timings[str(dtype).split(".")[-1]] = times(q, k, v, 768, 197, 197,
                                                   dtype)
    timings["detr"] = {
        name: times(*detr_qkv(sq, sk, bf, seed=8), DETR_BATCH * DETR_HEADS,
                    sq, sk, bf)
        for name, sq, sk in DETR_GRIDS}
    emit({"phase": "kernel_times", "flash_attention": timings})
    main = next(r for r in results
                if r["case"] == "vit_b16_b64_packed"
                and r["dtype"] == "bfloat16")
    return {"name": "flash_attention", "route": "cuda",
            "source": "tlxcv_tpu_torch/csrc/flash_attention.cu",
            "replaces": "tlxcv_tpu/ops/pallas/attention.py:39",
            "max_abs_err": main["max_abs_err"], **timings["bfloat16"],
            "detr_grids": {
                name: {key: t[key] for key in
                       ("shape", "ms", "plain_ms", "library_ms", "bound_ms",
                        "bound_by")}
                for name, t in timings["detr"].items()}}


def phase_kernel_profile():
    """torch.profiler over 20 calls of each redesigned kernel and of its
    library counterpart at the served shapes: device time per call by
    kernel name."""
    from torch.profiler import ProfilerActivity, profile

    from tlxcv_tpu_torch.ops.cuda.attention import flash_attention
    from tlxcv_tpu_torch.ops.cuda.matmul import bf16_matmul

    q, k, v = qkv(768, 197, 64, torch.bfloat16, seed=7, heads=12)
    g = torch.Generator(device="cuda").manual_seed(7)
    a, b = (torch.randn(4096, 4096, generator=g, device="cuda").to(
        torch.bfloat16) for _ in range(2))
    calls = {
        "flash_attention_768x197x64_packed": lambda: flash_attention(q, k, v),
        "sdpa_768x197x64_packed":
            lambda: torch.nn.functional.scaled_dot_product_attention(q, k, v),
        "bf16_matmul_4096": lambda: bf16_matmul(a, b),
        "torch_matmul_4096": lambda: torch.matmul(a, b),
    }
    for name, fn in calls.items():
        with torch.inference_mode():
            for _ in range(3):
                fn()
            torch.cuda.synchronize()
            with profile(activities=[ProfilerActivity.CPU,
                                     ProfilerActivity.CUDA]) as prof:
                for _ in range(20):
                    fn()
                torch.cuda.synchronize()
        emit_profile(prof, name, 20, None)


# ------------------------------------------------- flash attention backward
DETR_TRAIN_BATCH = 4  # DETR's published batch per GPU (64 images, 16 cards)
# (name, B, H, Sq, Sk, D, layout): ViT-B/16's b64 grid, DETR-R50's three
# training b4 grids
BACKWARD_GRIDS = [("vit_b16_b64_packed", 64, 12, 197, 197, 64, "packed")] + [
    (name, DETR_TRAIN_BATCH, DETR_HEADS, sq, sk, 32, "detr")
    for name, sq, sk in DETR_GRIDS]
BACKWARD_BIASES = (None, "shared", "per_bh", "row_masked")


def backward_edge_cases():
    """(name, B, H, Sq, Sk, D, layout, bias) about the backward's 64-row
    tiles, at every head dim: Sq and Sk each in {1, 63, 64, 65, 127, 128,
    129, 197} against both neighbours in that list (so Sq < Sk and Sq > Sk,
    one tile and several, the ragged and the whole last tile), as [B, H,
    S, D] tensors (the gradient of the output token-major, as a 4D call
    stores it), and ViT's packed-qkv views at S in {1, 65, 128, 197}; the
    biases of ``backward_bias`` in turn."""
    sizes = (1, 63, 64, 65, 127, 128, 129, 197)
    cases = []
    for d in (32, 64, 96, 128):
        shapes = [(f"sq{sq}_sk{sizes[(i + step) % 8]}_d{d}", sq,
                   sizes[(i + step) % 8], None)
                  for i, sq in enumerate(sizes) for step in (1, -1)]
        shapes += [(f"packed_s{s}_d{d}", s, s, "packed")
                   for s in (1, 65, 128, 197)]
        cases += [(name, 2, 3, sq, sk, d, layout,
                   BACKWARD_BIASES[(j + d // 32) % 4])
                  for j, (name, sq, sk, layout) in enumerate(shapes)]
    return cases


def attention_backward_bound_ms(bh, sq, sk, d, dtype, fma=False):
    """Least time of one backward without bias: q, o and dO read and dq
    written over Sq rows, k and v read and dk and dv written over Sk rows
    (eight tensors), the rows' log-sum-exp read, each once, against the
    card's memory rate; the five products (S, dP, dV, dK and dQ:
    10*Sq*Sk*D*BH operations) against ``attention_ops_per_s``.
    Returns (ms, what bounds it)."""
    elt = torch.finfo(dtype).bits // 8
    by_bytes = (4 * bh * (sq + sk) * d * elt + 4 * bh * sq) / HBM_BYTES_PER_S
    by_ops = 10 * sq * sk * d * bh / attention_ops_per_s(dtype, fma)
    return (1e3 * max(by_bytes, by_ops),
            "bytes" if by_bytes >= by_ops else "operations")


def _rel_card(got, want, scale=None):
    """max |got - want| over max |want| (or over ``scale``), on the card."""
    if scale is None:
        scale = want.float().abs().max()
    return ((got.float() - want.float()).abs().max()
            / torch.as_tensor(scale).clamp_min(1e-30)).item()


def _grad_rel_errs(got, want, sk):
    """``_rel_card`` of dq, dk and dv; at Sk = 1 dq and dk over dv's
    largest magnitude: there they are 0 in exact arithmetic (a softmax over
    one key is constant, so dP - delta cancels) and both sides give
    rounding of that cancellation."""
    dv_scale = want[2].float().abs().max()
    return [_rel_card(a, w, dv_scale if sk == 1 else None)
            for a, w in zip(got, want)]


def backward_inputs(b, h, sq, sk, d, layout, dtype, seed):
    """q, k, v of one backward case as the layers hand them over: ViT's
    [B, H, S, D] views into its packed qkv projection (``packed``), DETR's
    views into its separate q, k and v projections (``detr``), or [B, H,
    S, D] tensors of their own."""
    if layout == "packed":
        return qkv(b * h, sq, d, dtype, seed, heads=h)
    if layout == "detr":
        return detr_qkv(sq, sk, dtype, seed, batch=b, heads=h, d=d)
    g = torch.Generator(device="cuda").manual_seed(seed)
    return [torch.randn(b, h, n, d, generator=g, device="cuda").to(dtype)
            for n in (sq, sk, sk)]


def backward_bias(kind, n, sq, sk, gen):
    """None; a bias shared by the heads [1, Sq, Sk] (random, or causal);
    one per head [n, Sq, Sk]; or one per head whose query row 0 is masked
    at every key (the forward averages v there) and whose other rows are
    masked at every third key from the second."""
    if kind is None:
        return None
    if kind == "causal":  # TrOCR's teacher forcing, one shared by all
        return torch.triu(torch.full((1, sq, sk), -1e9, device="cuda"), 1)
    bias = torch.randn(1 if kind == "shared" else n, sq, sk, generator=gen,
                       device="cuda")
    if kind == "row_masked":
        bias[:, 0] = float("-inf")
        bias[:, 1:, 1::3] = float("-inf")
    return bias


def check_backward(case, dtype, seed):
    """One case of ``phase_flash_backward``'s checks; raises on a miss and
    returns its record."""
    from tlxcv_tpu_torch.ops.cuda import attention as A

    tol = {torch.float32: 1e-4, torch.bfloat16: 2e-2}[dtype]
    name, b, h, sq, sk, d, layout, bias_kind = case
    q, k, v = backward_inputs(b, h, sq, sk, d, layout, dtype, seed)
    g = torch.Generator(device="cuda").manual_seed(seed)
    bias = backward_bias(bias_kind, b * h, sq, sk, g)
    leaves = [t.detach().requires_grad_() for t in (q, k, v)]
    before = A.flash_attention_backward.launches
    out = A.flash_attention(*leaves, bias=bias)
    dout = torch.randn(out.shape, generator=g, device="cuda").to(dtype)
    got = torch.autograd.grad(out, leaves, dout)
    again = torch.autograd.grad(A.flash_attention(*leaves, bias=bias),
                                leaves, dout)
    flag_bitwise = None
    if dtype == torch.float32:
        # the f32 kernels never read the matmul TF32 flag: with it on, the
        # output and the gradients keep their bits
        flag = torch.backends.cuda.matmul.allow_tf32
        torch.backends.cuda.matmul.allow_tf32 = not flag
        try:
            out_flag = A.flash_attention(*leaves, bias=bias)
            with_flag = torch.autograd.grad(out_flag, leaves, dout)
        finally:
            torch.backends.cuda.matmul.allow_tf32 = flag
        flag_bitwise = torch.equal(out_flag, out) and all(
            torch.equal(a, c) for a, c in zip(got, with_flag))
    torch.cuda.synchronize()
    launched = A.flash_attention_backward.launches - before
    _, lse = A._launch_kernel(q, k, v, bias, d ** -0.5, with_lse=True)
    want = A.flash_attention_backward_plain(q, k, v, bias, None, out.detach(),
                                            lse, dout)
    _, plain_lse = A.flash_attention_plain(q, k, v, bias, return_lse=True)
    rows = plain_lse > A.NEG  # rows not masked at every key
    lse_err = ((lse - plain_lse)[rows].abs().max().item() if rows.any()
               else 0.0)
    errs = _grad_rel_errs(got, want, sk)
    abs_err = max((a.float() - w.float()).abs().max().item()
                  for a, w in zip(got, want))
    witness = None
    if dtype == torch.float32 and bias_kind != "row_masked":
        ref = [t.detach().requires_grad_() for t in (q, k, v)]
        mask = None if bias is None else bias.view(
            -1 if bias.shape[0] > 1 else 1, h if bias.shape[0] > 1 else 1,
            sq, sk)
        sdpa = torch.nn.functional.scaled_dot_product_attention(
            *ref, attn_mask=mask)
        witness = _grad_rel_errs(got, torch.autograd.grad(sdpa, ref, dout),
                                 sk)
    finite = all(bool(torch.isfinite(a).all()) for a in got)
    bitwise = all(torch.equal(a, c) for a, c in zip(got, again))
    record = {"case": name, "dtype": str(dtype)[6:],
              "shape": [b * h, sq, sk, d], "bias": bias_kind,
              "rel_err_dq_dk_dv": errs, "max_abs_err": abs_err,
              "bound": tol, "sdpa_rel_err_dq_dk_dv": witness,
              "lse_max_abs_err": lse_err, "bitwise_repeat": bitwise,
              "tf32_flag_bitwise": flag_bitwise, "finite": finite,
              "launches": launched}
    calls = 3 if dtype == torch.float32 else 2  # backward calls made here
    if (not finite or not bitwise or flag_bitwise is False
            or launched != calls or max(errs) > tol or lse_err > 1e-4
            or witness is not None and max(witness) > 1e-4):
        emit({"phase": "flash_backward", "failed": record})
        raise AssertionError(f"flash backward {name} {dtype} {bias_kind}: "
                             f"{record}")
    return record


def sdpa_backward_call(q, k, v, dout, is_causal=False):
    """SDPA's backward as its dispatcher picks it for q, k, v (causal with
    ``is_causal``): the name of SDPA's autograd node and a call of the
    aten backward op that node runs, fed by that op's own forward's
    outputs, returning dq, dk and dv first (None for a backend without
    one here, the math path)."""
    aten = torch.ops.aten
    ref = [t.detach().requires_grad_() for t in (q, k, v)]
    node = torch.nn.functional.scaled_dot_product_attention(
        *ref, is_causal=is_causal).grad_fn.name()
    if "Flash" in node:
        out, lse, cq, ck, mq, mk, seed, offset, _ = \
            aten._scaled_dot_product_flash_attention(q, k, v, 0.0, is_causal)
        return node, lambda: aten._scaled_dot_product_flash_attention_backward(
            dout, q, k, v, out, lse, cq, ck, mq, mk, 0.0, is_causal, seed,
            offset)
    if "Efficient" in node:
        out, lse, seed, offset = aten._scaled_dot_product_efficient_attention(
            q, k, v, None, True, 0.0, is_causal)
        return node, lambda: (
            aten._scaled_dot_product_efficient_attention_backward(
                dout, q, k, v, None, out, lse, seed, offset, 0.0,
                [True, True, True, False], is_causal))
    if "Cudnn" in node:
        out, lse, cq, ck, mq, mk, seed, offset, _ = \
            aten._scaled_dot_product_cudnn_attention(q, k, v, None, True,
                                                     0.0, is_causal)
        return node, lambda: aten._scaled_dot_product_cudnn_attention_backward(
            dout, q, k, v, out, lse, seed, offset, None, cq, ck, mq, mk, 0.0,
            is_causal)
    return node, None


def phase_flash_backward(flash_record=None):
    """The flash-attention backward kernel (``csrc/flash_attention_bwd.cu``)
    on the card, in bf16 and f32: at ViT-B/16's b64 grid and DETR-R50's
    three training b4 grids, each without a bias, with a per-head bias and
    with one that masks a query row at every key (the forward averages v
    there); and at the edges of its 64-row tiles (``backward_edge_cases``:
    Sq and Sk from 1 to 197 each way, every head dim, bias none, shared,
    per head or masking a row, ViT's packed views):

    - dq, dk and dv through ``autograd.grad`` against
      ``flash_attention_backward_plain`` on the kernel's own output and
      log-sum-exp, within 2e-2 (bf16) and 1e-4 (f32) of each gradient's
      largest magnitude (at Sk = 1 of dv's: ``_grad_rel_errs``): the
      forward's bounds, for the same reasons (f32
      sums in another order; in bf16 the gradients are rounded to bf16
      once, and the tensor-core products take dS rounded to bf16 where
      the plain version keeps it in f32);
    - in f32, without the masked row, against ``autograd.grad`` through
      ``F.scaled_dot_product_attention`` (a second witness, 1e-4);
    - the log-sum-exp the forward writes against the plain one's (1e-4,
      rows that are not masked entirely), two backward runs bitwise
      equal, one backward launch a call;
    - at the four grids, its time alone (``ms``: CUDA-graph replays;
      ``event_ms``: events around each call) beside the plain version's,
      SDPA's backward (``library_ms``: the aten backward op SDPA's
      dispatcher picks, ``library_op`` its autograd node, on that op's own
      forward outputs, graph replays as ``ms``; ``library_event_ms``: one
      ``autograd.grad`` through SDPA's graph, events), and the bound; the
      forward timed with and without writing the log-sum-exp
      (``train_forward_ms``, ``serve_forward_ms``); in f32 the forward
      also checked and timed beside SDPA's (``f32_forward_times``) and the
      bounds at the FMA units' rate beside (``fma_bound_ms``).  Each
      kernel's own device time comes from ``phase_backward_profile``, at
      the end of a run.

    Returns the kernel's record (the ViT grid in bf16 as its main case);
    the f32 rows go into its ``f32_grids`` and the forward's into
    ``flash_record``'s."""
    from tlxcv_tpu_torch.ops.cuda import attention as A

    results = []
    for dtype in (torch.bfloat16, torch.float32):
        cases = [(name, b, h, sq, sk, d, layout, bias)
                 for name, b, h, sq, sk, d, layout in BACKWARD_GRIDS
                 for bias in (None, "per_bh", "row_masked")]
        for case in cases + backward_edge_cases():
            results.append(check_backward(case, dtype, 300 + len(results)))
    emit({"phase": "flash_backward", "checks": results})
    def worst(dt, key):
        return max(max(r[key]) if isinstance(r[key], list) else r[key] or 0.0
                   for r in results if r["dtype"] == dt)

    emit({"phase": "flash_backward", "cases": len(results), "worst": {
        dt: {key: worst(dt, key) for key in (
            "rel_err_dq_dk_dv", "sdpa_rel_err_dq_dk_dv", "lse_max_abs_err")}
        for dt in ("bfloat16", "float32")}})

    def times(grid, dtype):
        name, b, h, sq, sk, d, layout = grid
        q, k, v = backward_inputs(b, h, sq, sk, d, layout, dtype, seed=11)
        scale = d ** -0.5
        out, lse = A._launch_kernel(q, k, v, None, scale, with_lse=True)
        g = torch.Generator(device="cuda").manual_seed(12)
        dout = torch.randn(out.shape, generator=g, device="cuda").to(dtype)
        out_v, dout_v = out.transpose(1, 2), dout.transpose(1, 2)

        def kernel():
            return A.flash_attention_backward(q, k, v, None, scale, out,
                                              lse, dout)

        ref = [t.detach().requires_grad_() for t in (q, k, v)]
        sdpa = torch.nn.functional.scaled_dot_product_attention(*ref)
        library_op, library = sdpa_backward_call(q, k, v, dout_v)
        bound, bound_by = attention_backward_bound_ms(b * h, sq, sk, d,
                                                      dtype)
        return {"shape": [b * h, sq, sk, d], "ms": graph_ms(kernel),
                "event_ms": time_ms(kernel),
                "plain_ms": time_ms(lambda: A.flash_attention_backward_plain(
                    q, k, v, None, None, out_v, lse, dout_v)),
                "library_ms": None if library is None else graph_ms(library),
                "library_op": library_op,
                "library_event_ms": time_ms(lambda: torch.autograd.grad(
                    sdpa, ref, dout_v, retain_graph=True)),
                "bound_ms": bound, "bound_by": bound_by,
                "serve_forward_ms": graph_ms(lambda: A._launch_kernel(
                    q, k, v, None, scale)),
                "train_forward_ms": graph_ms(lambda: A._launch_kernel(
                    q, k, v, None, scale, with_lse=True)),
                **({"fma_bound_ms": attention_backward_bound_ms(
                    b * h, sq, sk, d, dtype, fma=True)[0],
                    "forward": f32_forward_times(q, k, v, None, None)}
                   if dtype == torch.float32 else {})}

    timings = {dt: {grid[0]: times(grid, dtype) for grid in BACKWARD_GRIDS}
               for dt, dtype in (("bfloat16", torch.bfloat16),
                                 ("float32", torch.float32))}
    emit({"phase": "kernel_times", "flash_attention_backward": timings})
    main = next(r for r in results if r["case"] == "vit_b16_b64_packed"
                and r["dtype"] == "bfloat16" and r["bias"] is None)
    vit = timings["bfloat16"]["vit_b16_b64_packed"]
    keys = ("ms", "event_ms", "plain_ms", "library_ms", "library_op",
            "library_event_ms", "bound_ms", "bound_by")
    record = {"name": "flash_attention_backward", "route": "cuda",
            "source": "tlxcv_tpu_torch/csrc/flash_attention_bwd.cu",
            "replaces": "tlxcv_tpu/ops/pallas/attention.py:39",
            "max_abs_err": main["max_abs_err"],
            **{key: vit[key] for key in keys},
            "detr_grids": {
                name: {key: t[key] for key in ("shape",) + keys}
                for name, t in timings["bfloat16"].items()
                if name.startswith("detr")}}
    f32_records({} if flash_record is None else flash_record, record,
                timings["float32"])
    return record


def phase_backward_profile():
    """Each backward kernel's device time in one bf16 call at each of
    ``BACKWARD_GRIDS`` (torch.profiler).  Run last: a profiler session
    may leave launch overhead behind it in the process, which the
    host-bound legs would feel."""
    from torch.profiler import ProfilerActivity, profile

    from tlxcv_tpu_torch.ops.cuda import attention as A

    for name, b, h, sq, sk, d, layout in BACKWARD_GRIDS:
        q, k, v = backward_inputs(b, h, sq, sk, d, layout, torch.bfloat16,
                                  seed=11)
        out, lse = A._launch_kernel(q, k, v, None, d ** -0.5, with_lse=True)
        dout = torch.randn_like(out)

        def kernel():
            return A.flash_attention_backward(q, k, v, None, d ** -0.5, out,
                                              lse, dout)

        kernel()
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            kernel()
            torch.cuda.synchronize()
        emit_profile(prof, "flash_attention_backward_" + name, 1, None)


def phase_model(record):
    from tlxcv_tpu_torch import create_model
    from tlxcv_tpu_torch.ops.cuda.attention import flash_attention
    from tlxcv_tpu_torch.tasks import ImageClassification

    name = "vit_base_patch16_224"
    gen = torch.Generator().manual_seed(0)
    model = ImageClassification(create_model(name, generator=gen)).eval()
    ref = ImageClassification(create_model(name, device="cpu")).eval()
    ref.load_state_dict({k: t.cpu() for k, t in model.state_dict().items()})
    x4 = torch.randn(4, 224, 224, 3, generator=gen)
    with torch.inference_mode():
        want = ref(x4)
        scale = want.abs().max().item()
        got32 = model(x4.cuda()).float().cpu()
        model.to(torch.bfloat16)
        flash_attention.launches = 0
        got16 = model(x4.cuda().to(torch.bfloat16)).float().cpu()
        per_forward = flash_attention.launches
    err32 = (got32 - want).abs().max().item()
    err16 = (got16 - want).abs().max().item()
    # f32 on the card (TF32 off) differs from the CPU by summation order
    # only: 1e-3 of the logit scale.  bf16 rounds every activation and
    # weight to 8 bits of mantissa through 12 blocks: 3e-2 of the scale.
    check = {"logit_scale": scale, "f32_max_abs_err": err32,
             "f32_bound": 1e-3 * scale, "bf16_max_abs_err": err16,
             "bf16_bound": 3e-2 * scale, "launches_per_forward": per_forward}
    emit({"phase": "model_check", "model": name, "batch": 4, **check})
    if not (torch.isfinite(got32).all() and torch.isfinite(got16).all()):
        raise AssertionError("non-finite logits on the card")
    if not (err32 <= 1e-3 * scale and err16 <= 3e-2 * scale):
        raise AssertionError(f"logits disagree with the CPU: {check}")
    if per_forward != 12:
        raise AssertionError(f"{per_forward} attention kernel launches in "
                             f"one forward, expected 12")

    # the ViT path: b64 bf16 predict, served on the card
    x = torch.randn(64, 224, 224, 3, generator=gen).to("cuda", torch.bfloat16)
    counts, _ = serve(model, x, {"flash_attention": 12}, name, "bfloat16")
    record["launches"] = counts["flash_attention"]
    return model, x


# ---------------------------------------------------------------- int8 GEMM
# (name, M, K, N): the main path's shapes at b256 224^2, and the JAX
# package's int8 probe shapes
INT8_SHAPES = [
    ("stem_7x7_b256", 3211264, 147, 64),
    ("layer1_3x3_b256", 802816, 576, 64),
    ("layer4_1x1_b256", 12544, 2048, 512),
    ("fc_b256", 256, 2048, 1000),
    ("probe_4096", 4096, 4096, 4096),
    ("probe_1x1_b64", 200704, 256, 256),
]


def int8_bound_ms(m, k, n, out_bytes=4):
    """Least time of one [M, K] @ [K, N] int8 product: a, b read once and
    the output written once, ``out_bytes`` an element (4 for the int32
    sums; 1 or 2 for the fused epilogue's int8 or bf16, 4 for its f32),
    against the card's memory rate; 2*M*N*K operations against its dense
    int8 rate."""
    by_bytes = (m * k + k * n + out_bytes * m * n) / HBM_BYTES_PER_S
    by_ops = 2 * m * n * k / PEAK_OPS_PER_S[torch.int8]
    return (1e3 * max(by_bytes, by_ops),
            "bytes" if by_bytes >= by_ops else "operations")


def int8_operands(m, k, n, seed, fill=None):
    g = torch.Generator(device="cuda").manual_seed(seed)
    if fill is None:
        return [torch.randint(-127, 128, shape, generator=g, device="cuda",
                              dtype=torch.int8) for shape in ((m, k), (k, n))]
    return [torch.full(shape, v, device="cuda", dtype=torch.int8)
            for shape, v in (((m, k), fill[0]), ((k, n), fill[1]))]


def _times(fn, reps):
    """Device time of one call from CUDA-graph replays, and the median of
    CUDA events around each call (which also counts the host's launch
    cost where it exceeds the call's device time)."""
    return graph_ms(fn, reps=max(2, reps // 2), calls=5), \
        time_ms(fn, reps=reps)


def _int_mm_ms(ap, w, reps, epilogue=None):
    """torch._int_mm on the padded operands (followed by the PyTorch
    epilogue, if one is given), timed as ``_times``; its shape rules may
    refuse them: then (None, None, its message)."""
    from tlxcv_tpu_torch.ops.cuda.matmul import requantize

    def library():
        acc = torch._int_mm(ap, w.t())
        return acc if epilogue is None else requantize(acc, **epilogue)

    try:
        library()
    except RuntimeError as err:
        return None, None, str(err).splitlines()[0][:160]
    return (*_times(library, reps), None)


def time_int8_shape(m, k, n, seed, reps=20, epilogue=None):
    """Kernel, plain and library ms of one product as the int8 layers
    hand it over: K zero-padded for the kernel, the weight packed [N, Kp].
    The kernel's product is first held to the plain one, bitwise, so every
    shape timed is a shape checked.  The library call is torch._int_mm on
    the same padded operands; its shape rules may refuse them (then null,
    with its message).  ``ms`` and ``library_ms`` are device times from
    CUDA-graph replays, ``event_ms`` and ``library_event_ms`` CUDA events
    around each call (the wrapper's host time shows there).  With ``epilogue`` (the keyword arguments of
    ``int8_matmul_requant`` past the operands: a layer's own scale, bias,
    ReLU, out_scale and output dtype), the fused route too: checked bitwise
    against the plain product followed by ``requantize``, then timed beside
    ``torch._int_mm`` followed by ``requantize`` (what a PyTorch user would
    write) and its bound with the output's own bytes."""
    from tlxcv_tpu_torch.ops.cuda.matmul import (int8_matmul_nt,
                                                 int8_matmul_plain,
                                                 int8_matmul_requant, pad_k,
                                                 requantize)

    a, b = int8_operands(m, k, n, seed)
    ap, w = pad_k(a), pad_k(b.t().contiguous())
    want = int8_matmul_plain(a, b)
    if not torch.equal(int8_matmul_nt(ap, w), want):
        emit({"phase": "int8_kernels", "failed": "timed shape",
              "shape": [m, k, n]})
        raise AssertionError(f"int8_matmul {m}x{k}x{n} differs from its "
                             f"plain version")
    out = {"exact": True}
    out["ms"], out["event_ms"] = _times(lambda: int8_matmul_nt(ap, w), reps)
    out["plain_ms"] = time_ms(lambda: int8_matmul_plain(a, b),
                              reps=max(3, reps // 4), warmup=1)
    out["library_ms"], out["library_event_ms"], refused = _int_mm_ms(
        ap, w, reps)
    if refused:
        out["library_refused"] = refused
    out["bound_ms"], out["bound_by"] = int8_bound_ms(m, k, n)
    if epilogue is not None:
        got = int8_matmul_requant(ap, w, **epilogue)
        ref = requantize(want, **epilogue)
        if got.dtype != ref.dtype or not torch.equal(got, ref):
            emit({"phase": "int8_kernels", "failed": "timed fused shape",
                  "shape": [m, k, n], "out_dtype": str(ref.dtype)[6:]})
            raise AssertionError(f"int8_matmul_requant {m}x{k}x{n} differs "
                                 f"from its plain version")
        fused = {"out_dtype": str(got.dtype)[6:],
                 "bias": epilogue["bias"] is not None,
                 "relu": epilogue["relu"], "bitwise": True}
        fused["ms"], fused["event_ms"] = _times(
            lambda: int8_matmul_requant(ap, w, **epilogue), reps)
        fused["library_ms"], fused["library_event_ms"], _ = _int_mm_ms(
            ap, w, reps, epilogue)
        fused["bound_ms"], fused["bound_by"] = int8_bound_ms(
            m, k, n, got.element_size())
        out["fused"] = fused
        del got, ref
    return out


# The fused epilogue's edge cases: every output kind, with and without a
# bias, at N across the three tile widths (1, 17, 64; 255, 256; 1000 over
# four 256-column tiles) and K from one 16-byte step to 36 slices
INT8_EPILOGUE_N = (1, 17, 64, 255, 256, 1000)
INT8_EPILOGUE_KP = (16, 64, 576, 4608)
INT8_EPILOGUE_OUT = (("int8_relu", torch.int8, True),
                     ("int8", torch.int8, False),
                     ("bf16", torch.bfloat16, False),
                     ("f32", torch.float32, False))


def epilogue_operands(n, kp, out_dtype, relu, bias, seed):
    """A scale that brings the sums of random int8 operands to a spread of
    about 40 (so int8 codes span their range and some clamp), a bias of
    spread 10, and an out_scale of 0.37."""
    g = torch.Generator(device="cuda").manual_seed(seed)
    acc_std = 127 ** 2 / 3 * math.sqrt(kp)
    scale = (0.5 + 1.5 * torch.rand(n, generator=g, device="cuda")) \
        * (40 / acc_std)
    return {"scale": scale,
            "bias": 10 * torch.randn(n, generator=g, device="cuda")
            if bias else None,
            "relu": relu,
            "out_scale": torch.tensor(0.37, device="cuda")
            if out_dtype == torch.int8 else None,
            "out_dtype": out_dtype}


def phase_int8_epilogue():
    """int8_matmul_requant against int8_matmul_requant_plain on the card,
    bitwise: every output kind with and without a bias, N in
    INT8_EPILOGUE_N, Kp in INT8_EPILOGUE_KP, M ragged; and ties, where
    round-half-to-even decides every code.  Also how many of the plain
    version's quotients y / out_scale differ from y * (1 / out_scale): the
    check can tell the two divisions apart."""
    from tlxcv_tpu_torch.ops.cuda.matmul import (int8_matmul_plain,
                                                 int8_matmul_requant,
                                                 int8_matmul_requant_plain)

    cases, worst, differ, total = 0, 0.0, 0, 0
    i = 0
    for name, out_dtype, relu in INT8_EPILOGUE_OUT:
        for bias in (True, False):
            for n in INT8_EPILOGUE_N:
                for kp in INT8_EPILOGUE_KP:
                    m = (333, 1, 129, 4099)[i % 4]
                    a, b = int8_operands(m, kp, n, seed=300 + i)
                    w = b.t().contiguous()
                    ep = epilogue_operands(n, kp, out_dtype, relu, bias,
                                           seed=600 + i)
                    got = int8_matmul_requant(a, w, **ep)
                    torch.cuda.synchronize()
                    want = int8_matmul_requant_plain(a, w, **ep)
                    err = (got.float() - want.float()).abs().max().item()
                    if got.dtype != want.dtype or got.shape != (m, n) \
                            or not torch.equal(got, want):
                        emit({"phase": "int8_epilogue", "failed": name,
                              "bias": bias, "shape": [m, kp, n],
                              "max_abs_err": err})
                        raise AssertionError(
                            f"int8_matmul_requant {name} bias={bias} "
                            f"{m}x{kp}x{n}: max |err| {err}, expected "
                            f"bitwise")
                    if ep["out_scale"] is not None:
                        y = int8_matmul_plain(a, b).float() * ep["scale"]
                        if bias:
                            y = y + ep["bias"]
                        differ += int((y / ep["out_scale"]
                                       != y * (1 / ep["out_scale"])).sum())
                        total += y.numel()
                    worst = max(worst, err)
                    cases += 1
                    i += 1
    # ties: codes in {-1, 0, 1}, y = acc + 0.5 and out_scale 1, so every
    # quotient lies halfway between two integers
    ties = 0
    for relu in (False, True):
        g = torch.Generator(device="cuda").manual_seed(900 + relu)
        a, w = (torch.randint(-1, 2, s, generator=g, device="cuda",
                              dtype=torch.int8) for s in ((257, 16), (33, 16)))
        ep = {"scale": torch.ones(33, device="cuda"),
              "bias": torch.full((33,), 0.5, device="cuda"), "relu": relu,
              "out_scale": torch.tensor(1.0, device="cuda"),
              "out_dtype": torch.int8}
        got = int8_matmul_requant(a, w, **ep)
        if not torch.equal(got, int8_matmul_requant_plain(a, w, **ep)):
            raise AssertionError(f"int8_matmul_requant ties (relu={relu}) "
                                 f"differ from the plain version")
        ties += 1
    emit({"phase": "int8_epilogue", "cases": cases + ties,
          "max_abs_err": worst, "tolerance": 0,
          "why": "the kernel runs the plain version's f32 operations one by "
                 "one in its order, each rounded to nearest (no FMA), and "
                 "rounds half to even as torch.round",
          "division_differs_from_reciprocal_product": differ,
          "of_quotients": total})


def phase_int8_kernels():
    """int8_matmul against int8_matmul_plain on the card, exactly, at the
    main path's shapes and at the edges of its contract; the fused
    epilogue's cases; then the times."""
    from tlxcv_tpu_torch.ops.cuda.matmul import (int8_matmul,
                                                 int8_matmul_plain)

    cases = [(name, m, k, n, None) for name, m, k, n in INT8_SHAPES]
    cases += [(f"edge_{m}x{k}x{n}", m, k, n, None)
              for m in (1, 17, 33) for k in (1, 17, 33) for n in (1, 17, 33)]
    cases += [("all_minus_127", 300, 4096, 70, (-127, -127)),
              ("k4096_plus_minus_127", 129, 4096, 65, (127, -127)),
              ("k4096_random_sign", 257, 4096, 130, None),
              ("n255_ragged_m", 1000, 512, 255, None),
              ("n1000_ragged_m", 333, 2048, 1000, None)]
    worst = 0
    for i, (name, m, k, n, fill) in enumerate(cases):
        a, b = int8_operands(m, k, n, seed=i, fill=fill)
        if name == "k4096_random_sign":
            a, b = (torch.where(t >= 0, 127, -127).to(torch.int8)
                    for t in (a, b))
        got = int8_matmul(a, b)
        torch.cuda.synchronize()
        want = int8_matmul_plain(a, b)
        err = (got.double() - want.double()).abs().max().item()
        worst = max(worst, err)
        if got.dtype != torch.int32 or err != 0:
            emit({"phase": "int8_kernels", "failed": name,
                  "shape": [m, k, n], "max_abs_err": err})
            raise AssertionError(f"int8_matmul {name} {m}x{k}x{n}: "
                                 f"max |err| {err}, expected exact")
        del a, b, got, want
    emit({"phase": "int8_kernels", "cases": len(cases), "max_abs_err": worst,
          "tolerance": 0, "why": "int32 sums of int8 products are exact"})
    phase_int8_epilogue()

    timings = {}
    for i, (name, m, k, n) in enumerate(INT8_SHAPES):
        timings[name] = {"shape": [m, k, n], **time_int8_shape(m, k, n, i)}
        torch.cuda.empty_cache()
    emit({"phase": "kernel_times", "int8_matmul": timings})
    return {"name": "int8_matmul", "route": "cuda",
            "source": "tlxcv_tpu_torch/csrc/int8_matmul.cu",
            "replaces": "tlxcv_tpu/ops/pallas/matmul.py:32",
            "max_abs_err": worst}


# ---------------------------------------------------------------- bf16 GEMM
# (name, M, K, N, operands): the probe's 4096^3 (the main path), ragged M
# and N, one row, a K that the wrapper pads; "normal" operands from a seed,
# "integers" in [-4, 4], whose f32 sums are exact in any order
BF16_CASES = [
    ("probe_4096", 4096, 4096, 4096, "normal"),
    ("probe_4096_exact", 4096, 4096, 4096, "integers"),
    ("ragged_1000x520x1000", 1000, 520, 1000, "normal"),
    ("row_1x4096x4096", 1, 4096, 4096, "normal"),
    ("k_pad_300x1001x260", 300, 1001, 260, "normal"),
    ("ragged_129x64x77", 129, 64, 77, "normal"),
    ("col_4096x4096x1", 4096, 4096, 1, "normal"),
    ("small_17x9x33_exact", 17, 9, 33, "integers"),
]


def bf16_ulp(x):
    """The spacing of bf16 values at |x| (8 significant bits)."""
    x = x.abs().float().clamp_min(2.0 ** -126)
    return torch.exp2(torch.floor(torch.log2(x)) - 7)


def bf16_tolerance(a, b, got, want):
    """Per element: one bf16 ulp of the larger of the two results, and how
    far two f32 sums of the same K products may lie apart when taken in
    different orders, 2 (K - 1) 2^-24 sum_k |a_ik b_kj| (the kernel sums in
    k16 steps on the tensor cores, the plain version in cuBLAS's order)."""
    k = a.shape[1]
    reorder = 2 * (k - 1) * 2.0 ** -24 * (a.float().abs() @ b.float().abs())
    ulp = bf16_ulp(torch.maximum(got.float().abs(), want.float().abs()))
    return ulp, reorder


# the share of elements of a "normal" case that may lie beyond one bf16 ulp
# of the plain result: all of them near zero, where the f32 reordering is
# larger than the bf16 spacing (1.6e-4 read at 4096^3 on one H100 80GB
# HBM3, 700 W)
BF16_BEYOND_ONE_ULP = 1e-3


def bf16_close_share(got, want):
    """The share of elements within one bf16 ulp of the larger of the
    two."""
    g, w = got.float().cpu(), want.float().cpu()
    return ((g - w).abs() <= bf16_ulp(torch.maximum(g.abs(), w.abs()))) \
        .float().mean().item()


def bf16_bound_ms(m, k, n):
    """a and b read once and c written once (bf16) against the memory
    rate; 2*M*N*K operations against the dense bf16 rate."""
    by_bytes = 2 * (m * k + k * n + m * n) / HBM_BYTES_PER_S
    by_ops = 2 * m * n * k / PEAK_OPS_PER_S[torch.bfloat16]
    return (1e3 * max(by_bytes, by_ops),
            "bytes" if by_bytes >= by_ops else "operations")


def phase_bf16_kernels():
    """bf16_matmul against bf16_matmul_plain on the card at the probe's
    shape and at the edges of its contract; then the kernel's, the plain
    version's and torch.matmul's times at 4096^3 beside the bound."""
    from tlxcv_tpu_torch.ops.cuda.matmul import (bf16_matmul,
                                                 bf16_matmul_plain)

    results = []
    for i, (name, m, k, n, kind) in enumerate(BF16_CASES):
        g = torch.Generator(device="cuda").manual_seed(200 + i)
        if kind == "normal":
            a, b = (torch.randn(shape, generator=g, device="cuda").to(
                torch.bfloat16) for shape in ((m, k), (k, n)))
        else:
            a, b = (torch.randint(-4, 5, shape, generator=g, device="cuda")
                    .to(torch.bfloat16) for shape in ((m, k), (k, n)))
        got = bf16_matmul(a, b)
        torch.cuda.synchronize()
        want = bf16_matmul_plain(a, b)
        err = (got.float() - want.float()).abs()
        ulp, reorder = bf16_tolerance(a, b, got, want)
        away = want.float().abs() > reorder  # where one ulp must hold
        row = {"case": name, "shape": [m, k, n], "operands": kind,
               "max_abs_err": err.max().item(),
               "max_err_in_ulps": (err / ulp).max().item(),
               "max_err_in_ulps_away_from_zero":
                   (err / ulp)[away].max().item() if away.any() else 0.0,
               "share_differing": (err > 0).float().mean().item(),
               "share_beyond_one_ulp": (err > ulp).float().mean().item(),
               "within_bound": bool((err <= ulp + reorder).all()),
               "finite": bool(torch.isfinite(got).all())}
        results.append(row)
        ok = got.dtype == torch.bfloat16 and got.shape == (m, n) and \
            row["finite"] and row["within_bound"] and \
            row["max_err_in_ulps_away_from_zero"] <= 1 and \
            row["share_beyond_one_ulp"] <= BF16_BEYOND_ONE_ULP
        if kind == "integers":  # exact sums, one rounding: bitwise
            ok = ok and row["max_abs_err"] == 0
        if not ok:
            emit({"phase": "bf16_kernels", "failed": row})
            raise AssertionError(f"bf16_matmul {name}: {row}")
        del a, b, got, want, err, ulp, reorder, away
    emit({"phase": "bf16_kernels", "cases": results,
          "tolerance": "one bf16 ulp of the larger result wherever |plain| "
                       "exceeds the f32 reordering bound 2 (K - 1) 2^-24 "
                       "sum|a||b|, and one ulp plus that bound near zero; "
                       f"at most {BF16_BEYOND_ONE_ULP} of the elements "
                       "beyond one ulp; integer operands bitwise"})

    m = k = n = 4096
    g = torch.Generator(device="cuda").manual_seed(7)
    a, b = (torch.randn(s, s, generator=g, device="cuda").to(torch.bfloat16)
            for s in (m, k))
    saved = torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction
    torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False
    try:
        # ms and library_ms from CUDA-graph replays, the event times beside
        # them (as for flash_attention)
        timing = {"shape": [m, k, n],
                  "ms": graph_ms(lambda: bf16_matmul(a, b)),
                  "event_ms": time_ms(lambda: bf16_matmul(a, b)),
                  "plain_ms": time_ms(lambda: bf16_matmul_plain(a, b),
                                      reps=10),
                  "library_ms": graph_ms(lambda: torch.matmul(a, b)),
                  "library_event_ms": time_ms(lambda: torch.matmul(a, b))}
    finally:
        torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = \
            saved
    timing["bound_ms"], timing["bound_by"] = bf16_bound_ms(m, k, n)
    timing["tflops"] = 2e-9 * m * n * k / timing["ms"]
    timing["library_tflops"] = 2e-9 * m * n * k / timing["library_ms"]
    emit({"phase": "kernel_times", "bf16_matmul": timing})
    return {"name": "bf16_matmul", "route": "cuda",
            "source": "tlxcv_tpu_torch/csrc/bf16_matmul.cu",
            "replaces": "demo/image_classification/probe_int8_pallas.py:92",
            "max_abs_err": results[0]["max_abs_err"], **timing}


def phase_probe(record):
    """The port of the demo's GEMM probe at the reference's full sizes
    (int8 and bf16 at 4096^3, int8 at 200704 x 256 x 256), with the launch
    counts set to 0 before it and read after: both GEMM kernels must have
    run."""
    from tlxcv_tpu_torch.demo.image_classification import probe_int8_gemm

    reset_launches()
    result = probe_int8_gemm.run()
    counts = launch_counts(f32=False)
    emit({"phase": "probe", **result, "launches": counts})
    if counts["bf16_matmul"] == 0 or counts["int8_matmul"] == 0:
        raise AssertionError(f"the GEMM probe did not launch both kernels: "
                             f"{counts}")
    record["launches"] = counts["bf16_matmul"]


def check_labels(pred, batch):
    if pred.shape != (batch,) or not bool(((pred >= 0) & (pred < 1000)).all()):
        raise AssertionError(f"bad predictions {pred.shape}")


# timed rounds of each served leg and timed steps of each training leg,
# after 3 untimed ones (10 each until the default run grew past 800 s)
SERVE_ROUNDS = 6
TRAIN_STEPS = 6


def serve(model, x, expect, name, dtype, warmup=3, rounds=SERVE_ROUNDS,
          check=check_labels):
    """Time ``predict`` (host clock around each call and a synchronise),
    with the launch counts set to 0 just before and checked just after
    against ``expect`` launches per forward (kernels not named: 0)."""
    torch.cuda.reset_peak_memory_stats()
    times = []
    reset_launches()
    with torch.inference_mode():
        for i in range(warmup + rounds):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            pred = model.predict(x)
            torch.cuda.synchronize()
            if i >= warmup:
                times.append(time.perf_counter() - t0)
    counts = launch_counts(f32=False)
    want = {k: expect.get(k, 0) * (warmup + rounds) for k in counts}
    if counts != want:
        raise AssertionError(f"{name} {dtype}: kernel launches {counts}, "
                             f"expected {want}")
    batch = x.shape[0]
    check(pred, batch)
    step = statistics.median(times)
    emit({"phase": "serve", "model": name, "batch": batch, "dtype": dtype,
          "rounds": rounds, "step_ms_median": 1e3 * step,
          "step_ms_all": [1e3 * t for t in times],
          "img_per_s": batch / step, "launches": counts,
          "peak_mem_bytes": torch.cuda.max_memory_allocated()})
    return counts, step


def params_to(model, dtype):
    """Cast the float parameters only, as the JAX package's bench casts
    its params to bf16 and keeps the BatchNorm statistics in f32."""
    for p in model.parameters():
        if p.is_floating_point():
            p.data = p.data.to(dtype)
    return model


def random_bn_statistics(model, gen):
    """Non-trivial BatchNorm running statistics, drawn from ``gen``."""
    from tlxcv_tpu_torch.nn import BatchNorm

    for mod in model.modules():
        if isinstance(mod, BatchNorm):
            c = mod.running_mean.shape[0]
            mod.running_mean.copy_(0.2 * torch.randn(c, generator=gen))
            mod.running_var.copy_(0.5 + 1.5 * torch.rand(c, generator=gen))


def data_bn_statistics(model, x):
    """BatchNorm running statistics of the model's own activations, as
    training leaves them: one train-mode forward of ``x`` in which every
    BatchNorm keeps none of its old statistics, so each normalises its
    input to mean 0 and variance 1 and the head's logits stay O(1).  A
    FrozenBatchNorm (DETR's backbone) takes the mean and variance of its
    input in the same forward, through a hook run before it."""
    from tlxcv_tpu_torch.models.detection.detr import FrozenBatchNorm
    from tlxcv_tpu_torch.nn import BatchNorm

    def from_input(mod, args):
        xf = args[0].float()
        mod.running_mean.copy_(xf.mean((0, 1, 2)))
        mod.running_var.copy_(xf.var((0, 1, 2), correction=0))

    bns = [m for m in model.modules() if isinstance(m, BatchNorm)]
    hooks = [m.register_forward_pre_hook(from_input)
             for m in model.modules() if isinstance(m, FrozenBatchNorm)]
    kept = [m.momentum for m in bns]
    for m in bns:
        m.momentum = 0.0
    model.train()
    with torch.no_grad():
        model(x)
    model.eval()
    for m, v in zip(bns, kept):
        m.momentum = v
    for h in hooks:
        h.remove()


def float_logit_check(name, cpu, card, x4, depth="53 convs", expect=None,
                      chaotic=False):
    """f32 and bf16 outputs of ``card`` against f32 on the CPU; ``card`` is
    left with bf16 parameters.  With ``expect``, the kernel launches of
    each card forward must be exactly those (kernels not named: 0).  With
    ``chaotic``, bf16 is held as ``yolo_float_check`` holds YOLOv3's: to
    the CPU's own bf16 model's rms error against the f32 model."""
    with torch.inference_mode():
        want = cpu(x4)
        scale = want.abs().max().item()
        reset_launches()
        got32 = card(x4.cuda()).float().cpu()
        per_forward = launch_counts(f32=False)
    params_to(card, torch.bfloat16)
    with torch.inference_mode():
        got16 = card(x4.cuda().to(torch.bfloat16)).float().cpu()
    err32 = (got32 - want).abs().max().item()
    err16 = (got16 - want).abs().max().item()
    # f32 on the card (TF32 off) differs from the CPU by summation order
    # only: 1e-3 of the output scale.  bf16 rounds every activation and
    # weight to 8 bits of mantissa through the net: 3e-2 of the scale.
    check = {"logit_scale": scale, "f32_max_abs_err": err32,
             "f32_bound": 1e-3 * scale, "bf16_max_abs_err": err16,
             "bf16_bound": 3e-2 * scale, "depth": depth,
             "launches_per_forward": {k: v for k, v in per_forward.items()
                                      if v}}
    bf16_ok = err16 <= 3e-2 * scale
    if chaotic:
        cpu16 = params_to(copy.deepcopy(cpu), torch.bfloat16)
        with torch.inference_mode():
            want16 = cpu16(x4.to(torch.bfloat16)).float()
        del cpu16
        check.update({"bf16_bound": None,
                      "rms_bf16_card_f32_cpu": _rms(got16, want),
                      "rms_bf16_cpu_f32_cpu": _rms(want16, want),
                      "rms_bf16_card_bf16_cpu": _rms(got16, want16)})
        bf16_ok = (check["rms_bf16_card_f32_cpu"]
                   <= YOLO_BF16_RMS[0] * check["rms_bf16_cpu_f32_cpu"]
                   and check["rms_bf16_card_bf16_cpu"]
                   <= YOLO_BF16_RMS[1] * check["rms_bf16_cpu_f32_cpu"])
    emit({"phase": "model_check", "model": name, "batch": x4.shape[0],
          **check})
    if not (torch.isfinite(got32).all() and torch.isfinite(got16).all()):
        raise AssertionError(f"non-finite {name} outputs on the card")
    if not (err32 <= 1e-3 * scale and bf16_ok):
        raise AssertionError(f"{name} outputs disagree with the CPU: "
                             f"{check}")
    if expect is not None and per_forward != {
            k: expect.get(k, 0) for k in per_forward}:
        raise AssertionError(f"{name}: kernel launches {per_forward} in one "
                             f"forward, expected {expect}")
    return got32


def phase_resnet(int8_record, floats=True):
    """ResNet-50: float and int8 logits on the card against the CPU, then
    the two serving paths at b256 (with ``floats`` False, the int8 check
    and the int8 path alone)."""
    from tlxcv_tpu_torch import create_model
    from tlxcv_tpu_torch.ops.cuda.matmul import int8_matmul
    from tlxcv_tpu_torch.ops.quant import quantize_for_serving
    from tlxcv_tpu_torch.tasks import ImageClassification

    name = "resnet50"
    gen = torch.Generator().manual_seed(0)
    cpu = ImageClassification(create_model(name, device="cpu",
                                           generator=gen)).eval()
    random_bn_statistics(cpu, gen)
    x4 = torch.randn(4, 224, 224, 3, generator=gen)
    card = copy.deepcopy(cpu).cuda() if floats else None
    if floats:
        float_logit_check(name, cpu, card, x4)

    # full int8: prepared on the CPU in f32, served on the card
    calib = torch.randn(4, 224, 224, 3, generator=gen)
    t0 = time.perf_counter()
    counts = quantize_for_serving(cpu.backbone, [calib])
    prep_s = time.perf_counter() - t0
    card8 = copy.deepcopy(cpu).cuda()
    reset_launches()
    with torch.inference_mode():
        got8 = card8(x4.cuda()).cpu()
        per_forward = int8_matmul.launches
        want8 = cpu(x4)
    fc = cpu.backbone.fc
    step = float(fc.a_scale * 127 * fc.w_scale.max())
    err8 = (got8 - want8).abs().max().item()
    check = {"counts": list(counts), "expected_counts": [53, 54, 54, 32],
             "prep_s": prep_s, "logit_scale": want8.abs().max().item(),
             "max_abs_err": err8, "bound": 4 * step,
             "why": "up to the global pool every op is an exact int32 "
                    "product or an IEEE elementwise op; the pool's f32 "
                    "mean is summed in another order, which can move an "
                    "fc input code by one, each worth at most a_scale * "
                    "127 * max w_scale of the fc: four such codes",
             "launches_per_forward": per_forward}
    emit({"phase": "model_check", "model": name + "_int8", "batch": 4,
          **check})
    if tuple(counts) != (53, 54, 54, 32):
        raise AssertionError(f"quantize_for_serving counts {counts}")
    if not torch.isfinite(got8).all() or not err8 <= 4 * step:
        raise AssertionError(f"int8 ResNet-50 disagrees with the CPU: "
                             f"{check}")
    if per_forward != 54:
        raise AssertionError(f"{per_forward} int8 GEMM launches in one "
                             f"forward, expected 54")
    del cpu, x4

    # the ResNet paths: b256 bf16 predict, float on cuDNN and full int8
    batch = 256
    x = torch.randn(batch, 224, 224, 3, generator=gen).to(
        "cuda", torch.bfloat16)
    if floats:
        serve(card, x, {}, name, "bfloat16")
    counts, _ = serve(card8, x, {"int8_matmul": 54}, name + "_int8",
                      "int8 (bf16 input)")
    int8_record["launches"] = counts["int8_matmul"]
    int8_record.update(int8_forward_times(card8, x))
    return card, card8, x


def int8_forward_times(model, x, name="int8_matmul_per_forward"):
    """The int8 GEMM at every shape one int8 forward hands it (read from
    hooks on the int8 layers, with each layer's epilogue: its scale, bias,
    ReLU, out_scale and output dtype), checked and timed alone in both
    routes; summed over the forward.  Returns the int32 route's totals (the
    contract of the TPU kernel it replaces, beside torch._int_mm) and the
    fused route's as ``fused_*`` (beside torch._int_mm and the PyTorch
    epilogue).  A grouped conv hands over one GEMM a group, each at its
    group's shape, timed with group 0's epilogue; their sums are also
    returned under ``grouped`` (calls, fused route, its bound, plain)."""
    from tlxcv_tpu_torch.nn import Conv2d, Linear

    seen = []

    def hook(mod, args, out):
        if mod.weight.dtype != torch.int8:
            return
        k = mod.weight.shape[1]  # packed Kp; the function's own K below
        groups = mod.groups if isinstance(mod, Conv2d) else 1
        if isinstance(mod, Conv2d):
            k_fn = (mod.kernel_size[0] * mod.kernel_size[1]
                    * args[0].shape[-1] // groups)
        else:
            k_fn = mod.in_features
        n = out.shape[-1] // groups  # a grouped conv: one GEMM a group,
        rows = slice(0, n)           # timed with group 0's epilogue
        out_scale = getattr(mod, "out_scale", None)
        key = (out.numel() // out.shape[-1], k_fn, n, k,
               str(out.dtype)[6:], mod.bias is not None,
               out_scale is not None and getattr(mod, "relu_fused", False),
               groups > 1)
        for _ in range(groups):
            seen.append((key, {
                "scale": (mod.a_scale * mod.w_scale)[rows],
                "bias": None if mod.bias is None else mod.bias[rows],
                "relu": key[6], "out_scale": out_scale,
                "out_dtype": out.dtype}))

    handles = [m.register_forward_hook(hook) for m in model.modules()
               if isinstance(m, (Conv2d, Linear))]
    with torch.inference_mode():
        model(x)
    for h in handles:
        h.remove()
    keys = [key for key, _ in seen]
    epilogues = dict(seen)  # one layer's epilogue per distinct key
    per_shape = []
    total = {k: 0.0 for k in (
        "ms", "event_ms", "plain_ms", "bound_ms", "library_ms",
        "library_event_ms", "fused_ms", "fused_event_ms", "fused_bound_ms",
        "fused_library_ms", "fused_library_event_ms")}
    by = {"bytes": 0.0, "operations": 0.0}
    grouped = {"calls": 0, "fused_ms": 0.0, "fused_bound_ms": 0.0,
               "plain_ms": 0.0}
    for i, key in enumerate(sorted(set(keys))):
        m, k_fn, n, kp = key[:4]
        with torch.inference_mode():
            t = time_int8_shape(m, kp, n, seed=1000 + i, reps=10,
                                epilogue=epilogues[key])
        t["bound_ms"], t["bound_by"] = int8_bound_ms(m, k_fn, n)
        fused = t.pop("fused")
        fused["bound_ms"], fused["bound_by"] = int8_bound_ms(
            m, k_fn, n, {"int8": 1, "bfloat16": 2}.get(key[4], 4))
        calls = keys.count(key)
        per_shape.append({"m": m, "k": k_fn, "kp": kp, "n": n,
                          "calls": calls, "grouped": key[7], **t,
                          "fused": fused})
        for part, src in (("", t), ("fused_", fused)):
            for k in ("ms", "event_ms", "bound_ms", "library_ms",
                      "library_event_ms"):
                if total[part + k] is None or src[k] is None:
                    total[part + k] = None
                else:
                    total[part + k] += calls * src[k]
        total["plain_ms"] += calls * t["plain_ms"]
        by[t["bound_by"]] += calls * t["bound_ms"]
        if key[7]:
            for part, value in (("calls", 1), ("fused_ms", fused["ms"]),
                                ("fused_bound_ms", fused["bound_ms"]),
                                ("plain_ms", t["plain_ms"])):
                grouped[part] += calls * value
        torch.cuda.empty_cache()
    emit({"phase": "kernel_times", name: {
        "batch": x.shape[0], "calls": len(keys), "totals_ms": total,
        "grouped_totals_ms": grouped, "shapes": per_shape}})
    return {**total, "bound_by": max(by, key=by.get),
            **({"grouped": grouped} if grouped["calls"] else {})}


# ------------------------------------------------------ row gather, upsample
# The main path's shapes at b16 640^2 bf16: the packed pyramid table has
# 16 * 34,000 rows of 4 * 256 channels; the box branch gathers 16 * 256 *
# 7^2 rows, the mask branch 16 * 100 * 14^2.
GATHER_TABLE = (16 * 34_000, 1024)
GATHER_ROWS = {"box_b16": 16 * 256 * 49, "mask_b16": 16 * 100 * 196}
FPN_STEPS = [((16, 20, 20, 256), (40, 40)), ((16, 40, 40, 256), (80, 80)),
             ((16, 80, 80, 256), (160, 160))]


def gather_bound_ms(table, idx):
    """Least time of one gather on this data: each distinct row the indices
    name read once, each output row written once, the indices read once,
    over the memory rate.  Also the data-blind 2 * R * row_bytes form
    (every index its own row)."""
    row = table.shape[1] * table.element_size()
    r = idx.numel()
    distinct = int(torch.unique(idx).numel())
    by_data = (distinct * row + r * row + 4 * r) / HBM_BYTES_PER_S
    return 1e3 * by_data, 1e3 * 2 * r * row / HBM_BYTES_PER_S, distinct


def upsample_bound_ms(x, skip):
    """x and skip read once, the output written once, over the memory rate
    (a few flops per element, far below the compute rate)."""
    return 1e3 * (x.numel() + 2 * skip.numel()) * x.element_size() \
        / HBM_BYTES_PER_S


def phase_gather_kernels():
    """gather_rows against gather_rows_plain on the card, bitwise, at the
    main path's shapes and at the edges of its contract."""
    from tlxcv_tpu_torch.ops.cuda.gather import gather_rows, gather_rows_plain

    g = torch.Generator(device="cuda").manual_seed(11)
    cases = []
    big = torch.randn(*GATHER_TABLE, generator=g, device="cuda").to(
        torch.bfloat16)
    for name, r in GATHER_ROWS.items():
        cases.append((name, big, torch.randint(
            0, big.shape[0], (r,), generator=g, device="cuda",
            dtype=torch.int32)))
    for dtype in (torch.float32, torch.bfloat16, torch.int32, torch.uint8):
        for n, c, r in ((500, 256, 777), (1000, 1024, 4097), (37, 3, 5),
                        (64, 13, 100), (9, 5, 1)):
            if dtype.is_floating_point:
                t = torch.randn(n, c, generator=g, device="cuda").to(dtype)
            else:
                t = torch.randint(0, 100, (n, c), generator=g, device="cuda",
                                  dtype=torch.int32).to(dtype)
            idx = torch.randint(0, n, (r,), generator=g, device="cuda",
                                dtype=torch.int32)
            idx[:4] = torch.tensor([0, n - 1, 0, n - 1][:r])  # repeated, ends
            cases.append((f"{str(dtype)[6:]}_{n}x{c}_r{r}", t, idx))
    results = []
    for name, table, idx in cases:
        got = gather_rows(table, idx)
        torch.cuda.synchronize()
        same = torch.equal(got, gather_rows_plain(table, idx))
        results.append({"case": name, "table": list(table.shape),
                        "rows": idx.numel(), "bitwise": same})
        if not same:
            emit({"phase": "gather_kernels", "failed": results[-1]})
            raise AssertionError(f"gather_rows {name} differs from plain")
    emit({"phase": "gather_kernels", "cases": results, "tolerance": 0,
          "why": "a byte copy"})
    return {"name": "gather_rows", "route": "cuda",
            "source": "tlxcv_tpu_torch/csrc/gather_rows.cu",
            "replaces": "tlxcv_tpu/ops/pallas/gather.py:36",
            "max_abs_err": 0.0}


def upsample_tolerance(mode, dtype, want):
    """Nearest: bitwise.  Bilinear: the plain version's f32 operations in
    its order without FMA, so bitwise is expected; bound 1e-5 in f32 (the
    reference test's) and one bf16 step of the largest output in bf16."""
    if mode == "nearest":
        return 0.0
    if dtype == torch.float32:
        return 1e-5
    return 2.0 ** -8 * want.float().abs().max().item()


def phase_upsample_kernels():
    """upsample_add_fused against upsample_add_plain on the card, at the
    FPN's b16 shapes and at the edges of its contract."""
    from tlxcv_tpu_torch.ops.cuda.upsample import (upsample_add_fused,
                                                   upsample_add_plain)

    g = torch.Generator(device="cuda").manual_seed(12)
    shapes = FPN_STEPS + [((2, 38, 38, 8), (75, 75)),
                          ((2, 38, 38, 256), (75, 75)),
                          ((1, 7, 9, 8), (7, 18)), ((1, 5, 6, 3), (11, 13))]
    results = []
    for xshape, out_hw in shapes:
        for dtype in (torch.bfloat16, torch.float32):
            x = torch.randn(*xshape, generator=g, device="cuda").to(dtype)
            skip = torch.randn(xshape[0], *out_hw, xshape[3], generator=g,
                               device="cuda").to(dtype)
            for mode in ("nearest", "bilinear"):
                got = upsample_add_fused(x, skip, mode)
                torch.cuda.synchronize()
                want = upsample_add_plain(x, skip, mode)
                err = (got.float() - want.float()).abs().max().item()
                tol = upsample_tolerance(mode, dtype, want)
                results.append({"x": list(xshape), "out_hw": list(out_hw),
                                "dtype": str(dtype)[6:], "mode": mode,
                                "max_abs_err": err, "atol": tol})
                if got.dtype != dtype or not err <= tol:
                    emit({"phase": "upsample_kernels", "failed": results[-1]})
                    raise AssertionError(f"upsample_add_fused {results[-1]}")
    emit({"phase": "upsample_kernels", "cases": results})
    return {"name": "upsample_add_fused", "route": "cuda",
            "source": "tlxcv_tpu_torch/csrc/upsample_add.cu",
            "replaces": "tlxcv_tpu/ops/pallas/upsample.py:117",
            # the main path's calls: nearest, bf16, the FPN's shapes
            "max_abs_err": max(r["max_abs_err"] for r in results
                               if r["mode"] == "nearest"
                               and r["dtype"] == "bfloat16"
                               and [r["x"], r["out_hw"]] in
                               [[list(a), list(b)] for a, b in FPN_STEPS])}


# ------------------------------------------------------------- Mask R-CNN
def _rel(got, want):
    """max |got - want| over max |want|."""
    scale = want.abs().max().item()
    return (got.float().cpu() - want).abs().max().item() / max(scale, 1e-30)


def _box_iou(a, b):
    lt = torch.maximum(a[:, None, :2], b[None, :, :2])
    rb = torch.minimum(a[:, None, 2:], b[None, :, 2:])
    inter = (rb - lt).clamp_min(0).prod(-1)
    area = lambda t: (t[:, 2:] - t[:, :2]).clamp_min(0).prod(-1)  # noqa
    return inter / (area(a)[:, None] + area(b)[None, :] - inter + 1e-9)


def matched_share(want, got, labels=True):
    """Share of the reference's valid detections (rows [label, score, x1,
    y1, x2, y2], label -1 for none) that a detection of the card matches:
    the same label (unless ``labels`` is False) and IoU >= 0.9, or every
    coordinate within 0.5 px (random weights give some zero-area boxes,
    whose IoU is 0 even with themselves)."""
    hits = total = 0
    for w, g in zip(want, got):
        w, g = w[w[:, 0] >= 0], g[g[:, 0] >= 0].float().cpu()
        if len(w) == 0:
            continue
        close = (_box_iou(w[:, 2:], g[:, 2:]) >= 0.9) | (
            (w[:, None, 2:] - g[None, :, 2:]).abs().amax(-1) <= 0.5)
        if labels:
            close &= w[:, None, 0] == g[None, :, 0]
        hits += int(close.any(1).sum())
        total += len(w)
    return hits / max(total, 1)


def as_dets(boxes, valid):
    """Boxes [N, R, 4] with a validity mask as detection rows (label 0)."""
    return torch.cat([torch.where(valid, 0.0, -1.0)[..., None].float(),
                      torch.zeros_like(valid, dtype=torch.float32)[..., None],
                      boxes.float()], -1)


# bounds, relative to the largest reference value of each stage: f32 on the
# card (TF32 off) differs from the CPU by summation order only; bf16 rounds
# weights and activations to 8 bits through ~60 convolutions
MRCNN_BOUND = {"float32": 1e-3, "bfloat16": 5e-2}
# share of the CPU's detections the card must reproduce (same label and
# box).  f32 moves a logit by ~1e-5 of its scale, which reorders only
# near-ties.  bf16 moves the RPN logits by ~3% of their scale; with random
# weights (the RPN's convs drawn at std 0.01) the objectness logits of the
# 102,300 anchors lie close together, so the pre-NMS top 512 and the
# proposals after NMS change: 58% of the CPU's proposals and 49% of its
# detections were reproduced at seed 0, labels agreeing wherever boxes do
# (0.5 was predicted and first set as the floor).  A wrong kernel or
# layout reproduces almost none, so 0.25 still tells a working path from
# a broken one; the label-free share and the proposals' share are
# reported beside it, and the heads are held stage by stage above.
MRCNN_SHARE_FLOOR = {"float32": 0.9, "bfloat16": 0.25}


def mrcnn_stages(model, x, props=None, det_boxes=None):
    """The staged outputs of one forward: FPN levels, RPN logits and deltas,
    proposals, detections, counts and masks; box-head logits on ``props``
    and mask logits on ``det_boxes`` (the model's own when not given)."""
    with torch.inference_mode():
        feats, logits, deltas, _, p, pmask = model.forward_features(x)
        cls, bdel = model.box_logits(feats, p)
        dets, counts, masks = model._postprocess(feats, p, pmask, cls, bdel,
                                                 x.shape[1:3])
        if props is not None:
            cls, bdel = model.box_logits(feats, props)
        mlog = model.mask_logits(feats, dets[..., 2:6] if det_boxes is None
                                 else det_boxes)
    return {"feats": feats, "rpn_logits": logits, "rpn_deltas": deltas,
            "props": p, "pmask": pmask, "cls_logits": cls, "box_deltas": bdel,
            "dets": dets, "counts": counts, "masks": masks,
            "mask_logits": mlog}


def phase_mask_rcnn(gather_record, upsample_record):
    """Mask R-CNN (``create_model("mask_rcnn")``, ResNet-50 + FPN, 80
    classes, random weights and BatchNorm statistics from a seed): staged
    f32 and bf16 checks at b2 640^2 against f32 on the CPU, then the
    bench leg, b16 640^2 bf16 ``predict``, served and timed."""
    from tlxcv_tpu_torch import create_model
    from tlxcv_tpu_torch.tasks import ObjectDetection

    name = "mask_rcnn"
    gen = torch.Generator().manual_seed(0)
    # box_score_thresh=0: with random weights a class probability sits near
    # 1/81, under the leg's 0.05, and no detection would be left to compare
    card = create_model(name, generator=gen, box_score_thresh=0.0).eval()
    random_bn_statistics(card, gen)
    cpu = create_model(name, device="cpu", box_score_thresh=0.0).eval()
    cpu.load_state_dict({k: t.cpu() for k, t in card.state_dict().items()})
    x2 = torch.randn(2, 640, 640, 3, generator=gen)
    t0 = time.perf_counter()
    want = mrcnn_stages(cpu, x2)
    cpu_s = time.perf_counter() - t0
    for dtype in (torch.float32, torch.bfloat16):
        if dtype == torch.bfloat16:
            params_to(card, dtype)
        dname = str(dtype)[6:]
        got = mrcnn_stages(card, x2.to("cuda", dtype),
                           props=want["props"].cuda(),
                           det_boxes=want["dets"][..., 2:6].cuda())
        errs = {f"P{i + 2}": _rel(g, w)
                for i, (g, w) in enumerate(zip(got["feats"], want["feats"]))}
        errs.update({k: _rel(got[k], want[k]) for k in
                     ("rpn_logits", "rpn_deltas", "cls_logits", "box_deltas",
                      "mask_logits")})
        counts = got["counts"].cpu().tolist()
        share = matched_share(want["dets"], got["dets"])
        box_share = matched_share(want["dets"], got["dets"], labels=False)
        prop_share = matched_share(as_dets(want["props"], want["pmask"]),
                                   as_dets(got["props"], got["pmask"]))
        finite = all(bool(torch.isfinite(got[k]).all())
                     for k in ("dets", "masks", "cls_logits"))
        check = {"phase": "model_check", "model": name, "batch": 2,
                 "dtype": dname, "rel_max_abs_err": errs,
                 "bound": MRCNN_BOUND[dname], "counts": counts,
                 "cpu_counts": want["counts"].tolist(),
                 "matched_share": share,
                 "share_floor": MRCNN_SHARE_FLOOR[dname],
                 "box_share_any_label": box_share,
                 "proposal_share": prop_share,
                 "pmask_equal_share": (got["pmask"].cpu() == want["pmask"])
                 .float().mean().item(), "finite": finite,
                 "cpu_reference_s": cpu_s,
                 "heads_on": "the CPU's proposals and detections"}
        emit(check)
        if not finite or min(counts) <= 0:
            raise AssertionError(f"Mask R-CNN {dname}: {check}")
        if max(errs.values()) > MRCNN_BOUND[dname]:
            raise AssertionError(f"Mask R-CNN {dname} stages disagree with "
                                 f"the CPU: {errs}")
        if share < MRCNN_SHARE_FLOOR[dname]:
            raise AssertionError(f"Mask R-CNN {dname}: {share} of the CPU's "
                                 f"detections matched")
    del cpu, want, got

    # the bench leg: b16 640^2 bf16, the leg's own score threshold
    card.box_score_thresh = 0.05
    task = ObjectDetection(card)
    x = torch.randn(16, 640, 640, 3, generator=gen).to("cuda", torch.bfloat16)

    def check_dets(out, batch):
        dets, counts, masks = out
        if dets.shape != (batch, 100, 6) or masks.shape != (batch, 100, 28,
                                                            28):
            raise AssertionError(f"bad Mask R-CNN outputs {dets.shape} "
                                 f"{masks.shape}")
        if not (torch.isfinite(dets).all() and torch.isfinite(masks).all()):
            raise AssertionError("non-finite Mask R-CNN outputs")

    counts, step = serve(task, x, {"gather_rows": 2, "upsample_add_fused": 3},
                         name, "bfloat16", check=check_dets)
    gather_record["launches"] = counts["gather_rows"]
    upsample_record["launches"] = counts["upsample_add_fused"]
    mrcnn_kernel_times(task, x, gather_record, upsample_record)
    return task, x, step


@contextlib.contextmanager
def recorded_merges():
    """``ops.image``'s upsample-add kernel wrapped for the ``with`` block:
    each call's inputs and whether its output is bitwise the plain
    version's on them, appended to the list it yields."""
    import tlxcv_tpu_torch.ops.image as image
    from tlxcv_tpu_torch.ops.cuda.upsample import (upsample_add_fused,
                                                   upsample_add_plain)

    calls = []

    def wrapped(x, skip, mode):
        out = upsample_add_fused(x, skip, mode)
        calls.append((x, skip, mode, torch.equal(
            out, upsample_add_plain(x, skip, mode))))
        return out

    image.upsample_add_fused = wrapped
    try:
        yield calls
    finally:
        image.upsample_add_fused = upsample_add_fused


def merge_time_rows(calls):
    """Each upsample-add call that ``recorded_merges`` saw timed alone: the
    kernel, its plain version and ``F.interpolate`` plus the add, device
    time from CUDA-graph replays, the kernel's event-timed call beside
    them, the bound, and whether the call was bitwise its plain version."""
    from tlxcv_tpu_torch.ops.cuda.upsample import (upsample_add_fused,
                                                   upsample_add_plain)

    rows = []
    for a, b, mode, same in calls:
        size = tuple(b.shape[1:3])

        def library(a=a, b=b, mode=mode, size=size):
            up = torch.nn.functional.interpolate(a.permute(0, 3, 1, 2),
                                                 size=size, mode=mode)
            return up.permute(0, 2, 3, 1) + b

        rows.append({"x": list(a.shape), "skip": list(b.shape), "mode": mode,
                     "dtype": str(a.dtype)[6:],
                     "ms": graph_ms(lambda: upsample_add_fused(a, b, mode)),
                     "plain_ms": graph_ms(lambda: upsample_add_plain(a, b,
                                                                     mode)),
                     "library_ms": graph_ms(library),
                     "event_ms": time_ms(lambda: upsample_add_fused(a, b,
                                                                    mode)),
                     "bound_ms": upsample_bound_ms(a, b), "bitwise": same})
    return rows


def mrcnn_kernel_times(task, x, gather_record, upsample_record):
    """Both kernels timed alone on the inputs one served forward hands
    them (captured by wrapping the wrappers, outside any counted run; each
    merge held bitwise against its plain version on the same inputs),
    with their plain versions, the library calls and the bounds; summed
    over the forward.  Device times from CUDA-graph replays; the
    event-timed calls, which also count the wrapper's host time where it
    is the longer, beside them."""
    import tlxcv_tpu_torch.ops.roi_align as roi_align
    from tlxcv_tpu_torch.ops.cuda.gather import gather_rows, gather_rows_plain

    gathers = []
    roi_align.gather_rows = lambda t, i: (
        gathers.append((t, i)) or gather_rows(t, i))
    try:
        with recorded_merges() as merges, torch.inference_mode():
            task.predict(x)
    finally:
        roi_align.gather_rows = gather_rows
    keys = ("ms", "plain_ms", "library_ms", "bound_ms")
    rows = []
    for (table, idx), branch in zip(gathers, ("box", "mask")):
        bound, bound_2r, distinct = gather_bound_ms(table, idx)
        rows.append({"branch": branch, "table": list(table.shape),
                     "rows": idx.numel(), "distinct_rows": distinct,
                     "ms": graph_ms(lambda: gather_rows(table, idx)),
                     "plain_ms": graph_ms(lambda: gather_rows_plain(table,
                                                                    idx)),
                     "library_ms": graph_ms(
                         lambda: torch.index_select(table, 0, idx)),
                     "event_ms": time_ms(lambda: gather_rows(table, idx)),
                     "bound_ms": bound, "bound_ms_2_r_row_bytes": bound_2r})
    gather_record.update({k: sum(r[k] for r in rows) for k in keys},
                         bound_by="bytes")
    emit({"phase": "kernel_times", "gather_rows_per_forward": rows})
    del gathers
    rows = merge_time_rows(merges)
    upsample_record.update({k: sum(r[k] for r in rows) for k in keys},
                           bound_by="bytes")
    emit({"phase": "kernel_times", "upsample_add_fused_per_forward": rows})
    torch.cuda.empty_cache()
    if not all(r["bitwise"] for r in rows):
        raise AssertionError(f"Mask R-CNN's merges differ from the plain "
                             f"version: {rows}")


# ----------------------------------------------------------------- YOLOv3
def yolo_stages(model, x):
    """Head outputs, the decoded boxes and scores before NMS, and the
    detections of one forward."""
    with torch.inference_mode():
        outs = model.head_outputs(x)
        boxes, scores = model.decode(outs, x.shape[1:3])
        dets, counts = model.nms(boxes, scores)
    return {"heads": outs, "boxes": boxes, "scores": scores, "dets": dets,
            "counts": counts}


def _rms(a, b):
    return (a.double().cpu() - b.double().cpu()).pow(2).mean().sqrt().item()


def int8_layers_bitwise(name, cpu8, run, kinds):
    """``run(cpu8)`` on the CPU, recording each layer of ``kinds`` with its
    input and output; then each of those layers of a copy of ``cpu8`` on
    the card, given the CPU's input, must return the CPU's output bitwise
    (an int8 layer is an exact int32 GEMM between IEEE element-wise ops).
    Returns the card's copy, the CPU's output, the layers checked and the
    CPU forward's seconds."""
    seen = []
    handles = [m.register_forward_hook(
        lambda mod, args, out: seen.append((mod, args[0], out)))
        for m in cpu8.modules() if isinstance(m, kinds)]
    t0 = time.perf_counter()
    try:
        with torch.inference_mode():
            want = run(cpu8)
    finally:
        for h in handles:
            h.remove()
    cpu_s = time.perf_counter() - t0
    card8 = copy.deepcopy(cpu8).cuda()
    names = {id(m): p for p, m in cpu8.named_modules()}
    card_mods = dict(card8.named_modules())
    with torch.inference_mode():
        for mod, xin, yout in seen:
            got = card_mods[names[id(mod)]](xin.cuda()).cpu()
            if not torch.equal(got, yout):
                raise AssertionError(f"int8 layer {names[id(mod)]} of {name} "
                                     f"differs from the CPU on its input")
    return card8, want, len(seen), cpu_s


def yolo_int8_check(cpu8, cpu, x1):
    """int8 YOLOv3 on the card against the same int8 model on the CPU, at
    b1 416^2.  Layer by
    layer it must be exact: each int8 conv on the card, given the CPU's
    input to it, returns the CPU's output bitwise (an exact int32 GEMM
    between IEEE element-wise ops).  End to end the two chains drift apart
    as the JAX package's and the port's do on the CPU
    (tests/test_torch_yolov3.py): the float BatchNorm and leaky ReLU
    between the 75 unfolded int8 layers round differently on the two
    devices (torch.rsqrt among them), and a code flipped by one moves the
    next layer's inputs across further rounding boundaries (on one H100
    80GB HBM3 the two chains' head outputs differ by 0.37-0.43 times as
    much as either differs from the f32 model, and the card's lies
    0.995-1.003 times as far from it as the CPU's; only 8-34% of the head
    outputs lie within 4 quantization steps of the CPU's, the steps being
    small beside the int8 model's own error).  So the head outputs are
    held to the int8
    model's own error against its f32 model on the CPU, per level: the
    card's int8 model within 1.25 times it of the f32 model (as accurate as
    the CPU's), and within sqrt(2) times it of the CPU's int8 model (two
    quantization noises of that size).  Exactly 75 int8 GEMM launches per
    forward."""
    from tlxcv_tpu_torch.nn import Conv2d
    from tlxcv_tpu_torch.ops.cuda.matmul import int8_matmul

    card8, want8, layers_equal, cpu_s = int8_layers_bitwise(
        "yolov3", cpu8, lambda m: m.head_outputs(x1), (Conv2d,))
    with torch.inference_mode():
        want32 = cpu.head_outputs(x1)
        reset_launches()
        got8 = card8.head_outputs(x1.cuda())
        per_forward = int8_matmul.launches
    levels = []
    for conv, g, w, f in zip(cpu8.yolo_head.yolo_outputs, got8, want8,
                             want32):
        step = float(conv.a_scale * 127 * conv.w_scale.max())
        diff = (g.float().cpu() - w).abs()
        levels.append({"rms_card_cpu": _rms(g, w),
                       "rms_card_f32_cpu": _rms(g, f),
                       "rms_int8_f32_cpu": _rms(w, f),
                       "max_abs_err": diff.max().item(),
                       "step": step,
                       "share_within_4_steps":
                           (diff <= 4 * step).float().mean().item()})
    check = {"batch": 1, "hw": list(x1.shape[1:3]), "cpu_s": cpu_s,
             "layers_bitwise_equal": layers_equal, "levels": levels,
             "launches_per_forward": per_forward,
             "finite": all(bool(torch.isfinite(g).all()) for g in got8)}
    emit({"phase": "model_check", "model": "yolov3_int8", **check})
    if not check["finite"] or any(
            lv["rms_card_f32_cpu"] > 1.25 * lv["rms_int8_f32_cpu"]
            or lv["rms_card_cpu"] > math.sqrt(2) * lv["rms_int8_f32_cpu"]
            for lv in levels):
        raise AssertionError(f"int8 YOLOv3 disagrees with the CPU: {check}")
    if layers_equal != 75 or per_forward != 75:
        raise AssertionError(f"int8 YOLOv3: {layers_equal} layers equal, "
                             f"{per_forward} GEMM launches per forward; "
                             f"expected 75 and 75")
    return card8


# f32 on the card (TF32 off) differs from the CPU by summation order only:
# the head outputs and, end to end, the decoded boxes and scores within
# YOLO_F32_BOUND of the largest reference value.  A random network whose
# BatchNorms normalise its own activations is chaotic at init: through its
# 72 BatchNorms a rounding difference grows by orders of magnitude (the f32
# heads differ by 5.6e-5 of their max, the bf16 heads from the CPU's f32
# ones by 18-33%, on one H100 80GB HBM3; the CPU's own bf16 model lies as
# far from its f32 one).  So bf16 is held, per level, to the CPU's bf16
# model's rms error against the f32 model: the card's bf16 model within
# YOLO_BF16_RMS[0] times it of the f32 model (as accurate as the CPU's),
# and within YOLO_BF16_RMS[1] times it of the CPU's bf16 model (two
# rounding noises of that size).  The decode and the NMS are each also held
# alone: fed the CPU's own inputs in the run's dtype, against the CPU's
# decode and NMS of the same inputs.
YOLO_F32_BOUND = 1e-3
# PP-YOLOE-L and SSD with random weights are chaotic in f32 too (a
# BatchNorm network at init amplifies any rounding difference): PP-YOLOE-L's
# f32 heads on one H100 80GB HBM3 (700 W) lay 1.2% of their largest value
# from the CPU's at 640^2, where YOLO_F32_BOUND allows 0.1%.  So their f32
# heads, boxes and scores are held against the CPU's model run in f64: the
# card's rms error within CHAOTIC_F32_RMS times the CPU f32 model's own
# (cuDNN's f32 convolutions with TF32 off against oneDNN's).  Read on that
# card: 2.26-2.35 for PP-YOLOE-L's stages, 1.62-1.92 for SSD's; a wrong
# layer moves the heads by their own size, 1e3 times more
CHAOTIC_F32_RMS = 4.0
YOLO_BF16_RMS = (1.25, math.sqrt(2))
# the share of the decode's outputs within one bf16 ulp of the CPU's on the
# same bf16 inputs (sigmoid and exp may round differently on the two
# devices, and a probability on the conf_thresh cut may flip a box)
YOLO_BF16_DECODE_SHARE = 0.999
# the share of the CPU's f32 detections the card reproduces (same label and
# box), end to end, and by the NMS alone on the same inputs.  In bf16 the
# chaotic heads reorder which of the near-equal candidate scores survive:
# 0.35 end to end on one H100 80GB HBM3, 0.37 for the CPU's own bf16 model
YOLO_SHARE_FLOOR = {"float32": 0.9, "bfloat16": 0.25}
YOLO_NMS_SHARE_FLOOR = 0.9


def yolo_float_check(cpu, card, x2):
    """f32 and bf16 YOLOv3 on the card against f32 on the CPU, stage by
    stage (bf16 beside the CPU's own bf16 model); ``card`` is left with
    bf16 parameters."""
    dense_detector_check(
        "yolov3", cpu, card, x2, yolo_stages,
        decode=lambda m, heads, hw: m.decode(heads, hw),
        nms=lambda m, boxes, scores: m.nms(boxes, scores),
        bf16_share_floor=YOLO_SHARE_FLOOR["bfloat16"])


def dense_detector_check(name, cpu, card, x2, stages, decode, nms,
                         bf16_share_floor, f64_truth=False):
    """f32 and bf16 outputs of a detector with a dense head (YOLOv3,
    PP-YOLOE, SSD) on the card against f32 on the CPU, stage by stage, as
    ``YOLO_F32_BOUND`` and the comments below it say (bf16 beside the CPU's
    own bf16 model).  ``stages(model, x)`` gives the head outputs
    (``heads``, a list), the decoded ``boxes`` and ``scores`` before NMS,
    and the ``dets`` and ``counts``; ``decode(model, heads, input_hw)`` and
    ``nms(model, boxes, scores)`` run the decode and the NMS alone.  The
    share of the CPU's f32 detections reproduced end to end is held to
    ``YOLO_SHARE_FLOOR`` in f32 and to ``bf16_share_floor`` in bf16 (None:
    reported, not held).  With ``f64_truth`` the f32 head outputs and
    decoded boxes and scores are held instead against the CPU's model in
    f64: the card's rms error within ``CHAOTIC_F32_RMS`` times the CPU f32
    model's.  ``card`` is left with bf16 parameters."""

    def by_key(out):
        return dict({f"head{i}": h for i, h in enumerate(out["heads"])},
                    boxes=out["boxes"], scores=out["scores"])

    t0 = time.perf_counter()
    want = stages(cpu, x2)
    cpu_s = time.perf_counter() - t0
    truth = by_key(stages(copy.deepcopy(cpu).double(), x2.double())) \
        if f64_truth else None
    hw = x2.shape[1:3]
    keys = ("boxes", "scores")
    for dtype in (torch.float32, torch.bfloat16):
        dname = str(dtype)[6:]
        if dtype == torch.bfloat16:
            params_to(card, dtype)
            want16 = stages(params_to(copy.deepcopy(cpu), dtype),
                            x2.to(dtype))
        got = stages(card, x2.to("cuda", dtype))
        errs = {f"head{i}": _rel(g, w)
                for i, (g, w) in enumerate(zip(got["heads"], want["heads"]))}
        decoded = {k: _rel(got[k], want[k]) for k in keys}
        with torch.inference_mode():  # the decode and the NMS alone
            heads = [h.to(dtype) for h in want["heads"]]
            ref = decode(cpu, heads, hw)
            alone = decode(card, [h.cuda() for h in heads], hw)
            inputs = [want[k].to(dtype) for k in keys]
            ref_dets, _ = nms(cpu, *inputs)
            nms_dets, _ = nms(card, *(t.cuda() for t in inputs))
        decoded.update({f"{k}_on_cpu_heads": _rel(g, r)
                        for k, g, r in zip(keys, alone, ref)})
        levels = None
        over_cpu = None
        if dtype == torch.float32:
            errs.update(decoded)
            if truth:
                g, w = by_key(got), by_key(want)
                over_cpu = {k: _rms(g[k], t) / max(_rms(w[k], t), 1e-30)
                            for k, t in truth.items()}
        else:
            decoded.update({f"{k}_on_cpu_heads_share_within_one_ulp":
                            bf16_close_share(g, r)
                            for k, g, r in zip(keys, alone, ref)})
            levels = [{"rms_card_f32_cpu": _rms(g, w),
                       "rms_cpu_bf16_f32_cpu": _rms(c, w),
                       "rms_card_cpu_bf16": _rms(g, c)}
                      for g, c, w in zip(got["heads"], want16["heads"],
                                         want["heads"])]
        nms_share = matched_share(ref_dets, nms_dets)
        share = matched_share(want["dets"], got["dets"])
        counts = got["counts"].cpu().tolist()
        finite = all(bool(torch.isfinite(got[k]).all())
                     for k in ("boxes", "scores", "dets"))
        floor = YOLO_SHARE_FLOOR["float32"] if levels is None \
            else bf16_share_floor
        check = {"phase": "model_check", "model": name, "batch": 2,
                 "dtype": dname, "rel_max_abs_err": errs,
                 "bound": YOLO_F32_BOUND, "levels": levels,
                 "rms_bound": YOLO_BF16_RMS,
                 "f64_rms_card_over_cpu": over_cpu,
                 "f64_rms_bound": CHAOTIC_F32_RMS if truth else None,
                 "decoded_rel_max_abs_err": decoded, "counts": counts,
                 "cpu_counts": want["counts"].tolist(),
                 "matched_share": share,
                 "share_floor": floor,
                 "cpu_bf16_matched_share": matched_share(
                     want["dets"], want16["dets"]) if levels else None,
                 "cpu_scores_at_one": int((inputs[1] == 1).sum()),
                 "nms_share_on_cpu_inputs": nms_share, "finite": finite,
                 "cpu_reference_s": cpu_s}
        emit(check)
        if not finite or min(counts) <= 0:
            raise AssertionError(f"{name} {dname}: {check}")
        if dtype == torch.float32 and any(
                over_cpu[k] > CHAOTIC_F32_RMS if over_cpu and k in over_cpu
                else e > YOLO_F32_BOUND for k, e in errs.items()):
            raise AssertionError(f"{name} f32 stages disagree with the CPU: "
                                 f"{errs}, {over_cpu}")
        if levels and any(
                lv["rms_card_f32_cpu"] > YOLO_BF16_RMS[0]
                * lv["rms_cpu_bf16_f32_cpu"] or lv["rms_card_cpu_bf16"]
                > YOLO_BF16_RMS[1] * lv["rms_cpu_bf16_f32_cpu"]
                for lv in levels):
            raise AssertionError(f"{name} bf16 heads less accurate than the "
                                 f"CPU's bf16 model: {levels}")
        if levels and min(v for k, v in decoded.items()
                          if k.endswith("_ulp")) < YOLO_BF16_DECODE_SHARE:
            raise AssertionError(f"{name} bf16 decode disagrees with the "
                                 f"CPU's on the same inputs: {decoded}")
        if nms_share < YOLO_NMS_SHARE_FLOOR or (
                floor is not None and share < floor):
            raise AssertionError(f"{name} {dname}: {share} of the CPU's "
                                 f"detections matched, {nms_share} by the "
                                 f"NMS alone")
    del want, want16, got


def phase_yolov3(floats=True):
    """YOLOv3 (``create_model("yolov3", num_classes=80,
    use_matrix_nms=True)``, random weights from a seed, BatchNorm
    statistics from one train-mode forward of 2 seeded images): f32 and
    bf16 at b2 416^2 against f32 on the CPU stage by stage (bf16 beside the
    CPU's own bf16 model); int8 on the card against int8 on the CPU; then
    the bench legs ``yolov3`` and ``yolov3_int8``, b128 416^2 ``predict``,
    served (with ``floats`` False, the int8 check and leg alone)."""
    from tlxcv_tpu_torch import create_model
    from tlxcv_tpu_torch.ops.quant import (calibrate_activations,
                                           quantize_weights)
    from tlxcv_tpu_torch.tasks import ObjectDetection

    name = "yolov3"
    gen = torch.Generator().manual_seed(0)
    cpu = create_model(name, device="cpu", generator=gen, num_classes=80,
                       use_matrix_nms=True)
    data_bn_statistics(cpu, torch.randn(2, 416, 416, 3, generator=gen))
    card = copy.deepcopy(cpu).cuda() if floats else None
    x2 = torch.randn(2, 416, 416, 3, generator=gen)
    if floats:
        yolo_float_check(cpu, card, x2)

    # full int8, built as the JAX package's bench builds it: weights, then
    # activations calibrated through head_outputs on 2 images, on the CPU
    cpu8 = copy.deepcopy(cpu)
    calib = torch.randn(2, 416, 416, 3, generator=gen)
    t0 = time.perf_counter()
    n_q = quantize_weights(cpu8)
    n_cal = calibrate_activations(cpu8, [calib], forward=cpu8.head_outputs)
    emit({"phase": "int8_prep", "model": name, "quantized": n_q,
          "calibrated": n_cal, "prep_s": time.perf_counter() - t0})
    if n_q != 75 or n_cal != 75:
        raise AssertionError(f"YOLOv3 int8 preparation: {n_q} quantized, "
                             f"{n_cal} calibrated; expected 75")
    card8 = yolo_int8_check(cpu8, cpu, x2[:1])
    del cpu, cpu8

    # the bench legs: b128 416^2 predict, bf16 images
    x = torch.randn(128, 416, 416, 3, generator=gen).to("cuda",
                                                         torch.bfloat16)

    def check_dets(out, batch):
        dets, counts = out
        if dets.shape != (batch, 100, 6) or counts.shape != (batch,):
            raise AssertionError(f"bad YOLOv3 outputs {dets.shape}")
        if not torch.isfinite(dets).all() or int(counts.min()) <= 0:
            raise AssertionError("non-finite or empty YOLOv3 detections")

    task = ObjectDetection(card) if floats else None
    task8 = ObjectDetection(card8)
    step = serve(task, x, {}, name, "bfloat16", check=check_dets)[1] \
        if floats else None
    _, step8 = serve(task8, x, {"int8_matmul": 75}, name + "_int8",
                     "int8 (bf16 input)", check=check_dets)
    int8_forward_times(card8, x, "int8_matmul_per_yolov3_forward")
    return task, task8, x, step, step8


# ------------------------------------------------------------- training
# The transposed resize (the FPN upsample-add's backward) at the main
# path's shapes, b8 640^2: g at 40^2, 80^2, 160^2 -> dx at 20^2, 40^2, 80^2.
SEP_STEPS = [((8, 40, 40, 256), (20, 20)), ((8, 80, 80, 256), (40, 40)),
             ((8, 160, 160, 256), (80, 80))]
# one parameter from each part of Mask R-CNN, for the gradient check
MRCNN_PROBES = ("backbone.conv1.weight",
                "backbone.layer4.layers.2.conv3.weight",
                "fpn.lateral.0.weight", "fpn.output.0.weight",
                "rpn_head.conv.weight", "box_head.fc1.weight",
                "mask_head.convs.0.weight")
RESNET_PROBES = ("conv1.weight", "layer4.layers.2.conv3.weight", "fc.weight")
# Gradients on the card against the CPU, as a share of each parameter's max
# |g|, with the CPU's float64 gradient as the arbiter.  Some f32 gradients
# of these models are ill-conditioned: where a BatchNorm's output gradient
# lies close to what its backward removes (its mean and its projection on
# the normalised input), the conv before it sums a small residue of large
# terms.  So the card's f32 gradient is held to be as close to float64 as
# the CPU's own f32 one, within a factor 4 (cuDNN may pick FFT or Winograd
# convolutions, which sum along other paths), or within 1e-3 of the max;
# the loss within 1e-3.  bf16 rounds every weight, activation and
# activation gradient to 8 bits of mantissa, 2^16 times f32's rounding, so
# the gradients that sum a small residue of large terms are mostly
# rounding noise in bf16 at random init (measured on an H100 against
# float64: cosines 0.07-0.12 for the stem, 0.48-0.61 for C5's last conv,
# 0.81 for the RPN conv, 0.88 for the box head's fc1).  So in bf16 the
# loss is held within 0.1 (bf16's forward through ~60 layers), every
# parameter must get a non-zero gradient, and the probes that are not
# swamped (the FPN's lateral and output convs, the mask head, the
# classifier: cosines above 0.99 measured) must point within cosine 0.95
# of float64; the others are reported.  A detector's loss divided by the
# sum of its targets' scores (PP-YOLOE's varifocal loss: the IoUs of the
# predicted boxes) moves further in bf16: there the bound is twice the CPU's
# own bf16 model's distance from its f32 loss where that is the larger
# (PP-YOLOE-L b2 256^2: 8.1% on the CPU, 10.6% on an H100).
TRAIN_BOUND = {"float32": (1e-3, 1e-3), "bfloat16": (0.1, None)}
BF16_COSINE_PROBES = ("fpn.lateral.0.weight", "fpn.output.0.weight",
                      "mask_head.convs.0.weight", "backbone.fc.weight")


def cpu_conv_reference():
    """The CPU reference's training convolutions without oneDNN, whose f32
    weight gradients at some stride-2 shapes are several per cent of max
    |g| from float64 (tests/test_torch_trainer.py), while PyTorch's own CPU
    convolutions agree with float64 to 1e-5."""
    return torch.backends.mkldnn.flags(enabled=False)


def sep_bound_ms(g, out_hw):
    """g read once and dx written once over the memory rate (a few
    additions per element, far below the compute rate)."""
    n, _, _, c = g.shape
    return 1e3 * (g.numel() + n * out_hw[0] * out_hw[1] * c) \
        * g.element_size() / HBM_BYTES_PER_S


def phase_train_kernels():
    """sep_resize (the transposed resize) against sep_resize_plain on the
    card: the FPN backward's b8 shapes in bf16 and f32, nearest and
    bilinear, 38 -> 75 at C = 3, 8 and 256, a stride-0 and a permuted g."""
    from tlxcv_tpu_torch.ops.cuda.upsample import (sep_resize,
                                                   sep_resize_plain, sep_taps)

    dev = torch.device("cuda")
    g = torch.Generator(device="cuda").manual_seed(13)
    cases = []  # name, g, dx's (height, width), mode
    for dtype in (torch.bfloat16, torch.float32):
        dn = str(dtype)[6:]
        for gshape, in_hw in SEP_STEPS:
            for mode in ("nearest", "bilinear"):
                cases.append((f"fpn_{gshape[1]}_{mode}_{dn}",
                              torch.randn(*gshape, generator=g, device=dev)
                              .to(dtype), in_hw, mode))
        for c in (3, 8, 256):
            for mode in ("nearest", "bilinear"):
                cases.append((f"75to38_c{c}_{mode}_{dn}",
                              torch.randn(2, 75, 75, c, generator=g,
                                          device=dev).to(dtype), (38, 38),
                              mode))
        cases.append((f"stride0_{dn}", torch.tensor(0.5, device=dev).to(
            dtype).expand(8, 40, 40, 256), (20, 20), "nearest"))
        cases.append((f"permuted_{dn}", torch.randn(
            8, 256, 40, 40, generator=g, device=dev).to(dtype).permute(
            0, 2, 3, 1), (20, 20), "bilinear"))
    results = []
    for name, t, hw, mode in cases:  # g [N, OH, OW, C] -> dx [N, IH, IW, C]
        th = sep_taps(t.shape[1], hw[0], mode, True, dev)
        tw = sep_taps(t.shape[2], hw[1], mode, True, dev)
        got = sep_resize(t, th, tw)
        torch.cuda.synchronize()
        want = sep_resize_plain(t, th, tw)
        err = (got.float() - want.float()).abs().max().item()
        same = torch.equal(got, want)
        results.append({"case": name, "in": list(t.shape),
                        "out": list(got.shape), "bitwise": same,
                        "max_abs_err": err})
        if not same:
            emit({"phase": "train_kernels", "failed": results[-1]})
            raise AssertionError(f"sep_resize {name} differs from plain")
    emit({"phase": "train_kernels", "cases": results, "tolerance": 0,
          "why": "the plain version takes the same taps in the same order "
                 "with IEEE multiply and add and rounds once"})
    return {"name": "sep_resize", "route": "cuda",
            "source": "tlxcv_tpu_torch/csrc/sep_resize.cu",
            "replaces": "tlxcv_tpu/ops/pallas/upsample.py:164",
            "max_abs_err": 0.0}


# ---------------------------------------------------- 2x bilinear upsample
# No model calls it.  Timed at the FPN's P3 size in bf16 and f32, and at
# P2's, whose 105 MB input cannot stay in the 50 MB L2 between calls.
UP2X_TIMED = [((8, 80, 80, 256), torch.bfloat16),
              ((8, 80, 80, 256), torch.float32),
              ((8, 160, 160, 256), torch.bfloat16)]


def cold_ms(fn, flush, reps=10, calls=5):
    """Device time of one call that finds the L2 cold: each call captured
    after ``flush`` (a read of a buffer larger than the L2), less the
    flushes alone."""
    return graph_ms(lambda: (flush(), fn()), reps, calls) \
        - graph_ms(flush, reps, calls)


def up2x_sep_route():
    """The generic 2x route, forward and VJP: the CSR resize
    (``sep_resize``) on the 2x bilinear taps and on their transposes, which
    the 2x path used before its own kernels."""
    from tlxcv_tpu_torch.ops.cuda.upsample import sep_resize, sep_taps

    def forward(x):
        h, w = x.shape[1:3]
        return sep_resize(x, sep_taps(2 * h, h, "bilinear", False, x.device),
                          sep_taps(2 * w, w, "bilinear", False, x.device))

    def vjp(g):
        h, w = g.shape[1] // 2, g.shape[2] // 2
        return sep_resize(g, sep_taps(2 * h, h, "bilinear", True, g.device),
                          sep_taps(2 * w, w, "bilinear", True, g.device))

    return forward, vjp


def up2x_times(routes, plain):
    """Each route's (forward, VJP) pair at every UP2X_TIMED shape: device
    time from CUDA-graph replays (``ms``), CUDA events around each call
    (``event_ms``), the call with the L2 flushed before it (``cold_ms``),
    beside the plain version, the library call
    (``F.interpolate`` / ``aten.upsample_bilinear2d_backward`` on the
    channels-last NCHW views) and the bound (input read once, output
    written once)."""
    gen = torch.Generator(device="cuda").manual_seed(14)
    scratch = torch.zeros(64 * 2 ** 20, device="cuda")  # 256 MB
    flush = scratch.sum
    rows = []
    for shape, dtype in UP2X_TIMED:
        n, h, w, c = shape
        x = torch.randn(*shape, generator=gen, device="cuda").to(dtype)
        g = torch.randn(n, 2 * h, 2 * w, c, generator=gen,
                        device="cuda").to(dtype)
        xn, gn = x.permute(0, 3, 1, 2), g.permute(0, 3, 1, 2)
        library = (
            lambda: torch.nn.functional.interpolate(
                xn, scale_factor=2, mode="bilinear"),
            lambda: torch.ops.aten.upsample_bilinear2d_backward(
                gn, [2 * h, 2 * w], [n, c, h, w], False))
        for k, (part, t) in enumerate((("forward", x), ("vjp", g))):
            row = {"part": part, "x": list(shape), "dtype": str(dtype)[6:],
                   "bound_ms": sep_bound_ms(t, (2 * h, 2 * w) if k == 0
                                            else (h, w))}
            for name, fns in routes.items():
                fn = fns[k]
                row[f"{name}_ms"] = graph_ms(lambda: fn(t))
                row[f"{name}_event_ms"] = time_ms(lambda: fn(t))
                row[f"{name}_cold_ms"] = cold_ms(lambda: fn(t), flush)
            row["plain_ms"] = graph_ms(lambda: plain[k](t), reps=3, calls=2)
            row["library_ms"] = graph_ms(library[k])
            row["library_event_ms"] = time_ms(library[k])
            row["library_cold_ms"] = cold_ms(library[k], flush)
            rows.append(row)
        del x, g, xn, gn
        torch.cuda.empty_cache()
    emit({"phase": "kernel_times", "upsample2x": rows})
    return rows


def up2x_cases(gen):
    """(name, part, tensor) for the 2x kernels' bitwise check: the sizes
    with special edges (H, W in {1, 2, 3}) and a non-square one at C = 3,
    4, 6, 8 and 256 (one element a thread; 8 bytes: 4 bf16 or 2 of 6 f32;
    16 bytes with one or many threads a pixel), the older micro cases, the
    timed P3 shape, a stride-0 g (from ``.sum()``), permuted x and g
    (channels not contiguous) and sliced ones (channels contiguous, rows
    not dense: the VJP's pointer route at 16 bytes), in bf16 and f32."""
    cases = []
    for dtype in (torch.bfloat16, torch.float32):
        dn = str(dtype)[6:]
        shapes = [(2, h, w, c) for h in (1, 2, 3) for w in (1, 2, 3)
                  for c in (3, 4, 6, 8, 256)]
        shapes += [(1, 5, 7, c) for c in (3, 4, 6, 8, 256)]
        shapes += [(2, 8, 16, 8), (2, 8, 8, 128), (8, 80, 80, 256)]
        for n, h, w, c in shapes:
            name = f"{n}x{h}x{w}x{c}_{dn}"
            cases.append((name, "forward", torch.randn(
                n, h, w, c, generator=gen, device="cuda").to(dtype)))
            cases.append((name, "vjp", torch.randn(
                n, 2 * h, 2 * w, c, generator=gen, device="cuda").to(dtype)))
        cases.append((f"stride0_{dn}", "vjp", torch.tensor(
            0.5, device="cuda").to(dtype).expand(2, 40, 48, 64)))
        for part, hw in (("forward", (20, 24)), ("vjp", (40, 48))):
            cases.append((f"sliced_{dn}", part, torch.randn(   # not dense
                2, *hw, 128, generator=gen, device="cuda").to(dtype)[
                ..., 32:96]))
        for part, hw in (("forward", (20, 24)), ("vjp", (40, 48))):
            cases.append((f"permuted_{dn}", part, torch.randn(
                2, 64, *hw, generator=gen, device="cuda").to(dtype).permute(
                0, 2, 3, 1)))
    return cases


def phase_upsample2x_kernels():
    """The 2x bilinear upsample's forward and VJP kernels
    (``csrc/upsample2x.cu``) against their plain versions on the card,
    bitwise; then its path, ``upsample2x_fused`` forward and backward
    through autograd at [8, 80, 80, 256] bf16 with the launch counts set to
    0 just before, which must launch each kernel once and nothing else;
    then both kernels timed beside the generic route (the CSR
    ``sep_resize`` on the 2x taps), the plain versions, the library calls
    and the bounds."""
    from tlxcv_tpu_torch.ops.cuda.upsample import (upsample2x_fused,
                                                   upsample2x_plain,
                                                   upsample2x_vjp,
                                                   upsample2x_vjp_plain)

    gen = torch.Generator(device="cuda").manual_seed(15)
    kernel = {"forward": upsample2x_fused, "vjp": upsample2x_vjp}
    plain = {"forward": upsample2x_plain, "vjp": upsample2x_vjp_plain}
    results = []
    for name, part, t in up2x_cases(gen):
        got = kernel[part](t)
        torch.cuda.synchronize()
        same = torch.equal(got, plain[part](t)) and got.is_contiguous()
        results.append({"case": name, "part": part, "in": list(t.shape),
                        "in_stride": list(t.stride()), "bitwise": same})
        if not same:
            emit({"phase": "upsample2x_kernels", "failed": results[-1]})
            raise AssertionError(f"upsample2x {part} {name} differs from "
                                 f"plain")
    emit({"phase": "upsample2x_kernels", "cases": results, "tolerance": 0,
          "why": "the plain version takes the same taps in the same order "
                 "with IEEE multiply and add and rounds once"})

    x = torch.randn(8, 80, 80, 256, generator=gen, device="cuda").to(
        torch.bfloat16).requires_grad_()
    gy = torch.randn(8, 160, 160, 256, generator=gen, device="cuda").to(
        torch.bfloat16)
    reset_launches()
    y = upsample2x_fused(x)
    y.backward(gy)
    torch.cuda.synchronize()
    counts = launch_counts(f32=False)
    want = {k: int(k in ("upsample2x_fused", "upsample2x_vjp"))
            for k in counts}
    right = (torch.equal(y, upsample2x_plain(x.detach()))
             and torch.equal(x.grad, upsample2x_vjp_plain(gy)))
    emit({"phase": "upsample2x_path", "x": list(x.shape), "dtype": "bfloat16",
          "launches": counts, "bitwise": right})
    if counts != want or not right:
        raise AssertionError(f"upsample2x path: launches {counts}, "
                             f"expected {want}; bitwise {right}")
    del x, gy, y
    torch.cuda.empty_cache()

    rows = up2x_times({"upsample2x": (upsample2x_fused, upsample2x_vjp),
                       "sep_resize": up2x_sep_route()},
                      (upsample2x_plain, upsample2x_vjp_plain))
    step = [r for r in rows if r["x"] == [8, 80, 80, 256]
            and r["dtype"] == "bfloat16"]  # the path's shape: forward, vjp
    record = {"name": "upsample2x", "route": "cuda",
              "source": "tlxcv_tpu_torch/csrc/upsample2x.cu",
              "replaces": "tlxcv_tpu/ops/pallas/upsample.py:164",
              "launches": counts["upsample2x_fused"]
              + counts["upsample2x_vjp"],
              "max_abs_err": 0.0, "bound_by": "bytes"}
    for key, col in (("ms", "upsample2x_ms"), ("plain_ms", "plain_ms"),
                     ("bound_ms", "bound_ms"), ("library_ms", "library_ms")):
        record[key] = sum(r[col] for r in step)
    record["forward_ms"], record["vjp_ms"] = (r["upsample2x_ms"]
                                              for r in step)
    return record


def _rel_err(got, want):
    return ((got.double().cpu() - want).abs().max()
            / want.abs().max().clamp_min(1e-300)).item()


def _cpu_grads(model, x, y, dtype, loss_fn):
    """Loss and gradients of ``model`` (built on the CPU) in ``dtype``."""
    model = model.to(dtype).train()
    with cpu_conv_reference():
        out = model(torch.from_numpy(x).to(dtype))
        loss = loss_fn(model, out, y)
        loss.backward()
    return loss.item(), {k: p.grad.double() for k, p in
                         model.named_parameters() if p.grad is not None}


def _card_grads(task, x, y, dtype, loss_fn):
    """Loss and gradients on the card through the Trainer's compute policy
    (bf16: the parameters and inputs cast inside the differentiated
    function, the outputs cast to f32 before loss_fn)."""
    from tlxcv_tpu_torch.train import Trainer

    trainer = Trainer(task.train(), loss_fn=lambda o, t: loss_fn(task, o, t),
                      compute_dtype=None if dtype == torch.float32 else dtype)
    xb, yb = trainer._put_batch((x, y))
    loss, _ = trainer._loss(trainer.params, xb, yb, training=True)
    grads = torch.autograd.grad(loss, list(trainer.params.values()),
                                allow_unused=True, materialize_grads=True)
    return loss.item(), dict(zip(trainer.params, grads))


def _cpu_bf16_loss(model, x, y, loss_fn):
    """The loss of ``model`` (built on the CPU) under the Trainer's bf16
    policy: parameters and inputs in bf16, outputs cast to f32."""
    from tlxcv_tpu_torch.train.trainer import _cast_floats

    model = model.to(torch.bfloat16).train()
    with torch.no_grad():
        out = model(torch.from_numpy(x).to(torch.bfloat16))
        return loss_fn(model, _cast_floats(out, torch.float32), y).item()


def _without_dropout(model):
    """``model`` with every dropout's and drop path's rate set to 0."""
    from tlxcv_tpu_torch.nn import Dropout, DropPath

    for mod in model.modules():
        if isinstance(mod, (Dropout, DropPath, torch.nn.Dropout)):
            mod.p = 0.0
    return model


def train_check(name, build, x, y, loss_fn, probes, bf16_cpu_loss=False):
    """The card's loss and gradients in f32 and bf16 against the CPU's in
    f32 and float64, from one initial state (``build()`` makes the model on
    the CPU from a seed), dropout off on every side (the card and the CPU
    draw their masks from generators of their own).  With
    ``bf16_cpu_loss`` the bf16 loss bound is the larger of
    ``TRAIN_BOUND``'s and twice the CPU's own bf16 model's distance from
    its f32 loss."""
    init = build().state_dict()
    t0 = time.perf_counter()
    ref = {}
    for dtype in (torch.float32, torch.float64):
        model = _without_dropout(build())
        model.load_state_dict(init)
        ref[dtype] = _cpu_grads(model, x, y, dtype, loss_fn)
    cpu_bf16_err = None
    if bf16_cpu_loss:
        model = _without_dropout(build())
        model.load_state_dict(init)
        cpu_bf16_err = abs(_cpu_bf16_loss(model, x, y, loss_fn)
                           - ref[torch.float32][0]) / abs(
            ref[torch.float32][0])
    cpu_s = time.perf_counter() - t0
    (loss32, g32), (_, g64) = ref[torch.float32], ref[torch.float64]
    cpu_err = {k: _rel_err(g32[k], g64[k]) for k in probes}
    for dtype in (torch.float32, torch.bfloat16):
        card = _without_dropout(build())
        card.load_state_dict(init)
        loss, got = _card_grads(card.cuda(), x, y, dtype, loss_fn)
        dname = str(dtype)[6:]
        loss_bound, grad_bound = TRAIN_BOUND[dname]
        if dtype == torch.bfloat16 and cpu_bf16_err is not None:
            loss_bound = max(loss_bound, 2 * cpu_bf16_err)
        err64 = {k: _rel_err(got[k], g64[k]) for k in probes}
        bound = {k: max(4 * cpu_err[k], grad_bound) for k in probes} \
            if grad_bound is not None else None
        missing = [k for k, g in g32.items() if g.abs().max() > 0
                   and not bool(got[k].abs().max() > 0)]
        loss_err = abs(loss - loss32) / abs(loss32)
        check = {"phase": "train_check", "model": name, "batch": x.shape[0],
                 "dtype": dname, "cpu_loss": loss32, "loss": loss,
                 "loss_rel_err": loss_err, "loss_bound": loss_bound,
                 "cpu_bf16_loss_rel_err": cpu_bf16_err,
                 "grad_err_vs_cpu_f64": err64,
                 "cpu_f32_err_vs_cpu_f64": cpu_err,
                 "grad_err_vs_cpu_f32": {k: _rel_err(got[k], g32[k])
                                         for k in probes},
                 "grad_cosine_vs_cpu_f64": {
                     k: torch.nn.functional.cosine_similarity(
                         got[k].double().cpu().flatten(), g64[k].flatten(),
                         dim=0).item() for k in probes},
                 "grad_bound": bound,
                 "params_with_cpu_grad": sum(bool(g.abs().max() > 0)
                                             for g in g32.values()),
                 "params_without_card_grad": missing,
                 "cpu_reference_s": cpu_s}
        emit(check)
        cos = check["grad_cosine_vs_cpu_f64"]
        if missing or not loss_err <= loss_bound or not math.isfinite(loss) \
                or bound and any(err64[k] > bound[k] for k in probes) \
                or bound is None and any(cos[k] < 0.95 for k in probes
                                         if k.endswith(BF16_COSINE_PROBES)):
            raise AssertionError(f"{name} {dname} gradients disagree with "
                                 f"the CPU: {check}")
        del card, got
        torch.cuda.empty_cache()


def phase_train_check():
    """Gradients on the card against the CPU: Mask R-CNN at b2 640^2 on
    ``ShapesDetection`` and ResNet-50 at b4, each in f32 and bf16.  Mask
    R-CNN takes the CPU's f32 proposals as constants on every side: through
    the proposals, a slot's gradient reaches the RPN delta of the anchor
    that the device's own top-k picked, and with random weights the 102,300
    objectness logits lie so close together that the card and the CPU pick
    other anchors for the same box (f32 rpn_head gradients 23% apart on an
    H100 with the path kept).  That path is held on the CPU against JAX
    (tests/test_torch_mask_rcnn.py) and on the card by
    tests/test_torch_cuda.py."""
    from tlxcv_tpu_torch import create_model
    from tlxcv_tpu_torch.data import ShapesDetection, pad_targets
    from tlxcv_tpu_torch.tasks import ImageClassification, ObjectDetection

    def mask_rcnn():
        return ObjectDetection(create_model(
            "mask_rcnn", device="cpu", generator=torch.Generator()
            .manual_seed(0)))

    ds = ShapesDetection(num=2, size=640, return_masks=True, max_objects=6)
    x, y = pad_targets(8)([ds[i] for i in range(2)])
    model = mask_rcnn().train()
    with torch.no_grad(), cpu_conv_reference():
        out = model(torch.from_numpy(x))
    props, pmask = out["proposals"], out["proposal_mask"]
    del model, out

    def mrcnn_loss(task, o, t):
        dev, dt = o["proposals"].device, o["proposals"].dtype
        t = {k: torch.as_tensor(v, device=dev) for k, v in t.items()}
        return task.loss_fn({**o, "proposals": props.to(dev, dt),
                             "proposal_mask": pmask.to(dev)}, t)

    train_check("mask_rcnn", mask_rcnn, x, y, mrcnn_loss,
                ["backbone." + k for k in MRCNN_PROBES])

    def resnet50():
        return ImageClassification(create_model(
            "resnet50", device="cpu", generator=torch.Generator()
            .manual_seed(1)))

    gen = torch.Generator().manual_seed(2)
    x = torch.randn(4, 224, 224, 3, generator=gen).numpy()
    y = torch.randint(0, 1000, (4,), generator=gen).numpy()

    def ce(task, o, t):
        return task.loss_fn(o, torch.as_tensor(t, device=o.device))

    train_check("resnet50", resnet50, x, y, ce,
                ["backbone." + k for k in RESNET_PROBES])


def timed_train(trainer, batches, expect, name, batch, warmup=3,
                steps=TRAIN_STEPS):
    """``Trainer.train`` over device-resident batches (made in set-up, as
    the bench's training leg keeps its inputs on the device): ``warmup``
    steps, then ``steps`` timed ones (host clock, synchronised), with every
    launch count set to 0 before the warm-up and checked after against
    ``expect`` launches per step."""
    data = [batches[i % len(batches)] for i in range(warmup + steps)]
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_launches()
    trainer.train(1, data[:warmup], print_freq=2)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    trainer.train(1, data[warmup:], print_freq=2)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = launch_counts(f32=False)
    want = {k: expect.get(k, 0) * (warmup + steps) for k in counts}
    if counts != want:
        raise AssertionError(f"{name} training: kernel launches {counts}, "
                             f"expected {want}")
    step = wall / steps
    emit({"phase": "train", "model": name, "batch": batch,
          "dtype": "bfloat16 compute, f32 masters", "steps": steps,
          "warmup": warmup, "step_ms": 1e3 * step, "img_per_s": batch / step,
          "launches": counts,
          "launches_per_step": {k: v / (warmup + steps)
                                for k, v in counts.items()},
          "peak_mem_bytes": torch.cuda.max_memory_allocated()})
    return counts, step


def falling_loss(trainer, batch, name, steps=20):
    """``steps`` steps on one fixed batch: the mean loss of the last 5 must
    be below that of the first 5."""
    xb, yb = trainer._put_batch(batch)
    losses = [trainer._train_step(xb, yb)[0] for _ in range(steps)]
    losses = torch.stack(losses).tolist()
    first, last = statistics.mean(losses[:5]), statistics.mean(losses[-5:])
    emit({"phase": "train_fixed_batch", "model": name, "losses": losses,
          "first5_mean": first, "last5_mean": last})
    if not (all(map(math.isfinite, losses)) and last < first):
        raise AssertionError(f"{name}: the loss did not fall on a fixed "
                             f"batch: {losses}")


def mrcnn_sep_times(trainer, batch, record):
    """The transposed resize timed alone on the gradients one training step
    hands it (captured by wrapping it, outside any counted run), with its
    plain version, the library's nearest-upsample backward and the bound;
    summed over the step.  Device times from CUDA-graph replays (the
    40^2 call's device work is a few microseconds, under the Python
    wrapper's host time); the event-timed calls beside them."""
    import tlxcv_tpu_torch.ops.cuda.upsample as up

    seen = []
    real = up.sep_resize

    def capture(g, th, tw):
        seen.append((g, th, tw))
        return real(g, th, tw)

    capture.launches = 0  # the real wrapper counts on the module's name
    up.sep_resize = capture
    try:
        trainer._train_step(*trainer._put_batch(batch))
    finally:
        up.sep_resize = real
    rows = []
    for gy, th, tw in seen:
        in_hw = (th.ptr.numel() - 1, tw.ptr.numel() - 1)
        n, oh, ow, c = gy.shape
        nchw = gy.permute(0, 3, 1, 2)

        def library(nchw=nchw, oh=oh, ow=ow, n=n, c=c, in_hw=in_hw):
            return torch.ops.aten.upsample_nearest2d_backward(
                nchw, [oh, ow], [n, c, *in_hw])

        rows.append({"g": list(gy.shape), "g_stride": list(gy.stride()),
                     "dx_hw": list(in_hw), "dtype": str(gy.dtype)[6:],
                     "ms": graph_ms(lambda: real(gy, th, tw)),
                     "plain_ms": graph_ms(lambda: up.sep_resize_plain(
                         gy, th, tw), reps=5, calls=2),
                     "library_ms": graph_ms(library),
                     "event_ms": time_ms(lambda: real(gy, th, tw)),
                     "event_library_ms": time_ms(library),
                     "bound_ms": sep_bound_ms(gy, in_hw)})
    keys = ("ms", "plain_ms", "library_ms", "bound_ms")
    record.update({k: sum(r[k] for r in rows) for k in keys},
                  bound_by="bytes")
    emit({"phase": "kernel_times", "sep_resize_per_step": rows})


def phase_train(sep_record, profile):
    """Training through ``Trainer.train`` on the card, bf16 compute with
    f32 masters: Mask R-CNN b8 640^2 (``ShapesDetection``, ground truth
    padded to 8 slots, Adam(1e-4)) and ResNet-50 b256 224^2 (the bench's
    training leg: random inputs and labels from seed 0, Adam(1e-3))."""
    import numpy as np

    from tlxcv_tpu_torch import create_model
    from tlxcv_tpu_torch.data import DataLoader, ShapesDetection, pad_targets
    from tlxcv_tpu_torch.tasks import ImageClassification, ObjectDetection
    from tlxcv_tpu_torch.train import Trainer, optimizers

    gen = torch.Generator().manual_seed(0)
    task = ObjectDetection(create_model("mask_rcnn", generator=gen))
    trainer = Trainer(network=task, loss_fn=task.loss_fn,
                      optimizer=optimizers.Adam(1e-4),
                      compute_dtype=torch.bfloat16)
    loader = DataLoader(ShapesDetection(num=32, size=640, return_masks=True,
                                        max_objects=6),
                        batch_size=8, collate_fn=pad_targets(8))
    batches = [trainer._put_batch(b) for _, b in zip(range(4), loader)]
    falling_loss(trainer, batches[0], "mask_rcnn")
    per_step = {"upsample_add_fused": 3, "sep_resize": 3, "gather_rows": 2}
    counts, step = timed_train(trainer, batches, per_step, "mask_rcnn", 8)
    sep_record["launches"] = counts["sep_resize"]
    mrcnn_sep_times(trainer, batches[0], sep_record)
    if profile:
        phase_train_profile("mask_rcnn", trainer, batches[0], step)
    del trainer, task, batches
    torch.cuda.empty_cache()

    task = ImageClassification(create_model("resnet50", generator=gen))
    trainer = Trainer(network=task, loss_fn=task.loss_fn,
                      optimizer=optimizers.Adam(1e-3),
                      compute_dtype=torch.bfloat16)
    rng = np.random.default_rng(0)
    x = torch.from_numpy(rng.normal(size=(256, 224, 224, 3)).astype(
        np.float32)).to("cuda", torch.bfloat16)
    y = torch.from_numpy(rng.integers(0, 1000, size=256)).cuda()
    falling_loss(trainer, (x, y), "resnet50")
    _, step = timed_train(trainer, [(x, y)], {}, "resnet50", 256)
    if profile:
        phase_train_profile("resnet50", trainer, (x, y), step)
    del trainer, task, x, y
    torch.cuda.empty_cache()


# ------------------------------------------ ViT-B/16 int8, grouped int8 conv
# End-to-end limits of ``vit_int8_check``, set from the readings in PERF.md:
# the card's int8 model's rms distance to the CPU's, in units of the int8
# model's own error sigma, and in units of the CPU witness's drift.
VIT_INT8_RMS = 1.0
VIT_INT8_WITNESS = 2.0


def vit_int8_check(cpu8, cpu32, card8, x4, attention):
    """int8 ViT-B/16 on the card against the same int8 model on the CPU,
    as ``yolo_int8_check`` holds int8 YOLOv3, with either attention.  Layer
    by layer it must be exact: each of the 50 int8 layers on the card,
    given the CPU's input to it, returns the CPU's output bitwise (an exact
    int32 GEMM and the IEEE epilogue), no step apart, tighter than the 4
    head steps of the ResNet-50 check.  End to end the chains drift apart:
    the float ops between the int8 layers (LayerNorm, GELU, the attention's
    softmax and products) round differently on the two devices, a code
    flipped by one moves the next layer's inputs across further rounding
    boundaries, and through 12 blocks the difference grows to the size of
    the quantization noise itself.  A witness on the CPU alone shows that
    this is the chain's and not the card's: the CPU's int8 model on the
    input moved by one ulp drifts from itself by as much.  So the logits
    are held, with sigma the int8 model's rms error against the f32 model
    (float attention) on the CPU: the card's int8 model within 1.25 sigma
    of the f32 model (as accurate as the CPU's), within VIT_INT8_RMS sigma
    of the CPU's int8 model, and within VIT_INT8_WITNESS times the
    witness's drift.  Exactly 50 int8 GEMM launches a forward, and 12
    flash launches with float attention."""
    from tlxcv_tpu_torch.nn import Conv2d, Linear
    from tlxcv_tpu_torch.nn.attention import use_int8_attention

    seen = []
    layers = [m for m in cpu8.modules() if isinstance(m, (Conv2d, Linear))]
    with torch.inference_mode():
        want32 = cpu32(x4)
    handles = [m.register_forward_hook(
        lambda mod, args, out: seen.append((mod, args[0], out)))
        for m in layers]
    use_int8_attention(attention == "int8")
    try:
        with torch.inference_mode():
            want8 = cpu8(x4)
            for h in handles:
                h.remove()
            witness = cpu8(torch.nextafter(x4, torch.full_like(x4, math.inf)))
            reset_launches()
            got8 = card8(x4.cuda()).cpu()
            per_forward = launch_counts(f32=False)
    finally:
        use_int8_attention(False)
        for h in handles:
            h.remove()
    names = {id(m): p for p, m in cpu8.named_modules()}
    card_mods = dict(card8.named_modules())
    layers_equal = 0
    with torch.inference_mode():
        for mod, xin, yout in seen:
            got = card_mods[names[id(mod)]](xin.cuda()).cpu()
            if not torch.equal(got, yout):
                raise AssertionError(f"int8 layer {names[id(mod)]} differs "
                                     f"from the CPU on the CPU's input "
                                     f"({attention} attention)")
            layers_equal += 1
    head = cpu8.backbone.head
    step = float(head.a_scale * 127 * head.w_scale.max())
    diff = (got8 - want8).abs()
    expect = {"int8_matmul": 50,
              "flash_attention": 12 if attention == "float" else 0}
    sigma = _rms(want8, want32)
    check = {"attention": attention, "batch": x4.shape[0],
             "layers_bitwise_equal": layers_equal,
             "rms_card_cpu": _rms(got8, want8),
             "rms_card_f32_cpu": _rms(got8, want32),
             "rms_int8_f32_cpu": sigma,
             "rms_cpu_ulp_witness": _rms(witness, want8),
             "logit_scale": want8.abs().max().item(),
             "max_abs_err": diff.max().item(), "head_step": step,
             "share_within_4_steps": (diff <= 4 * step).float().mean().item(),
             "argmax_agrees_with_cpu_int8":
                 (got8.argmax(-1) == want8.argmax(-1)).float().mean().item(),
             "launches_per_forward": {k: v for k, v in per_forward.items()
                                      if v}}
    check["card_cpu_over_sigma"] = check["rms_card_cpu"] / sigma
    check["card_cpu_over_witness"] = (check["rms_card_cpu"]
                                      / check["rms_cpu_ulp_witness"])
    emit({"phase": "model_check", "model": "vit_base_patch16_224_int8",
          **check})
    if not bool(torch.isfinite(got8).all()) or \
            check["rms_card_f32_cpu"] > 1.25 * sigma or \
            check["rms_card_cpu"] > VIT_INT8_RMS * sigma or \
            check["card_cpu_over_witness"] > VIT_INT8_WITNESS:
        raise AssertionError(f"int8 ViT-B/16 disagrees with the CPU: {check}")
    if layers_equal != 50 or \
            per_forward != {k: expect.get(k, 0) for k in per_forward}:
        raise AssertionError(f"int8 ViT-B/16 ({attention} attention): "
                             f"{layers_equal} layers equal, launches "
                             f"{per_forward}, expected 50 and {expect}")


def int8_products_check():
    """The int8 attention's two products (``nn.attention.int8_products``,
    the f32 product of the codes) at ViT-B/16 b256's shapes, [256, 12, 197,
    64] codes, with TF32 switched on globally: bitwise against the same
    products on the CPU, the CPU's f32 route tied to its int32 sums on a
    slice, and TF32 still on after the calls.  The plain f32 product with
    TF32 on is computed beside it to show what the guard keeps out."""
    from tlxcv_tpu_torch.nn.attention import (int8_products,
                                              int8_products_plain)

    g = torch.Generator(device="cuda").manual_seed(7)
    q, k = (torch.randint(-127, 128, (256, 12, 197, 64), generator=g,
                          device="cuda", dtype=torch.int8) for _ in range(2))
    p = torch.randint(0, 128, (256, 12, 197, 197), generator=g,
                      device="cuda", dtype=torch.int8)
    kt = k.transpose(-1, -2)
    saved = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = True
    try:
        with torch.inference_mode():
            scores = int8_products(q, kt).cpu()
            pv = int8_products(p, k).cpu()
            kept = torch.backends.cuda.matmul.allow_tf32
            tf32 = torch.matmul(q.float(), kt.float()).cpu()
            products_ms = graph_ms(lambda: int8_products(q, kt), reps=5,
                                   calls=2)
    finally:
        torch.backends.cuda.matmul.allow_tf32 = saved
    qc, kc, pc = q.cpu(), k.cpu(), p.cpu()
    want_scores = int8_products(qc, kc.transpose(-1, -2))
    want_pv = int8_products(pc, kc)
    tied = (torch.equal(want_scores[:2].to(torch.int32),
                        int8_products_plain(qc[:2], kc[:2].transpose(-1, -2)))
            and torch.equal(want_pv[:2].to(torch.int32),
                            int8_products_plain(pc[:2], kc[:2])))
    check = {"shape": [256, 12, 197, 64], "tf32_on_globally": True,
             "scores_bitwise": torch.equal(scores, want_scores),
             "pv_bitwise": torch.equal(pv, want_pv),
             "cpu_f32_equals_int32": tied, "tf32_flag_restored": kept,
             "tf32_product_max_abs_err": (tf32 - want_scores).abs().max()
             .item(), "scores_ms": products_ms}
    check["detr_encoder_pv"] = int8_products_past_1040()
    emit({"phase": "int8_attention_products", **check})
    if not (check["scores_bitwise"] and check["pv_bitwise"] and tied
            and kept):
        raise AssertionError(f"int8 attention products: {check}")


def int8_products_past_1040():
    """The P.V product at DETR-R50's encoder grid under int8 attention
    (b8 x 8 heads, 1050 keys): [64, 1050, 1050] probability codes by [64,
    1050, 32] value codes, more keys than the f32 product holds exactly,
    so summed in int32 over chunks of at most 1040; with TF32 on globally,
    bitwise against the CPU and against the plain int32 product."""
    from tlxcv_tpu_torch.nn.attention import (int8_products,
                                              int8_products_plain)

    g = torch.Generator(device="cuda").manual_seed(8)
    p = torch.randint(0, 128, (64, 1050, 1050), generator=g, device="cuda",
                      dtype=torch.int8)
    v = torch.randint(-127, 128, (64, 1050, 32), generator=g, device="cuda",
                      dtype=torch.int8)
    saved = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = True
    try:
        with torch.inference_mode():
            got = int8_products(p, v).cpu()
            ms = graph_ms(lambda: int8_products(p, v), reps=5, calls=2)
    finally:
        torch.backends.cuda.matmul.allow_tf32 = saved
    pc, vc = p.cpu(), v.cpu()
    want = int8_products(pc, vc)
    plain = int8_products_plain(pc[:4], vc[:4]).float()
    check = {"shape": [[64, 1050, 1050], [64, 1050, 32]],
             "bitwise": torch.equal(got, want)
             and torch.equal(want[:4], plain), "ms": ms}
    if not check["bitwise"]:
        raise AssertionError(f"int8 P.V past 1040 keys: {check}")
    return check


def phase_vit_int8(int8_record):
    """ViT-B/16 int8 as the JAX package's bench leg builds it:
    ``quantize_weights``, then ``calibrate_activations`` on 4 images, on
    the CPU in f32; attention stays float (the flash kernel).  The int8
    model on the card against the same model on the CPU, with exactly 50
    int8 GEMM and 12 flash launches a forward, then served at b256.  The
    same with the opt-in int8 attention (``use_int8_attention``): checked,
    its products bitwise (``int8_products_check``), served and timed
    beside the float attention."""
    from tlxcv_tpu_torch import create_model
    from tlxcv_tpu_torch.nn.attention import use_int8_attention
    from tlxcv_tpu_torch.ops.quant import (calibrate_activations,
                                           quantize_weights)
    from tlxcv_tpu_torch.tasks import ImageClassification

    name = "vit_base_patch16_224"
    gen = torch.Generator().manual_seed(0)
    cpu = ImageClassification(create_model(name, device="cpu",
                                           generator=gen)).eval()
    cpu32 = copy.deepcopy(cpu)
    calib = torch.randn(4, 224, 224, 3, generator=gen)
    t0 = time.perf_counter()
    counts = (quantize_weights(cpu.backbone),
              calibrate_activations(cpu.backbone, [calib]))
    prep_s = time.perf_counter() - t0
    if counts != (50, 50):
        raise AssertionError(f"ViT-B/16 quantized {counts} layers, "
                             f"expected (50, 50): 48 block Linears, the "
                             f"head and the patch conv")
    emit({"phase": "int8_prep", "model": name, "counts": list(counts),
          "prep_s": prep_s})
    card = copy.deepcopy(cpu).cuda()
    x4 = torch.randn(4, 224, 224, 3, generator=gen)
    for attention in ("float", "int8"):
        vit_int8_check(cpu, cpu32, card, x4, attention)
    del cpu, cpu32
    int8_products_check()

    # the leg: b256 224^2, bf16 images, float attention; then int8 attention
    x = torch.randn(256, 224, 224, 3, generator=gen).to("cuda",
                                                        torch.bfloat16)
    served, float_step = serve(card, x, {"int8_matmul": 50,
                                         "flash_attention": 12},
                               name + "_int8", "int8 (bf16 input)")
    int8_record["vit_launches"] = served["int8_matmul"]
    use_int8_attention(True)
    try:
        _, int8_step = serve(card, x, {"int8_matmul": 50},
                             name + "_int8_attention",
                             "int8, int8 attention (bf16 input)")
    finally:
        use_int8_attention(False)
    emit({"phase": "vit_int8_attention", "batch": 256,
          "float_attention_step_ms": 1e3 * float_step,
          "int8_attention_step_ms": 1e3 * int8_step,
          "int8_over_float": int8_step / float_step})
    int8_forward_times(card, x, name="int8_matmul_per_forward_vit")
    return card, x, float_step


def phase_grouped_int8(int8_record):
    """A grouped full-int8 conv at a ResNeXt-50 shape (3x3, 128 -> 128, 32
    groups, 56^2, b32, bf16 input), quantized and calibrated on the CPU:
    on the card bitwise equal to the same conv on the CPU (the plain
    route), with exactly 32 int8 GEMM launches (one a group); then timed:
    the conv, and its 32 fused GEMMs alone beside their plain versions and
    the bound; cuDNN's bf16 grouped conv of the dequantized weight beside
    it for scale (no library call computes the int8 function)."""
    from tlxcv_tpu_torch.nn.layers import Conv2d
    from tlxcv_tpu_torch.ops.cuda.matmul import (int8_matmul_requant,
                                                 int8_matmul_requant_plain)
    from tlxcv_tpu_torch.ops.quant import (calibrate_activations,
                                           quantize_weights)

    gen = torch.Generator().manual_seed(21)
    conv = Conv2d(128, 128, 3, padding=1, groups=32, device="cpu",
                  generator=gen)
    with torch.no_grad():
        conv.bias.copy_(0.1 * torch.randn(128, generator=gen))
    x = torch.randn(32, 56, 56, 128, generator=gen).to(torch.bfloat16)
    if (quantize_weights(conv), calibrate_activations(conv, [x[:4].float()])
            ) != (1, 1):
        raise AssertionError("the grouped conv was not quantized")
    card = copy.deepcopy(conv).cuda()
    xc = x.cuda()
    reset_launches()
    with torch.inference_mode():
        got = card(xc)
        torch.cuda.synchronize()
        counts = launch_counts(f32=False)
        want = conv(x)
    bitwise = got.dtype == want.dtype and torch.equal(got.cpu(), want)
    expect = {k: 32 if k == "int8_matmul" else 0 for k in counts}

    og, groups = 4, 32
    with torch.inference_mode():
        cols, _ = card._group_patches(
            torch.round(xc.float() / card.a_scale).clamp(-127, 127)
            .to(torch.int8))
        scale = card.a_scale * card.w_scale
        args = [(cols[j], card.weight[j * og:(j + 1) * og],
                 scale[j * og:(j + 1) * og].contiguous(),
                 card.bias[j * og:(j + 1) * og], False, None,
                 torch.bfloat16) for j in range(groups)]

        def gemms(fn):
            return [fn(*a) for a in args]

        conv_ms, conv_event_ms = _times(lambda: card(xc), 10)
        gemm_ms, gemm_event_ms = _times(lambda: gemms(int8_matmul_requant),
                                        10)
        plain_ms = time_ms(lambda: gemms(int8_matmul_requant_plain), reps=5,
                           warmup=1)
        wf = (card._unpacked().float()
              * card.w_scale[:, None, None, None]).to(torch.bfloat16)
        cudnn_ms = graph_ms(lambda: card._conv(xc, wf))
    m = 32 * 56 * 56
    bound, bound_by = int8_bound_ms(m, 36, og, out_bytes=2)
    record = {"shape": [32, 56, 56, 128], "groups": groups,
              "m_k_n_per_group": [m, 36, og], "bitwise": bitwise,
              "launches": counts["int8_matmul"], "conv_ms": conv_ms,
              "conv_event_ms": conv_event_ms, "gemms_ms": gemm_ms,
              "gemms_event_ms": gemm_event_ms, "plain_ms": plain_ms,
              "bound_ms": groups * bound, "bound_by": bound_by,
              "cudnn_bf16_grouped_conv_ms": cudnn_ms}
    emit({"phase": "grouped_int8", **record})
    if not bitwise or counts != expect:
        raise AssertionError(f"grouped int8 conv on the card: {record}")
    int8_record.update({"grouped_launches": counts["int8_matmul"],
                        "grouped_ms": gemm_ms,
                        "grouped_plain_ms": plain_ms,
                        "grouped_bound_ms": groups * bound})


# --------------------------------------------------- HRNet segmentation
def check_seg(classes, hw):
    def check(pred, batch):
        if pred.shape != (batch, *hw, classes) or \
                not bool(torch.isfinite(pred).all()):
            raise AssertionError(f"bad segmentation logits {pred.shape}")
    return check


def phase_hrnet_seg():
    """HRNet-W18 segmentation (``create_model("hrnet_seg_w18",
    num_classes=19)``, random weights from a seed, BatchNorm statistics
    from one train-mode forward of 2 seeded 256^2 images on the CPU): f32
    and bf16 logits at b1 512^2 against f32 on the CPU, unconverted and
    after ``convert_hrnet_branches_to_s2d``, the two card graphs against
    each other in f32; no kernel of ours launched.  Like YOLOv3's, the
    random net is chaotic in bf16 (on one H100 80GB HBM3 the card's bf16
    logits lay 1.78 rms from the f32 ones, max 19.7, and the CPU's bf16
    model 1.77), so bf16 is held to the CPU's own bf16 model's error
    (``float_logit_check``).  Then both graphs served at b16 512^2 bf16,
    the converted one being the bench leg."""
    from tlxcv_tpu_torch import create_model
    from tlxcv_tpu_torch.models.backbones.hrnet import (
        convert_hrnet_branches_to_s2d)
    from tlxcv_tpu_torch.tasks import ImageSegmentation

    name = "hrnet_seg_w18"
    gen = torch.Generator().manual_seed(0)
    cpu = ImageSegmentation(create_model(name, device="cpu", num_classes=19,
                                         generator=gen))
    data_bn_statistics(cpu, torch.randn(2, 256, 256, 3, generator=gen))
    x1 = torch.randn(1, 512, 512, 3, generator=gen)
    x = torch.randn(16, 512, 512, 3, generator=gen).to("cuda",
                                                       torch.bfloat16)
    cards, f32 = {}, {}
    for graph in ("plain", "s2d"):
        if graph == "s2d":
            converted = convert_hrnet_branches_to_s2d(cpu)
            if converted != 16:
                raise AssertionError(f"{converted} branches converted, "
                                     f"expected 16 (two a module)")
        cards[graph] = copy.deepcopy(cpu).cuda()
        f32[graph] = float_logit_check(f"{name}_{graph}", cpu, cards[graph],
                                       x1, depth="HRNet-W18", expect={},
                                       chaotic=True)
    scale = f32["plain"].abs().max().item()
    gap = (f32["s2d"] - f32["plain"]).abs().max().item()
    # the blocked 3x3 convs multiply structural zeros and sum in another
    # order; f32 rounding through the net stays under 1e-4 of the scale
    emit({"phase": "model_check", "model": name + "_s2d_vs_plain",
          "batch": 1, "max_abs_err": gap, "bound": 1e-4 * scale,
          "logit_scale": scale})
    if not gap <= 1e-4 * scale:
        raise AssertionError(f"the converted graph moved the logits by "
                             f"{gap} (scale {scale})")
    steps = {}
    for graph in ("plain", "s2d"):
        _, steps[graph] = serve(cards[graph], x, {}, f"{name}_{graph}",
                                "bfloat16", check=check_seg(19, (512, 512)))
    emit({"phase": "hrnet_s2d", "batch": 16,
          "plain_step_ms": 1e3 * steps["plain"],
          "s2d_step_ms": 1e3 * steps["s2d"],
          "s2d_over_plain": steps["s2d"] / steps["plain"]})
    return cards, x, steps


# ------------------------------------------------------ DeiT-B and Swin-B
def phase_transformers(flash_record):
    """DeiT-B (``create_model("deit_base")``) at b2 224^2, f32 and bf16
    against f32 on the CPU with exactly 12 flash launches a forward (S =
    198), served at b64 bf16; Swin-B (``create_model("swin_base")``) the
    same at window packs 1 (its default) and 2, with no launch of ours
    (its window attention is plain PyTorch), served at b64 bf16 at its
    default pack."""
    from tlxcv_tpu_torch import create_model
    from tlxcv_tpu_torch.models.classification import set_window_pack
    from tlxcv_tpu_torch.tasks import ImageClassification

    gen = torch.Generator().manual_seed(0)
    x2 = torch.randn(2, 224, 224, 3, generator=gen)
    x = torch.randn(64, 224, 224, 3, generator=gen).to("cuda",
                                                       torch.bfloat16)
    cpu = ImageClassification(create_model("deit_base", device="cpu",
                                           generator=gen)).eval()
    card = copy.deepcopy(cpu).cuda()
    float_logit_check("deit_base", cpu, card, x2, depth="12 blocks",
                      expect={"flash_attention": 12})
    del cpu
    counts, _ = serve(card, x, {"flash_attention": 12}, "deit_base",
                      "bfloat16")
    flash_record["deit_launches"] = counts["flash_attention"]
    del card
    torch.cuda.empty_cache()

    cpu = ImageClassification(create_model("swin_base", device="cpu",
                                           generator=gen)).eval()
    for pack in (2, 1):
        set_window_pack(cpu, pack)
        card = copy.deepcopy(cpu).cuda()
        float_logit_check(f"swin_base_pack{pack}", cpu, card, x2,
                          depth="24 blocks", expect={})
    _, step = serve(card, x, {}, "swin_base", "bfloat16")
    return card, x, step


# ------------------------------------------- DETR-R50, PP-YOLOE-L and SSD
DETR_STAGES = ("memory", "decoder", "logits", "boxes")
SSD_HWS = ((19, 19), (10, 10), (5, 5), (3, 3), (2, 2), (1, 1))  # at 300^2


def detr_stages(model, x):
    """The encoder's memory, the last decoder layer's normalised output,
    and the logits and boxes of one forward."""
    with torch.inference_mode():
        memory, pos = model.encode(x)
        decoder = model.decode(memory, pos)[-1]
        return {"memory": memory, "decoder": decoder, **model.heads(decoder)}


def detr_check(cpu, card, x2):
    """DETR-R50 f32 and bf16 on the card against f32 on the CPU, stage by
    stage: f32 within ``YOLO_F32_BOUND`` of each stage's largest value;
    bf16, through 50 convolutions and 12 transformer layers of random
    weights, held to the CPU's own bf16 model's rms error against its f32
    one (``YOLO_BF16_RMS``, as YOLOv3's heads).  Exactly 18 flash launches
    a forward.  ``card`` is left with bf16 parameters."""
    t0 = time.perf_counter()
    want = detr_stages(cpu, x2)
    cpu_s = time.perf_counter() - t0
    top = want["logits"][..., :-1].argmax(-1)
    for dtype in (torch.float32, torch.bfloat16):
        dname = str(dtype)[6:]
        if dtype == torch.bfloat16:
            params_to(card, dtype)
            want16 = detr_stages(params_to(copy.deepcopy(cpu), dtype),
                                 x2.to(dtype))
        reset_launches()
        got = detr_stages(card, x2.to("cuda", dtype))
        per_forward = {k: v for k, v in launch_counts(f32=False).items() if v}
        errs = {k: _rel(got[k], want[k]) for k in DETR_STAGES}
        finite = all(bool(torch.isfinite(got[k]).all()) for k in DETR_STAGES)
        levels = None
        if dtype == torch.bfloat16:
            levels = {k: {"rms_card_f32_cpu": _rms(got[k], want[k]),
                          "rms_cpu_bf16_f32_cpu": _rms(want16[k], want[k]),
                          "rms_card_cpu_bf16": _rms(got[k], want16[k])}
                      for k in DETR_STAGES}
        label_share = (got["logits"][..., :-1].argmax(-1).cpu() == top) \
            .float().mean().item()
        check = {"phase": "model_check", "model": "detr_resnet50",
                 "batch": x2.shape[0], "hw": list(x2.shape[1:3]),
                 "dtype": dname, "rel_max_abs_err": errs,
                 "bound": YOLO_F32_BOUND, "levels": levels,
                 "rms_bound": YOLO_BF16_RMS,
                 "top_label_share": label_share,
                 "label_floor": DETR_LABEL_FLOOR if levels is None else None,
                 "launches_per_forward": per_forward, "finite": finite,
                 "cpu_reference_s": cpu_s}
        emit(check)
        if not finite or per_forward != {"flash_attention": 18} or (
                dtype == torch.float32 and label_share < DETR_LABEL_FLOOR):
            raise AssertionError(f"DETR-R50 {dname}: {check}")
        if dtype == torch.float32 and max(errs.values()) > YOLO_F32_BOUND:
            raise AssertionError(f"DETR-R50 f32 stages disagree with the "
                                 f"CPU: {errs}")
        if levels and any(
                lv["rms_card_f32_cpu"] > YOLO_BF16_RMS[0]
                * lv["rms_cpu_bf16_f32_cpu"] or lv["rms_card_cpu_bf16"]
                > YOLO_BF16_RMS[1] * lv["rms_cpu_bf16_f32_cpu"]
                for lv in levels.values()):
            raise AssertionError(f"DETR-R50 bf16 stages less accurate than "
                                 f"the CPU's bf16 model: {levels}")


def ppyoloe_stages(model, x):
    with torch.inference_mode():
        heads = model.head_outputs(x)  # scores, distance logits, grid
        boxes, scores = model.yolo_head.decode(heads)
        dets, counts = model.yolo_head.nms(boxes, scores)
    return {"heads": list(heads[:2]), "boxes": boxes, "scores": scores,
            "dets": dets, "counts": counts}


def ppyoloe_decode(model, heads, hw):
    head = model.yolo_head
    hws = tuple((hw[0] // s, hw[1] // s) for s in head.fpn_strides)
    return head.decode((*heads, hws))


def ssd_stages(model, x):
    with torch.inference_mode():
        deltas, logits, priors = model.head_outputs(x)
        boxes, probs = model.decode(deltas, logits, priors, x.shape[1:3])
        dets, counts = model.nms(boxes, probs)
    return {"heads": [deltas, logits], "boxes": boxes, "scores": probs,
            "dets": dets, "counts": counts}


def ssd_decode(model, heads, hw):
    return model.decode(*heads, model.priors(SSD_HWS, heads[0].device), hw)


def fcos_stages(model, x):
    with torch.inference_mode():
        outs, hws = model.head_outputs(x)
        boxes, scores = model.decode(outs, hws, tuple(x.shape[1:3]))
        dets, counts = model.nms(boxes, scores)
    return {"heads": [t for level in outs for t in level], "boxes": boxes,
            "scores": scores, "dets": dets, "counts": counts}


def fcos_decode(model, heads, hw):
    """FCOS's decode on a flat list of head outputs (cls, reg, ctr a
    level)."""
    outs = [heads[i:i + 3] for i in range(0, len(heads), 3)]
    return model.decode(outs, [tuple(t.shape[1:3]) for t in heads[::3]],
                        tuple(hw))


# FCOS-R50 (PaddleDetection's fcos_r50_fpn_1x_coco): COCO's 800x1333
# padded to a multiple of 32, as the DETR leg does; checked at b2 on a
# frame of 2/5 the side; the FPN's half-pixel nearest resize checked on an
# unpadded 800x1333, where C4 [50, 84] goes up to C3's [100, 167] at a ratio
# that is not an integer
FCOS_BATCH, FCOS_HW, FCOS_CHECK_HW, FCOS_ODD_HW = 8, (800, 1344), \
    (320, 544), (800, 1333)


def fcos_targets_for(batch, hw, gen, boxes=3, classes=80):
    """Seeded boxes in pixels (xyxy, at least 16 px a side) and labels,
    the last row of each image padding."""
    h, w = hw
    xy = torch.rand(batch, boxes, 2, generator=gen) * torch.tensor(
        [w / 2, h / 2])
    wh = 16 + torch.rand(batch, boxes, 2, generator=gen) * torch.tensor(
        [w / 2, h / 2])
    mask = torch.ones(batch, boxes)
    mask[:, -1] = 0
    return {"boxes": torch.cat([xy, xy + wh], -1),
            "class_labels": torch.randint(0, classes, (batch, boxes),
                                          generator=gen),
            "mask": mask}


def fcos_check(name, cpu, card, x2, gen):
    """FCOS beyond ``dense_detector_check``'s stages, in f32 on the card
    (TF32 off) against f32 on the CPU: ``loss_fn`` on the train-mode
    outputs (BatchNorm on the batch's statistics, copies of both models)
    at b2 on seeded boxes, within ``TRAIN_BOUND``'s f32 loss bound (the
    training checks'); the neck on an unpadded 800x1333 frame's C3-C5 (the CPU's,
    handed to both), whose top-down resize is not 2x, within
    ``YOLO_F32_BOUND`` a level, the levels' sizes the CPU's, and the
    card's own head outputs at that frame of the CPU's shapes."""
    tg = fcos_targets_for(2, x2.shape[1:3], gen)
    losses = []
    for model, dev in ((cpu, "cpu"), (card, "cuda")):
        m = copy.deepcopy(model).train()
        with torch.no_grad():
            losses.append(m.loss_fn(m(x2.to(dev)), {
                k: v.to(dev) for k, v in tg.items()}).item())
        del m
    loss_err = abs(losses[1] - losses[0]) / abs(losses[0])
    x1 = torch.randn(1, *FCOS_ODD_HW, 3, generator=gen)
    with torch.inference_mode():
        feats = cpu.backbone.features(x1)[1:]
        want = cpu.neck(feats)
        got = card.neck([f.cuda() for f in feats])
        heads, hws = card.head_outputs(x1.cuda())
    level_err = [_rel(g, w) for g, w in zip(got, want)]
    shapes = [tuple(f.shape[1:3]) for f in want]
    check = {"phase": "model_check", "model": name, "stage": "loss_and_neck",
             "cpu_loss": losses[0], "loss": losses[1],
             "loss_rel_err": loss_err, "loss_bound": TRAIN_BOUND["float32"][0],
             "odd_frame": list(FCOS_ODD_HW), "c_levels": [
                 list(f.shape[1:3]) for f in feats],
             "p_levels": shapes, "neck_rel_max_abs_err": level_err,
             "bound": YOLO_F32_BOUND}
    emit(check)
    if not (loss_err <= TRAIN_BOUND["float32"][0] and math.isfinite(losses[1])
            and max(level_err) <= YOLO_F32_BOUND
            and list(hws) == shapes
            and [tuple(t.shape[1:3]) for t, _, _ in heads] == shapes):
        raise AssertionError(f"{name}: {check}")


def deform_sampler_ms(task, x):
    """Time of the deformable sampler (``DeformConv2d.sample``, all but the
    1x1 projection) over one served forward: each deformable conv's inputs
    captured in one forward, then each sampled again; the sums over the
    calls of the device time from CUDA-graph replays and of the CUDA-event
    time around each call (which also counts the host's launches where
    they outlast the device's work)."""
    from tlxcv_tpu_torch.models.detection.deform import DeformConv2d

    seen = []
    hooks = [m.register_forward_pre_hook(
        lambda mod, args: seen.append((mod, args[0])))
        for m in task.modules() if isinstance(m, DeformConv2d)]
    with torch.inference_mode():
        task.predict(x)
        for h in hooks:
            h.remove()
        calls = [functools.partial(mod.sample, inp) for mod, inp in seen]
        return (len(calls),
                sum(graph_ms(fn, reps=3, calls=2) for fn in calls),
                sum(time_ms(fn, reps=5, warmup=1) for fn in calls))


def offset_stats(model, x):
    """What the deformable convs' offset convs give on ``x``: the rms and
    the largest offset in pixels, the share of samples that fall outside
    the map (clamped to its border) and the range of the masks."""
    from tlxcv_tpu_torch.models.detection.deform import DeformConv2d

    offs = []
    hooks = [d.offset_conv.register_forward_hook(
        lambda mod, args, out: offs.append(out.float()))
        for d in model.modules() if isinstance(d, DeformConv2d)]
    try:
        with torch.inference_mode():
            model.head_outputs(x)
    finally:
        for h in hooks:
            h.remove()
    sq = peak = outside = masks_hi = 0.0
    masks_lo, n_off, n_taps = 1.0, 0, 0
    for off in offs:
        _, h, w, _ = off.shape
        gy = torch.arange(h, device=off.device).view(1, h, 1, 1)
        gx = torch.arange(w, device=off.device).view(1, 1, w, 1)
        taps = torch.arange(9, device=off.device)
        y = gy + (taps // 3 - 1) + off[..., 0:18:2]
        xx = gx + (taps % 3 - 1) + off[..., 1:18:2]
        outside += float(((y < 0) | (y > h - 1) | (xx < 0)
                          | (xx > w - 1)).sum())
        n_taps += y.numel()
        sq += float(off[..., :18].square().sum())
        n_off += off[..., :18].numel()
        peak = max(peak, float(off[..., :18].abs().max()))
        mask = torch.sigmoid(off[..., 18:])
        masks_lo = min(masks_lo, float(mask.min()))
        masks_hi = max(masks_hi, float(mask.max()))
    return {"calls": len(offs), "offset_rms_px": math.sqrt(sq / n_off),
            "offset_max_px": peak, "outside_share": outside / n_taps,
            "mask_range": [masks_lo, masks_hi]}


@torch.no_grad()
def redraw(convs, std, gen):
    """Draw the weights of ``convs`` anew from N(0, std^2)."""
    for conv in convs:
        conv.weight.copy_(std * torch.randn(conv.weight.shape,
                                            generator=gen))


def dets_check(keep):
    def check(out, batch):
        dets, counts = out
        if dets.shape != (batch, keep, 6) or counts.shape != (batch,):
            raise AssertionError(f"bad detections {dets.shape}")
        if not torch.isfinite(dets).all() or int(counts.min()) <= 0:
            raise AssertionError("non-finite or empty detections")
    return check


def detr_outputs_check(out, batch):
    logits, boxes = out["logits"], out["boxes"]
    if logits.shape != (batch, 100, 92) or boxes.shape != (batch, 100, 4):
        raise AssertionError(f"bad DETR outputs {logits.shape}")
    if not (torch.isfinite(logits).all() and boxes.min() >= 0
            and boxes.max() <= 1):
        raise AssertionError("non-finite DETR logits or boxes outside "
                             "[0, 1]")


# the share of queries whose top class the card's f32 DETR gives as the
# CPU does (the f32 logits differ by summation order only)
DETR_LABEL_FLOOR = 0.9


def detector_checked(name, hw, redraw_heads=lambda m: None, gen=None,
                     **kw):
    """The model on the CPU with its heads redrawn and statistics from the
    2 check images, its copy on the card, and those images."""
    from tlxcv_tpu_torch import create_model

    cpu = create_model(name, device="cpu", generator=gen, **kw)
    redraw_heads(cpu)
    x2 = torch.randn(2, *hw, 3, generator=gen)
    data_bn_statistics(cpu, x2)
    return cpu, copy.deepcopy(cpu).cuda(), x2


def detector_served(name, card, x, expect, check, profile=False):
    """``predict`` of the detector served and timed (``serve``), with
    ``profile`` its device time and idle share."""
    from tlxcv_tpu_torch.tasks import ObjectDetection

    task = ObjectDetection(card.eval())
    counts, step = serve(task, x, expect, name, "bfloat16", check=check)
    if profile:
        phase_profile(name, task, x, step_s=step)
    torch.cuda.empty_cache()
    return counts


def phase_detectors(flash_record, profile, gather_record, upsample_record):
    """The reference's three other detectors, random weights from a seed,
    bf16 parameters with f32 statistics as the JAX package's bench keeps
    them.  BatchNorm (and DETR's frozen BatchNorm) statistics come from one
    forward of the 2 seeded images each is checked on, on the CPU: the
    normalisation of a random network does not carry over well from other
    random images, and with statistics from them the random PP-YOLOE's
    scores saturate at 1.0, so that a check would compare ties.

    - DETR-R50 (``create_model("detr")``: 91 classes, 100 queries, width
      256 over 8 heads, 6 + 6 layers, frozen BatchNorms): b2 800x1344
      against the CPU stage by stage (``detr_check``), 18 flash launches a
      forward; served at b8 800x1344 bf16 (25 x 42 = 1050 encoder tokens);
    - PP-YOLOE-L (``create_model("ppyoloe_l")``, 80 classes): its
      prediction convs are zero at init (every score sigmoid(-4.595) =
      0.01 and one box for every anchor, so a check would compare ties) and
      are drawn from N(0, 0.02^2) with their biases kept; b2 640^2 against
      the CPU (``dense_detector_check``); served at b32 640^2 (8400
      anchors, NMS score 0.01, IoU 0.6, top 1000, keep 100);
    - SSD-MobileNetV1 (``create_model("ssd")``, 80 classes, 300^2): its
      score convs at their N(0, 0.01^2) init put every class close to
      1/81, so each box's label would be decided by rounding; they are
      drawn from N(0, 0.1^2) and the box convs from N(0, 0.05^2); b2 300^2
      against the CPU; served at b128 (1917 priors, NMS score 0.01, IoU
      0.45, top 400, keep 200).

    Both dense detectors are chaotic with random weights.  In f32 their
    stages are held against the CPU's model in f64 (``CHAOTIC_F32_RMS``).
    In bf16 (the BatchNorms apply scale and offset in bf16, as the
    reference's do) the CPU's own bf16 heads lie about as far from its f32
    ones as those are large, and the CPU's bf16 model reproduced 0.5% and
    6% of its f32 detections (on the host of one H100 80GB HBM3); so
    their bf16 detections are held by the stages, the decode and the NMS
    alone and a count > 0 per image, and the end-to-end share is reported
    beside the CPU bf16 model's, not held.  No kernel of ours runs in
    PP-YOLOE or SSD; every launch is counted."""
    gen = torch.Generator().manual_seed(0)
    cpu, card, x2 = detector_checked("detr", DETR_HW, gen=gen)
    detr_check(cpu, card, x2)
    del cpu
    x = torch.randn(DETR_BATCH, *DETR_HW, 3, generator=gen)
    counts = detector_served("detr_resnet50", card,
                             x.to("cuda", torch.bfloat16),
                             {"flash_attention": 18}, detr_outputs_check,
                             profile)
    flash_record["detr_launches"] = counts["flash_attention"]
    del card

    def ppyoloe_heads(m):
        redraw([*m.yolo_head.pred_cls, *m.yolo_head.pred_reg], 0.02, gen)

    cpu, card, x2 = detector_checked("ppyoloe_l", (640, 640), ppyoloe_heads,
                                     gen)
    dense_detector_check("ppyoloe_l", cpu, card, x2, ppyoloe_stages,
                         ppyoloe_decode,
                         lambda m, b, s: m.yolo_head.nms(b, s),
                         bf16_share_floor=None, f64_truth=True)
    del cpu
    x = torch.randn(32, 640, 640, 3, generator=gen)
    detector_served("ppyoloe_l", card, x.to("cuda", torch.bfloat16), {},
                    dets_check(100), profile)
    del card

    def ssd_heads(m):
        redraw(m.ssd_head.score_convs, 0.1, gen)
        redraw(m.ssd_head.box_convs, 0.05, gen)

    cpu, card, x2 = detector_checked("ssd", (300, 300), ssd_heads, gen,
                                     image_size=(300, 300))
    dense_detector_check("ssd", cpu, card, x2, ssd_stages, ssd_decode,
                         lambda m, b, s: m.nms(b, s), bf16_share_floor=None,
                         f64_truth=True)
    del cpu
    x = torch.randn(128, 300, 300, 3, generator=gen)
    detector_served("ssd", card, x.to("cuda", torch.bfloat16), {},
                    dets_check(200), profile)
    del card
    torch.cuda.empty_cache()
    fcos_legs(profile, gen)
    zoo_legs(gather_record, upsample_record, profile, gen)
    leg_fcos_train(profile)


def fcos_legs(profile, gen):
    """FCOS-R50 and FCOS-DCN-R50 (80 classes): the classifier and
    centerness convs drawn from N(0, 0.05^2) and the distance conv from
    N(0, 0.02^2), biases kept (at their N(0, 0.01^2) init every score is
    about sigmoid(-4.6) / 2 = 0.005, under the 0.025 threshold, and no box
    survives); the deformable convs' offset convs drawn from N(0, 0.05^2)
    (zero at init, where every tap samples its own pixel with mask 1/2 and
    neither the bilinear blend nor the border clamp is exercised: drawn,
    offsets of a few pixels and mask logits away from 0, as
    ``offset_stats`` records); statistics from the 2 check images; b2 at
    320x544 against
    the CPU stage by stage (``dense_detector_check``, f32 held against the
    CPU's f64 model), ``fcos_check``, then the detections of the card's
    bf16 head outputs against the CPU's decode and NMS of those very
    outputs; served in bf16 at b8 800x1344 (~22,300 points, NMS score
    0.025, IoU 0.6, top 1000, keep 100).  No kernel of ours runs; with
    ``profile``, the deformable sampler's device time a served forward."""
    from tlxcv_tpu_torch.models.detection.deform import DeformConv2d

    def fcos_heads(m):
        redraw([m.head.cls_pred, m.head.ctr_pred], 0.05, gen)
        redraw([m.head.reg_pred], 0.02, gen)
        redraw([d.offset_conv for d in m.head.modules()
                if isinstance(d, DeformConv2d)], 0.05, gen)

    for name in ("fcos_r50", "fcos_dcn_r50"):
        cpu, card, x2 = detector_checked(name, FCOS_CHECK_HW, fcos_heads,
                                         gen)
        if name == "fcos_dcn_r50":  # the sampler off its grid, past the map
            stats = offset_stats(card, x2.cuda())
            emit({"phase": "model_check", "model": name,
                  "stage": "deform_offsets", **stats})
            if stats["offset_rms_px"] < 0.5 or stats["outside_share"] == 0:
                raise AssertionError(f"{name}: offsets too small {stats}")
        fcos_check(name, cpu, card, x2, gen)
        dense_detector_check(name, cpu, card, x2, fcos_stages, fcos_decode,
                             lambda m, b, s: m.nms(b, s),
                             bf16_share_floor=None, f64_truth=True)
        got = fcos_stages(card, x2.to("cuda", torch.bfloat16))
        with torch.inference_mode():  # the CPU's decode and NMS of them
            ref, ref_counts = cpu.nms(*fcos_decode(
                cpu, [h.cpu() for h in got["heads"]], x2.shape[1:3]))
        share = matched_share(ref, got["dets"])
        emit({"phase": "model_check", "model": name,
              "stage": "nms_of_card_heads", "dtype": "bfloat16",
              "matched_share": share, "floor": YOLO_NMS_SHARE_FLOOR,
              "counts": got["counts"].tolist(),
              "cpu_counts": ref_counts.tolist()})
        if share < YOLO_NMS_SHARE_FLOOR:
            raise AssertionError(f"{name}: the card's detections of its own "
                                 f"heads match {share} of the CPU's")
        del cpu, got, ref
        x = torch.randn(FCOS_BATCH, *FCOS_HW, 3, generator=gen).to(
            "cuda", torch.bfloat16)
        detector_served(name, card, x, {}, dets_check(100), profile)
        if profile and name == "fcos_dcn_r50":
            from tlxcv_tpu_torch.tasks import ObjectDetection

            calls, ms, event_ms = deform_sampler_ms(
                ObjectDetection(card.eval()), x)
            emit({"phase": "deform_sampler", "model": name,
                  "batch": FCOS_BATCH, "calls_per_forward": calls,
                  "ms_per_forward": ms, "event_ms_per_forward": event_ms})
        del card, x
        torch.cuda.empty_cache()


# ------------------------------------------------------ the detection zoo
# The rest of the reference's detection zoo at its published settings:
# (registry name, check frame, served batch, served frame, launches of our
# kernels a forward).  COCO's 800x1333 padded to 1344, as the FCOS and DETR
# legs serve it; the two-stage models at the Mask R-CNN leg's b16 640^2;
# YOLOX-s at its 640^2, CenterNet and TTFNet at their 512^2, PicoDet-S at
# its 416^2.  Each is checked at b2 on the smaller frame first.
ZOO_LEGS = [
    ("retinanet", (320, 544), 8, (800, 1344), {}),
    ("gfl_r50", (320, 544), 8, (800, 1344), {}),
    ("tood_r50", (320, 544), 8, (800, 1344), {}),
    ("faster_rcnn", (384, 384), 16, (640, 640),
     {"gather_rows": 1, "upsample_add_fused": 3}),
    ("cascade_rcnn", (384, 384), 16, (640, 640),
     {"gather_rows": 3, "upsample_add_fused": 3}),
    ("yolox_s", (320, 320), 64, (640, 640), {}),
    ("centernet", (256, 256), 32, (512, 512), {}),
    ("ttfnet", (256, 256), 32, (512, 512), {}),
    ("picodet_lcnet", (320, 320), 64, (416, 416), {}),
    ("solov2_r50", (320, 544), 8, (800, 1344), {"upsample_add_fused": 3}),
]


def _levels(outs):
    return [t for level in outs for t in level]


def _regroup(heads, per_level):
    return [heads[i:i + per_level] for i in range(0, len(heads), per_level)]


def _hws(heads, per_level):
    return tuple(tuple(t.shape[1:3]) for t in heads[::per_level])


def zoo_heads(name, gen):
    """Redraw the score-bearing convs of a random ``name`` (at their
    normal(0.01) init every score sits at its prior, under the leg's
    threshold, or, where the bias is 0, at one value for every box, so
    that a check would compare ties), with stds read off the CPU's full
    models at the check frames: counts of 64 to 100 an image at b2, the
    scores spread below saturation.  The box convs too, so that boxes
    differ from their anchors or cells."""
    def draw(*pairs):
        def heads(m):
            for convs, std in pairs:
                redraw(convs(m), std, gen)
        return heads
    return {
        "retinanet": draw((lambda m: [m.head.cls_pred], 0.05),
                          (lambda m: [m.head.reg_pred], 0.02)),
        "gfl_r50": draw((lambda m: [m.head.cls_pred], 0.02),
                        (lambda m: [m.head.reg_pred], 0.02)),
        "tood_r50": draw((lambda m: [m.head.cls_pred], 0.05),
                         (lambda m: [m.head.cls_prob_conv2], 0.1),
                         (lambda m: [m.head.reg_pred], 0.02)),
        "faster_rcnn": draw((lambda m: [m.cls_score], 0.003)),
        "cascade_rcnn": draw((lambda m: list(m.stage_cls), 0.01)),
        "yolox_s": draw((lambda m: [*m.head.cls_preds, *m.head.obj_preds],
                         0.05), (lambda m: list(m.head.reg_preds), 0.02)),
        "centernet": draw((lambda m: [m.hm_head.pred], 0.05),
                          (lambda m: [m.wh_head.pred], 0.5),
                          (lambda m: [m.off_head.pred], 0.1)),
        "ttfnet": draw((lambda m: [m.hm_head.pred], 0.05),
                       (lambda m: [m.wh_head.pred], 0.05)),
        "picodet_lcnet": draw((lambda m: list(m.head.preds), 0.05)),
        "solov2_r50": draw((lambda m: [m.head.cate_pred], 0.05)),
    }[name]


def zoo_stages(name):
    """``(stages, select)`` of a zoo detector.  ``stages(model, x, ref)``
    runs one forward and gives the outputs to compare (``heads``: every
    head output, in f32 or bf16 as the model makes them) and the
    detections (``dets``); two-stage models take the proposals of the
    reference run ``ref`` in place of their own (with random weights the
    top 512 of 100k near-equal objectness logits differ between devices,
    as the Mask R-CNN leg found).  ``select(model, out, hw)`` makes the
    detections of ``out``'s heads alone: the decode and the NMS (the
    peaks' top-k for CenterNet and TTFNet, the matrix NMS for SOLOv2)."""
    from tlxcv_tpu_torch.models.detection import CascadeRCNN

    def dense(per_level, with_hw=True):
        def decode(m, heads, hws, hw):
            outs = _regroup(heads, per_level)
            return m.nms(*(m.decode(outs, hws, hw) if with_hw
                           else m.decode(outs, hws)))

        def stages(m, x, ref=None):
            outs, hws = m.head_outputs(x)
            heads = _levels(outs)
            return {"heads": heads,
                    "dets": decode(m, heads, hws, tuple(x.shape[1:3]))}

        def select(m, out, hw):
            return decode(m, out["heads"], _hws(out["heads"], per_level), hw)
        return stages, select

    def retina():
        def stages(m, x, ref=None):
            cls, reg, hws = m.head_outputs(x)
            return {"heads": [cls, reg], "hws": hws,
                    "dets": select(m, {"heads": [cls, reg], "hws": hws},
                                   tuple(x.shape[1:3]))}

        def select(m, out, hw):
            cls, reg = out["heads"]
            return m.nms(*m.decode(cls, reg, m.anchors(out["hws"],
                                                       cls.device), hw))
        return stages, select

    def peaks():
        def stages(m, x, ref=None):
            heads = list(m.head_outputs(x))
            return {"heads": heads, "dets": m.select(*m.cells(*heads))}

        def select(m, out, hw):
            return m.select(*m.cells(*out["heads"]))
        return stages, select

    def rcnn():
        def stages(m, x, ref=None):
            hw = tuple(x.shape[1:3])
            feats, logits, deltas, _, props, pmask = m.forward_features(x)
            if ref is not None:
                props = ref["props"].to(x.device, props.dtype)
                pmask = ref["pmask"].to(x.device)
            if isinstance(m, CascadeRCNN):
                steps, final = m._run_cascade(feats, props, hw)
                box = [t for i, (b, c, d) in enumerate(steps)
                       for t in ((c, d) if i == 0 else (b, c, d))] + [final]
            else:
                box = list(m.box_logits(feats, props))
            out = {"heads": feats + [logits, deltas] + box, "props": props,
                   "pmask": pmask}
            out["dets"] = select(m, out, hw)
            return out

        def select(m, out, hw):
            box = out["heads"][len(out["heads"]) - (9 if isinstance(
                m, CascadeRCNN) else 2):]
            props, pmask = out["props"], out["pmask"]
            if isinstance(m, CascadeRCNN):
                c0, d0, b1, c1, d1, b2, c2, d2, final = box
                return m.postprocess([(props, c0, d0), (b1, c1, d1),
                                      (b2, c2, d2)], final, pmask)
            return m._postprocess(None, props, pmask, *box, hw)
        return stages, select

    def solo():
        def stages(m, x, ref=None):
            outs, mfeat = m.head_outputs(x)
            return {"heads": _levels(outs) + [mfeat],
                    "dets": m.post_process(outs, mfeat)}

        def select(m, out, hw):
            return m.post_process(_regroup(out["heads"][:-1], 2),
                                  out["heads"][-1])
        return stages, select

    family = {"retinanet": retina, "gfl_r50": lambda: dense(2),
              "tood_r50": lambda: dense(2), "faster_rcnn": rcnn,
              "cascade_rcnn": rcnn, "yolox_s": lambda: dense(3, False),
              "centernet": peaks, "ttfnet": peaks,
              "picodet_lcnet": lambda: dense(2), "solov2_r50": solo}[name]
    stages, select = family()

    def run(m, x, ref=None):
        with torch.inference_mode():
            return stages(m, x, ref)

    def run_select(m, out, hw):
        with torch.inference_mode():
            return select(m, out, hw)
    return run, run_select


def mask_matched_share(want, got):
    """SOLOv2: the share of the reference's valid instances that an
    instance of the card matches, the same label and mask IoU >= 0.9 (the
    masks cut at 0.5)."""
    hits = total = 0
    for wl, wm, gl, gm in zip(want[0], want[2], got[0], got[2]):
        keep, gkeep = wl >= 0, gl.cpu() >= 0
        w = (wm[keep] > 0.5).flatten(1).float()
        g = (gm.cpu()[gkeep] > 0.5).flatten(1).float()
        if len(w) == 0:
            continue
        inter = w @ g.T
        iou = inter / (w.sum(1)[:, None] + g.sum(1)[None] - inter).clamp_min(1)
        same = wl[keep][:, None] == gl.cpu()[gkeep][None]
        hits += int(((iou >= 0.9) & same).any(1).sum())
        total += len(w)
    return hits / max(total, 1)


def zoo_share(want, got):
    if len(want) == 4:
        return mask_matched_share(want, got)
    return matched_share(want[0], got[0])


def _to_cpu(out):
    return {k: [t.cpu() for t in v] if isinstance(v, list)
            else v.cpu() if torch.is_tensor(v) else v
            for k, v in out.items()}


def zoo_check(name, cpu, card, x2, expect, dev="cuda"):
    """A zoo detector at b2 on the card against the CPU, in f32 (TF32
    off) and bf16, stage by stage under the chaotic-net rule of PERF.md
    §2: every head output in f32 within ``CHAOTIC_F32_RMS`` times the CPU
    f32 model's rms error from the CPU's model in f64, in bf16 within
    ``YOLO_BF16_RMS`` times the CPU bf16 model's own rms error from its
    f32 model (of the f32 model, and of the bf16 model); a count > 0 an
    image; the detections the CPU's decode and NMS make of the card's own
    head outputs reproduced to ``YOLO_NMS_SHARE_FLOOR``; exactly
    ``expect`` launches of our kernels in one forward.  The end-to-end
    share of the CPU's f32 detections is reported, not held (random nets
    are chaotic).  ``card`` is left with bf16 parameters."""
    stages, select = zoo_stages(name)
    hw = tuple(x2.shape[1:3])
    t0 = time.perf_counter()
    want = stages(cpu, x2)
    cpu_s = time.perf_counter() - t0
    truth = stages(copy.deepcopy(cpu).double(), x2.double(), want)
    want16 = stages(params_to(copy.deepcopy(cpu), torch.bfloat16),
                    x2.to(torch.bfloat16), want)
    for dtype in (torch.float32, torch.bfloat16):
        dname = str(dtype)[6:]
        if dtype == torch.bfloat16:
            params_to(card, dtype)
        reset_launches()
        got = stages(card, x2.to(dev, dtype), want)
        per_forward = {k: v for k, v in launch_counts(f32=False).items() if v}
        heads = zip(got["heads"], want["heads"], truth["heads"],
                    want16["heads"])
        if dtype == torch.float32:
            ratio = [_rms(g, t) / max(_rms(w, t), 1e-30)
                     for g, w, t, _ in heads]
            held = max(ratio) <= CHAOTIC_F32_RMS
        else:
            ratio = [(_rms(g, w) / max(_rms(c, w), 1e-30),
                      _rms(g, c) / max(_rms(c, w), 1e-30))
                     for g, w, _, c in heads]
            held = all(a <= YOLO_BF16_RMS[0] and b <= YOLO_BF16_RMS[1]
                       for a, b in ratio)
        own = select(cpu, _to_cpu(got), hw)
        own_share = zoo_share(own, got["dets"])
        # detections an image: the last of (dets, counts) or of SOLOv2's
        # (labels, scores, masks, counts)
        counts = got["dets"][-1].cpu().tolist()
        finite = all(bool(torch.isfinite(t).all()) for t in got["heads"])
        check = {"phase": "model_check", "model": name, "batch": 2,
                 "frame": list(hw), "dtype": dname,
                 "heads": len(got["heads"]),
                 "rms_ratios": ratio,
                 "rms_bound": CHAOTIC_F32_RMS if dtype == torch.float32
                 else YOLO_BF16_RMS, "held": held, "counts": counts,
                 "cpu_counts": want["dets"][-1].tolist(),
                 "matched_share_end_to_end": zoo_share(want["dets"],
                                                       got["dets"]),
                 "own_heads_share": own_share,
                 "own_heads_floor": YOLO_NMS_SHARE_FLOOR,
                 "launches_per_forward": per_forward, "finite": finite,
                 "cpu_reference_s": cpu_s}
        emit(check)
        if not (held and finite and min(counts) > 0
                and own_share >= YOLO_NMS_SHARE_FLOOR):
            raise AssertionError(f"{name} {dname} disagrees with the CPU: "
                                 f"{check}")
        if dev == "cuda" and per_forward != expect:
            raise AssertionError(f"{name}: kernel launches {per_forward} in "
                                 f"one forward, expected {expect}")
    del want, truth, want16, got


def solo_check(keep):
    def check(out, batch):
        labels, scores, masks, counts = out
        if labels.shape != (batch, keep) or masks.shape[:2] != (batch, keep):
            raise AssertionError(f"bad SOLOv2 outputs {masks.shape}")
        if not (torch.isfinite(scores).all() and torch.isfinite(masks).all()
                and int(counts.min()) > 0):
            raise AssertionError("non-finite or empty SOLOv2 outputs")
    return check


def zoo_legs(gather_record, upsample_record, profile, gen):
    """The rest of the detection zoo (``ZOO_LEGS``), 80 classes, random
    weights from a seed, the score-bearing convs drawn (``zoo_heads``),
    BatchNorm statistics from the 2 check images: each checked at b2
    (``zoo_check``), then served in bf16 with its launches checked,
    exactly, a forward: Faster R-CNN 1 row gather (RoIAlign of its box
    head) and 3 upsample-adds (the FPN), Cascade R-CNN 3 gathers (one a
    stage) and 3 upsample-adds, SOLOv2 3 upsample-adds, the others none.
    The launch counts of the served runs go into the two kernels'
    records."""
    for name, check_hw, batch, hw, expect in ZOO_LEGS:
        cpu, card, x2 = detector_checked(name, check_hw,
                                         zoo_heads(name, gen), gen)
        zoo_check(name, cpu, card, x2, expect)
        del cpu
        x = torch.randn(batch, *hw, 3, generator=gen).to("cuda",
                                                         torch.bfloat16)
        keep = 100
        counts = detector_served(
            name, card, x, expect,
            solo_check(keep) if name == "solov2_r50" else dets_check(keep),
            profile)
        for record, kernel in ((gather_record, "gather_rows"),
                               (upsample_record, "upsample_add_fused")):
            if kernel in expect:
                record[f"{name}_launches"] = counts[kernel]
        del card, x
        torch.cuda.empty_cache()


def padded_shapes(batch, seed, hw):
    """``shapes_targets`` at the frame's height, its images zero-padded on
    the right to its width (COCO's batches padded to one frame): boxes in
    pixels."""
    import numpy as np

    x, t = shapes_targets(batch, seed, hw[0], normalise=False)
    pad = np.zeros((batch, hw[0], hw[1] - hw[0], 3), x.dtype)
    return np.concatenate([x, pad], 2), t


def leg_fcos_train(profile, dev="cuda", train_batch=8, hw=(800, 1344),
                   check_size=256):
    """FCOS-R50 training (``create_model("fcos_r50")``, 80 classes),
    random weights from a seed, BatchNorm in train mode, the distance
    conv drawn as the serving leg draws it (at its normal(0.01) init the
    distances sit within bf16's rounding of 0, so their ReLU opens at other
    cells in bf16 than in f32, and a level's scale lost its every gradient
    on the card in bf16); the classifier and centerness keep their prior:
    gradients at b2 256^2 against the CPU
    (``train_check``), the loss falling on one batch, then
    ``Trainer.train`` at b8 800x1344 on ``ShapesDetection`` padded to the
    frame, bf16 over f32 masters, Adam: ``TRAIN_STEPS`` timed steps after
    3, no kernel
    of ours."""
    from tlxcv_tpu_torch import create_model
    from tlxcv_tpu_torch.tasks import ObjectDetection
    from tlxcv_tpu_torch.train import Trainer, optimizers

    name = "fcos_r50"

    def build(seed=71):
        gen = torch.Generator().manual_seed(seed)
        model = create_model(name, device="cpu", generator=gen)
        redraw([model.head.reg_pred], 0.02, gen)
        return ObjectDetection(model)

    xg, yg = shapes_targets(2, 9, check_size, normalise=False)

    def loss(task, o, t):
        return task.loss_fn(o, _to(o["outs"][0][0].device, t))

    train_check(name, build, xg, yg, loss,
                ["backbone.backbone.conv1.weight",
                 "backbone.neck.lateral.0.weight",
                 "backbone.head.cls_tower.0.weight",
                 "backbone.head.reg_pred.weight"], bf16_cpu_loss=True)
    trainer = Trainer(build(73).to(dev), optimizer=optimizers.Adam(1e-4),
                      compute_dtype=torch.bfloat16, device=dev)
    batches = [trainer._put_batch(padded_shapes(train_batch, s, hw))
               for s in (10, 11)]
    attention_train(name, trainer, batches, {}, train_batch, profile)
    del trainer, batches
    empty_cache(dev)


# ------------------------------- segmentation, BIT and padded head dims
# BIT at b32 256^2 (a 32 x 32 grid at stride 8): width 32 over 8 heads, so
# head dim 4, which the wrapper pads to 32; (name, Sq, Sk) of its token
# encoder (4 tokens an image, both images' together) and of each decoder
# layer (an image's 1024 pixels over its 4 tokens)
BIT_BATCH, BIT_HEADS, BIT_D = 32, 8, 4
BIT_GRIDS = [("bit_encoder", 8, 8), ("bit_decoder", 1024, 4)]
PADDED_DS = (2, 4, 6, 8, 16, 24, 48, 80, 112)


def bit_qkv(name, dtype, seed, batch=BIT_BATCH):
    """q, k, v as BIT hands them over: the encoder's [B, H, 8, D] views of
    its packed qkv projection, the decoder's [B, H, S, D] views of its
    separate q, k and v projections."""
    g = torch.Generator(device="cuda").manual_seed(seed)
    h, d = BIT_HEADS, BIT_D
    if name == "bit_encoder":
        packed = torch.randn(batch, 8, 3, h, d, generator=g, device="cuda")
        return list(packed.to(dtype).permute(2, 0, 3, 1, 4))
    return [torch.randn(batch, n, h * d, generator=g, device="cuda")
            .to(dtype).view(batch, n, h, d).transpose(1, 2)
            for n in (1024, 4, 4)]


def check_padded(name, q, k, v, dtype):
    """The flash wrapper at a head dim it pads: the output against the
    plain version at the real D (on the same inputs, in f32), and dq, dk,
    dv through ``autograd.grad`` (the pad's and the slice's backward around
    the backward kernel) against ``flash_attention_backward_plain`` at the
    real D on the kernel's output, each within the forward's bound of its
    largest magnitude, bitwise over two runs; one forward and one backward
    launch a call.  Raises on a miss; returns the record."""
    from tlxcv_tpu_torch.ops.cuda import attention as A

    tol = {torch.float32: 1e-4, torch.bfloat16: 2e-2}[dtype]
    sk = k.shape[-2]
    leaves = [t.detach().requires_grad_() for t in (q, k, v)]
    before = (A.flash_attention.launches, A.flash_attention_backward.launches)
    out = A.flash_attention(*leaves)
    qf, kf, vf = (t.float() for t in (q, k, v))
    ref, lse = A.flash_attention_plain(qf, kf, vf, return_lse=True)
    fwd_err = _rel_card(out, ref)
    g = torch.Generator(device="cuda").manual_seed(sk)
    dout = torch.randn(out.shape, generator=g, device="cuda").to(dtype)
    got = torch.autograd.grad(out, leaves, dout)
    again = torch.autograd.grad(A.flash_attention(*leaves), leaves, dout)
    torch.cuda.synchronize()
    launched = (A.flash_attention.launches - before[0],
                A.flash_attention_backward.launches - before[1])
    want = A.flash_attention_backward_plain(qf, kf, vf, None, None,
                                            out.detach().float(), lse,
                                            dout.float())
    errs = _grad_rel_errs(got, want, sk)
    finite = bool(torch.isfinite(out).all()) and all(
        bool(torch.isfinite(a).all()) for a in got)
    bitwise = all(torch.equal(a, c) for a, c in zip(got, again))
    record = {"case": name, "dtype": str(dtype)[6:],
              "shape": [q.shape[:-2].numel(), q.shape[-2], sk, q.shape[-1]],
              "padded_to": A.padded_head_dim(q.shape[-1]),
              "forward_rel_err": fwd_err, "rel_err_dq_dk_dv": errs,
              "bound": tol, "bitwise_repeat": bitwise, "finite": finite,
              "launches": launched}
    if (not finite or not bitwise or launched != (2, 2) or fwd_err > tol
            or max(errs) > tol):
        emit({"phase": "flash_padded", "failed": record})
        raise AssertionError(f"flash at a padded head dim {name} {dtype}: "
                             f"{record}")
    return record


def padded_flash_times(q, k, v):
    """Flash attention on the inputs a model hands it, at a head dim its
    wrapper may pad: the wrapper with its pad (``ms``: CUDA-graph replays;
    ``event_ms``: events around each call), the kernel alone on inputs
    padded beforehand (``kernel_ms``), the plain version, SDPA at the real
    D (``library_ms``) and the bound, which counts the bytes of the
    unpadded q, k, v and output."""
    from tlxcv_tpu_torch.ops.cuda import attention as A

    d = q.shape[-1]
    bh, sq, sk = q.shape[:-2].numel(), q.shape[-2], k.shape[-2]
    dp = A.padded_head_dim(d)
    qp, kp, vp = (torch.nn.functional.pad(t, (0, dp - d)) for t in (q, k, v))
    bound, bound_by = attention_bound_ms(bh, sq, sk, d, q.dtype)

    def sdpa():
        return torch.nn.functional.scaled_dot_product_attention(q, k, v)

    return {"shape": [bh, sq, sk, d], "padded_to": dp,
            "ms": graph_ms(lambda: A.flash_attention(q, k, v)),
            "event_ms": time_ms(lambda: A.flash_attention(q, k, v)),
            "kernel_ms": graph_ms(lambda: A._launch_kernel(
                qp, kp, vp, None, d ** -0.5)),
            "plain_ms": time_ms(lambda: A.flash_attention_plain(q, k, v)),
            "library_ms": graph_ms(sdpa), "library_event_ms": time_ms(sdpa),
            "bound_ms": bound, "bound_us": 1e3 * bound, "bound_by": bound_by}


def phase_padded_flash(flash_record):
    """Flash attention at head dims the kernel does not take, which the
    wrapper zero-pads to the next of 32/64/96/128 (``padded_head_dim``):
    ``check_padded`` in bf16 and f32 at BIT's two b32 grids and at D in
    ``PADDED_DS`` on [2, 3, 77, D] queries over 65 keys; D = 129 raises.
    Then BIT's two grids timed in bf16 (``padded_flash_times``).
    Adds the grids' record to ``flash_record`` (``bit_grids``)."""
    from tlxcv_tpu_torch.ops.cuda import attention as A

    results = []
    for dtype in (torch.bfloat16, torch.float32):
        for name, _, _ in BIT_GRIDS:
            results.append(check_padded(
                name, *bit_qkv(name, dtype, seed=len(results)), dtype))
        for d in PADDED_DS:
            g = torch.Generator(device="cuda").manual_seed(d)
            q, k, v = (torch.randn(2, 3, n, d, generator=g, device="cuda")
                       .to(dtype) for n in (77, 65, 65))
            results.append(check_padded(f"d{d}", q, k, v, dtype))
    try:
        A.flash_attention(*qkv(2, 16, 129, torch.bfloat16, seed=1))
    except ValueError:
        pass
    else:
        raise AssertionError("flash_attention took head dim 129")
    emit({"phase": "flash_padded", "checks": results, "cases": len(results),
          "worst": {dt: {key: max(max(r[key]) if isinstance(r[key], list)
                                  else r[key] for r in results
                                  if r["dtype"] == dt)
                         for key in ("forward_rel_err", "rel_err_dq_dk_dv")}
                    for dt in ("bfloat16", "float32")}})

    timings = {name: padded_flash_times(*bit_qkv(name, torch.bfloat16,
                                                 seed=21))
               for name, _, _ in BIT_GRIDS}
    emit({"phase": "kernel_times", "flash_attention_bit": timings})
    flash_record["bit_grids"] = timings
    return results


class PairPredict(torch.nn.Module):
    """A change detector as the checks and ``serve`` take a model: one
    [B, H, W, 6] tensor, the two images side by side on the channel axis,
    handed over as ``model(t1, t2)``."""

    def __init__(self, model):
        super().__init__()
        self.model = model

    def forward(self, x):
        return self.model(x[..., :3], x[..., 3:])

    def predict(self, x):
        return self.forward(x)


# (leg, config under configs/segmentation, served batch, served frame,
# checked frame, input channels, expected launches a forward); the frames
# are (H, W).  Cityscapes frames are 1024 x 2048 as PaddleSeg evaluates;
# UNet's 1028 x 2052 is the nearest whose valid-padding halvings stay
# whole (its output 988 x 2012); FastFCN serves its ADE20K crop.
SEG_LEGS = [
    ("bisenetv2", "bisenet/bisenet_cityscapes_1024x1024_160k.yml", 8,
     (1024, 2048), (256, 512), 3),
    ("fastscnn", "fastscnn/fastscnn_cityscapes_1024x1024_160k.yml", 8,
     (1024, 2048), (256, 512), 3),
    ("enet", "enet/enet_cityscapes_1024x512_80k.yml", 8, (1024, 2048),
     (256, 512), 3),
    ("unet", "unet/unet_cityscapes_1024x512_160k.yml", 8, (1028, 2052),
     (260, 516), 1),
    ("deeplabv3p_r50vd_os8",
     "deeplabv3p/deeplabv3p_resnet50_os8_cityscapes_1024x512_80k.yml", 4,
     (1024, 2048), (256, 512), 3),
    ("encnet_r101vd_os8",
     "encnet/encnet_resnet101_os8_cityscapes_1024x512_80k.yml", 4,
     (1024, 2048), (256, 512), 3),
    ("fastfcn_r50vd_os8",
     "fastfcn/fastfcn_resnet50_os8_ade20k_480x480_120k.yml", 16,
     (480, 480), (240, 240), 3),
]


def unet_out(hw, depth=3):
    """A valid-padding UNet's output size: two 3x3 convs (-4) a level,
    halved on the way down, doubled on the way up."""
    out = []
    for n in hw:
        for _ in range(depth - 1):
            n = (n - 4) // 2
        n -= 4
        for _ in range(depth - 1):
            n = 2 * n - 4
        out.append(n)
    return tuple(out)


def seg_logit_check(name, cpu, card, x1, expect):
    """f32 and bf16 logits of ``card`` against the CPU's models on ``x1``;
    ``card`` is left with bf16 parameters, and each card forward must
    launch exactly ``expect`` kernels of ours.  The bounds are PERF.md
    §2's, 1e-3 (f32) and 3e-2 (bf16) of the logits' largest magnitude
    against the CPU's f32 model, where the CPU's own models meet them:
    its f32 model within 1e-4 of that scale from its float64 model, its
    bf16 model within 3e-2 from its f32 one.  Random BatchNorm networks
    are chaotic at init (a rounding difference grows through the
    normalised layers), and in bf16 most of these miss by far, the deep
    ResNet-vD ones in f32 too (``model_check`` prints ``f32_chaotic`` and
    ``bf16_chaotic``).  Where the CPU's own model misses, its dtype is
    held as the detectors' are: f32
    against the f64 model within ``CHAOTIC_F32_RMS`` times the CPU f32
    model's rms error, bf16 within ``YOLO_BF16_RMS`` times the CPU bf16
    model's rms error of the f32 model, and of the CPU's bf16 model.
    Returns the card's f32 logits."""
    with torch.inference_mode():
        want = cpu(x1)
        want64 = copy.deepcopy(cpu).double()(x1.double())
        want16 = params_to(copy.deepcopy(cpu), torch.bfloat16)(
            x1.to(torch.bfloat16)).float()
        reset_launches()
        got32 = card(x1.cuda()).float().cpu()
        per_forward = launch_counts(f32=False)
        params_to(card, torch.bfloat16)
        got16 = card(x1.cuda().to(torch.bfloat16)).float().cpu()
        if launch_counts(f32=False) != {k: 2 * v for k, v in per_forward.items()}:
            raise AssertionError(f"{name}: the bf16 forward launched "
                                 f"other kernels than the f32 one")
    scale = want.abs().max().item()
    err32 = (got32 - want).abs().max().item()
    err16 = (got16 - want).abs().max().item()
    chaotic32 = (want.double() - want64).abs().max().item() > 1e-4 * scale
    chaotic16 = (want16 - want).abs().max().item() > 3e-2 * scale
    rms = {"f32_card_f64": _rms(got32, want64),
           "f32_cpu_f64": _rms(want, want64),
           "bf16_card_f32_cpu": _rms(got16, want),
           "bf16_cpu_f32_cpu": _rms(want16, want),
           "bf16_card_bf16_cpu": _rms(got16, want16)}
    ok32 = (rms["f32_card_f64"] <= CHAOTIC_F32_RMS * rms["f32_cpu_f64"]
            if chaotic32 else err32 <= 1e-3 * scale)
    ok16 = (rms["bf16_card_f32_cpu"]
            <= YOLO_BF16_RMS[0] * rms["bf16_cpu_f32_cpu"]
            and rms["bf16_card_bf16_cpu"]
            <= YOLO_BF16_RMS[1] * rms["bf16_cpu_f32_cpu"]
            if chaotic16 else err16 <= 3e-2 * scale)
    check = {"logit_scale": scale, "f32_max_abs_err": err32,
             "bf16_max_abs_err": err16, "f32_chaotic": chaotic32,
             "bf16_chaotic": chaotic16, "rms": rms,
             "launches_per_forward": {k: v for k, v in per_forward.items()
                                      if v}}
    emit({"phase": "model_check", "model": name, "batch": x1.shape[0],
          "shape": list(got32.shape), **check})
    if not (torch.isfinite(got32).all() and torch.isfinite(got16).all()):
        raise AssertionError(f"non-finite {name} outputs on the card")
    if not (ok32 and ok16):
        raise AssertionError(f"{name} outputs disagree with the CPU: "
                             f"{check}")
    if per_forward != {k: expect.get(k, 0) for k in per_forward}:
        raise AssertionError(f"{name}: kernel launches {per_forward} in one "
                             f"forward, expected {expect}")
    return got32


def seg_leg(name, model, classes, batch, served, checked, channels, gen,
            profile, expect=None, pair=False):
    """One segmentation leg: BatchNorm statistics from one train-mode
    forward of 2 seeded images at the checked frame on the CPU
    (``data_bn_statistics``); f32 and bf16 logits on the card at b1 on
    the checked frame against the CPU (``seg_logit_check``, ``expect``
    launches a forward); then the task's ``predict`` served in bf16 (float
    parameters bf16, statistics f32) at ``batch`` on the served frame,
    median of ``SERVE_ROUNDS`` rounds after 3, peak memory, and with
    ``profile`` the
    idle share.  With ``pair`` the model is a change detector, called as
    ``model(t1, t2)`` on two images of ``channels`` each (``PairPredict``);
    ``batch`` counts pairs."""
    from tlxcv_tpu_torch.tasks import ImageSegmentation

    expect = expect or {}
    c = 2 * channels if pair else channels
    cpu = PairPredict(model) if pair else ImageSegmentation(model)
    data_bn_statistics(cpu, torch.randn(2, *checked, c, generator=gen))
    x1 = torch.randn(1, *checked, c, generator=gen)
    card = copy.deepcopy(cpu).cuda()
    out = seg_logit_check(name, cpu, card, x1, expect)
    out_hw = unet_out(checked) if name == "unet" else checked
    if out.shape != (1, *out_hw, classes):
        raise AssertionError(f"{name}: logits {tuple(out.shape)} at "
                             f"{checked}, expected {(1, *out_hw, classes)}")
    del cpu
    x = torch.randn(batch, *served, c, generator=gen).to("cuda",
                                                         torch.bfloat16)
    out_hw = unet_out(served) if name == "unet" else served
    counts, step = serve(card.eval(), x, expect, name, "bfloat16",
                         check=check_seg(classes, out_hw))
    if profile:
        phase_profile(name, card, x, step_s=step)
    del card, x
    torch.cuda.empty_cache()
    return counts


def phase_segmentation(flash_record, profile):
    """The segmentation zoo and BIT, each built as the JAX package builds
    it (``build_seg_model`` on the in-repo YAML: its ``num_classes``, a
    string backbone by its ``resnet_vd`` factory at output stride 8),
    random weights from a seed, checked and served by ``seg_leg``:
    BiSeNetV2, Fast-SCNN, ENet (19 classes) and UNet (its default 1 input
    channel, 19 classes) at b8, DeepLabV3+ on ResNet50-vD and EncNet on
    ResNet101-vD at b4, all on Cityscapes frames; FastFCN on ResNet50-vD
    (150 classes) at b16 on ADE20K's 480^2 crop; BIT at its defaults
    (``create_model("bit")``: width 32 over 8 heads, 4 tokens, 1 encoder
    and 8 decoder layers, 2 classes, BIT's published LEVIR-CD setting),
    ``model(t1, t2)`` at b32 256^2 pairs, 17 flash launches a forward (1 +
    2 x 8) at head dim 4, padded.  None of the others launches a kernel of
    ours: their resizes are plain torch, as in the reference's default
    path."""
    import os

    from tlxcv_tpu_torch import build_seg_model, create_model, load_seg_config

    root = os.path.dirname(os.path.abspath(__file__))
    gen = torch.Generator().manual_seed(0)
    for name, cfg, batch, served, checked, channels in SEG_LEGS:
        path = os.path.join(root, "configs", "segmentation", cfg)
        model = build_seg_model(path, device="cpu", generator=gen)
        classes = load_seg_config(path)["model"]["num_classes"]
        seg_leg(name, model, classes, batch, served, checked, channels, gen,
                profile)
    bit = create_model("bit", device="cpu", generator=gen)
    counts = seg_leg("bit", bit, 2, BIT_BATCH, (256, 256), (256, 256), 3,
                     gen, profile, expect={"flash_attention": 17}, pair=True)
    flash_record["bit_launches"] = counts["flash_attention"]


# (leg, the port's registry name or ``models.rs`` class, keyword arguments,
# served batch, served frame, checked frame, a change detector (a pair of
# 3-channel images), classes).  The change detectors serve LEVIR-CD's 256^2
# crops of its 1024^2 tiles, as PaddleRS's LEVIR-CD configs crop (batch in
# pairs); FarSeg iSAID's 896^2 patches (16 classes); the UNet PaddleRS's
# 512^2 crops.  Each is checked at b1 on a frame of half the side, but
# FCCDN on its served frame: its centre (stride 64 of the input after the
# NL-FPN's pools) normalises over 2 x 2 positions at 128^2, and statistics
# taken there blow its served logits up to ~10^6 (~10^2 with statistics
# taken at 256^2).
RS_LEGS = [
    ("fc_ef", "fc_ef", {}, 32, 256, 128, True, 2),
    ("cdnet", "CDNet", {}, 32, 256, 128, True, 2),
    ("snunet", "snunet", {}, 32, 256, 128, True, 2),
    ("dsifn", "DSIFN", {}, 16, 256, 128, True, 2),
    ("stanet_bam", "STANet", {"att_type": "BAM"}, 16, 256, 128, True, 2),
    ("stanet_pam", "STANet", {"att_type": "PAM"}, 16, 256, 128, True, 2),
    ("dsamnet", "DSAMNet", {}, 16, 256, 128, True, 2),
    ("fccdn", "FCCDN", {}, 32, 256, 256, True, 2),
    ("farseg", "farseg", {}, 8, 896, 448, False, 16),
    ("rsunet", "RSUNet", {"width": 64, "num_classes": 2}, 8, 512, 256, False,
     2),
]


def phase_remote_sensing(profile):
    """The remote-sensing models, random weights from a seed, each checked
    and served by ``seg_leg`` (bf16 serving: float parameters bf16,
    BatchNorm statistics f32): FC-EF and CDNet (2 classes), SNUNet at
    width 32 (``create_model("snunet")``), FCCDN (output stride 16, SE) at
    b32 256^2 pairs; DSIFN (VGG-16 trunk), STANet with BAM and with PAM
    (ResNet-18, width 64, ``ds_factor`` 1) and DSAMNet at b16 256^2 pairs;
    FarSeg (``create_model("farseg")``: ResNet-50, 16 classes) at b8
    896^2; the PaddleRS UNet (width 64, 2 classes) at b8 512^2.  STANet's
    BAM attends over every position of the 64 x 128 stride-4 map of a
    pair: its [16, 8192, 8192] energy and softmax take 2 GiB each in bf16.
    No kernel of ours runs in any of them: every launch count must stay
    0."""
    from tlxcv_tpu_torch import create_model, list_models
    from tlxcv_tpu_torch.models import rs

    gen = torch.Generator().manual_seed(0)
    for leg, name, kw, batch, served, checked, pair, classes in RS_LEGS:
        build = (functools.partial(create_model, name)
                 if name in list_models() else getattr(rs, name))
        model = build(device="cpu", generator=gen, **kw)
        seg_leg(leg, model, classes, batch, (served, served),
                (checked, checked), 3, gen, profile, pair=pair)


# -------------------------------------- pose, landmarks, YOLOv3 training,
# QAT served in int8, train-state checkpoints
class Predict(torch.nn.Module):
    """A task's ``predict`` as a module's forward (PFLD's landmarks), for
    the checks that take a module."""

    def __init__(self, task):
        super().__init__()
        self.task = task

    def forward(self, x):
        return self.task.predict(x)


def check_shape(*shape):
    def check(pred, batch):
        if pred.shape != (batch, *shape) or \
                not bool(torch.isfinite(pred).all()):
            raise AssertionError(f"bad outputs {tuple(pred.shape)}, "
                                 f"expected {(batch, *shape)}")
    return check


def pose_targets(batch, seed, size=(256, 192), joints=17):
    """Heatmap targets (a quarter of the input's size, sigma 2) of seeded
    keypoints (inside the image, a tenth invisible) through the host
    transform ``GenerateTarget``, as a data pipeline makes them: (images
    [B, H, W, 3], (targets, weights))."""
    import numpy as np

    from tlxcv_tpu_torch.tasks import GenerateTarget

    rng = np.random.default_rng(seed)
    transform = GenerateTarget(size, joints, (size[0] // 4, size[1] // 4),
                               2)
    x = rng.normal(size=(batch, *size, 3)).astype(np.float32)
    kp = np.concatenate([rng.uniform(0, size[1], (batch, joints, 1)),
                         rng.uniform(0, size[0], (batch, joints, 1)),
                         rng.random((batch, joints, 1)) > 0.1], -1)
    pairs = [transform((None, k))[1] for k in kp.astype(np.float32)]
    return x, (np.stack([p[0] for p in pairs]),
               np.stack([p[1] for p in pairs]))


def pfld_targets(batch, seed):
    """Seeded landmarks (normalised), Euler angles (radians) and six
    binary attributes, as PFLD's loss takes them."""
    import numpy as np

    rng = np.random.default_rng(seed)
    x = rng.normal(size=(batch, 112, 112, 3)).astype(np.float32)
    return x, (rng.uniform(0, 1, (batch, 136)).astype(np.float32),
               rng.uniform(-0.5, 0.5, (batch, 3)).astype(np.float32),
               (rng.random((batch, 6)) < 0.3).astype(np.int64))


def yolo_targets(batch, seed, size=416, max_gt=50):
    """``ShapesDetection`` at ``size``, ground truth padded to ``max_gt`` a
    image, boxes turned into the normalised cxcywh that ``YOLOv3.loss_fn``
    takes (padding rows stay zero, so zero width)."""
    from tlxcv_tpu_torch.data import ShapesDetection, pad_targets

    ds = ShapesDetection(num=batch, size=size, max_objects=6, seed=seed)
    x, t = pad_targets(max_gt)([ds[i] for i in range(batch)])
    b = t["boxes"]
    cxcywh = b.copy()
    cxcywh[..., 0] = (b[..., 0] + b[..., 2]) / 2 / size
    cxcywh[..., 1] = (b[..., 1] + b[..., 3]) / 2 / size
    cxcywh[..., 2] = (b[..., 2] - b[..., 0]) / size
    cxcywh[..., 3] = (b[..., 3] - b[..., 1]) / size
    cxcywh *= t["mask"][..., None]
    return x, {"boxes": cxcywh, "class_labels": t["class_labels"]}


def _to(dev, y):
    """A target tree of numpy arrays as tensors on ``dev``."""
    if isinstance(y, dict):
        return {k: torch.as_tensor(v, device=dev) for k, v in y.items()}
    return tuple(torch.as_tensor(v, device=dev) for v in y)


def pose_decode_check(got, want, tol):
    """``get_max_preds`` on the card's f32 heatmaps against the CPU's,
    compared only where the CPU's top value leads its runner-up by more
    than ``tol`` (the f32 bound): the 0.001-std head leaves random
    heatmaps nearly flat, so a peak within the bound of another is decided
    by rounding.  Returns the share compared and the number that differ."""
    from tlxcv_tpu_torch.tasks import get_max_preds

    b, h, w, j = want.shape
    top2 = want.reshape(b, h * w, j).topk(2, dim=1).values
    decisive = (top2[:, 0] - top2[:, 1] > tol).numpy()
    pg, _ = get_max_preds(got.numpy())
    pw, _ = get_max_preds(want.numpy())
    differ = int((pg != pw).any(-1)[decisive].sum())
    return float(decisive.mean()), differ


def leg_pose(profile, dev="cuda", serve_batch=64, train_batch=32,
             check_hw=(256, 192)):
    """HRNet-W32 pose (``create_model("pose_hrnet_w32")``, 17 joints,
    256x192 input, 64x48 heatmaps, sigma 2: the reference's COCO setting),
    random weights from a seed, BatchNorm statistics from the checked
    images: f32 and bf16 heatmaps at b2 against f32 on the CPU (bf16 held
    to the CPU's own bf16 model's error, as HRNet-W18's), the argmax
    decode where it is decided, no kernel of ours; served at b64 bf16.
    Then training: gradients at b2 against the CPU (``train_check``), the
    loss falling over 20 steps on one batch, and ``Trainer.train`` at b32
    (bf16 over f32 masters, Adam, ``TRAIN_STEPS`` steps after 3) with
    targets from
    ``GenerateTarget``.  Returns the trainer and a batch for the
    checkpoint leg."""
    from tlxcv_tpu_torch import create_model
    from tlxcv_tpu_torch.tasks import HumanPoseEstimation
    from tlxcv_tpu_torch.train import Trainer, optimizers

    name = "pose_hrnet_w32"
    gen = torch.Generator().manual_seed(11)

    def build(seed=11):
        return HumanPoseEstimation(create_model(
            name, device="cpu", generator=torch.Generator().manual_seed(seed)))

    cpu = build()
    x2 = torch.from_numpy(pose_targets(2, 0, check_hw)[0])
    data_bn_statistics(cpu, x2)
    card = copy.deepcopy(cpu).to(dev)
    got32 = float_logit_check(name, cpu, card, x2, depth="HRNet-W32",
                              expect={}, chaotic=True)
    with torch.inference_mode():
        want = cpu(x2)
    tol = 1e-3 * want.abs().max().item()
    share, differ = pose_decode_check(got32, want, tol)
    emit({"phase": "model_check", "model": name + "_decode", "batch": 2,
          "decided_share": share, "decided_differ": differ, "tol": tol})
    if differ:
        raise AssertionError(f"{name}: {differ} decided joints decode "
                             f"elsewhere on the card")
    x = torch.randn(serve_batch, *check_hw, 3, generator=gen).to(
        dev, torch.bfloat16)
    _, step = serve(card, x, {}, name, "bfloat16",
                    check=check_shape(check_hw[0] // 4, check_hw[1] // 4,
                                      17))
    if profile:
        phase_profile(name, card, x, step_s=step)
    del card, cpu, x
    empty_cache(dev)

    xg, yg = pose_targets(2, 1, check_hw)

    def pose_loss(task, o, t):
        return task.loss_fn(o, _to(o.device, t))

    train_check(name, build, xg, yg, pose_loss,
                ["backbone.backbone.conv1.conv.weight",
                 "backbone.backbone.layer1.0.conv1.conv.weight",
                 "backbone.final_layer.weight"])
    task = build(12).to(dev)
    trainer = Trainer(task, optimizer=optimizers.Adam(1e-3),
                      compute_dtype=torch.bfloat16, device=dev,
                      ema_decay=0.999)
    batches = [trainer._put_batch(pose_targets(train_batch, s, check_hw))
               for s in (2, 3)]
    falling_loss(trainer, batches[0], name)
    _, step = timed_train(trainer, batches, {}, name, train_batch)
    if profile:
        phase_train_profile(name, trainer, batches[0], step)
    return trainer, batches


def leg_checkpoint(trainer, batches, dev="cuda", steps=5):
    """A full train-state checkpoint on the pose trainer's network: a
    ``Trainer`` trains ``steps`` steps and saves; a fresh ``Trainer`` on
    another initialisation (another seed) restores, and the round trip is
    bitwise for params, buffers, optimizer state (with its shared count),
    step, EMA and the generators' states, each on its device and in its
    dtype.  The first runs ``steps`` more steps, then the resumed one the
    same steps on the same batches: its losses are the uninterrupted
    run's within 1e-3 relative (cuDNN's default convolution backward
    algorithms are not deterministic, so two runs of one step may differ
    in the last bits; the phase reports whether they came out bitwise)."""
    import os
    import tempfile

    from tlxcv_tpu_torch.train import Trainer, optimizers

    def fresh(seed, perturb):
        net = copy.deepcopy(trainer.network)
        if perturb:  # another initialisation: restore must overwrite it
            g = torch.Generator().manual_seed(seed)
            with torch.no_grad():
                for p in net.parameters():
                    p.add_(0.01 * torch.randn(p.shape, generator=g)
                           .to(p.device))
        return Trainer(net, optimizer=optimizers.Adam(1e-3),
                       compute_dtype=torch.bfloat16, device=dev,
                       ema_decay=0.999, seed=seed)

    first = fresh(21, False)
    for i in range(steps):
        first._train_step(*batches[i % len(batches)])
        first.step += 1

    def state(t):
        return {"params": t.params, "buffers": t._buffers(),
                "optimizer": t._opt_state(), "ema": t.ema_params,
                "loop": t._loop_state()}

    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "pose_state.npz")
        t0 = time.perf_counter()
        first.save_checkpoint(path)
        save_s = time.perf_counter() - t0
        size = os.path.getsize(path)
        snapshot = {k: {n: v.detach().clone() for n, v in tree.items()}
                    for k, tree in state(first).items()}
        want = [first._train_step(*batches[i % len(batches)])[0].item()
                for i in range(steps, 2 * steps)]
        resumed = fresh(22, True)
        t0 = time.perf_counter()
        resumed.restore_checkpoint(path)
        restore_s = time.perf_counter() - t0
    equal = {k: all(torch.equal(snapshot[k][n], v) and
                    snapshot[k][n].device == v.device for n, v in
                    tree.items())
             for k, tree in state(resumed).items()}
    equal["step"] = resumed.step == steps
    got = [resumed._train_step(*batches[i % len(batches)])[0].item()
           for i in range(steps, 2 * steps)]
    rel = max(abs(g - w) / abs(w) for g, w in zip(got, want))
    check = {"phase": "checkpoint", "model": "pose_hrnet_w32",
             "saved_after_steps": steps, "bytes": size, "save_s": save_s,
             "restore_s": restore_s, "round_trip_bitwise": equal,
             "losses_uninterrupted": want, "losses_resumed": got,
             "max_rel_loss_diff": rel, "bound": 1e-3,
             "losses_bitwise": got == want}
    emit(check)
    if not all(equal.values()) or not rel <= 1e-3:
        raise AssertionError(f"checkpoint resume: {check}")


def leg_pfld(profile, dev="cuda", serve_batch=256, train_batch=256):
    """PFLD (``create_model("pfld")``, 68 landmarks, 112^2), random weights
    from a seed, BatchNorm statistics from the checked images: landmarks
    at b4 in f32 and bf16 against f32 on the CPU, no kernel of ours;
    served at b256 bf16 (``predict``: the landmarks); gradients with the
    auxiliary net in the loss at b4 against the CPU, the loss falling on
    one batch, ``Trainer.train`` at b256 on seeded landmarks, Euler angles
    and attributes."""
    from tlxcv_tpu_torch import create_model
    from tlxcv_tpu_torch.tasks import FacialLandmarkDetection
    from tlxcv_tpu_torch.train import Trainer, optimizers

    name = "pfld"

    def build(seed=13):
        return FacialLandmarkDetection(create_model(
            name, device="cpu", generator=torch.Generator().manual_seed(seed)))

    cpu = build()
    x4 = torch.from_numpy(pfld_targets(4, 0)[0])
    data_bn_statistics(cpu, x4)
    card = Predict(copy.deepcopy(cpu).to(dev))
    float_logit_check(name, Predict(cpu), card, x4, depth="PFLD", expect={},
                      chaotic=True)
    x = torch.from_numpy(pfld_targets(serve_batch, 1)[0]).to(
        dev, torch.bfloat16)
    _, step = serve(card.task, x, {}, name, "bfloat16",
                    check=check_shape(136))
    if profile:
        phase_profile(name, card.task, x, step_s=step)
    del card, cpu, x
    empty_cache(dev)

    xg, yg = pfld_targets(4, 2)

    def pfld_loss(task, o, t):
        return task.loss_fn(o, _to(o[0].device, t))

    train_check(name, build, xg, yg, pfld_loss,
                ["backbone.backbone.conv1.weight",
                 "backbone.backbone.fc.weight",
                 "backbone.auxiliarynet.fc2.weight"])
    trainer = Trainer(build(14).to(dev), optimizer=optimizers.Adam(1e-3),
                      compute_dtype=torch.bfloat16, device=dev)
    batches = [trainer._put_batch(pfld_targets(train_batch, s))
               for s in (3, 4)]
    falling_loss(trainer, batches[0], name)
    _, step = timed_train(trainer, batches, {}, name, train_batch)
    if profile:
        phase_train_profile(name, trainer, batches[0], step)
    del trainer, batches
    empty_cache(dev)


def leg_yolov3_train(profile, dev="cuda", train_batch=32, size=416,
                     check_size=256):
    """YOLOv3 training (DarkNet-53, 80 classes, 416^2): the per-level
    targets built on the card bitwise the CPU's, at ``gt_iou_thresh`` 1
    and 0.5, on a ``ShapesDetection`` batch (GT padded to 50 a image);
    gradients at b2 256^2 against the CPU (``train_check``); the loss
    falling over 20 steps on one batch; ``Trainer.train`` at b32 416^2,
    bf16 over f32 masters, no kernel of ours."""
    from tlxcv_tpu_torch import create_model
    from tlxcv_tpu_torch.models.detection.yolov3 import (DEFAULT_ANCHORS,
                                                         DEFAULT_MASKS,
                                                         DOWNSAMPLES,
                                                         gt2yolo_targets)
    from tlxcv_tpu_torch.tasks import ObjectDetection
    from tlxcv_tpu_torch.train import Trainer, optimizers

    name = "yolov3"
    _, t = yolo_targets(train_batch, 0, size)
    boxes = torch.from_numpy(t["boxes"])
    cls = torch.from_numpy(t["class_labels"])
    score = (boxes[..., 2] > 0).float()
    same = {}
    for thresh in (1.0, 0.5):
        args = (DEFAULT_ANCHORS, DEFAULT_MASKS, DOWNSAMPLES, (size, size),
                80)
        want = gt2yolo_targets(boxes, cls, score, *args, iou_thresh=thresh)
        got = gt2yolo_targets(boxes.to(dev), cls.to(dev), score.to(dev),
                              *args, iou_thresh=thresh)
        same[str(thresh)] = {
            "bitwise": all(torch.equal(g.cpu(), w)
                           for g, w in zip(got, want)),
            "positives": [int((w[..., 5] > 0).sum()) for w in want]}
    emit({"phase": "model_check", "model": "yolov3_targets",
          "batch": train_batch, "gt_slots": int(boxes.shape[1]),
          "valid_gt": int(score.sum()), "iou_thresh": same})
    if not all(v["bitwise"] for v in same.values()):
        raise AssertionError(f"YOLOv3 targets differ on the card: {same}")

    def build(seed=15):
        return ObjectDetection(create_model(
            name, device="cpu", num_classes=80,
            generator=torch.Generator().manual_seed(seed)))

    xg, yg = yolo_targets(2, 1, check_size)

    def yolo_loss(task, o, t):
        return task.loss_fn(o, _to(o["head_outs"][0].device, t))

    train_check(name, build, xg, yg, yolo_loss,
                ["backbone.backbone.conv0.conv.weight",
                 "backbone.neck.yolo_blocks.1.tip.conv.weight",
                 "backbone.yolo_head.yolo_outputs.2.weight"])
    trainer = Trainer(build(16).to(dev), optimizer=optimizers.Adam(1e-4),
                      compute_dtype=torch.bfloat16, device=dev)
    batches = [trainer._put_batch(yolo_targets(train_batch, s, size))
               for s in (0, 2)]
    falling_loss(trainer, batches[0], name)
    _, step = timed_train(trainer, batches, {}, name + "_train",
                          train_batch)
    if profile:
        phase_train_profile(name, trainer, batches[0], step)
    del trainer, batches
    empty_cache(dev)


def bf16_fake_quant_codes(w):
    """The int8 codes inside ``nn.layers._fake_quant_w`` of the bf16 cast
    of the master ``w``: what a training step under the bf16 compute
    policy fake-quantizes the weight to."""
    f = w.detach().to(torch.bfloat16).float()
    s = torch.clamp_min(f.abs().amax(dim=tuple(range(1, f.ndim)),
                                     keepdim=True) / 127.0, 1e-12)
    return torch.round(f / s).clamp(-127, 127)


def _rms_t(a, b):
    return (a.double() - b.double()).pow(2).mean().sqrt().item()


def leg_resnet50_qat(int8_record, profile, dev="cuda", train_batch=64,
                     serve_batch=256, calib_batch=8, check_batch=2):
    """ResNet-50 quantization-aware training, served in int8: random
    weights from a seed, BatchNorm statistics from seeded images;
    ``enable_qat`` (54 layers), ``calibrate_activations`` on 2 seeded
    batches (54), a QAT fine-tune at b64 (bf16 over f32 masters, Adam,
    ``TRAIN_STEPS`` steps after 3, no kernel of ours: the fake quant is
    float), then
    ``qat_serving_convert`` (54) and the full int8 model served at b256
    with exactly 54 ``int8_matmul`` launches a forward (one a layer).

    Checks: each int8 layer on the card, given the CPU's input to it,
    returns the CPU's output bitwise, and the float QAT layer's within
    1e-5 of its largest value (f32 sums of the same products).  End to
    end the QAT forward and the int8 chain drift apart: BatchNorm stays
    float between the 54 unfolded int8 layers, so a product summed in
    another order moves an activation across a rounding boundary of the
    next layer's input quantization now and then, and the chain amplifies
    it (on the CPU at b2: 1.8e-6 of the largest value layer by layer,
    0.44 times the QAT forward's own quantization error end to end, 7% of
    the logits within 4 fc steps).  So the int8 logits are held within
    the QAT model's quantization error (its rms distance to the same
    weights without fake quant) of the QAT forward, and the share within
    the int8 ResNet-50 leg's 4 steps is reported.  The share of served
    int8 weight codes equal to the codes the last training step's bf16
    fake quant used is reported."""
    import numpy as np

    from tlxcv_tpu_torch import create_model
    from tlxcv_tpu_torch.nn import Conv2d, Linear
    from tlxcv_tpu_torch.ops.cuda.matmul import int8_matmul
    from tlxcv_tpu_torch.ops.quant import (calibrate_activations,
                                           enable_qat, qat_serving_convert)
    from tlxcv_tpu_torch.tasks import ImageClassification
    from tlxcv_tpu_torch.train import Trainer, optimizers

    name = "resnet50_qat"
    gen = torch.Generator().manual_seed(17)
    task = ImageClassification(create_model("resnet50", device=dev,
                                            generator=gen))
    data_bn_statistics(task, torch.randn(8, 224, 224, 3, generator=gen)
                       .to(dev))
    flagged = enable_qat(task)
    calib = [torch.randn(calib_batch, 224, 224, 3, generator=gen)
             for _ in range(2)]
    calibrated = calibrate_activations(task, calib)
    trainer = Trainer(task, optimizer=optimizers.Adam(1e-4),
                      compute_dtype=torch.bfloat16, device=dev)
    rng = np.random.default_rng(17)
    batches = [trainer._put_batch((
        rng.normal(size=(train_batch, 224, 224, 3)).astype(np.float32),
        rng.integers(0, 1000, train_batch))) for _ in range(2)]
    _, step = timed_train(trainer, batches, {}, name, train_batch)
    if profile:
        phase_train_profile(name, trainer, batches[0], step)
    # one more step, the last: the codes its bf16 fake quant used
    layers = {n: m for n, m in task.named_modules()
              if isinstance(m, (Conv2d, Linear))}
    seen = {n: bf16_fake_quant_codes(trainer.params[n + ".weight"])
            for n in layers}
    trainer._train_step(*batches[0])
    trainer._sync_to_network()
    del trainer, batches
    empty_cache(dev)

    x = torch.randn(check_batch, 224, 224, 3, generator=gen)
    task.eval()
    with torch.inference_mode():
        qat = task(x.to(dev)).float().cpu()
        saved = {n: m._qat for n, m in layers.items()}
        for m in layers.values():
            m._qat = False
        plain = task(x.to(dev)).float().cpu()
        for n, m in layers.items():
            m._qat = saved[n]
    qat_layers = {n: copy.deepcopy(m) for n, m in layers.items()}
    converted = qat_serving_convert(task)
    codes_equal = codes_total = 0
    for n, m in layers.items():
        served = m._unpacked() if isinstance(m, Conv2d) else \
            m.weight[:, :m.in_features]
        codes_equal += int((seen[n] == served.float()).sum())
        codes_total += served.numel()

    cpu8 = copy.deepcopy(task).cpu()
    recorded = []
    handles = [m.register_forward_hook(
        lambda mod, args, out: recorded.append((mod, args[0], out)))
        for m in cpu8.modules() if isinstance(m, (Conv2d, Linear))]
    try:
        with torch.inference_mode():
            want8 = cpu8(x)
    finally:
        for h in handles:
            h.remove()
    names = {id(m): n for n, m in cpu8.named_modules()}
    card_mods = dict(task.named_modules())
    n_layers, bitwise, worst_qat = len(recorded), 0, 0.0
    with torch.inference_mode():
        for mod, xin, yout in recorded:
            n = names[id(mod)]
            got = card_mods[n](xin.to(dev)).cpu()
            if torch.equal(got, yout):
                bitwise += 1
            ref = qat_layers[n].to(dev)(xin.to(dev)).float().cpu()
            worst_qat = max(worst_qat, ((got.float() - ref).abs().max()
                                        / ref.abs().max()).item())
        reset_launches()
        got8 = task(x.to(dev)).float().cpu()
        per_forward = int8_matmul.launches
    del recorded, qat_layers
    fc = cpu8.backbone.fc
    fc_step = float(fc.a_scale * 127 * fc.w_scale.max())
    sigma = _rms_t(qat, plain)
    diff = (got8 - qat).abs()
    check = {"flagged": flagged, "calibrated": calibrated,
             "converted": converted, "layers": n_layers,
             "layers_bitwise_vs_cpu": bitwise,
             "worst_layer_rel_vs_qat_float": worst_qat,
             "rms_int8_vs_qat_forward": _rms_t(got8, qat),
             "rms_qat_vs_float": sigma,
             "rms_card_vs_cpu_int8": _rms_t(got8, want8),
             "max_abs_err_vs_qat": diff.max().item(), "fc_step": fc_step,
             "share_within_4_steps": (diff <= 4 * fc_step).float().mean()
             .item(), "served_codes_equal_last_step_share":
             codes_equal / codes_total,
             "launches_per_forward": per_forward}
    emit({"phase": "model_check", "model": name, "batch": check_batch,
          **check})
    if (flagged, calibrated, converted) != (54, 54, 54) or \
            n_layers != 54 or bitwise != 54 or per_forward != 54 or not worst_qat <= 1e-5 \
            or not check["rms_int8_vs_qat_forward"] <= sigma \
            or not check["rms_card_vs_cpu_int8"] <= math.sqrt(2) * sigma \
            or not bool(torch.isfinite(got8).all()):
        raise AssertionError(f"QAT-served ResNet-50: {check}")
    del cpu8
    x = torch.randn(serve_batch, 224, 224, 3, generator=gen).to(
        dev, torch.bfloat16)
    counts, step = serve(task, x, {"int8_matmul": 54}, name,
                         "int8 (bf16 input)")
    if profile:
        phase_profile(name, task, x, step_s=step)
    int8_record["qat_launches"] = counts["int8_matmul"]
    times = int8_forward_times(task, x, name="int8_matmul_per_qat_forward")
    int8_record.update({"qat_ms": times["fused_ms"],
                        "qat_bound_ms": times["fused_bound_ms"],
                        "qat_library_ms": times["fused_library_ms"]})
    del task, x
    empty_cache(dev)


# ----------------------------- training through attention; the detectors'
# losses
def detr_targets(batch, seed, hw):
    """``ShapesDetection`` images (square, the canvas's height) in the
    top-left corner of a zero ``hw`` canvas, ground truth padded to 10 a
    image: boxes in the normalised cxcywh of the canvas, labels and the
    mask, as ``DetrLoss`` takes them."""
    import numpy as np

    from tlxcv_tpu_torch.data import ShapesDetection, pad_targets

    h, w = hw
    ds = ShapesDetection(num=batch, size=h, max_objects=6, seed=seed)
    x, t = pad_targets(10)([ds[i] for i in range(batch)])
    canvas = np.zeros((batch, h, w, 3), np.float32)
    canvas[:, :, :h] = x
    b = t["boxes"]
    boxes = np.stack([(b[..., 0] + b[..., 2]) / 2 / w,
                      (b[..., 1] + b[..., 3]) / 2 / h,
                      (b[..., 2] - b[..., 0]) / w,
                      (b[..., 3] - b[..., 1]) / h], -1)
    mask = t["mask"].astype(np.float32)
    return canvas, {"boxes": (boxes * mask[..., None]).astype(np.float32),
                    "class_labels": t["class_labels"], "mask": mask}


def shapes_targets(batch, seed, size, normalise):
    """``ShapesDetection`` at ``size``, ground truth padded to 10 a image:
    xyxy boxes in pixels (PP-YOLOE) or over the image's size (SSD), labels
    and the mask."""
    from tlxcv_tpu_torch.data import ShapesDetection, pad_targets

    ds = ShapesDetection(num=batch, size=size, max_objects=6, seed=seed)
    x, t = pad_targets(10)([ds[i] for i in range(batch)])
    if normalise:
        t["boxes"] = t["boxes"] / size
    t["mask"] = t["mask"].astype("float32")
    return x, t


def from_data_statistics(build, x):
    """``build`` with BatchNorm (and frozen BatchNorm) statistics taken
    once from ``x`` (``data_bn_statistics``), as a maker of identical
    models for ``train_check``."""
    state = build()
    data_bn_statistics(state, torch.from_numpy(x))
    state = state.state_dict()

    def built():
        model = build()
        model.load_state_dict(state)
        return model
    return built


def attention_train(name, trainer, batches, per_step, batch, profile):
    """The loss falling on one fixed batch, then ``Trainer.train`` timed
    with the launch counts checked (``timed_train``); the profile of a
    step with ``profile``."""
    falling_loss(trainer, batches[0], name)
    counts, step = timed_train(trainer, batches, per_step, name + "_train",
                               batch)
    if profile:
        phase_train_profile(name, trainer, batches[0], step)
    return counts, step


def leg_vit_train(record, profile, dev="cuda", train_batch=64):
    """ViT-B/16 training (``create_model("vit_base_patch16_224")``, random
    weights from a seed): gradients at b2 against the CPU
    (``train_check``; the card's attention forward and backward are the
    kernels, in f32 and bf16), the loss falling on one batch, then
    ``Trainer.train`` at b64 224^2, bf16 over f32 masters, Adam: 12 flash
    forward and 12 backward launches a step."""
    from tlxcv_tpu_torch import create_model
    from tlxcv_tpu_torch.tasks import ImageClassification
    from tlxcv_tpu_torch.train import Trainer, optimizers

    name = "vit_base_patch16_224"

    def build(seed=31):
        return ImageClassification(create_model(
            name, device="cpu", generator=torch.Generator().manual_seed(seed)))

    gen = torch.Generator().manual_seed(32)
    xg = torch.randn(2, 224, 224, 3, generator=gen).numpy()
    yg = torch.randint(0, 1000, (2,), generator=gen).numpy()

    def ce(task, o, t):
        return task.loss_fn(o, torch.as_tensor(t, device=o.device))

    train_check(name, build, xg, yg, ce,
                ["backbone.patch_embed.proj.weight",
                 "backbone.blocks.0.attn.qkv.weight",
                 "backbone.blocks.11.attn.proj.weight",
                 "backbone.head.weight"])
    trainer = Trainer(build(33).to(dev), optimizer=optimizers.Adam(1e-4),
                      compute_dtype=torch.bfloat16, device=dev)
    batches = [(torch.randn(train_batch, 224, 224, 3, generator=gen).to(dev),
                torch.randint(0, 1000, (train_batch,), generator=gen).to(dev))
               for _ in range(2)]
    counts, _ = attention_train(name, trainer, batches,
                                {"flash_attention": 12,
                                 "flash_attention_backward": 12},
                                train_batch, profile)
    record["launches"] = counts["flash_attention_backward"]
    del trainer, batches
    empty_cache(dev)


def leg_detr_train(record, profile, dev="cuda", check_hw=(256, 384)):
    """DETR-R50 training (``create_model("detr")``: 91 classes, 100
    queries, width 256 over 8 heads, 6 + 6 layers, frozen BatchNorms, aux
    loss, the callback matcher), random weights from a seed, the frozen
    statistics from the checked images: gradients at b2 on a 256 x 384
    canvas (8 x 12 = 96 encoder tokens) against the CPU, with dropout 0
    there (the card's and the CPU's dropout draws differ); the loss
    falling on one batch and ``Trainer.train`` at b4 (DETR's published
    batch per GPU) on ``ShapesDetection`` images padded into the served
    800 x 1344 canvas (1050 encoder tokens), dropout 0.1, bf16 over f32
    masters, Adam(1e-4): 18 flash forward and 18 backward launches a step,
    and the Hungarian match's host round trip timed per step."""
    from tlxcv_tpu_torch import create_model
    from tlxcv_tpu_torch.ops.hungarian import hungarian_callback
    from tlxcv_tpu_torch.tasks import ObjectDetection
    from tlxcv_tpu_torch.train import Trainer, optimizers

    name = "detr_resnet50"

    def build(seed=41, dropout=0.0):
        return ObjectDetection(create_model(
            "detr", device="cpu", dropout=dropout, matcher="callback",
            generator=torch.Generator().manual_seed(seed)))

    xg, yg = detr_targets(2, 1, check_hw)

    def detr_loss(task, o, t):
        return task.loss_fn(o, _to(o[0]["logits"].device, t))

    train_check(name, from_data_statistics(build, xg), xg, yg, detr_loss,
                ["backbone.backbone.conv1.weight",
                 "backbone.input_proj.weight",
                 "backbone.encoder.0.attn.q.weight",
                 "backbone.decoder.5.cross_attn.k.weight",
                 "backbone.class_head.weight"])
    x, y = detr_targets(2 * DETR_TRAIN_BATCH, 2, DETR_HW)
    task = build(42, dropout=0.1)
    data_bn_statistics(task, torch.from_numpy(x[:2]))
    trainer = Trainer(task.to(dev), optimizer=optimizers.Adam(1e-4),
                      compute_dtype=torch.bfloat16, device=dev)
    n = DETR_TRAIN_BATCH
    batches = [trainer._put_batch((x[i:i + n], {k: v[i:i + n]
                                                for k, v in y.items()}))
               for i in (0, n)]
    host0 = hungarian_callback.host_seconds
    counts, step = attention_train(name, trainer, batches,
                                   {"flash_attention": 18,
                                    "flash_attention_backward": 18},
                                   n, profile)
    # falling_loss, then timed_train's warm-up and timed steps
    steps = 20 + 3 + TRAIN_STEPS
    emit({"phase": "train", "model": name + "_hungarian",
          "host_ms_per_step": 1e3 * (hungarian_callback.host_seconds
                                     - host0) / steps,
          "step_ms": 1e3 * step, "matches_per_step": 6 * n})
    record["detr_launches"] = counts["flash_attention_backward"]
    del trainer, batches, task
    empty_cache(dev)


def leg_ppyoloe_train(profile, dev="cuda", train_batch=16, size=640,
                      check_size=256):
    """PP-YOLOE-L training (``create_model("ppyoloe_l")``, 80 classes),
    random weights from a seed, BatchNorm in train mode everywhere:
    gradients at b2 256^2 against the CPU with the prediction convs drawn
    from N(0, 0.02^2) (at init they are zero and pass no gradient back);
    the loss falling on one batch, then ``Trainer.train`` at b16 640^2 on
    ``ShapesDetection`` with the ATSS assigner (before
    ``static_assigner_epoch``) and again with the task-aligned one (the
    switch moved to epoch 0), no kernel of ours."""
    from tlxcv_tpu_torch import create_model
    from tlxcv_tpu_torch.tasks import ObjectDetection
    from tlxcv_tpu_torch.train import Trainer, optimizers

    name = "ppyoloe_l"

    def build(seed=51, heads=True):
        model = create_model(name, device="cpu",
                             generator=torch.Generator().manual_seed(seed))
        if heads:
            redraw([*model.yolo_head.pred_cls, *model.yolo_head.pred_reg],
                   0.02, torch.Generator().manual_seed(seed + 1))
        return ObjectDetection(model)

    xg, yg = shapes_targets(2, 3, check_size, normalise=False)

    def loss(task, o, t):
        return task.loss_fn(o, _to(o["head_outs"][0].device, t))

    train_check(name, build, xg, yg, loss,
                ["backbone.backbone.stem.layers.0.conv.weight",
                 "backbone.neck.fpn_stages.0.layers.0.convs.0.conv1.conv"
                 ".weight",
                 "backbone.yolo_head.stem_cls.2.conv.conv.weight",
                 "backbone.yolo_head.pred_reg.2.weight"],
                bf16_cpu_loss=True)
    task = build(53, heads=False)
    trainer = Trainer(task.to(dev), optimizer=optimizers.Adam(1e-4),
                      compute_dtype=torch.bfloat16, device=dev)
    batches = [trainer._put_batch(shapes_targets(train_batch, s, size,
                                                 normalise=False))
               for s in (4, 5)]
    head = task.backbone.yolo_head
    emit({"phase": "train", "model": name, "assigner": "atss",
          "static_assigner_epoch": head.static_assigner_epoch})
    attention_train(name, trainer, batches, {}, train_batch, profile)
    head.static_assigner_epoch = 0  # epoch 0 onward: task-aligned
    emit({"phase": "train", "model": name, "assigner": "task_aligned",
          "static_assigner_epoch": 0})
    timed_train(trainer, batches, {}, name + "_task_aligned_train",
                train_batch)
    del trainer, batches, task
    empty_cache(dev)


def leg_ssd_train(profile, dev="cuda", train_batch=32):
    """SSD-MobileNetV1 training (``create_model("ssd")``, 80 classes,
    300^2, 1917 priors), random weights from a seed: gradients at b2
    against the CPU, the loss falling on one batch, ``Trainer.train`` at
    b32 on ``ShapesDetection`` (prior matching, hard-negative mining by a
    stable sort), no kernel of ours."""
    from tlxcv_tpu_torch import create_model
    from tlxcv_tpu_torch.tasks import ObjectDetection
    from tlxcv_tpu_torch.train import Trainer, optimizers

    name = "ssd"

    def build(seed=61):
        return ObjectDetection(create_model(
            name, device="cpu", image_size=(300, 300),
            generator=torch.Generator().manual_seed(seed)))

    xg, yg = shapes_targets(2, 6, 300, normalise=True)

    def loss(task, o, t):
        return task.loss_fn(o, _to(o["scores"].device, t))

    train_check(name, build, xg, yg, loss,
                ["backbone.backbone.net.stem.conv.weight",
                 "backbone.backbone.net.blocks.10.pw.conv.weight",
                 "backbone.ssd_head.score_convs.0.weight",
                 "backbone.ssd_head.box_convs.0.weight"],
                bf16_cpu_loss=True)
    trainer = Trainer(build(62).to(dev), optimizer=optimizers.Adam(1e-3),
                      compute_dtype=torch.bfloat16, device=dev)
    batches = [trainer._put_batch(shapes_targets(train_batch, s, 300,
                                                 normalise=True))
               for s in (7, 8)]
    attention_train(name, trainer, batches, {}, train_batch, profile)
    del trainer, batches
    empty_cache(dev)


def attention_training_legs(bwd_record, profile):
    """The training legs of this slice, in order: ViT-B/16 and DETR-R50
    (the flash forward and backward kernels), PP-YOLOE-L and SSD."""
    leg_vit_train(bwd_record, profile)
    leg_detr_train(bwd_record, profile)
    leg_ppyoloe_train(profile)
    leg_ssd_train(profile)


def empty_cache(dev):
    if torch.device(dev).type == "cuda":
        torch.cuda.empty_cache()


def training_legs(int8_record, profile):
    """The training legs, in order: pose (with the checkpoint on its
    trainer), PFLD, YOLOv3 training, the QAT-served ResNet-50."""
    trainer, batches = leg_pose(profile)
    leg_checkpoint(trainer, batches)
    del trainer, batches
    torch.cuda.empty_cache()
    leg_pfld(profile)
    leg_yolov3_train(profile)
    leg_resnet50_qat(int8_record, profile)


def phase_train_profile(name, trainer, batch, step_s, steps=2):
    """Device time per kernel over a few training steps (torch.profiler),
    and with the timed step's wall time, the share the card idles."""
    from torch.profiler import ProfilerActivity, profile

    trainer._train_step(*batch)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(steps):
            trainer._train_step(*batch)
        torch.cuda.synchronize()
    emit_profile(prof, name + "_train", steps, step_s)


def phase_profile(name, model, x, forwards=3, step_s=None, call=None):
    """Device time per kernel over a few forwards (torch.profiler), for
    the breakdown of the step; with the served step's wall time, the share
    of it the card spends idle.  ``call`` (default ``model.predict``) is
    what is profiled."""
    from torch.profiler import ProfilerActivity, profile

    call = model.predict if call is None else call
    with torch.inference_mode():
        call(x)
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(forwards):
                call(x)
            torch.cuda.synchronize()
    emit_profile(prof, name, forwards, step_s)


def emit_profile(prof, name, calls, step_s):
    """Device time per call and its top kernels; with the timed step's
    wall time, the share of it the card spends idle; and the host ops
    that take the most host time of their own (``host_top``), which say
    what a host-bound step waits on."""
    # a user annotation (``Optimizer.step#...``) on the device timeline
    # spans the kernels inside it: leave it out of the kernels' sum
    annotations = {e.name for e in prof.events()
                   if getattr(e, "is_user_annotation", False)}
    kernels = [e for e in prof.key_averages()
               if e.device_type == torch.autograd.DeviceType.CUDA
               and e.key not in annotations]
    total = sum(e.self_device_time_total for e in kernels)  # microseconds
    top = sorted(kernels, key=lambda e: -e.self_device_time_total)[:30]
    device_ms = total / calls / 1e3
    idle = None if step_s is None else 1 - device_ms / (1e3 * step_s)
    emit({"phase": "profile", "model": name, "calls": calls,
          "device_ms_per_call": device_ms,
          "step_ms": None if step_s is None else 1e3 * step_s,
          "idle_share": idle,
          "top": [[e.key[:120], e.count // calls,
                   e.self_device_time_total / calls / 1e3,
                   e.self_device_time_total / total if total else None]
                  for e in top],
          "host_top": [[e.key[:80], e.count // calls,
                        e.self_cpu_time_total / calls / 1e3]
                       for e in sorted(
                           (e for e in prof.key_averages()
                            if e.device_type == torch.autograd.DeviceType.CPU
                            and e.key not in annotations),
                           key=lambda e: -e.self_cpu_time_total)[:8]]})


def vit_int8_and_grouped(int8, profile):
    """The ViT-B/16 int8 leg (profiled with ``profile``), then the grouped
    int8 conv; the card's memory freed after."""
    vit8, vit8_x, vit8_step = phase_vit_int8(int8)
    if profile:
        phase_profile("vit_base_patch16_224_int8", vit8, vit8_x,
                      step_s=vit8_step)
    del vit8, vit8_x
    torch.cuda.empty_cache()
    phase_grouped_int8(int8)
    torch.cuda.empty_cache()


def hrnet_seg_leg(profile):
    cards, x, steps = phase_hrnet_seg()
    if profile:
        for graph in ("s2d", "plain"):
            phase_profile(f"hrnet_seg_w18_{graph}", cards[graph], x,
                          step_s=steps[graph])
    del cards, x
    torch.cuda.empty_cache()


def transformer_legs(flash, profile):
    swin, x, step = phase_transformers(flash)
    if profile:
        phase_profile("swin_base", swin, x, step_s=step)
    del swin, x
    torch.cuda.empty_cache()


# ------------------------------------ the classification zoo, first half
# (registry name, served batch, our kernels' launches a forward): each at
# its published ImageNet setting, 224^2; the mobile nets at b256, as
# ResNet-50's cell.  TNT-S is the reference's, at depth 6: its inner and
# outer attention launch the flash kernel once each a block.
CLS_LEGS = [
    ("tnt_s", 64, {"flash_attention": 12}),
    ("pp_hgnet_small", 64, {}), ("pvt_v2_b2", 64, {}),
    ("pcpvt_small", 64, {}), ("alt_gvt_small", 64, {}),
    ("cswin_tiny", 64, {}), ("levit_256", 64, {}),
    ("convnext_tiny", 64, {}), ("van_b1", 64, {}), ("rednet50", 64, {}),
    ("se_resnext50_32x4d", 64, {}), ("resnest50", 64, {}),
    ("res2net50_26w_4s", 64, {}), ("regnetx_4gf", 64, {}),
    ("regnety_4gf", 64, {}), ("mobilenet_v2", 256, {}),
    ("mobilenet_v3_large", 256, {}), ("efficientnet_b0", 256, {}),
    ("ghostnet", 256, {}),
]
# legs (of ``CLS_LEGS`` and ``CLASSIC_LEGS``) whose bf16 logits are held
# to the CPU bf16 model's own rms error (``float_logit_check``'s
# ``chaotic``) rather than 3e-2 of their scale: random BatchNorm networks
# whose own CPU bf16 model misses that bound or comes near it (PP-HGNet,
# SE-ResNeXt, Res2Net, the RegNets, the mobile nets), LeViT with drawn
# statistics, and every classic CNN but AlexNet, VGG-16, SqueezeNet and
# PP-LCNetV2, whose card bf16 logits came within 0.9% of their scale (on
# the others they came 2.5% (Xception-41) to 33% (ReXNet) from it, and
# the CPU's own bf16 model as far)
CLS_CHAOTIC = {"pp_hgnet_small", "levit_256", "se_resnext50_32x4d",
               "res2net50_26w_4s", "regnetx_4gf", "regnety_4gf",
               "mobilenet_v2", "mobilenet_v3_large", "efficientnet_b0",
               "ghostnet", "googlenet", "densenet121", "shufflenet_v2_x1_0",
               "esnet_x1_0", "mixnet_s", "rexnet_1_0", "peleenet",
               "hardnet68", "dpn68", "dla34", "inception_v3", "xception41",
               "xception65_deeplab", "cspdarknet53"}
# BatchNorm statistics come from the model's own activations
# (``data_bn_statistics``), except where a BatchNorm normalises one vector
# an image (LeViT's head, ResNeSt's split attention): over a few images of
# noise its variance is tiny and the logits reach 1e3, so these legs'
# statistics are drawn (``random_bn_statistics``)
CLS_RANDOM_BN = {"levit_256", "resnest50"}
# Involution multiplies each pixel's neighbours by weights made from the
# pixel, so a random RedNet-50 squares, block after block, any deviation
# from the images its statistics came from (1e26 by block 11 on other
# images; bf16 rounding alone suffices): its bottlenecks' last BatchNorm
# scale starts at 0.1, as a zero-gamma start keeps residual branches
# small (then f32 and f64 agree to 1e-6 of the logits on the CPU)
CLS_RESIDUAL_BN_SCALE = {"rednet50": 0.1}
# TNT-S's attention at b64 224^2 as its blocks hand it over, views of the
# packed qkv projection (``flash_grid``'s form: name, B, H, Sq, Sk, D,
# layout, bias); the inner attention over each patch's 16 pixel tokens (24
# channels, 4 heads: D = 6, which the wrapper pads to 32), the outer over
# the 197 patch tokens
TNT_GRIDS = [("tnt_inner", 64 * 196, 4, 16, 16, 6, "packed", None),
             ("tnt_outer", 64, 6, 197, 197, 64, "packed", None)]
SE_RESNEXT_INT8_LAUNCHES = 582  # 37 convs, 16 x 32 groups, 33 linears


def draw_small_starts(model, gen):
    """The parameters that start at or near zero, drawn at O(1) from
    ``gen`` so that the paths they scale are checked and timed as a
    trained model runs them: the layer scales (ConvNeXt's ``gamma``, 1e-6;
    VAN's ``ls1`` and ``ls2``, 1e-2) around 1, LeViT's attention biases
    (zeros) and the BatchNorm scales it starts at zero, TNT's position
    embeddings and class token (std 0.02)."""
    from tlxcv_tpu_torch.nn import BatchNorm

    with torch.no_grad():
        for name, p in model.named_parameters():
            leaf = name.rpartition(".")[2]
            if leaf in ("gamma", "ls1", "ls2"):
                p.copy_(1 + 0.5 * torch.randn(p.shape, generator=gen))
            elif leaf == "attention_biases":
                p.copy_(torch.randn(p.shape, generator=gen))
            elif leaf in ("pixel_pos", "patch_pos", "cls_token"):
                p.copy_(0.5 * torch.randn(p.shape, generator=gen))
        for mod in model.modules():
            if (isinstance(mod, BatchNorm) and mod.weight is not None
                    and not mod.weight.any()):
                mod.weight.copy_(0.5 + torch.rand(mod.weight.shape,
                                                  generator=gen))


def cls_model(name, gen, size=224):
    """``create_model(name)`` on the CPU in a task, eval mode, with random
    weights from ``gen`` and its small starts drawn; BatchNorm statistics
    from one train-mode forward of 4 other images of side ``size``
    (``data_bn_statistics``) or, for ``CLS_RANDOM_BN``, drawn
    (``random_bn_statistics``); RedNet's residual branches damped
    (``CLS_RESIDUAL_BN_SCALE``)."""
    from tlxcv_tpu_torch import create_model
    from tlxcv_tpu_torch.models.classification.rednet import BottleneckRed
    from tlxcv_tpu_torch.nn import BatchNorm
    from tlxcv_tpu_torch.tasks import ImageClassification

    cpu = ImageClassification(create_model(name, device="cpu",
                                           generator=gen)).eval()
    draw_small_starts(cpu, gen)
    if name in CLS_RESIDUAL_BN_SCALE:
        with torch.no_grad():
            for mod in cpu.modules():
                if isinstance(mod, BottleneckRed):
                    mod.conv3[1].weight.fill_(CLS_RESIDUAL_BN_SCALE[name])
    if name in CLS_RANDOM_BN:
        random_bn_statistics(cpu, gen)
    elif any(isinstance(m, BatchNorm) for m in cpu.modules()):
        data_bn_statistics(cpu, torch.randn(4, size, size, 3, generator=gen))
    return cpu


def cls_leg(name, batch, expect, gen, profile, size=224):
    """One leg: f32 and bf16 logits at b2 ``size``^2 against f32 on the
    CPU (``float_logit_check``, the launches of one forward exactly
    ``expect``; bf16 held as a chaotic net's for ``CLS_CHAOTIC``), then
    ``predict`` served at ``batch`` in bf16.
    Returns the launch counts of the served run."""
    cpu = cls_model(name, gen, size)
    x2 = torch.randn(2, size, size, 3, generator=gen)
    card = copy.deepcopy(cpu).cuda()
    params = sum(p.numel() for p in cpu.parameters())
    float_logit_check(name, cpu, card, x2, depth=f"{params / 1e6:.1f}M "
                      f"parameters", expect=expect,
                      chaotic=name in CLS_CHAOTIC)
    del cpu
    x = torch.randn(batch, size, size, 3, generator=gen).to("cuda",
                                                            torch.bfloat16)
    counts, step = serve(card, x, expect, name, "bfloat16")
    if profile:
        phase_profile(name, card, x, step_s=step)
    del card, x
    torch.cuda.empty_cache()
    return counts


def int8_layer_check(name, cpu8, cpu32, x, expect):
    """The int8 model on the card against the same int8 model on the CPU,
    as ``yolo_int8_check`` holds YOLOv3's: each int8 Conv2d and Linear
    bitwise on the CPU's input (``int8_layers_bitwise``); the logits held
    to the int8 model's own error against its f32 model on the CPU, the
    card's within 1.25 times it of the f32 model and within sqrt(2) times
    it of the CPU's int8 model (the float BatchNorms between the int8
    layers round differently on the two devices, and a code moved by one
    moves the next layer's inputs).  The int8 GEMM launches of one
    forward must be exactly ``expect``."""
    from tlxcv_tpu_torch.nn import Conv2d, Linear
    from tlxcv_tpu_torch.ops.cuda.matmul import int8_matmul

    card8, want8, layers, cpu_s = int8_layers_bitwise(
        name, cpu8, lambda m: m(x), (Conv2d, Linear))
    with torch.inference_mode():
        want32 = cpu32(x)
        reset_launches()
        got8 = card8(x.cuda()).float().cpu()
        per_forward = int8_matmul.launches
    check = {"batch": x.shape[0], "cpu_s": cpu_s,
             "layers_bitwise_equal": layers,
             "rms_card_cpu": _rms(got8, want8),
             "rms_card_f32_cpu": _rms(got8, want32),
             "rms_int8_f32_cpu": _rms(want8, want32),
             "logit_scale": want32.abs().max().item(),
             "launches_per_forward": per_forward,
             "expected_launches": expect,
             "finite": bool(torch.isfinite(got8).all())}
    emit({"phase": "model_check", "model": name, **check})
    if (not check["finite"]
            or check["rms_card_f32_cpu"] > 1.25 * check["rms_int8_f32_cpu"]
            or check["rms_card_cpu"] > math.sqrt(2)
            * check["rms_int8_f32_cpu"] or per_forward != expect):
        raise AssertionError(f"int8 {name} disagrees with the CPU: {check}")
    return card8


def leg_se_resnext_int8(int8_record, gen, profile):
    """SE-ResNeXt-50 32x4d in full int8, quantized as the int8 YOLOv3 leg
    is (``quantize_weights``, then ``calibrate_activations`` on 4 images,
    on the CPU in f32; BatchNorm in float between the int8 layers).  Each
    int8 Conv2d and Linear launches the int8 GEMM once, each 32-group 3x3
    once a group (``nn.layers.Conv2d._grouped_int8``): the count is
    derived from the model and must be ``SE_RESNEXT_INT8_LAUNCHES``.
    Checked at b2 224^2 (``int8_layer_check``), served at b64 (bf16
    input), and the int8 GEMM timed at every shape its forward hands it
    (``int8_forward_times``), the grouped route's sum apart."""
    from tlxcv_tpu_torch.nn import Conv2d, Linear
    from tlxcv_tpu_torch.ops.quant import (calibrate_activations,
                                           quantize_weights)

    name = "se_resnext50_32x4d_int8"
    cpu32 = cls_model("se_resnext50_32x4d", gen)
    cpu8 = copy.deepcopy(cpu32)
    layers = (quantize_weights(cpu8.backbone),
              calibrate_activations(cpu8.backbone, [
                  torch.randn(4, 224, 224, 3, generator=gen)]))
    derived = sum(m.groups if isinstance(m, Conv2d) else 1
                  for m in cpu8.modules() if isinstance(m, (Conv2d, Linear))
                  and m.weight.dtype == torch.int8)
    if layers != (86, 86) or derived != SE_RESNEXT_INT8_LAUNCHES:
        raise AssertionError(f"{name}: {layers} layers quantized and "
                             f"calibrated, {derived} GEMMs a forward")
    card8 = int8_layer_check(name, cpu8, cpu32,
                             torch.randn(2, 224, 224, 3, generator=gen),
                             derived)
    del cpu8, cpu32
    x = torch.randn(64, 224, 224, 3, generator=gen).to("cuda",
                                                       torch.bfloat16)
    expect = {"int8_matmul": derived}
    counts, step = serve(card8, x, expect, name, "int8 (bf16 input)")
    if profile:
        phase_profile(name, card8, x, step_s=step)
    times = int8_forward_times(card8, x, name="int8_matmul_per_"
                               "se_resnext50_int8_forward")
    int8_record.update({
        "se_resnext_int8_launches": counts["int8_matmul"],
        "se_resnext_int8_ms": times["fused_ms"],
        "se_resnext_int8_bound_ms": times["fused_bound_ms"],
        "se_resnext_int8_grouped_ms": times["grouped"]["fused_ms"],
        "se_resnext_int8_grouped_bound_ms": times["grouped"]["fused_bound_ms"],
        "se_resnext_int8_grouped_calls": times["grouped"]["calls"]})
    del card8, x
    torch.cuda.empty_cache()


def phase_classification(flash_record, int8_record, profile):
    """The first half of the classification zoo (``CLS_LEGS``), each
    checked at b2 and served (``cls_leg``), flash attention at TNT-S's two
    grids (``flash_grid``) and SE-ResNeXt-50 in full int8
    (``leg_se_resnext_int8``); the phase's own seconds."""
    t0 = time.perf_counter()
    gen = torch.Generator().manual_seed(0)
    grids = {g[0]: flash_grid(g, 40 + i) for i, g in enumerate(TNT_GRIDS)}
    emit({"phase": "kernel_times", "flash_attention_tnt": grids})
    flash_record["tnt_grids"] = grids
    failed = {}
    for name, batch, expect in CLS_LEGS:
        try:  # every leg runs; a failure fails the phase at its end
            counts = cls_leg(name, batch, expect, gen, profile)
        except AssertionError as err:
            failed[name] = str(err)[:2000]
            torch.cuda.empty_cache()
            continue
        if name == "tnt_s":
            flash_record["tnt_launches"] = counts["flash_attention"]
    leg_se_resnext_int8(int8_record, gen, profile)
    emit({"phase": "classification", "legs": len(CLS_LEGS) + 1,
          "failed": failed, "seconds": time.perf_counter() - t0})
    if failed:
        raise AssertionError(f"classification legs failed: {list(failed)}")

# ------------------------------------ the classification zoo, second half
# (registry name, served batch, side): the classic CNNs, each at its
# published ImageNet size (Inception-v3 and the Xceptions 299, CSPDarkNet
# 256, the others 224), the light nets at b256 as the mobile nets of
# ``CLS_LEGS``;
# none launches a kernel of ours; the chaotic ones are in ``CLS_CHAOTIC``
CLASSIC_LEGS = [
    ("alexnet", 256, 224), ("vgg16", 64, 224), ("googlenet", 256, 224),
    ("squeezenet1_1", 256, 224), ("densenet121", 64, 224),
    ("shufflenet_v2_x1_0", 256, 224), ("esnet_x1_0", 256, 224),
    ("pp_lcnet_v2", 256, 224), ("mixnet_s", 256, 224),
    ("rexnet_1_0", 256, 224), ("peleenet", 256, 224),
    ("hardnet68", 64, 224), ("dpn68", 64, 224), ("dla34", 64, 224),
    ("inception_v3", 64, 299), ("xception41", 64, 299),
    ("xception65_deeplab", 64, 299), ("cspdarknet53", 64, 256),
]


def phase_classic(profile):
    """The classic CNNs (``CLASSIC_LEGS``), random weights from a seed and
    BatchNorm statistics from data (``cls_model``), each checked at b2
    against the CPU and served in bf16 (``cls_leg``), no launch of ours;
    the phase's own seconds."""
    t0 = time.perf_counter()
    gen = torch.Generator().manual_seed(1)
    failed = {}
    for name, batch, size in CLASSIC_LEGS:
        try:  # every leg runs; a failure fails the phase at its end
            cls_leg(name, batch, {}, gen, profile, size=size)
        except AssertionError as err:
            failed[name] = str(err)[:2000]
            torch.cuda.empty_cache()
    emit({"phase": "classic", "legs": len(CLASSIC_LEGS), "failed": failed,
          "seconds": time.perf_counter() - t0})
    if failed:
        raise AssertionError(f"classic legs failed: {list(failed)}")


# ---------------------------------------------------------- face models
# RetinaFace-R50 served at the reference's default input size, b16; its
# FPN's two nearest merges are the upsample-add kernel's launches, 2 a
# forward ([16, 20^2, 256] -> 40^2 and [16, 40^2, 256] -> 80^2 at 640^2).
# Checked at b1 600^2, where the C4 -> C3 merge is 38 -> 75, not 2x.
RETINAFACE_SERVE = (16, 640)
RETINAFACE_CHECK = 600
RETINAFACE_LAUNCHES = {"upsample_add_fused": 2}
FACE_SCORE_TH = 0.5   # ``detect_faces``' default
# The host's NMS loops once a kept face, so the post-process costs what
# the count of priors over ``FACE_SCORE_TH`` makes it cost, and a random
# net's scores say nothing of that count.  The class convs are drawn
# (``draw_face_scores``) for a trained net's count instead: WIDER FACE's
# faces an image (393,703 labelled faces in 32,203 images; Yang et al.,
# "WIDER FACE: A Face Detection Benchmark", CVPR 2016) times the priors
# that the port's ``Encoder`` labels positive for one face
# (``face_candidates``).  Their places stay random, so NMS keeps nearly
# all of them, where a trained net's cluster on faces and NMS keeps about
# one a face: the post-process is timed on random-net traffic.
WIDER_FACES_PER_IMAGE = 393_703 / 32_203
# ArcFace-R50 embeddings served at b256 128^2 (at the reference's default
# 112 its dense layer does not fit ResNet-50's 4 x 4 map: ROADMAP queue 3)
ARCFACE_SERVE = (256, 128)


class _Predict:
    """``serve`` and ``phase_profile`` call ``.predict``: a model's
    forward, or ArcFace's ``embed``, under that name."""

    def __init__(self, fn):
        self.predict = fn


def face_candidates(side, gen):
    """Priors over ``FACE_SCORE_TH`` in one ``side``^2 image of a trained
    RetinaFace, taken as ``WIDER_FACES_PER_IMAGE`` times the priors that
    ``Encoder`` labels positive for one square face: the mean over 8
    faces of each of ``prior_box``'s six anchor sizes, at places drawn
    from ``gen``.  Returns that mean and the count."""
    from tlxcv_tpu_torch.tasks.face_recognition import Encoder, prior_box

    encode = Encoder(prior_box((side, side)))
    positives = []
    for size in (16, 32, 64, 128, 256, 512):
        for _ in range(8):
            lt = (side - size) * torch.rand(2, generator=gen)
            label = torch.cat([torch.cat([lt, lt + size]) / side,
                               torch.zeros(11)])
            positives.append(int((encode(label[None].numpy())[:, 15] == 1)
                                 .sum()))
    per_face = statistics.mean(positives)
    return per_face, WIDER_FACES_PER_IMAGE * per_face


def draw_face_scores(model, x, share):
    """RetinaFace's three class convs rescaled from their outputs on ``x``
    (CPU, f32) so that, at each level, the face-minus-background logit of
    a prior has std 1 and a share ``share`` of the priors clears
    ``FACE_SCORE_TH`` (at init every score sits near 1/2 and NMS would
    take every prior).  Channel ``2 a + 1`` is anchor a's face logit."""
    outs = []
    hooks = [h.register_forward_hook(lambda m, a, y: outs.append(y))
             for h in model.classheads]
    with torch.no_grad():
        model(x)
        for h in hooks:
            h.remove()
        for head, y in zip(model.classheads, outs):
            diff = (y[..., 1] - y[..., 0]).double().flatten()
            a = 1.0 / diff.std().item()
            head.conv.weight.mul_(a)
            head.conv.bias.mul_(a)
            head.conv.bias[1::2] -= a * torch.quantile(diff,
                                                       1 - share).item()


def face_detections(bbox, cls, side, iou_th):
    """One forward's outputs through the port's post-process
    (``tasks.face_recognition.post_process``, as ``detect_faces`` runs it)
    on the host, the priors made once: per image the kept pixel boxes
    [K, 4] and scores."""
    from tlxcv_tpu_torch.tasks.face_recognition import (post_process,
                                                        prior_box)

    priors = prior_box((side, side))
    return [tuple(map(torch.from_numpy, post_process(
        b, c, priors, side, FACE_SCORE_TH, iou_th)))
        for b, c in zip(bbox.float().cpu().numpy(),
                        cls.float().cpu().numpy())]


def face_matched_share(want, got):
    """Share of ``want``'s faces that a face of ``got``'s, in the same
    image, overlaps with IoU >= 0.9."""
    hits = total = 0
    for (w, _), (g, _) in zip(want, got):
        total += len(w)
        if len(w) and len(g):
            hits += int((_box_iou(w, g) >= 0.9).any(1).sum())
    return hits / max(total, 1)


def retinaface_check(cpu, card, x1):
    """RetinaFace on the card against the CPU at b1 ``RETINAFACE_CHECK``
    px: f32 boxes, landmarks and scores within 1e-3 of each one's scale,
    bf16 held as a chaotic net's (to the CPU bf16 model's rms error); each
    forward exactly 2 upsample-add launches, each merge bitwise its plain
    version on the same inputs; the host's post-process of the card's f32
    outputs reproducing the CPU's faces: at least 90% of either side's
    faces overlap one of the other's with IoU >= 0.9.  ``card`` is left
    with bf16 parameters."""
    names = ("boxes", "landmarks", "scores")
    with torch.inference_mode():
        t0 = time.perf_counter()
        want = cpu(x1)
        cpu_s = time.perf_counter() - t0
        want16 = params_to(copy.deepcopy(cpu), torch.bfloat16)(
            x1.to(torch.bfloat16))
    check = {"batch": 1, "side": x1.shape[1], "cpu_s": cpu_s}
    ok = True
    for dtype in (torch.float32, torch.bfloat16):
        dname = str(dtype)[6:]
        if dtype == torch.bfloat16:
            params_to(card, dtype)
        with recorded_merges() as calls, torch.inference_mode():
            reset_launches()
            got = card(x1.to("cuda", dtype))
            torch.cuda.synchronize()
            per_forward = {k: v for k, v in launch_counts(f32=False).items() if v}
        merges = [[list(a.shape[1:3]), list(b.shape[1:3]), same]
                  for a, b, _, same in calls]
        got = [g.float().cpu() for g in got]
        row = {"launches_per_forward": per_forward, "merges": merges,
               "finite": all(bool(torch.isfinite(g).all()) for g in got)}
        ok &= (per_forward == RETINAFACE_LAUNCHES and len(merges) == 2
               and all(m[2] for m in merges) and row["finite"])
        for name, g, w, w16 in zip(names, got, want, want16):
            scale = w.abs().max().item()
            if dtype == torch.float32:
                err = (g - w).abs().max().item()
                row[name] = {"scale": scale, "max_abs_err": err,
                             "bound": 1e-3 * scale}
                ok &= err <= 1e-3 * scale
            else:
                w16 = w16.float()
                row[name] = {"scale": scale,
                             "max_abs_err": (g - w).abs().max().item(),
                             "rms_bf16_card_f32_cpu": _rms(g, w),
                             "rms_bf16_cpu_f32_cpu": _rms(w16, w),
                             "rms_bf16_card_bf16_cpu": _rms(g, w16)}
                ok &= (_rms(g, w) <= YOLO_BF16_RMS[0] * _rms(w16, w)
                       and _rms(g, w16) <= YOLO_BF16_RMS[1] * _rms(w16, w))
        if dtype == torch.float32:
            side = x1.shape[1]
            cpu_faces = face_detections(want[0], want[2], side, cpu.iou_th)
            card_faces = face_detections(got[0], got[2], side, cpu.iou_th)
            row["faces_cpu"] = [len(f) for f, _ in cpu_faces]
            row["faces_card"] = [len(f) for f, _ in card_faces]
            row["cpu_faces_matched_share"] = face_matched_share(
                cpu_faces, card_faces)
            row["card_faces_matched_share"] = face_matched_share(
                card_faces, cpu_faces)
            ok &= (min(row["faces_cpu"]) > 0
                   and row["cpu_faces_matched_share"] >= 0.9
                   and row["card_faces_matched_share"] >= 0.9)
        check[dname] = row
    emit({"phase": "model_check", "model": "retinaface", **check})
    if not ok:
        raise AssertionError(f"RetinaFace disagrees with the CPU: {check}")


def retinaface_merge_times(card, x, upsample_record):
    """The two merges of one served forward, captured (each bitwise its
    plain version) and timed alone (``merge_time_rows``), summed over the
    forward into the upsample-add's record."""
    with recorded_merges() as calls, torch.inference_mode():
        card(x)
        torch.cuda.synchronize()
    rows = merge_time_rows(calls)
    emit({"phase": "kernel_times", "upsample_add_fused_per_retinaface_"
          "forward": rows})
    if len(rows) != 2 or not all(r["bitwise"] for r in rows):
        raise AssertionError(f"RetinaFace's merges: {rows}")
    for key in ("ms", "plain_ms", "library_ms", "bound_ms"):
        upsample_record[f"retinaface_{key}"] = sum(r[key] for r in rows)


def leg_retinaface(upsample_record, gen, profile):
    """RetinaFace-R50 (``create_model("retinaface")``, random weights from
    ``gen``, BatchNorm statistics from 2 other images, the class convs
    drawn by ``draw_face_scores`` for ``face_candidates``' count): checked
    at b1 600^2 (``retinaface_check``), then its forward served at b16
    640^2 in bf16 with exactly 2 upsample-add launches a forward, the
    host's post-process of one served batch timed (the copy to the host,
    the priors once, ``post_process`` an image), and the two merges timed
    (``retinaface_merge_times``)."""
    from tlxcv_tpu_torch import create_model

    batch, served_side = RETINAFACE_SERVE
    priors = 2 * sum(math.ceil(served_side / s) ** 2 for s in (8, 16, 32))
    per_face, candidates = face_candidates(served_side, gen)
    side = RETINAFACE_CHECK
    cpu = create_model("retinaface", device="cpu", generator=gen).eval()
    data_bn_statistics(cpu, torch.randn(2, side, side, 3, generator=gen))
    x1 = torch.randn(1, side, side, 3, generator=gen)
    draw_face_scores(cpu, torch.randn(1, side, side, 3, generator=gen),
                     candidates / priors)
    card = copy.deepcopy(cpu).cuda()
    retinaface_check(cpu, card, x1)
    iou_th = cpu.iou_th
    del cpu
    side = served_side
    x = torch.randn(batch, side, side, 3, generator=gen).to("cuda",
                                                           torch.bfloat16)

    def outputs_check(out, n):
        shapes = [tuple(t.shape) for t in out]
        if shapes != [(n, priors, 4), (n, priors, 10), (n, priors, 2)] or \
                not all(bool(torch.isfinite(t).all()) for t in out):
            raise AssertionError(f"bad RetinaFace outputs {shapes}")

    served = _Predict(card)
    counts, step = serve(served, x, RETINAFACE_LAUNCHES, "retinaface",
                         "bfloat16", check=outputs_check)
    with torch.inference_mode():
        bbox, _, cls = card(x)
    t0 = time.perf_counter()
    faces = face_detections(bbox, cls, side, iou_th)
    host_s = time.perf_counter() - t0
    emit({"phase": "host_post_process", "model": "retinaface",
          "batch": batch, "decode_nms_ms": 1e3 * host_s,
          "wider_faces_per_image": WIDER_FACES_PER_IMAGE,
          "positives_per_face": per_face,
          "candidates_per_image_drawn": candidates,
          "candidates_per_image": (cls[..., 1] > FACE_SCORE_TH).sum(1)
          .tolist(),
          "faces_per_image": [len(f) for f, _ in faces]})
    if min(len(f) for f, _ in faces) == 0:
        raise AssertionError("RetinaFace served a batch with no face kept")
    if profile:
        phase_profile("retinaface", served, x, step_s=step)
    upsample_record["retinaface_launches"] = counts["upsample_add_fused"]
    retinaface_merge_times(card, x, upsample_record)
    del card, x
    torch.cuda.empty_cache()


class _ArcLogits(torch.nn.Module):
    """ArcFace's margin logits of fixed labels, as one module for
    ``float_logit_check``."""

    def __init__(self, model, labels):
        super().__init__()
        self.model = model
        self.labels = labels

    def forward(self, x):
        return self.model(x, self.labels.to(x.device))


def leg_arcface(gen, profile):
    """ArcFace-R50 (``create_model("arcface", input_size=128)``: 512-wide
    embeddings, 10,575 classes; random weights from ``gen``; BatchNorm
    statistics from one train-mode forward of 32 images, so that ``bn2``,
    which normalises one vector an image, sees 32 of them): the margin
    logits of b2 against the CPU (``float_logit_check``, no launch of
    ours), the loss in f32 within 1e-4 of the CPU's, then ``embed`` served
    at b256 128^2 in bf16, unit-norm rows."""
    from tlxcv_tpu_torch import create_model

    batch, side = ARCFACE_SERVE
    cpu = create_model("arcface", input_size=side, device="cpu",
                       generator=gen).eval()
    data_bn_statistics(cpu, torch.randn(32, side, side, 3, generator=gen))
    card = copy.deepcopy(cpu).cuda()
    x2 = torch.randn(2, side, side, 3, generator=gen)
    labels = torch.tensor([3, 10_000])
    with torch.inference_mode():
        want = cpu.loss_fn(cpu.embed(x2), labels).item()
        got = card.loss_fn(card.embed(x2.cuda()), labels.cuda()).item()
    emit({"phase": "model_check", "model": "arcface_loss", "cpu": want,
          "card_f32": got, "bound": 1e-4 * abs(want)})
    if not abs(got - want) <= 1e-4 * abs(want):
        raise AssertionError(f"ArcFace loss {got} on the card, {want} on "
                             f"the CPU")
    float_logit_check("arcface_margin_logits", _ArcLogits(cpu, labels),
                      _ArcLogits(card, labels), x2, depth="ResNet-50",
                      expect={}, chaotic=True)
    del cpu
    x = torch.randn(batch, side, side, 3, generator=gen).to("cuda",
                                                           torch.bfloat16)

    def embed_check(e, n):
        norms = e.float().norm(dim=1)
        if e.shape != (n, 512) or not bool(
                ((norms - 1).abs() <= 1e-2).all()):
            raise AssertionError(f"bad ArcFace embeddings {e.shape}")

    served = _Predict(card.embed)
    _, step = serve(served, x, {}, "arcface", "bfloat16", check=embed_check)
    if profile:
        phase_profile("arcface", served, x, step_s=step)
    del card, x
    torch.cuda.empty_cache()


def phase_faces(upsample_record, profile):
    """RetinaFace-R50 through the upsample-add kernel (``leg_retinaface``)
    and ArcFace-R50 (``leg_arcface``); the phase's own seconds."""
    t0 = time.perf_counter()
    gen = torch.Generator().manual_seed(2)
    leg_retinaface(upsample_record, gen, profile)
    leg_arcface(gen, profile)
    emit({"phase": "faces", "seconds": time.perf_counter() - t0})


# ---------------------------------- video, OCR, distillation, face training
# Flash attention at the grids this slice's models hand it (name, B, H, Sq,
# Sk, D, layout, bias), served in bf16: TrOCR's encoder at b64 (ViT
# blocks: views of the packed qkv projection), its teacher-forced
# self-attention (a shared causal [1, 32, 32] bias) and cross-attention
# over the 577 memory tokens at b32 (views of separate projections), its
# decode steps at b64 (one query row over the 32-slot KV cache under a
# [1, 1, 32] bias of the filled slots, and over the memory), and the DeiT-B
# student at b64 (S = 198: the class, distillation and 196 patch tokens)
SEQUENCE_GRIDS = [
    ("trocr_encoder", 64, 6, 577, 577, 64, "packed", None),
    ("trocr_self_train", 32, 8, 32, 32, 32, "detr", "causal"),
    ("trocr_cross_train", 32, 8, 32, 577, 32, "detr", None),
    ("trocr_self_step", 64, 8, 1, 32, 32, "cache", "cache"),
    ("trocr_cross_step", 64, 8, 1, 577, 32, "detr", None),
    ("deit_b_student", 64, 12, 198, 198, 64, "packed", None),
]
# The backward at the training grids, in the dtype each trains in: TrOCR's
# at b32 in f32 (the Trainer's bf16 policy hands ``loss_fn`` the images
# cast back to f32, and the loss encodes them: the encoder runs in f32 on
# bf16-rounded weights, and so does the decoder from its first
# cross-attention on, whose f32 memory promotes it; only the first layer's
# self-attention is bf16, checked in bf16 as well), the DeiT-B student's at
# b64 in bf16
SEQUENCE_BACKWARD = [
    ("trocr_encoder_train", 32, 6, 577, 577, 64, "packed", None,
     torch.float32),
    ("trocr_self_train", 32, 8, 32, 32, 32, "detr", "causal",
     torch.float32),
    ("trocr_self_train_layer0", 32, 8, 32, 32, 32, "detr", "causal",
     torch.bfloat16),
    ("trocr_cross_train", 32, 8, 32, 577, 32, "detr", None, torch.float32),
    ("deit_b_student", 64, 12, 198, 198, 64, "packed", None, torch.bfloat16),
]
# TrOCR as the demo builds it (demo/ocr/train.py:27,33): vocabulary 64,044,
# 384^2 in 16 px patches (577 tokens), encoder 384 wide, 6 layers, 6
# heads, decoder 256 wide, 6 layers, 8 heads, FFN 1,024, ``max_length`` 32
TROCR_KW = dict(max_length=32)
TROCR_GREEDY, TROCR_BEAM, TROCR_BEAMS, TROCR_TRAIN = 64, 16, 4, 32
TROCR_CHECK = (4, 2)  # greedy and beam batches held against the CPU
# flash launches: a generation (the encoder, then each step's self- and
# cross-attention in each of 6 layers), a teacher-forced forward
TROCR_GENERATE = {"flash_attention": 6 + 12 * 32}
TROCR_FORWARD = {"flash_attention": 18}
# the share of sequences whose tokens equal the CPU's, in f32
TROCR_F32_SHARE = 0.9
# I3D on Charades (demo/video_classification/train.py:16-19): 157
# classes, 32 frames, I3D's published 224 crop; served at b16, trained at
# b8; checked against the CPU at b1 on 16 frames of 112^2
I3D_CLASSES, I3D_FRAMES, I3D_SIDE = 157, 32, 224
I3D_SERVE, I3D_TRAIN = 16, 8
# DeiT-B distilled from RegNetY-4GF (DeiT's teacher is RegNetY-16GF, which
# the repo lacks), hard distillation, b64 224^2; 12 flash launches forward
# and 12 backward a step
DISTILL_BATCH = 64
# RetinaFace-R50 trained at b8 640^2 (its FPN's two merges: upsample-add
# forward, transposed resize backward), gradients checked at b2 320^2;
# ArcFace-R50 at b128 128^2, 10,575 classes, its margin warmed up from 0 to
# 0.5 over ``ARCFACE_WARMUP`` steps, gradients checked at b8
RETINAFACE_TRAIN, RETINAFACE_TRAIN_CHECK = (8, 640), (2, 320)
RETINAFACE_TRAIN_LAUNCHES = {"upsample_add_fused": 2, "sep_resize": 2}
ARCFACE_TRAIN, ARCFACE_CHECK, ARCFACE_WARMUP = (128, 128), 8, 10


def sequence_qkv(b, h, sq, sk, d, layout, dtype, seed):
    """q, k, v as ``SEQUENCE_GRIDS``' layouts hand them over: ``cache``,
    a decode step's [B, H, 1, D] view of its q projection over a
    contiguous [B, H, T, D] cache; else ``backward_inputs``' layouts."""
    if layout == "cache":
        g = torch.Generator(device="cuda").manual_seed(seed)
        q = detr_qkv(sq, sq, dtype, seed, batch=b, heads=h, d=d)[0]
        return [q] + [torch.randn(b, h, sk, d, generator=g, device="cuda")
                      .to(dtype) for _ in range(2)]
    return backward_inputs(b, h, sq, sk, d, layout, dtype, seed)


def sequence_bias(kind, sq, sk):
    """The grid's [1, Sq, Sk] bias: causal, or a decode step's at slot
    ``sk // 2`` (the filled slots 0, the empty ones -1e9)."""
    if kind == "cache":
        slots = torch.arange(sk, device="cuda")
        return torch.where(slots <= sk // 2, 0.0, -1e9).expand(
            1, sq, sk).contiguous()
    return backward_bias(kind, None, sq, sk, None)


def flash_grid(grid, seed):
    """One forward grid in bf16 (``SEQUENCE_GRIDS``' form): checked against
    the plain version in f32 on the same inputs (2e-2 of the largest
    magnitude, the kernel's bf16 bound), one launch a call; timed by graph
    replays (``ms``) and events around each call (``event_ms``, which
    count the wrapper's host time), beside the plain version, SDPA on the
    same views with the same mask (``is_causal`` for the causal one) and
    the bound, which counts the bytes of the unpadded q, k, v and output.
    At a head dim that the wrapper zero-pads (``padded_head_dim``), also
    the kernel alone on inputs padded beforehand (``kernel_ms``)."""
    from tlxcv_tpu_torch.ops.cuda import attention as A

    name, b, h, sq, sk, d, layout, kind = grid
    q, k, v = sequence_qkv(b, h, sq, sk, d, layout, torch.bfloat16, seed)
    bias = None if kind is None else sequence_bias(kind, sq, sk)
    before = A.flash_attention.launches
    out = A.flash_attention(q, k, v, bias=bias)
    torch.cuda.synchronize()
    launched = A.flash_attention.launches - before
    err = _rel_card(out, A.flash_attention_plain(q.float(), k.float(),
                                                 v.float(), bias))
    mask = (None if kind in (None, "causal")
            else bias.view(1, 1, sq, sk).to(q.dtype))

    def sdpa():
        return torch.nn.functional.scaled_dot_product_attention(
            q, k, v, attn_mask=mask, is_causal=kind == "causal")

    def kernel():
        return A.flash_attention(q, k, v, bias=bias)

    bound, bound_by = attention_bound_ms(b * h, sq, sk, d, q.dtype)
    row = {"shape": [b * h, sq, sk, d], "bias": kind, "dtype": "bfloat16",
           "max_rel_err": err, "bound_rel_err": 2e-2, "launches": launched,
           "ms": graph_ms(kernel), "event_ms": time_ms(kernel),
           "plain_ms": time_ms(lambda: A.flash_attention_plain(q, k, v,
                                                               bias)),
           "library_ms": graph_ms(sdpa), "library_event_ms": time_ms(sdpa),
           "sdpa_rel_err": _rel_card(sdpa(), out.float()),
           "bound_ms": bound, "bound_us": 1e3 * bound, "bound_by": bound_by}
    dp = A.padded_head_dim(d)
    if dp != d:
        qp, kp, vp = (torch.nn.functional.pad(t, (0, dp - d))
                      for t in (q, k, v))
        row.update(padded_to=dp, kernel_ms=graph_ms(
            lambda: A._launch_kernel(qp, kp, vp, bias, d ** -0.5)))
    if launched != 1 or not err <= 2e-2:
        emit({"phase": "kernel_times", "failed": {name: row}})
        raise AssertionError(f"flash at {name}: {row}")
    return row


def sequence_backward_times(case, dtype):
    """The backward kernel alone at one ``SEQUENCE_BACKWARD`` grid (graph
    replays; events), its plain version, SDPA's backward with
    ``is_causal`` for the causal grids (its aten op on its own forward's
    outputs, graph replays, its dq, dk and dv held to ``autograd.grad``
    through SDPA within 2e-2 of each one's largest magnitude, the bf16
    bound, where the op without its causal mask is O(1) off; one
    ``autograd.grad`` through SDPA, events) and the bound."""
    from tlxcv_tpu_torch.ops.cuda import attention as A

    name, b, h, sq, sk, d, layout, kind = case
    q, k, v = backward_inputs(b, h, sq, sk, d, layout, dtype, seed=11)
    bias = backward_bias(kind, b * h, sq, sk, None)
    scale = d ** -0.5
    out, lse = A._launch_kernel(q, k, v, bias, scale, with_lse=True)
    g = torch.Generator(device="cuda").manual_seed(12)
    dout = torch.randn(out.shape, generator=g, device="cuda").to(dtype)
    out_v, dout_v = out.transpose(1, 2), dout.transpose(1, 2)

    def kernel():
        return A.flash_attention_backward(q, k, v, bias, scale, out, lse,
                                          dout)

    ref = [t.detach().requires_grad_() for t in (q, k, v)]
    causal = kind == "causal"
    sdpa = torch.nn.functional.scaled_dot_product_attention(
        *ref, is_causal=causal)
    library_op, library = sdpa_backward_call(q, k, v, dout_v, causal)
    library_err = None
    if library is not None:
        want = torch.autograd.grad(sdpa, ref, dout_v, retain_graph=True)
        library_err = [_rel_card(a, w)
                       for a, w in zip(library()[:3], want)]
        if not max(library_err) <= 2e-2:
            emit({"phase": "kernel_times", "failed": {
                name: {"library_op": library_op,
                       "library_rel_err": library_err}}})
            raise AssertionError(f"SDPA's backward op at {name} is not "
                                 f"SDPA's gradient: {library_err}")
    bound, bound_by = attention_backward_bound_ms(b * h, sq, sk, d, dtype)
    row = {"shape": [b * h, sq, sk, d], "bias": kind,
            "dtype": str(dtype)[6:], "ms": graph_ms(kernel),
            "event_ms": time_ms(kernel),
            "plain_ms": time_ms(lambda: A.flash_attention_backward_plain(
                q, k, v, bias, None, out_v, lse, dout_v), reps=5),
            "library_ms": None if library is None else graph_ms(library),
            "library_op": library_op, "library_rel_err": library_err,
            "library_event_ms": time_ms(lambda: torch.autograd.grad(
                sdpa, ref, dout_v, retain_graph=True)),
            "bound_ms": bound, "bound_by": bound_by}
    if dtype == torch.float32:
        row["fma_bound_ms"] = attention_backward_bound_ms(
            b * h, sq, sk, d, dtype, fma=True)[0]
        row["forward"] = f32_forward_times(q, k, v, bias, kind)
    return row


def f32_forward_times(q, k, v, bias, kind):
    """The f32 forward as a training step runs it (writing the rows'
    log-sum-exp) on [B, H, S, D] views: checked against the plain version
    (1e-4 of the largest magnitude, lse within 1e-4 on rows not masked
    entirely), timed by graph replays (``ms``) and events (``event_ms``)
    beside the plain version, SDPA's f32 forward on the same views
    (``library_ms``, graph replays, and events; ``library_op`` the autograd
    node its dispatcher picks for f32, the memory-efficient one; causal
    through ``is_causal``) and the bounds at the split-TF32 rate
    (``bound_ms``) and at the FMA units' (``fma_bound_ms``)."""
    from tlxcv_tpu_torch.ops.cuda import attention as A

    b, h, sq, d = q.shape
    sk = k.shape[-2]
    scale = d ** -0.5

    def kernel():
        return A._launch_kernel(q, k, v, bias, scale, with_lse=True)

    out, lse = kernel()
    want, want_lse = A.flash_attention_plain(q, k, v, bias, return_lse=True)
    rows = want_lse > A.NEG
    err = _rel_card(out.transpose(1, 2), want)
    lse_err = ((lse - want_lse)[rows].abs().max().item() if rows.any()
               else 0.0)
    causal = kind == "causal"

    def sdpa():
        return torch.nn.functional.scaled_dot_product_attention(
            q, k, v, is_causal=causal)

    ref = [t.detach().requires_grad_() for t in (q, k, v)]
    library_op = torch.nn.functional.scaled_dot_product_attention(
        *ref, is_causal=causal).grad_fn.name()
    bound, bound_by = attention_bound_ms(b * h, sq, sk, d, q.dtype)
    row = {"shape": [b * h, sq, sk, d], "bias": kind, "max_rel_err": err,
           "lse_max_abs_err": lse_err, "ms": graph_ms(kernel),
           "event_ms": time_ms(kernel),
           "plain_ms": time_ms(lambda: A.flash_attention_plain(
               q, k, v, bias), reps=5),
           "library_ms": graph_ms(sdpa), "library_event_ms": time_ms(sdpa),
           "library_op": library_op, "bound_ms": bound, "bound_by": bound_by,
           "fma_bound_ms": attention_bound_ms(b * h, sq, sk, d, q.dtype,
                                              fma=True)[0]}
    if not err <= 1e-4 or not lse_err <= 1e-4:
        emit({"phase": "kernel_times", "failed": {"f32_forward": row}})
        raise AssertionError(f"f32 flash forward at {row['shape']}: {row}")
    return row


def phase_sequence_flash(flash_record, bwd_record):
    """Flash attention forward at ``SEQUENCE_GRIDS`` and backward at
    ``SEQUENCE_BACKWARD`` (``check_backward``: against the plain version,
    f32 also against SDPA's gradients, bitwise over two runs), checked
    and timed; the rows go into both kernels' records."""
    grids = {g[0]: flash_grid(g, 60 + i)
             for i, g in enumerate(SEQUENCE_GRIDS)}
    emit({"phase": "kernel_times", "flash_attention_sequence": grids})
    checks, times = [], {}
    for i, (*case, dtype) in enumerate(SEQUENCE_BACKWARD):
        checks.append(check_backward(tuple(case), dtype, 700 + i))
        times[case[0]] = sequence_backward_times(tuple(case), dtype)
    emit({"phase": "flash_backward", "sequence_checks": checks})
    emit({"phase": "kernel_times", "flash_attention_backward_sequence":
          times})
    flash_record["sequence_grids"] = grids
    bwd_record["sequence_grids"] = times
    f32_records(flash_record, bwd_record, times)


def f32_records(flash_record, bwd_record, times):
    """The f32 rows of ``times`` (``sequence_backward_times``' records by
    grid) into both kernels' records: the forward's and the backward's
    ``f32_grids``."""
    for name, row in times.items():
        if "forward" in row:
            flash_record.setdefault("f32_grids", {})[name] = row["forward"]
            bwd_record.setdefault("f32_grids", {})[name] = {
                key: val for key, val in row.items() if key != "forward"}


# Flash attention's f32 training grids: ViT-B/16's and DETR-R50's (their
# f32 leg of ``phase_flash_backward``) and TrOCR's three f32 ones
F32_TRAINING_GRIDS = [(*grid, None) for grid in BACKWARD_GRIDS] + [
    tuple(case) for *case, dtype in SEQUENCE_BACKWARD
    if dtype == torch.float32]


def phase_f32_attention(flash_record, bwd_record):
    """Flash attention in f32 alone at ``F32_TRAINING_GRIDS``:
    ``check_backward`` at each (the plain version, SDPA's gradient, lse,
    bitwise over two runs and with the TF32 flag flipped), the forward and
    the backward timed (``sequence_backward_times``), then one forward and
    one backward call of each profiled (each kernel's device time).  The
    rows go into both kernels' records (``f32_grids``)."""
    from torch.profiler import ProfilerActivity, profile

    from tlxcv_tpu_torch.ops.cuda import attention as A

    checks, times = [], {}
    for i, case in enumerate(F32_TRAINING_GRIDS):
        checks.append(check_backward(case, torch.float32, 800 + i))
        times[case[0]] = sequence_backward_times(case, torch.float32)
    emit({"phase": "flash_backward", "f32_checks": checks})
    emit({"phase": "kernel_times", "flash_attention_f32": times})
    f32_records(flash_record, bwd_record, times)
    for name, b, h, sq, sk, d, layout, kind in F32_TRAINING_GRIDS:
        q, k, v = backward_inputs(b, h, sq, sk, d, layout, torch.float32,
                                  seed=11)
        bias = backward_bias(kind, b * h, sq, sk, None)
        out, lse = A._launch_kernel(q, k, v, bias, d ** -0.5, with_lse=True)
        dout = torch.randn_like(out)
        calls = {"forward": lambda: A._launch_kernel(
                     q, k, v, bias, d ** -0.5, with_lse=True),
                 "backward": lambda: A.flash_attention_backward(
                     q, k, v, bias, d ** -0.5, out, lse, dout)}
        for part, fn in calls.items():
            fn()
            torch.cuda.synchronize()
            with profile(activities=[ProfilerActivity.CPU,
                                     ProfilerActivity.CUDA]) as prof:
                fn()
                torch.cuda.synchronize()
            emit_profile(prof, f"flash_f32_{part}_{name}", 1, None)


def sequence_leg_seconds(name, t0):
    emit({"phase": "sequence_leg", "leg": name,
          "seconds": time.perf_counter() - t0})


# ---------------------------------------------------------------- I3D
def i3d_clip_check(pred, batch):
    if pred.shape != (batch, I3D_FRAMES // 8) or not bool(
            ((pred >= 0) & (pred < I3D_CLASSES)).all()):
        raise AssertionError(f"bad I3D predictions {tuple(pred.shape)}")


def i3d_targets(batch, gen, frames=I3D_FRAMES):
    """Charades-style per-frame multi-labels [B, frames, 157]: each clip
    carries 1-3 actions over random spans of its frames."""
    y = torch.zeros(batch, frames, I3D_CLASSES)
    for i in range(batch):
        for _ in range(int(torch.randint(1, 4, (1,), generator=gen))):
            cls = int(torch.randint(0, I3D_CLASSES, (1,), generator=gen))
            a, b = sorted(torch.randint(0, frames, (2,), generator=gen)
                          .tolist())
            y[i, a:b + 1, cls] = 1.0
    return y


def i3d_loss(task, out, target):
    """The demo's loss (demo/video_classification/train.py:22-28): the
    per-frame labels taken at ``linspace``-spaced frames, one for each of
    the logits' T/8 steps, then BCE with logits."""
    target = torch.as_tensor(target, device=out.device)
    t = out.shape[1]
    idx = torch.linspace(0, target.shape[1] - 1, t).to(torch.long)
    return task.loss_fn(out, target[:, idx.to(out.device)])


def leg_i3d(profile, dev="cuda"):
    """I3D (``create_model("i3d", num_classes=157)``, random weights from a
    seed, BatchNorm statistics from one train-mode forward of 2 clips):
    logits at b1 16 x 112^2 against the CPU (``float_logit_check``, bf16
    as a chaotic net's, no launch of ours), then ``predict`` (per-frame argmax [B, 4]) served at
    b16 32 x 224^2 in bf16; gradients at b1 16 x 112^2 against the CPU
    (``train_check``), the loss falling on one batch and ``Trainer.train``
    at b8 32 x 224^2, bf16 over f32 masters, Adam, the demo's loss."""
    from tlxcv_tpu_torch import create_model
    from tlxcv_tpu_torch.tasks import VideoClassification
    from tlxcv_tpu_torch.train import Trainer, optimizers

    t0 = time.perf_counter()
    gen = torch.Generator().manual_seed(81)
    side = I3D_SIDE
    cpu = VideoClassification(create_model(
        "i3d", device="cpu", num_classes=I3D_CLASSES, generator=gen)).eval()
    data_bn_statistics(cpu, torch.randn(2, 16, side, side, 3, generator=gen))
    card = copy.deepcopy(cpu).to(dev)
    # a random I3D is chaotic in bf16 (14% of the logits' scale on the
    # card at b1 16 x 224^2): held to the CPU bf16 model's own error, on
    # a 16 x 112^2 clip, which the CPU's bf16 Conv3d takes in seconds
    float_logit_check("i3d", cpu, card, torch.randn(
        1, 16, 112, 112, 3, generator=gen), depth="57 Conv3d", expect={},
        chaotic=True)
    del cpu
    x = torch.randn(I3D_SERVE, I3D_FRAMES, side, side, 3,
                    generator=gen).to(dev, torch.bfloat16)
    _, step = serve(card, x, {}, "i3d", "bfloat16", check=i3d_clip_check)
    if profile:
        phase_profile("i3d", card, x, step_s=step)
    del card, x
    empty_cache(dev)

    def build(seed=82):
        g = torch.Generator().manual_seed(seed)
        model = VideoClassification(create_model(
            "i3d", device="cpu", num_classes=I3D_CLASSES, generator=g))
        data_bn_statistics(model, torch.randn(1, 16, 112, 112, 3,
                                              generator=g))
        return model

    xg = torch.randn(1, 16, 112, 112, 3, generator=gen).numpy()
    yg = i3d_targets(1, gen, frames=16).numpy()
    train_check("i3d", build, xg, yg, i3d_loss,
                ["backbone.conv1.conv.weight",
                 "backbone.mixed_3b.b1b.conv.weight",
                 "backbone.mixed_5c.b0.conv.weight",
                 "backbone.logits.conv.weight"])
    task = build(83).to(dev)
    trainer = Trainer(task, loss_fn=functools.partial(i3d_loss, task),
                      optimizer=optimizers.Adam(1e-4),
                      compute_dtype=torch.bfloat16, device=dev)
    batches = [(torch.randn(I3D_TRAIN, I3D_FRAMES, side, side, 3,
                            generator=gen).to(dev),
                i3d_targets(I3D_TRAIN, gen).to(dev)) for _ in range(2)]
    attention_train("i3d", trainer, batches, {}, I3D_TRAIN, profile)
    del trainer, task, batches
    empty_cache(dev)
    sequence_leg_seconds("i3d", t0)


# -------------------------------------------------------------- TrOCR
def trocr_forced_logits(model, x, tokens):
    """The decode steps run along ``tokens`` [B, T] (BOS, then each token
    as the next step's input): each step's logits [B, T, V] in f32, on
    the device of ``model``, whatever its own argmax would have taken."""
    from tlxcv_tpu_torch.models.ocr.trocr import cache_masks

    with torch.inference_mode():
        memory = model.encode(x)
        b, t = tokens.shape
        dev = memory.device
        cache = model.decoder.init_cache(b, t, memory.dtype, dev)
        kvs = model.decoder.memory_kv(memory)
        masks = cache_masks(t, dev)
        bos = torch.full((b, 1), model.bos_token_id, dtype=torch.long,
                         device=dev)
        inputs = torch.cat([bos, tokens.to(dev).long()[:, :-1]], 1)
        steps = []
        for pos in range(t):
            logits, cache = model.decoder.decode_step(
                inputs[:, pos], pos, memory, cache, kvs, masks[pos])
            steps.append(logits.float())
        return torch.stack(steps, 1)


def _token_share(got, want):
    return (got.cpu() == want.cpu()).all(1).float().mean().item()


def trocr_check(cpu, card, x):
    """TrOCR on the card against the CPU's f32 model at b4 (greedy) and b2
    (4 beams), full width, ``max_length`` 32: the share of greedy and of
    beam sequences whose tokens equal the CPU's (at least
    ``TROCR_F32_SHARE`` in f32; bf16 reported); the decode steps' logits
    along the CPU's own greedy tokens (so that no argmax flip cascades)
    within 1e-3 (f32) and 3e-2 (bf16) of their largest magnitude; the
    teacher-forced logits likewise; exactly ``TROCR_GENERATE`` launches a
    generation and ``TROCR_FORWARD`` a teacher-forced forward.  ``card``
    is left with bf16 parameters."""
    nb = TROCR_CHECK[1]
    t0 = time.perf_counter()
    greedy = cpu.generate(x)
    beam = cpu.generate_beam(x[:nb], num_beams=TROCR_BEAMS)
    forced = trocr_forced_logits(cpu, x, greedy)
    with torch.inference_mode():
        teacher = cpu(x, greedy.long())
    cpu_s = time.perf_counter() - t0
    check = {"batch": list(TROCR_CHECK), "cpu_s": cpu_s,
             "cpu_eos_share": (greedy == cpu.eos_token_id).any(1).float()
             .mean().item()}
    ok = True
    for dtype in (torch.float32, torch.bfloat16):
        dname = str(dtype)[6:]
        if dtype == torch.bfloat16:
            params_to(card, dtype)
        xc = x.to("cuda", dtype)
        reset_launches()
        got = card.generate(xc)
        torch.cuda.synchronize()
        per_generate = {k: v for k, v in launch_counts(f32=False).items() if v}
        got_beam = card.generate_beam(xc[:nb], num_beams=TROCR_BEAMS)
        got_forced = trocr_forced_logits(card, xc, greedy).cpu()
        reset_launches()
        with torch.inference_mode():
            got_teacher = card(xc, greedy.cuda().long()).float().cpu()
        per_forward = {k: v for k, v in launch_counts(f32=False).items() if v}
        tol = 1e-3 if dtype == torch.float32 else 3e-2
        scale = forced.abs().max().item()
        row = {"greedy_share": _token_share(got, greedy),
               "beam_share": _token_share(got_beam, beam),
               "step_logit_scale": scale,
               "step_max_abs_err": (got_forced - forced).abs().max().item(),
               "teacher_max_abs_err": (got_teacher - teacher).abs().max()
               .item(), "bound": tol * scale,
               "launches_per_generate": per_generate,
               "launches_per_forward": per_forward}
        ok &= (per_generate == TROCR_GENERATE and per_forward == TROCR_FORWARD
               and row["step_max_abs_err"] <= tol * scale
               and row["teacher_max_abs_err"] <= tol * scale
               and bool(torch.isfinite(got_forced).all()))
        if dtype == torch.float32:
            ok &= (row["greedy_share"] >= TROCR_F32_SHARE
                   and row["beam_share"] >= TROCR_F32_SHARE)
        check[dname] = row
    emit({"phase": "model_check", "model": "trocr", **check})
    if not ok:
        raise AssertionError(f"TrOCR disagrees with the CPU: {check}")


def trocr_labels(batch, gen, vocab=64044, length=32):
    """Token ids of random words: 4-24 ids (fewer than ``length``) from
    the vocabulary, past the specials, EOS, then PAD, [B, length] int32."""
    y = torch.ones(batch, length, dtype=torch.int32)
    for i in range(batch):
        n = int(torch.randint(4, min(25, length), (1,), generator=gen))
        y[i, :n] = torch.randint(3, vocab, (n,), generator=gen)
        y[i, n] = 2
    return y


def leg_trocr(profile, dev="cuda"):
    """TrOCR (``create_model("trocr", max_length=32)``: the demo's model,
    random weights from a seed) served on token ids: checked at b4 and b2
    against the CPU (``trocr_check``), then greedy decoding served at b64
    and 4-beam decoding at b16, both bf16 at 384^2 (390 flash launches a
    generation); then trained (``trocr_training``)."""
    from tlxcv_tpu_torch import create_model

    t0 = time.perf_counter()
    gen = torch.Generator().manual_seed(91)
    cpu = create_model("trocr", device="cpu", generator=gen,
                       **TROCR_KW).eval()
    card = copy.deepcopy(cpu).to(dev)
    trocr_check(cpu, card, torch.randn(TROCR_CHECK[0], 384, 384, 3,
                                       generator=gen))
    del cpu

    def tokens_check(pred, batch):
        if pred.shape != (batch, 32) or pred.dtype != torch.int32 or not \
                bool(((pred >= 0) & (pred < 64044)).all()):
            raise AssertionError(f"bad TrOCR tokens {tuple(pred.shape)}")

    for name, batch, fn in (
            ("trocr_greedy", TROCR_GREEDY, card.generate),
            ("trocr_beam4", TROCR_BEAM, functools.partial(
                card.generate_beam, num_beams=TROCR_BEAMS))):
        x = torch.randn(batch, 384, 384, 3, generator=gen).to(
            dev, torch.bfloat16)
        _, step = serve(_Predict(fn), x, TROCR_GENERATE, name, "bfloat16",
                        check=tokens_check)
        if profile:
            phase_profile(name, _Predict(fn), x, step_s=step)
        del x
    del card
    empty_cache(dev)
    trocr_training(profile, gen, dev)
    sequence_leg_seconds("trocr", t0)


def trocr_training(profile, gen, dev="cuda"):
    """TrOCR trained by teacher forcing through the OCR task: gradients at
    b2 against the CPU (``train_check``), the loss falling on one batch and
    ``Trainer.train`` at b32, bf16 policy over f32 masters (its encoder and
    most of its decoder run in f32), AdamW(5e-5) as the demo: 18 flash
    forward and 18 backward launches a step; the step profiled with
    ``profile``."""
    from tlxcv_tpu_torch import create_model
    from tlxcv_tpu_torch.tasks import OpticalCharacterRecognition
    from tlxcv_tpu_torch.train import Trainer, optimizers

    def build(seed=92):
        return OpticalCharacterRecognition(create_model(
            "trocr", device="cpu", generator=torch.Generator().manual_seed(
                seed), **TROCR_KW))

    def loss(task, o, t):
        return task.loss_fn(o, torch.as_tensor(t, device=o.device))

    xg = torch.randn(2, 384, 384, 3, generator=gen).numpy()
    yg = trocr_labels(2, gen).numpy()
    train_check("trocr", build, xg, yg, loss,
                ["backbone.encoder.patch_embed.proj.weight",
                 "backbone.encoder.blocks.0.attn.qkv.weight",
                 "backbone.decoder.layers.0.self_attn.q.weight",
                 "backbone.decoder.layers.5.cross_attn.k.weight",
                 "backbone.decoder.output_projection.weight"])
    task = build(93).to(dev)
    trainer = Trainer(task, loss_fn=lambda o, t: task.loss_fn(o, t),
                      optimizer=optimizers.AdamW(5e-5),
                      compute_dtype=torch.bfloat16, device=dev)
    batches = [(torch.randn(TROCR_TRAIN, 384, 384, 3, generator=gen).to(dev),
                trocr_labels(TROCR_TRAIN, gen).to(dev)) for _ in range(2)]
    attention_train("trocr", trainer, batches,
                    {"flash_attention": 18, "flash_attention_backward": 18},
                    TROCR_TRAIN, profile)
    del trainer, task, batches
    empty_cache(dev)


# ------------------------------------------------------- distillation
def leg_distillation(profile, dev="cuda"):
    """DeiT-B (``create_model("deit_base")``, random weights from a seed)
    distilled from RegNetY-4GF (``cls_model``: BatchNorm statistics from
    data, on the card in bf16, eval) by DeiT's hard objective
    (``DistilledClassification``): targets made by ``teacher_labels``
    (its time a batch recorded), gradients at b2 against the CPU
    (``train_check``, the CPU teacher's logits), the loss falling on one
    batch and ``Trainer.train`` at b64 224^2, bf16 over f32 masters,
    AdamW: 12 flash forward and 12 backward launches a step, none in the
    teacher."""
    from tlxcv_tpu_torch import create_model
    from tlxcv_tpu_torch.tasks import DistilledClassification, teacher_labels
    from tlxcv_tpu_torch.train import Trainer, optimizers

    t0 = time.perf_counter()
    gen = torch.Generator().manual_seed(101)
    teacher = cls_model("regnety_4gf", gen)
    xg = torch.randn(2, 224, 224, 3, generator=gen)
    yg = torch.randint(0, 1000, (2,), generator=gen)
    with torch.inference_mode():
        tg = teacher(xg)
    target = {"label": yg.numpy(), "teacher": tg.numpy()}

    def build(seed=102):
        return DistilledClassification(create_model(
            "deit_base", device="cpu",
            generator=torch.Generator().manual_seed(seed)))

    def loss(task, o, t):
        return task.loss_fn(o, _to(o.device, t))

    train_check("deit_base_distilled", build, xg.numpy(), target, loss,
                ["backbone.patch_embed.proj.weight",
                 "backbone.blocks.0.attn.qkv.weight",
                 "backbone.dist_token", "backbone.head_dist.weight",
                 "backbone.head.weight"])
    teacher = params_to(teacher.to(dev), torch.bfloat16)
    host = [(torch.randn(DISTILL_BATCH, 224, 224, 3, generator=gen)
             .to(dev, torch.bfloat16),
             torch.randint(0, 1000, (DISTILL_BATCH,), generator=gen).to(dev))
            for _ in range(2)]
    list(teacher_labels(teacher, host[:1]))  # cuDNN's first-call choices
    torch.cuda.synchronize()
    reset_launches()
    t1 = time.perf_counter()
    batches = list(teacher_labels(teacher, host))
    torch.cuda.synchronize()
    teacher_ms = 1e3 * (time.perf_counter() - t1) / len(host)
    counts = launch_counts(f32=False)
    agree = [(y["teacher"].argmax(-1) == y["label"]).float().mean().item()
             for _, y in batches]
    emit({"phase": "teacher_labels", "teacher": "regnety_4gf",
          "batch": DISTILL_BATCH, "ms_per_batch": teacher_ms,
          "launches": {k: v for k, v in counts.items() if v},
          "teacher_dtype": str(batches[0][1]["teacher"].dtype)[6:],
          "teacher_label_agreement": agree})
    if any(counts.values()):
        raise AssertionError(f"the teacher launched kernels of ours: "
                             f"{counts}")
    del teacher
    trainer = Trainer(build(103).to(dev), optimizer=optimizers.AdamW(1e-4),
                      compute_dtype=torch.bfloat16, device=dev)
    batches = [(x.float(), y) for x, y in batches]
    attention_train("deit_base_distilled", trainer, batches,
                    {"flash_attention": 12, "flash_attention_backward": 12},
                    DISTILL_BATCH, profile)
    del trainer, batches, host
    empty_cache(dev)
    sequence_leg_seconds("distillation", t0)


# ------------------------------------------------------ face training
def face_labels(gen, faces):
    """``faces`` face labels of one image: normalised xyxy boxes (side 3%
    to 30% of the frame), 5 landmarks inside each, landmarks valid for
    two in three, [faces, 15]."""
    lt = 0.02 + 0.6 * torch.rand(faces, 2, generator=gen)
    wh = 0.03 + 0.27 * torch.rand(faces, 1, generator=gen).expand(faces, 2)
    pts = lt[:, None] + torch.rand(faces, 5, 2, generator=gen) * wh[:, None]
    valid = (torch.rand(faces, 1, generator=gen) < 2 / 3).float()
    return torch.cat([lt, lt + wh, pts.reshape(faces, 10), valid], 1)


def retinaface_targets(batch, side, gen):
    """Images and ``Encoder`` targets [B, priors, 16] of WIDER FACE's
    density (``WIDER_FACES_PER_IMAGE``, rounded, faces an image)."""
    import numpy as np

    from tlxcv_tpu_torch.tasks.face_recognition import Encoder, prior_box

    encode = Encoder(prior_box((side, side)))
    faces = round(WIDER_FACES_PER_IMAGE)
    y = np.stack([encode(face_labels(gen, faces).numpy())
                  for _ in range(batch)]).astype(np.float32)
    return torch.randn(batch, side, side, 3, generator=gen).numpy(), y


def leg_retinaface_train(upsample_record, sep_record, profile, dev="cuda"):
    """RetinaFace-R50 trained by ``multi_box_loss`` on ``Encoder`` targets
    (random weights from a seed, BatchNorm in train mode): gradients at b2
    320^2 against the CPU (``train_check``), the loss falling on one batch
    and ``Trainer.train`` at b8 640^2, bf16 over f32 masters, SGD with
    momentum: exactly 2 upsample-add and 2 transposed-resize launches a
    step; both merges and both transposed resizes of a step timed alone
    (``merge_time_rows``, ``mrcnn_sep_times``)."""
    from tlxcv_tpu_torch import create_model
    from tlxcv_tpu_torch.train import Trainer, optimizers

    t0 = time.perf_counter()
    gen = torch.Generator().manual_seed(111)
    n, side = RETINAFACE_TRAIN_CHECK

    def build(seed=112, size=side):
        return create_model("retinaface", device="cpu", input_size=size,
                            generator=torch.Generator().manual_seed(seed))

    xg, yg = retinaface_targets(n, side, gen)
    train_check("retinaface", build, xg, yg,
                lambda m, o, t: m.loss_fn(o, torch.as_tensor(t,
                                                             device=o[0].device)),
                ["backbone.conv1.weight", "fpn.outputs.0.conv.weight",
                 "ssh.0.conv_3x3.conv.weight", "classheads.0.conv.weight",
                 "bboxheads.1.conv.weight", "landheads.2.conv.weight"])
    batch, side = RETINAFACE_TRAIN
    model = build(113, side).to(dev)
    trainer = Trainer(model, optimizer=optimizers.SGD(1e-3, momentum=0.9),
                      compute_dtype=torch.bfloat16, device=dev)
    batches = [trainer._put_batch(retinaface_targets(batch, side, gen))
               for _ in range(2)]
    counts, _ = attention_train("retinaface", trainer, batches,
                                RETINAFACE_TRAIN_LAUNCHES, batch, profile)
    upsample_record["retinaface_train_launches"] = counts[
        "upsample_add_fused"]
    sep_record["retinaface_train_launches"] = counts["sep_resize"]
    with recorded_merges() as calls, torch.no_grad():
        model.eval()
        model(batches[0][0].to(torch.bfloat16))
        torch.cuda.synchronize()
    rows = merge_time_rows(calls)
    emit({"phase": "kernel_times",
          "upsample_add_fused_per_retinaface_train_step": rows})
    if len(rows) != 2 or not all(r["bitwise"] for r in rows):
        raise AssertionError(f"RetinaFace's training merges: {rows}")
    times = {}
    mrcnn_sep_times(trainer, batches[0], times)
    for key in ("ms", "plain_ms", "library_ms", "bound_ms"):
        upsample_record[f"retinaface_train_{key}"] = sum(r[key] for r in rows)
        sep_record[f"retinaface_train_{key}"] = times[key]
    del trainer, batches, model
    empty_cache(dev)
    sequence_leg_seconds("retinaface_train", t0)


def leg_arcface_train(profile, dev="cuda"):
    """ArcFace-R50 (``create_model("arcface", input_size=128)``, 10,575
    classes, random weights from a seed, BatchNorm and dropout in train
    mode) trained by its margin head: gradients at b8 against the CPU at
    the warm-up's mid margin (``train_check``, dropout off), the loss
    falling on one batch at the full margin,
    then ``Trainer.train`` at b128 128^2, bf16 over f32 masters, SGD with
    momentum, the margin rising from 0 to 0.5 over the first
    ``ARCFACE_WARMUP`` steps (read from the Trainer's step count); no
    kernel of ours."""
    from tlxcv_tpu_torch import create_model
    from tlxcv_tpu_torch.train import Trainer, optimizers

    t0 = time.perf_counter()
    gen = torch.Generator().manual_seed(121)
    batch, side = ARCFACE_TRAIN

    def build(seed=122):
        return create_model("arcface", device="cpu", input_size=side,
                            generator=torch.Generator().manual_seed(seed))

    xg = torch.randn(ARCFACE_CHECK, side, side, 3, generator=gen).numpy()
    yg = torch.randint(0, 10575, (ARCFACE_CHECK,), generator=gen).numpy()
    train_check("arcface", build, xg, yg,
                lambda m, e, t: m.loss_fn(e, torch.as_tensor(
                    t, device=e.device), margin=0.25),
                ["backbone.conv1.weight",
                 "backbone.layer4.layers.2.conv3.weight", "dense.weight",
                 "head.weight"])
    model = build(123).to(dev)

    def warmed_up(e, t):
        margin = 0.5 * min(1.0, trainer.step / ARCFACE_WARMUP)
        return model.loss_fn(e, t, margin=margin)

    trainer = Trainer(model, loss_fn=warmed_up,
                      optimizer=optimizers.SGD(0.1, momentum=0.9),
                      compute_dtype=torch.bfloat16, device=dev)
    trainer.step = ARCFACE_WARMUP  # the full margin on the fixed batch
    batches = [(torch.randn(batch, side, side, 3, generator=gen).to(dev),
                torch.randint(0, 10575, (batch,), generator=gen).to(dev))
               for _ in range(2)]
    falling_loss(trainer, batches[0], "arcface")
    trainer.step = 0
    _, step = timed_train(trainer, batches, {}, "arcface_train", batch)
    if trainer.step != 3 + TRAIN_STEPS:
        raise AssertionError(f"ArcFace trained {trainer.step} steps")
    if profile:
        phase_train_profile("arcface", trainer, batches[0], step)
    del trainer, batches, model
    empty_cache(dev)
    sequence_leg_seconds("arcface_train", t0)


def phase_sequence(flash, bwd, upsample, sep, profile):
    """This slice's legs: flash at their grids (``phase_sequence_flash``),
    I3D, TrOCR, DeiT-B distilled from RegNetY-4GF, RetinaFace-R50 and
    ArcFace-R50 trained; the phase's own seconds."""
    t0 = time.perf_counter()
    phase_sequence_flash(flash, bwd)
    leg_i3d(profile)
    leg_trocr(profile)
    leg_distillation(profile)
    leg_retinaface_train(upsample, sep, profile)
    leg_arcface_train(profile)
    emit({"phase": "sequence", "seconds": time.perf_counter() - t0})



# ------------------------------------------------------ data and utilities
# the data phase's fixtures: CIFAR-style 32^2 images whose class is
# written into them (a per-class colour over noise), so that three epochs
# of ten steps lower ResNet-50's loss; COCO-style 416^2 JPEGs with boxes
DATA_CIFAR = {"images": 320, "steps": 10, "epochs": 3}
DATA_COCO = {"images": 16, "side": 416, "batch": 8, "boxes": 4,
             "eval_images": 100, "eval_dets": 100}
# the export round trips' batches: ViT-B/16 bf16, ResNet-50 full int8 (bf16
# input), SSD's predict at 300^2
DATA_EXPORT = {"vit": 64, "resnet50_int8": 256, "ssd": 128}
DATA_RESIZE = {"batch": 256, "src_hw": (375, 500), "dst_hw": (224, 224)}
# TrOCR's decode steps (PERF.md section 6): one query row over the
# 577-token memory and over the 32-slot cache under a [1, 1, 32] bias
DISPATCH_GRIDS = [("trocr_decode_memory", 512, 1, 577, 32, False),
                  ("trocr_decode_self", 512, 1, 32, 32, True)]


def host_call_us(fn, calls=400, rounds=5):
    """Host time of one call (microseconds): ``calls`` calls back to back
    on the wall clock, the card's queue drained before and after, the
    median of ``rounds``.  Where the call's device work is shorter than its
    host work, this is the wrapper's own cost."""
    for _ in range(20):
        fn()
    out = []
    for _ in range(rounds):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(calls):
            fn()
        t1 = time.perf_counter()
        torch.cuda.synchronize()
        out.append(1e6 * (t1 - t0) / calls)
    return statistics.median(out)


def registration_routes_us(device="cuda"):
    """The dispatch cost of each route to an operator, on a call that does
    nothing but allocate its output: a plain Python function,
    ``torch.library`` ``define``/``impl`` (the port's route), and
    ``torch.library.custom_op``.  Host microseconds a call."""
    x = torch.zeros(64, device=device)

    def body(t):
        return torch.empty_like(t)

    # custom_op reads the schema from annotations, which this module's
    # ``from __future__ import annotations`` would leave as strings
    body.__annotations__ = {"t": torch.Tensor, "return": torch.Tensor}
    lib = torch.library.Library("tlxcv_probe", "DEF")
    lib.define("body(Tensor t) -> Tensor")
    lib.impl("body", body, "CUDA" if device == "cuda" else "CPU")
    op = torch.ops.tlxcv_probe.body.default
    custom = torch.library.custom_op("tlxcv_probe::custom_body",
                                     mutates_args=())(body)
    return {"python_function": host_call_us(lambda: body(x)),
            "library_define_impl": host_call_us(lambda: op(x)),
            "library_custom_op": host_call_us(lambda: custom(x))}


def wrapper_host_times():
    """The flash wrapper at TrOCR's decode grids, bf16, as the decode loop
    calls it (no grad): host microseconds a call, events around each call
    (``time_ms``, which counts the host's work where it is the longer),
    and the graph-replayed device time.  Runs on any tree that has
    ``flash_attention``: the registration's before and after."""
    from tlxcv_tpu_torch.ops.cuda.attention import NEG, flash_attention

    out = {}
    for name, bh, sq, sk, d, biased in DISPATCH_GRIDS:
        q, k, v = qkv(bh, sq, d, torch.bfloat16, 0, sk=sk)
        bias = None
        if biased:
            bias = torch.zeros(1, sq, sk, device="cuda")
            bias[..., sk // 2:] = NEG
        with torch.inference_mode():
            call = functools.partial(flash_attention, q, k, v, bias)
            out[name] = {"grid": [bh, sq, sk, d],
                         "host_us": host_call_us(call),
                         "events_ms": time_ms(call, reps=200),
                         "device_ms": graph_ms(call)}
    return out


def phase_dispatch():
    """The wrapper's host cost at TrOCR's decode grids, and the dispatch
    cost of the registration routes; copy this file into another tree's
    root to measure that tree (``--dispatch``)."""
    emit({"phase": "dispatch", "flash_wrapper": wrapper_host_times(),
          "routes_us": registration_routes_us()})


def data_native():
    """The native resize/normalize at b256 uint8 500x375 -> 224^2 against
    its fallback (cv2's resize, or the numpy one), the pinned copy of the
    batch to the card, and the fused JPEG route where libjpeg built."""
    import numpy as np

    from tlxcv_tpu_torch import native
    from tlxcv_tpu_torch.data.transforms import FusedResizeNormalize

    if not native.available():
        raise AssertionError("the native resize library did not build "
                             "(g++ on tlxcv_tpu_torch/native/image_ops.cpp)")
    rng = np.random.default_rng(0)
    b, (sh, sw), dst = (DATA_RESIZE["batch"], DATA_RESIZE["src_hw"],
                        DATA_RESIZE["dst_hw"])
    imgs = rng.integers(0, 256, (b, sh, sw, 3), dtype=np.uint8)
    mean, std = (123.7, 116.3, 103.5), (58.4, 57.1, 57.4)
    fused = FusedResizeNormalize(dst, mean, std)
    times = []
    for _ in range(5):
        t0 = time.perf_counter()
        out = fused(imgs)
        times.append(time.perf_counter() - t0)
    fallback = native._fallback(imgs[:32], dst,
                                np.asarray(mean, np.float32),
                                np.asarray(std, np.float32))
    err = float(np.abs(out[:32] - fallback).max())
    host = torch.from_numpy(out).pin_memory()
    copy_ms = time_ms(lambda: host.to("cuda", non_blocking=True), reps=10,
                      warmup=2)
    check = {"batch": b, "src_hw": [sh, sw], "dst_hw": list(dst),
             "threads": "hardware",
             "resize_ms_median": 1e3 * statistics.median(times),
             "resize_ms_all": [1e3 * t for t in times],
             "fallback_max_abs_err": err, "bound": 0.05,
             "why": "the reference's tolerance against cv2's fixed-point "
                    "resize (tests/test_native.py), in normalised units",
             "pinned_copy_ms": copy_ms,
             "pinned_copy_gb_per_s": out.nbytes / copy_ms / 1e6,
             "jpeg_route": native.jpeg_available()}
    emit({"phase": "data_native", **check})
    if not err <= 0.05 or out.shape != (b, *dst, 3):
        raise AssertionError(f"native resize disagrees: {check}")
    if not native.jpeg_available():
        print("data_native: jpeglib.h is absent here; the native JPEG "
              "route did not build, and JPEGs decode through PIL",
              flush=True)
        return
    import io

    from PIL import Image

    blobs = []
    for im in imgs[:16]:
        buf = io.BytesIO()
        Image.fromarray(im).save(buf, format="JPEG", quality=90)
        blobs.append(buf.getvalue())
    t0 = time.perf_counter()
    fusedj = native.decode_resize_normalize(blobs, dst, mean, std)
    jpeg_s = time.perf_counter() - t0
    stepwise = fused(np.stack([native.decode_jpeg(b) for b in blobs]))
    errj = float(np.abs(fusedj - stepwise).max())
    emit({"phase": "data_jpeg", "images": 16, "decode_resize_ms": 1e3 *
          jpeg_s, "max_abs_err_against_decode_then_resize": errj})
    if not errj <= 1e-4:
        raise AssertionError(f"fused JPEG route disagrees: {errj}")


def _config(path):
    """``Config.from_file``, or the same fields from a dict where PyYAML is
    missing (the CPU tests hold the dicts equal to the files)."""
    from tlxcv_tpu_torch.config import Config

    try:
        return Config.from_file(os.path.join(
            os.path.dirname(os.path.abspath(__file__)), path))
    except ImportError:
        return Config(**DATA_CONFIGS[path])


DATA_CONFIGS = {
    "configs/resnet50_cifar10.yaml": {
        "model": "resnet50", "model_kwargs": {"num_classes": 10},
        "task": "classification", "optimizer": "Adam", "lr": 0.0001,
        "batch_size": 32, "n_epoch": 100},
    "configs/unet_circles.yaml": {
        "model": "unet", "model_kwargs": {"nx": 172, "ny": 172,
                                          "channels": 1, "num_classes": 2},
        "task": "segmentation", "optimizer": "Adam", "lr": 0.001,
        "batch_size": 2, "n_epoch": 5},
    "configs/yolov3_coco.yaml": {
        "model": "yolov3", "model_kwargs": {"num_classes": 80},
        "task": "detection", "optimizer": "Adam", "lr": 0.0001,
        "batch_size": 8, "n_epoch": 50},
}


def _write_cifar(root, n, gen):
    """``n`` images in the CIFAR pickle layout (five train batches), each
    class a colour over noise."""
    import pickle

    import numpy as np

    labels = gen.integers(0, 10, n)
    colours = gen.integers(0, 256, (10, 3))
    base = os.path.join(root, "cifar-10-batches-py")
    os.makedirs(base)
    for i, idx in enumerate(np.array_split(np.arange(n), 5)):
        img = (0.8 * colours[labels[idx]][:, :, None, None]
               + 0.2 * gen.integers(0, 256, (len(idx), 3, 32, 32)))
        data = img.astype(np.uint8).reshape(len(idx), -1)
        with open(os.path.join(base, f"data_batch_{i + 1}"), "wb") as f:
            pickle.dump({b"data": data,
                         b"labels": labels[idx].tolist()}, f)


def _recording(trainer):
    """Record each training step's loss (a device tensor)."""
    losses, step = [], trainer._train_step

    def recorded(x, y, epoch_id=0):
        loss, out = step(x, y, epoch_id)
        losses.append(loss)
        return loss, out

    trainer._train_step = recorded
    return losses


def _timed_epoch(trainer, loader, steps):
    """Images a second of one epoch of ``steps`` steps."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    trainer.train(n_epoch=1, train_dataset=loader,
                  max_steps_per_epoch=steps)
    torch.cuda.synchronize()
    return steps * loader.batch_size / (time.perf_counter() - t0)


def data_training(tmp):
    """Config-built training with a metric: ResNet-50 (10 classes) on
    CIFAR batches at b32, with and without ``Accuracy``; the UNet of
    ``configs/unet_circles.yaml`` on Circles with ``MeanIoU``."""
    import numpy as np

    from tlxcv_tpu_torch.data import Circles, Cifar10, DataLoader
    from tlxcv_tpu_torch.utils.metrics import Accuracy, MeanIoU

    gen = np.random.default_rng(0)
    _write_cifar(tmp, DATA_CIFAR["images"], gen)
    ds = Cifar10(tmp, split="train",
                 transform=lambda im: im.astype(np.float32) / 255.0)
    cfg = _config("configs/resnet50_cifar10.yaml")
    loader = DataLoader(ds, batch_size=cfg.batch_size)
    torch.manual_seed(0)
    trainer = cfg.build_trainer(metrics=Accuracy())
    losses = _recording(trainer)
    steps = DATA_CIFAR["steps"]
    trainer.train(n_epoch=DATA_CIFAR["epochs"], train_dataset=loader,
                  max_steps_per_epoch=steps)
    curve = [float(v) for v in losses]
    acc = trainer.metrics.result()
    with_metric = _timed_epoch(trainer, loader, steps)
    trainer.metrics = None
    without = _timed_epoch(trainer, loader, steps)
    trainer.metrics = Accuracy()
    evaluated = trainer.evaluate(loader, max_batches=2)
    check = {"model": cfg.model, "classes": 10, "batch": cfg.batch_size,
             "steps": len(curve), "loss_curve": curve, "train_acc": acc,
             "evaluate": evaluated, "img_per_s_with_metric": with_metric,
             "img_per_s_without_metric": without,
             "metric_cost_share": 1 - with_metric / without}
    emit({"phase": "data_train_cifar", **check})
    if not (all(math.isfinite(v) for v in curve)
            and np.mean(curve[-steps:]) < np.mean(curve[:steps])
            and 0.0 <= acc <= 1.0 and "metric" in evaluated):
        raise AssertionError(f"config-built ResNet-50 training: {check}")
    del trainer
    torch.cuda.empty_cache()

    cfg = _config("configs/unet_circles.yaml")

    def crop(x, size=132):
        d = (x.shape[0] - size) // 2
        return np.ascontiguousarray(x[d:d + size, d:d + size])

    circles = Circles(8, nx=172, ny=172, nc=1, seed=0,
                      target_transform=crop)
    loader = DataLoader(circles, batch_size=cfg.batch_size)
    trainer = cfg.build_trainer(metrics=MeanIoU(2))
    losses = _recording(trainer)
    trainer.train(n_epoch=2, train_dataset=loader)
    curve = [float(v) for v in losses]
    miou = trainer.metrics.result()
    check = {"model": cfg.model, "batch": cfg.batch_size, "hw": [172, 172],
             "steps": len(curve), "loss_curve": curve, "train_miou": miou}
    emit({"phase": "data_train_circles", **check})
    if not (all(math.isfinite(v) for v in curve) and 0.0 <= miou <= 1.0):
        raise AssertionError(f"config-built UNet training: {check}")


def _write_coco(root, gen, n, side, boxes):
    """``n`` JPEG images of ``side``^2 with ``boxes`` filled rectangles
    each, and their instances JSON (80 categories)."""
    import numpy as np
    from PIL import Image

    images, anns = [], []
    for i in range(n):
        img = gen.integers(0, 64, (side, side, 3), dtype=np.uint8)
        for _ in range(boxes):
            x, y = gen.integers(0, side - 96, 2)
            w, h = gen.integers(24, 96, 2)
            img[y:y + h, x:x + w] = gen.integers(128, 256, 3)
            anns.append({"id": len(anns) + 1, "image_id": i + 1,
                         "category_id": int(gen.integers(1, 81)),
                         "bbox": [float(x), float(y), float(w), float(h)],
                         "area": float(w * h), "iscrowd": 0})
        name = f"{i:04d}.jpg"
        Image.fromarray(img).save(os.path.join(root, name), quality=92)
        images.append({"id": i + 1, "file_name": name, "height": side,
                       "width": side})
    path = os.path.join(root, "instances.json")
    with open(path, "w") as f:
        json.dump({"images": images, "annotations": anns, "categories": [
            {"id": c, "name": str(c)} for c in range(1, 81)]}, f)
    return path


def _synthetic_eval(gen, n, dets, gts=7, classes=80, side=640):
    """Per-image detections near random GT boxes, half of them with the
    GT's label, for the evaluator's cost at COCO's scale."""
    import numpy as np

    preds, truth = [], []
    for _ in range(n):
        xy = gen.uniform(0, side - 64, (gts, 2))
        wh = gen.uniform(8, 200, (gts, 2))
        g = np.concatenate([xy, np.minimum(xy + wh, side)], 1).astype(
            np.float32)
        gl = gen.integers(0, classes, gts)
        j = gen.integers(0, gts, dets)
        p = g[j] + gen.normal(0, 8, (dets, 4)).astype(np.float32)
        pl = np.where(gen.random(dets) < 0.5, gl[j],
                      gen.integers(0, classes, dets))
        preds.append({"boxes": p, "scores": gen.random(dets).astype(
            np.float32), "labels": pl})
        truth.append({"boxes": g, "labels": gl})
    return preds, truth


def data_coco(tmp):
    """COCO evaluation: ``configs/yolov3_coco.yaml``'s detector predicts at
    b8 on ``CocoDetection`` through the detection transforms; the ground
    truth scored as predictions gives 1.0, the detector's stats are finite;
    the evaluator's host cost at 100 detections an image."""
    import numpy as np

    from tlxcv_tpu_torch.data import CocoDetection, DataLoader
    from tlxcv_tpu_torch.data import det_transforms as DT
    from tlxcv_tpu_torch.utils.coco_eval import CocoEvaluator

    gen = np.random.default_rng(1)
    side, batch = DATA_COCO["side"], DATA_COCO["batch"]
    ann = _write_coco(tmp, gen, DATA_COCO["images"], side,
                      DATA_COCO["boxes"])
    pipeline = DT.DetCompose([
        DT.DetResize((side, side)),
        DT.DetNormalize((0.485, 0.456, 0.406), (0.229, 0.224, 0.225)),
        DT.PadGTSingle(num_max_boxes=50)])
    ds = CocoDetection(tmp, ann, transforms=pipeline)
    cfg = _config("configs/yolov3_coco.yaml")
    task = cfg.build_task().eval()
    first = torch.from_numpy(next(iter(DataLoader(ds, batch_size=batch)))[0])
    data_bn_statistics(task.backbone, first.cuda())
    preds, truth, gt_as_pred = [], [], []
    t_pred = 0.0
    with torch.inference_mode():
        for x, y in DataLoader(ds, batch_size=batch):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            dets, counts = task.predict(torch.from_numpy(x).cuda())
            torch.cuda.synchronize()
            t_pred += time.perf_counter() - t0
            for i in range(len(x)):
                d = dets[i, :int(counts[i])]
                preds.append({"boxes": d[:, 2:6], "scores": d[:, 1],
                              "labels": d[:, 0].long()})
                keep = y["pad_gt_mask"][i] > 0
                cxcywh = y["boxes"][i][keep] * side
                xyxy = np.concatenate([cxcywh[:, :2] - cxcywh[:, 2:] / 2,
                                       cxcywh[:, :2] + cxcywh[:, 2:] / 2], 1)
                gt = {"boxes": xyxy, "labels": y["class_labels"][i][keep]}
                truth.append(gt)
                gt_as_pred.append({**gt, "scores": np.ones(len(xyxy))})
    ev = CocoEvaluator()
    ev.update(preds, truth)
    stats = ev.accumulate()["stats"]
    perfect = CocoEvaluator()
    perfect.update(gt_as_pred, truth)
    perfect_map = perfect.accumulate()["map"]
    n, dets = DATA_COCO["eval_images"], DATA_COCO["eval_dets"]
    p, g = _synthetic_eval(np.random.default_rng(2), n, dets)
    timed = CocoEvaluator()
    timed.update(p, g)
    t0 = time.perf_counter()
    timed.accumulate()
    eval_s = time.perf_counter() - t0
    check = {"images": len(truth), "batch": batch, "hw": [side, side],
             "classes": 80, "detector_stats": stats.tolist(),
             "gt_as_prediction_map": perfect_map,
             "predict_s": t_pred, "evaluator_images": n,
             "evaluator_dets_per_image": dets,
             "evaluator_s": eval_s,
             "evaluator_s_per_1000_images": eval_s * 1000 / n,
             "image_reader": ("native libjpeg" if __import__(
                 "tlxcv_tpu_torch.native", fromlist=["x"]).jpeg_available()
                 else "PIL"),
             "fixture_encoder": "PIL JPEG, quality 92"}
    emit({"phase": "data_coco", **check})
    if not (len(truth) == DATA_COCO["images"] and perfect_map == 1.0
            and np.isfinite(stats).all()):
        raise AssertionError(f"COCO evaluation: {check}")


def _served_rate(fn, x, rounds=5, warmup=2):
    """Images a second of ``fn(x)``, the host clock around each call and a
    synchronise, median of ``rounds``."""
    times = []
    for i in range(warmup + rounds):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn(x)
        torch.cuda.synchronize()
        if i >= warmup:
            times.append(time.perf_counter() - t0)
    return x.shape[0] / statistics.median(times)


def _equal(got, want):
    if isinstance(got, torch.Tensor):
        return torch.equal(got, want)
    return len(got) == len(want) and all(_equal(g, w)
                                         for g, w in zip(got, want))


def export_round_trip(tmp, name, model, x, kernel, per_forward, method,
                      profile=False):
    """Export ``model.method`` on the card at a symbolic batch, save, load
    and serve ``x``: the outputs bitwise the eager model's, ``kernel``
    launched ``per_forward`` times by one exported forward.  With
    ``profile``, the device time and idle share of both."""
    from tlxcv_tpu_torch.utils.export import (export_model, load_exported,
                                              save_exported)

    t0 = time.perf_counter()
    art = export_model(model, tuple(x.shape[1:]), dtype=x.dtype,
                       method=method)
    export_s = time.perf_counter() - t0
    path = os.path.join(tmp, f"{name}.pt2")
    size = save_exported(path, art)
    served = load_exported(path)
    eager = getattr(model, "forward" if method == "__call__" else method)
    with torch.inference_mode():
        want = eager(x)
        reset_launches()
        got = served(x)
        counts = launch_counts(f32=False)
        small = served(x[:3])
        rates = {"exported_img_per_s": _served_rate(served, x)}
        rates["eager_img_per_s"] = _served_rate(eager, x)
    graph_ops = sorted({str(n.target) for n in art.graph.nodes
                        if str(n.target).startswith("tlxcv.")})
    want_counts = {k: per_forward if k == kernel else 0 for k in counts}
    check = {"batch": x.shape[0], "dtype": str(x.dtype).split(".")[-1],
             "bitwise_equal": _equal(got, want), "launches": counts,
             "graph_operators": graph_ops, "artifact_bytes": size,
             "export_s": export_s, "batch3_shapes": [
                 list(t.shape) for t in (small if isinstance(small, tuple)
                                         else (small,))], **rates}
    emit({"phase": "data_export", "model": name, **check})
    if not check["bitwise_equal"] or counts != want_counts:
        raise AssertionError(f"{name} exported: {check}")
    if profile:
        batch = x.shape[0]
        phase_profile(name + "_exported", None, x, call=served,
                      step_s=batch / rates["exported_img_per_s"])
        phase_profile(name + "_eager", None, x, call=eager,
                      step_s=batch / rates["eager_img_per_s"])
    return counts


def data_export(tmp, flash_record, int8_record, profile=False):
    """ViT-B/16 b64 bf16 (12 flash launches), full-int8 ResNet-50 b256 (54
    int8_matmul launches) and SSD's predict at b128 300^2, each exported
    on the card, saved, loaded and served (with ``profile``, each profiled
    beside its eager twin)."""
    from tlxcv_tpu_torch import create_model
    from tlxcv_tpu_torch.ops.quant import quantize_for_serving
    from tlxcv_tpu_torch.tasks import ImageClassification, ObjectDetection

    gen = torch.Generator().manual_seed(5)
    vit = ImageClassification(create_model(
        "vit_base_patch16_224", generator=gen)).eval().to(torch.bfloat16)
    x = torch.randn(DATA_EXPORT["vit"], 224, 224, 3, generator=gen).to(
        "cuda", torch.bfloat16)
    counts = export_round_trip(tmp, "vit_base_patch16_224", vit, x,
                               "flash_attention", 12, "__call__", profile)
    flash_record["export_launches"] = counts["flash_attention"]
    del vit, x
    torch.cuda.empty_cache()

    # quantized on the card (phase_resnet holds the card's int8 ResNet-50
    # against the CPU's); the round trip compares the card with itself
    card8 = ImageClassification(create_model("resnet50",
                                             generator=gen)).eval()
    random_bn_statistics(card8, gen)
    quantize_for_serving(card8.backbone, [torch.randn(2, 224, 224, 3,
                                                      generator=gen)])
    x = torch.randn(DATA_EXPORT["resnet50_int8"], 224, 224, 3,
                    generator=gen).to("cuda", torch.bfloat16)
    counts = export_round_trip(tmp, "resnet50_int8", card8, x,
                               "int8_matmul", 54, "__call__", profile)
    int8_record["export_launches"] = counts["int8_matmul"]
    del card8, x
    torch.cuda.empty_cache()

    ssd = ObjectDetection(create_model("ssd", generator=gen)).eval()
    x = torch.randn(DATA_EXPORT["ssd"], 300, 300, 3, generator=gen).cuda()
    data_bn_statistics(ssd.backbone, x[:16])
    export_round_trip(tmp, "ssd", ssd, x, None, 0, "predict", profile)


def data_theseus_profiler(tmp):
    """``record_features`` on ResNet-50 at the reference's paths, on the
    card in bf16 against the CPU in f32 within the ResNet legs' bf16 bound;
    ``profiler.trace`` writes a trace and ``benchmark_fn`` times a
    forward."""
    from tlxcv_tpu_torch import create_model
    from tlxcv_tpu_torch.utils import profiler
    from tlxcv_tpu_torch.utils.theseus import record_features

    gen = torch.Generator().manual_seed(7)
    cpu = create_model("resnet50", device="cpu", generator=gen).eval()
    random_bn_statistics(cpu, gen)
    card = params_to(copy.deepcopy(cpu).cuda(), torch.bfloat16)
    paths = ["layer1", "layer2", "layer3", "layer4"]
    want, got = record_features(cpu, paths), record_features(card, paths)
    x = torch.randn(4, 224, 224, 3, generator=gen)
    with torch.inference_mode():
        cpu(x)
        card(x.cuda().to(torch.bfloat16))
    errs = {}
    for p in paths:
        scale = want[p].abs().max().item()
        errs[p] = {"max_abs_err": (got[p].float().cpu() - want[p]).abs()
                   .max().item(), "bound": 3e-2 * scale,
                   "shape": list(got[p].shape)}
    logdir = os.path.join(tmp, "trace")
    xc = x.cuda().to(torch.bfloat16)
    with torch.inference_mode():
        with profiler.trace(logdir) as prof:
            card(xc)
            torch.cuda.synchronize()
        fwd_s = profiler.benchmark_fn(card, xc, iters=10)
    trace = os.path.join(logdir, "trace.json")
    device_us = sum(getattr(e, "device_time_total",
                            getattr(e, "cuda_time_total", 0))
                    for e in prof.key_averages())
    check = {"features": errs, "trace_bytes": os.path.getsize(trace),
             "trace_device_us": device_us, "benchmark_fn_ms": 1e3 * fwd_s,
             "device_info": profiler.device_info()}
    emit({"phase": "data_theseus_profiler", **check})
    if not all(e["max_abs_err"] <= e["bound"] for e in errs.values()):
        raise AssertionError(f"recorded features disagree: {check}")
    if not (check["trace_bytes"] > 0 and fwd_s > 0):
        raise AssertionError(f"profiler: {check}")


def phase_data(flash_record, int8_record, profile=False):
    """The data and utility layers on the card: the native host ops, config
    training with metrics, COCO evaluation, export round trips (with
    ``profile``, each profiled beside its eager twin), theseus and the
    profiler, then the flash wrapper's host cost."""
    import tempfile

    t0 = time.perf_counter()
    data_native()
    with tempfile.TemporaryDirectory() as tmp:
        data_training(tmp)
    with tempfile.TemporaryDirectory() as tmp:
        data_coco(tmp)
    with tempfile.TemporaryDirectory() as tmp:
        data_export(tmp, flash_record, int8_record, profile)
    with tempfile.TemporaryDirectory() as tmp:
        data_theseus_profiler(tmp)
    phase_dispatch()
    emit({"phase": "data_done", "seconds": time.perf_counter() - t0})


# ------------------------------------------------ hermetic accuracy checks
# check -> (its module under tlxcv_tpu_torch.demo, its main's arguments);
# the sweep's entries (sweep:<entry>[,...], sweep-int8:<entry>) come on top
ACCURACY_CHECKS = {
    "fcos": ("object_detection.accuracy_check", {}),
    "maskrcnn": ("object_detection.accuracy_check_instance_seg",
                 {"names": ["maskrcnn"]}),
    "solov2": ("object_detection.accuracy_check_instance_seg",
               {"names": ["solov2"]}),
    "pose": ("human_pose_estimation.accuracy_check", {}),
    "pfld": ("facial_landmark_detection.accuracy_check", {}),
    "face": ("face_recognition.accuracy_check", {}),
    "video": ("video_classification.accuracy_check", {}),
    "ocr": ("ocr.accuracy_check", {}),
    "qat": ("image_classification.accuracy_check_qat", {}),
    "detr_r50": ("object_detection.accuracy_check_detr_r50", {}),
}
# The nine checks that --accuracy runs when it is named alone
ACCURACY_DEFAULT = tuple(ACCURACY_CHECKS)[:9]
# the kernels each check must reach on the card (launch counters above 0):
# the flash kernels on their f32 route, the int8 GEMM, the Mask R-CNN trio
ACCURACY_KERNELS = {
    "ocr": ("flash_attention_f32", "flash_attention_backward_f32"),
    "qat": ("int8_matmul",),
    "maskrcnn": ("gather_rows", "upsample_add_fused", "sep_resize"),
}


def run_accuracy_check(name, out_dir):
    """Run one check at its defaults (the reference's schedules); the
    result rows its ``main`` returned, or those of its ``BelowFloor``."""
    import importlib

    from tlxcv_tpu_torch.demo import _accuracy as A

    if name.startswith(("sweep:", "sweep-int8:")):
        module, kw = "object_detection.accuracy_sweep", {
            "names": name.split(":", 1)[1].split(","),
            "int8": name.startswith("sweep-int8:")}
    else:
        module, kw = ACCURACY_CHECKS[name]
        kw = dict(kw)
    if out_dir is not None:
        # one folder a task, as the scripts sit (four checks' files are
        # all called accuracy_results.json)
        kw["out_dir"] = os.path.join(out_dir, module.split(".")[0])
    main = importlib.import_module("tlxcv_tpu_torch.demo." + module).main
    try:
        result = main(**kw)
    except A.BelowFloor as e:
        result = e.result
    return result if isinstance(result, list) else [result]


def phase_accuracy(names, out_dir=None):
    """The hermetic accuracy checks, one after another, each at its
    defaults; one JSON line each.  Every named check runs even if an
    earlier one missed; the misses, errors and kernels not reached are
    returned."""
    failed = []
    for name in names:
        reset_launches()
        t0 = time.perf_counter()
        row = {"phase": "accuracy", "check": name}
        try:
            rows = run_accuracy_check(name, out_dir)
            errors = [f"{r['model']}: {r['error']}" for r in rows
                      if "error" in r]
            if errors:
                raise RuntimeError("; ".join(errors))
            sweep = name.startswith(("sweep:", "sweep-int8:"))
            steps = [{k: v for k, v in r.items() if "steps" in k}
                     for r in rows]
            row["steps"] = ({r["model"]: st for r, st in zip(rows, steps)}
                            if sweep else steps[0])
            row["metrics"] = [
                {**m, "metric": f"{r['model']}.{m['metric']}" if sweep
                 else m["metric"]} for r in rows for m in r["metrics"]]
            row.update({k: row["metrics"][0][k]
                        for k in ("metric", "value", "floor")})
            ok = all(m["ok"] for m in row["metrics"])
        except Exception as e:  # the other checks still run
            row["error"] = repr(e)[:2000]
            ok = False
        counts = launch_counts()
        row["seconds"] = round(time.perf_counter() - t0, 1)
        row["launches"] = {k: v for k, v in counts.items() if v}
        missing = [k for k in ACCURACY_KERNELS.get(name, ())
                   if counts[k] == 0]
        if missing:
            row["kernels_not_reached"] = missing
        row["ok"] = ok and not missing
        emit(row)
        if not row["ok"]:
            failed.append(name)
        torch.cuda.empty_cache()
    return failed


def accuracy_main(argv):
    """``--accuracy [name ...] [--out-dir DIR]``."""
    out_dir = None
    if "--out-dir" in argv:
        i = argv.index("--out-dir")
        out_dir = argv[i + 1]
        argv = argv[:i] + argv[i + 2:]
    names = [a for a in argv[argv.index("--accuracy") + 1:]
             if not a.startswith("--")] or list(ACCURACY_DEFAULT)
    bad = [n for n in names if n not in ACCURACY_CHECKS
           and not n.startswith(("sweep:", "sweep-int8:"))]
    if bad:
        print(f"chip_smoke: unknown accuracy checks {bad}", file=sys.stderr)
        return 2
    emit({"phase": "environment", "card": card_line(),
          "torch": torch.__version__, "cuda": torch.version.cuda})
    failed = phase_accuracy(names, out_dir)
    emit({"phase": "accuracy_done", "checks": names, "failed": failed})
    print(card_line(), flush=True)
    emit({"ok": not failed,
          "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                     "count": torch.cuda.device_count()}})
    return 1 if failed else 0


def main():
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; nothing was run", file=sys.stderr)
        return 1
    if "--accuracy" in sys.argv[1:]:  # the checks at PyTorch's own TF32
        return accuracy_main(sys.argv[1:])  # defaults (cuDNN TF32 on)
    torch.backends.cuda.matmul.allow_tf32 = False  # f32 references in f32
    torch.backends.cudnn.allow_tf32 = False
    if "--dispatch" in sys.argv[1:]:  # the flash wrapper's host cost alone
        phase_dispatch()      # (builds only the flash kernel, at first use)
        print(card_line(), flush=True)
        return 0
    phase_environment()
    if "--vit" in sys.argv[1:]:  # ViT-B/16 checked and served, alone
        phase_model({})
        print(card_line(), flush=True)
        return 0
    profile = "--profile" in sys.argv[1:]
    if "--data" in sys.argv[1:]:  # the data and utility layers alone
        flash = {"name": "flash_attention"}
        int8 = {"name": "int8_matmul"}
        phase_data(flash, int8, profile)
        emit({"kernels": [flash, int8]})
        print(card_line(), flush=True)
        return 0
    if "--int8" in sys.argv[1:]:  # the int8 GEMM and its two int8 paths
        int8 = phase_int8_kernels()
        _, resnet8, resnet_x = phase_resnet(int8, floats=False)
        if profile:
            phase_profile("resnet50_int8", resnet8, resnet_x)
        del resnet8, resnet_x
        torch.cuda.empty_cache()
        _, yolo8, yolo_x, _, yolo8_step = phase_yolov3(floats=False)
        if profile:
            phase_profile("yolov3_int8", yolo8, yolo_x, step_s=yolo8_step)
        del yolo8, yolo_x
        torch.cuda.empty_cache()
        vit_int8_and_grouped(int8, profile)
        emit({"kernels": [int8]})
        print(card_line(), flush=True)
        return 0
    if "--seg" in sys.argv[1:]:  # HRNet-W18 segmentation alone
        hrnet_seg_leg(profile)
        print(card_line(), flush=True)
        return 0
    if "--segmentation" in sys.argv[1:]:  # the padded flash, the seg zoo
        flash = {"name": "flash_attention"}
        phase_padded_flash(flash)
        phase_segmentation(flash, profile)
        emit({"kernels": [flash]})
        print(card_line(), flush=True)
        return 0
    if "--remote-sensing" in sys.argv[1:]:  # the remote-sensing legs alone
        phase_remote_sensing(profile)
        print(card_line(), flush=True)
        return 0
    if "--transformers" in sys.argv[1:]:  # DeiT-B and Swin-B alone
        transformer_legs({}, profile)
        print(card_line(), flush=True)
        return 0
    if "--mask-rcnn" in sys.argv[1:]:  # its two kernels and its serving
        gather = phase_gather_kernels()
        upsample = phase_upsample_kernels()
        mrcnn, mrcnn_x, mrcnn_step = phase_mask_rcnn(gather, upsample)
        if profile:
            phase_profile("mask_rcnn", mrcnn, mrcnn_x, step_s=mrcnn_step)
        emit({"kernels": [gather, upsample]})
        print(card_line(), flush=True)
        return 0
    if "--resize" in sys.argv[1:]:  # the three resize kernels alone
        records = [phase_upsample_kernels(), phase_train_kernels(),
                   phase_upsample2x_kernels()]
        emit({"kernels": records})
        print(card_line(), flush=True)
        return 0
    if "--train-attention" in sys.argv[1:]:  # this slice's legs alone
        bwd = phase_flash_backward()
        attention_training_legs(bwd, profile)
        phase_backward_profile()
        emit({"kernels": [bwd]})
        print(card_line(), flush=True)
        return 0
    if "--training" in sys.argv[1:]:  # the training legs alone
        emit({"phase": "int8_attention_products",
              "detr_encoder_pv": int8_products_past_1040()})
        bwd = phase_flash_backward()
        attention_training_legs(bwd, profile)
        int8 = {"name": "int8_matmul"}
        training_legs(int8, profile)
        phase_backward_profile()
        emit({"kernels": [bwd, int8]})
        print(card_line(), flush=True)
        return 0
    if "--classification" in sys.argv[1:]:  # the zoo's first half alone
        flash = {"name": "flash_attention"}
        int8 = {"name": "int8_matmul"}
        phase_classification(flash, int8, profile)
        emit({"kernels": [flash, int8]})
        print(card_line(), flush=True)
        return 0
    if "--sequence" in sys.argv[1:]:  # video, OCR, distillation, faces
        flash = {"name": "flash_attention"}
        bwd = {"name": "flash_attention_backward"}
        upsample = {"name": "upsample_add_fused"}
        sep = {"name": "sep_resize"}
        phase_sequence(flash, bwd, upsample, sep, profile)
        emit({"kernels": [flash, bwd, upsample, sep]})
        print(card_line(), flush=True)
        return 0
    classic, faces = ("--classic" in sys.argv[1:],
                      "--faces" in sys.argv[1:])
    if classic or faces:  # the classic CNNs and the face models, alone
        upsample = {"name": "upsample_add_fused"}
        if classic:
            phase_classic(profile)
        if faces:
            phase_faces(upsample, profile)
        emit({"kernels": [upsample]})
        print(card_line(), flush=True)
        return 0
    if "--zoo" in sys.argv[1:]:  # the detection zoo and FCOS training
        gather = {"name": "gather_rows"}
        upsample = {"name": "upsample_add_fused"}
        zoo_legs(gather, upsample, profile, torch.Generator().manual_seed(0))
        leg_fcos_train(profile)
        emit({"kernels": [gather, upsample]})
        print(card_line(), flush=True)
        return 0
    if "--f32-attention" in sys.argv[1:]:  # f32 flash, TrOCR trained
        flash = {"name": "flash_attention"}
        bwd = {"name": "flash_attention_backward"}
        phase_f32_attention(flash, bwd)
        trocr_training(profile, torch.Generator().manual_seed(91))
        emit({"kernels": [flash, bwd]})
        print(card_line(), flush=True)
        return 0
    flash = phase_kernels()
    bwd = phase_flash_backward(flash)
    if "--detectors" in sys.argv[1:]:  # the detector legs alone
        gather = {"name": "gather_rows"}
        upsample = {"name": "upsample_add_fused"}
        phase_detectors(flash, profile, gather, upsample)
        phase_backward_profile()
        emit({"kernels": [{key: flash[key] for key in
                           ("name", "detr_launches", "detr_grids")},
                          gather, upsample]})
        print(card_line(), flush=True)
        return 0
    if "--kernels" in sys.argv[1:]:  # the redesigned kernels alone
        bf16 = phase_bf16_kernels()
        phase_probe(bf16)
        phase_kernel_profile()
        phase_model(flash)
        phase_backward_profile()
        emit({"kernels": [flash, bf16]})
        print(card_line(), flush=True)
        return 0
    int8 = phase_int8_kernels()
    bf16 = phase_bf16_kernels()
    phase_probe(bf16)
    gather = phase_gather_kernels()
    upsample = phase_upsample_kernels()
    sep = phase_train_kernels()
    up2x = phase_upsample2x_kernels()
    vit, vit_x = phase_model(flash)
    resnet16, resnet8, resnet_x = phase_resnet(int8)
    mrcnn, mrcnn_x, mrcnn_step = phase_mask_rcnn(gather, upsample)
    if profile:
        phase_profile("vit_base_patch16_224", vit, vit_x)
        phase_profile("resnet50", resnet16, resnet_x)
        phase_profile("resnet50_int8", resnet8, resnet_x)
        phase_profile("mask_rcnn", mrcnn, mrcnn_x, step_s=mrcnn_step)
    del vit, vit_x, resnet16, resnet8, resnet_x, mrcnn, mrcnn_x
    torch.cuda.empty_cache()
    yolo, yolo8, yolo_x, yolo_step, yolo8_step = phase_yolov3()
    if profile:
        phase_profile("yolov3", yolo, yolo_x, step_s=yolo_step)
        phase_profile("yolov3_int8", yolo8, yolo_x, step_s=yolo8_step)
    del yolo, yolo8, yolo_x
    torch.cuda.empty_cache()
    vit_int8_and_grouped(int8, profile)
    hrnet_seg_leg(profile)
    transformer_legs(flash, profile)
    phase_detectors(flash, profile, gather, upsample)
    phase_padded_flash(flash)
    phase_segmentation(flash, profile)
    phase_remote_sensing(profile)
    phase_classification(flash, int8, profile)
    phase_classic(profile)
    phase_faces(upsample, profile)
    phase_sequence(flash, bwd, upsample, sep, profile)
    phase_train_check()
    phase_train(sep, profile)
    attention_training_legs(bwd, profile)
    training_legs(int8, profile)
    phase_backward_profile()
    phase_data(flash, int8, profile)
    keys = ("name", "route", "source", "replaces", "launches", "max_abs_err",
            "ms", "plain_ms", "bound_ms", "bound_by", "library_ms")
    extra = ("fused_ms", "fused_bound_ms", "fused_library_ms", "forward_ms",
             "vjp_ms", "vit_launches", "grouped_launches", "grouped_ms",
             "grouped_plain_ms", "grouped_bound_ms", "deit_launches",
             "detr_launches", "detr_grids", "bit_launches", "bit_grids",
             "library_op", "qat_launches",
             "qat_ms", "qat_bound_ms", "qat_library_ms",
             "faster_rcnn_launches", "cascade_rcnn_launches",
             "solov2_r50_launches", "tnt_launches", "tnt_grids",
             "se_resnext_int8_launches", "se_resnext_int8_ms",
             "se_resnext_int8_bound_ms", "se_resnext_int8_grouped_ms",
             "se_resnext_int8_grouped_bound_ms",
             "se_resnext_int8_grouped_calls", "retinaface_launches",
             "retinaface_ms", "retinaface_plain_ms", "retinaface_library_ms",
             "retinaface_bound_ms", "sequence_grids",
             "retinaface_train_launches", "retinaface_train_ms",
             "retinaface_train_plain_ms", "retinaface_train_library_ms",
             "retinaface_train_bound_ms", "f32_grids", "export_launches")
    emit({"kernels": [{key: r[key] for key in keys + extra if key in r}
                      for r in (flash, bwd, int8, bf16, gather, upsample,
                                sep, up2x)]})
    print(card_line(), flush=True)
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
