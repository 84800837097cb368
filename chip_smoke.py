#!/usr/bin/env python3
"""Build the port's CUDA kernels and drive its main path on one GPU.

    python3 chip_smoke.py

Runs from the root of a checkout on a machine with an NVIDIA H100 (sm_90a),
the CUDA toolkit (``nvcc``) and PyTorch built for CUDA.  It imports
``deepi2p_tpu_torch`` only, never JAX or the JAX package.  Phases, each
announced as ``phase=<name> start|done t=<seconds>``:

1. ``device``: the card's name and power limit (``nvidia-smi``); fails
   without a CUDA device.  TF32 is switched off for matmuls and cuDNN, so
   every f32 comparison below is a true f32 one.
2. ``build``: one ``nvcc -c`` per ``deepi2p_tpu_torch/csrc/*.cu``, all
   started together, then one link; the native data core (``g++``)
   beside them.
3. ``batch``: the Oxford-shaped synthetic batch (B=32, N=20480, 384x640).
4. ``model``: ``config.oxford(batch_size=32)`` with seeded weights, bf16
   as the config says; one forward gives the labels the solve sees.
5. ``knn``: the kNN kernel against its plain version at the four shapes of
   the forward and at harder inputs of the same shapes on both of the
   kernel's paths (ties, NaN rows and queries, k = M = 16, M = 512 with
   k = 16): indices equal, the same NaN distances, the others within 1e-5
   relative; at the four calls the kernel's time by CUDA events around
   20 calls in a CUDA graph (beside it the ``torch.profiler`` device time,
   which must be found, and CUDA events over 20 calls launched back to
   back), and the times of the plain version and of ``torch.cdist`` +
   ``torch.topk``.
6. ``lm``: the 2-D LM kernel against its plain version at the solve's
   probe and refine shapes, on the model's labels and on those of the
   true pose: the same NaN pattern, costs within 1e-4 relative, theta
   within 1e-3 absolute (both sum in the same order, so what may remain
   is the rounding of the CUDA and PyTorch math functions).  It prints
   each launch's plan (cluster size C, inits per block G, warps per init
   W), the kernel's registers and shared memory and its time against the
   plain version, and checks pairs of 40960 and 81920 points (the longer
   too long for shared memory) at the plans they pick.
7. ``slice``: forward -> argmax -> ``solve_frustum_batch`` (64 inits, 24
   iterations, solver stride 2), three times after one warm-up, with the
   launch counts set to 0 just before; each kernel must have launched
   (4 kNN per forward, 2 LM per solve) and every output must be finite.
8. ``nn1``: the 1-NN kernel against its plain version, bitwise (indices
   equal, distances equal, NaN where the plain version's are), at the
   ICP path's launch shape (8 KITTI clouds, N=20480, each moved by its 64
   inits: 512 query sets against the 8 pseudo clouds of M=5120, 64 sets
   per cloud), at one init group (8 sets) against one cloud cut to
   M=5000 and padded back with 1e6 sentinel rows, as the harness pads,
   and cut to M=5000 unpadded, and on the kernel's hard cases: ties
   across its tracked tiles, NaN rows and all-NaN queries, M=5001
   against N=20479, databases too large for shared memory (streamed),
   and D = 1, 5 and 8.  Each line names the launch plan.  Times of the
   kernel and the plain version at the launch shape, of the kernel and
   ``torch.cdist`` + ``torch.min`` at one init group; then ICP's own
   kernels (``icp_cuda``) at the launch shape: the transform bitwise
   ``_transform``, one update's inlier counts, moments and float64 R, t
   against ``_kabsch`` in float64, each kernel timed against its bound
   and its plain chain; one ICP batch on the card's path against the
   plain path run on the card (the CPU's code: PyTorch ops and
   ``torch.linalg.svd``) from the same inits, poses and fitness; then
   one batch timed and under ``torch.profiler`` (1-NN vs the
   ``icp_cuda`` kernels vs the rest).  The ``eval`` and ``depth`` phases
   hold ``icp_cuda.launches`` to 2 an iteration and 1 for the fitness
   pass in their ICP batches.
9. ``lm6``: the LM kernel's 6-DoF mode (its registers, shared memory and
   local memory printed) against its plain version, bitwise, at the
   6-DoF solve's probe (N=5120, 64 inits, 8 iterations) and refine
   (N=10240, 8 inits, 16 iterations) shapes at the plans they pick, on
   the model's labels, on those of the true pose, and from zero-angle
   inits (the first-order rotation branch), then on pairs of 40960
   (shared memory) and 81920 points (device memory).  The points behind
   any non-finite cost are printed.
10. ``solve6``: forward -> argmax -> ``solve_frustum_batch(is_2d=False)``
    at the main path's settings, three steps after a warm-up: 2 launches
    of the 6-DoF LM per solve, finite poses, pairs/s, and the success
    rate of a solve from the true pose's labels.
11. ``eval``: the evaluation path end to end at the KITTI shape (B=8,
    N=20480, 160x512, street scenes): the seeded detector's
    ``dump_predictions`` into a temporary directory, pseudo clouds from
    the ray-cast depth (stride 4, M=5120), then ``evaluate_registration``
    with ``icp`` (60 inits, 30 iterations), ``frustum`` (on the labels and
    on the predictions) and ``random``: finite summaries, at least 31
    1-NN launches per ICP batch, and kNN and 2-D LM launches.  Then the
    2-D LM kernel at the frustum solve's two launches on the dump's
    labels and predictions (probe B=8 N=5120 I=64, refine N=20480 I=8),
    at the plans they pick, held to the plain version as in ``lm`` and
    timed.
12. ``depth``: the estimated-depth ICP path at the committed depth run's
    shape (``train.depth_cli`` at 160x512, dense street targets, B=8, f32,
    seeded weights), with grad on for its training: 2 warm-up and 10
    timed ``DepthTrainer`` steps on 2 batches made before the clock
    (ms/step, peak memory, the forward's GFLOP); one step (B=2) on the
    card against the CPU (f32: loss within 1e-5, the whole gradient within
    1e-3 of float64's; a float64 copy: loss and every gradient leaf
    within 1e-8); the ``eval`` batch dumped with ``--save-images`` and
    ``eval.cli depth-dump`` of it with the trained weights (``depth.npz``)
    on the card, timed, its depth maps and clouds within 1e-4 of the
    CPU's; ``eval.cli solve --method icp --pseudo-dir`` on the estimated
    clouds: exactly 31 1-NN launches, finite RTE/RRE, s per batch and the
    1-NN's share; the 1-NN held bitwise to its plain version at that
    launch (the harness's scaled, padded estimated clouds).
13. ``serve``: the evaluation stage a user runs on trained weights, on the
    ``eval`` batch with seeded bf16 weights: (a) the port's ``Engine``
    inside ``SubsampleEnsemble`` (classify at N=8192, 2 covers: 6 takes)
    through ``dump_predictions`` with ``save_probs``: kNN launches (4 per
    take) and wall time; (b) ``evaluate_registration(method="pnp")`` from
    the predictions and from the true pose's labels on the card: wall time
    per batch, CUDA kernel launches (``torch.profiler``), the split of
    device time between the draw of the minimal sets, DLT, reprojection
    and polish, finite summaries, and from the labels at least the
    success of the JAX harness on the same dump less one pair; (c) the card's PnP against the port's CPU
    PnP on the same minimal sets: poses within ``PNP_POSE_ATOL``, equal
    inlier counts except for points whose error sits within
    ``PNP_THRESH_BAND`` px of the threshold; (d) a frustum solve with the
    knobs set to their defaults is bitwise the solve without them, and
    other values (probe stride 8, 16 survivors) run their two LM launches
    to finite poses.
14. ``reference``: a small input (``config.tiny()``, f32) through the card
    path and the CPU path (the plain versions, which the CPU tests hold to
    the JAX package): logits and solved poses (2-D and 6-DoF) must agree,
    and ``sample_inits`` from one seeded CPU generator must give equal
    inits with ``ang`` on the card and on the CPU.

15. ``norm``, with grad on: the norm kernel pair (``ops/norm_cuda.py``)
    against its plain version (``Norm.plain`` + ReLU, autograd) at the
    KITTI train step's shapes at B=64 (``profile_norm.shapes``: the
    head's, the point tower's, the ResNet stem's channels-last and NCHW):
    y and the running statistics bitwise, dx within 1e-2, dweight and
    dbias within 1e-3 (norm-wise, relative), two calls bitwise equal, 6
    launches a layer; its forward and backward device times beside its
    bound, the plain version's and ``batch_norm``'s.
    Then ``train``: the training path, with grad on, at the committed
    KITTI-shaped run (``config.kitti`` street scenes, N=8192, 128+128
    nodes, B=8, 160x512, bf16 activations, f32 parameters, seeded
    weights): the kNN kernel against its plain version at the training
    forward's four calls; two batches made before the clock, two warm-up
    steps; from that state and one generator seed, one
    ``Engine.train_step_scan`` of 4 steps (``--steps-per-dispatch``)
    against 3 runs of 4 ``train_step`` calls, cuDNN deterministic: every
    metric, parameter, running statistic and Adam moment bitwise equal,
    or else each part's distance from the nearest run within the runs'
    own spread, and 16 kNN launches per call; then ten timed
    ``Engine.train_step``s ending in a CUDA sync
    (ms/step, samples/s, peak memory), finite losses and exactly 4 kNN
    launches per step, and 3 timed 4-step calls right after (ms/step at
    K=4 beside K=1); twenty steps on one batch must lower the loss;
    ``CheckpointManager`` save -> restore and ``export_npz`` ->
    ``warm_start_npz`` into a temporary directory, exact; then one step
    (B=2) on the card against the same step on the CPU from the same
    weights, batch and dropout uniforms, in f32 and in a float64 copy of
    the model (``train_reference``: f32 loss and metrics within 1e-5,
    running statistics within 1e-5, the whole gradient within 5% of
    float64's; float64 loss, metrics, statistics and every gradient leaf
    within 1e-8).
16. ``data``: the real-dataset path on a KITTI-layout tree written to a
    temporary directory from a seed (sequence 00: 96 frames, 09: 88; each
    60000 points x 7 channels and a 376x1241x3 uint8 image; 32 train and
    16 val samples): the native core loaded; the
    train loader's host samples/s at ``config.kitti(input_pt_num=8192)``
    with 1 and 8 threads; 2 + 10 bf16 train steps (B=8) from the tree
    through 8 loader threads and the pinned prefetch (ms/step and
    samples/s end to end beside the ``train`` phase's, exactly 4 kNN
    launches per step, finite losses, the first prefetched batch bitwise
    its host batch); ``eval.cli dump --dataset kitti`` of the val split at
    ``config.kitti()`` (2 batches of 8, 8 kNN launches) and ``eval.cli
    solve --method frustum`` on the card (finite summary, 2-D LM
    launches), then the 2-D LM held to its plain version at the solve's
    launches on the dump's labels and predictions.  Then JPEGs: every
    committed fixture (``tests/data/torch_port_jpeg``) decoded by the
    port's own decoder at scales 1, 1/2, 1/4 and 1/8 to its ``cv2``
    digest, the 1280x960 frame's decode timed at full and half size; an
    Oxford-layout tree of that frame (32 train and 16 val clouds of 50000
    points) read at ``config.oxford()`` (half-size decode), the train
    loader's samples/s on 1 and 8 threads, ``eval.cli dump --dataset
    oxford`` of the val split (2 batches of 8, 8 kNN launches) and
    ``solve --method frustum`` (2-D LM launches).
17. ``device_data``: batches made on the card at the ``train`` phase's
    configuration (KITTI street, N=8192, 128+128 nodes, B=8, 160x512):
    ``synthetic_batch_device`` timed by CUDA events, its keys, shapes,
    dtypes and finite values; its renderer on the card against the CPU on
    one CPU-made cloud, pose and K (point-pixel masks agree on >= 99.9% of
    pixels); ``train.cli --dataset synthetic --device-data`` for two
    epochs of 12 bf16 steps (exactly 4 kNN launches per train step, finite
    losses, ms/step and samples/s end to end over the second epoch beside
    the ``train`` phase's, the validation batches bitwise equal across the
    epochs); the same run with ``--steps-per-dispatch 4`` (3 calls per
    epoch, 16 kNN launches each, no single step, step 24 at the end,
    ms/step over the second epoch's last 2 calls); 3 single steps under
    ``torch.profiler`` without a host-to-device copy the size of an
    image batch.
18. ``debug``: the ``eval`` batch dumped again with ``viz_dir`` (two PNGs
    per sample, decoded by the port's ``read_png``);
    ``solve_frustum_batch(backend="fast")`` (60 inits, 32 iterations, the
    first 4 pairs) on the card against the CPU from the same inits: poses within 1e-3 and
    costs within 1e-4 relative, apart from pairs whose answers put a
    point on different sides of a frame edge or centre line (the kinks of
    the cost), which are counted; ``eval.cli solve --method frustum
    --debug-vis``: four ``{"debug_vis": ...}`` lines, three decodable
    PNGs each, finite numbers; ``KNNModule``, ``KNNFusionModule`` and
    ``query_topk`` on the card against the CPU (within 1e-4, 3 kNN
    launches); the frustum quality gate of
    ``tests/test_torch_port_quality_gates.py`` on the card with labels
    from the port's ``noise.flip_border_band`` and ``flip_iid``: at least
    4 of 6 solved.
19. ``prep``: the offline prep tools on raw files (``data/prep``), with
    the host CPU's model and the card's name beside their times: 4 raw
    velodyne scans (64 beams x 1875 azimuths, 120000 x 4 points) and 4
    PNGs of 376x1241 through the KITTI prep (voxel 0.1, normals, images
    bitwise their pixels, poses), the prepared frames cycled into an
    88-frame sequence read by the ``KittiLoader`` and 2 bf16 train steps
    on the card (4 kNN launches each); a raw Oxford traversal (VO, LMS
    scans, 4 Bayer PNGs of 1280x960, a LUT) through ``build_traversal``
    (s per image: demosaic, undistortion, JPEG), its JPEGs through the
    ``OxfordLoader`` into ``eval.cli dump --dataset oxford`` on the card;
    the JPEG encoder's bytes against the committed ``cv2.imencode``
    digests (``tests/data/torch_port_jpeg_encode``) and a 1280x960
    encode timed; ``build_dataset_info`` on a one-scene nuScenes tree.
20. ``parallel``: two gloo ranks on the one card
    (``parallel/dryrun.py``): the DP step of the KITTI-shaped config at
    B=8 (4 per rank, f32) against rank 0's one-rank step at B=8 (the
    float64 copy's gradient within 1e-8, the loss within 1e-5,
    parameters bitwise equal across ranks), a 1x2 TP step (wide Linears
    split, the float64 gradient within 1e-8); the sharded Oxford B=32
    registration (16 pairs per rank) in 2-D and 6-DoF against the
    one rank solving in chunks of a rank's pairs, with the same pair
    generators: inits bitwise, poses and costs at the JAX dry run's
    bounds, at its solve (8 inits, 4 iterations; 4 kNN and 1 LM launch
    per rank) and at the main path's (64 inits, 24 iterations, stride 2;
    4 kNN and 2 LM launches per rank); on the TP layout, the JAX dry run's
    point-axis sharding (each rank holds half of the clouds' points,
    gathered at the step's entry): the eval loss within 1e-3 relative of
    the DP layout's and a train step from it to a finite loss, parameters
    bitwise equal across ranks; then ``train.cli`` at world size 1 over
    NCCL for 2 steps in one ``--steps-per-dispatch 2`` call, in this
    process with the environment ``torch.distributed.run`` sets.

Then a ``kernels=`` line, one JSON line of per-kernel numbers (launches
from the path each kernel serves: ``slice`` for kNN and the 2-D LM,
``solve6`` for the 6-DoF LM, ``eval`` for the 1-NN; the kNN entry also
carries ``train_launches_per_step``, ``train_scan_launches_per_call``
and ``device_data_scan_launches_per_call`` (4-step calls),
``data_launches_per_step``,
``device_data_launches_per_step``, ``debug_launches``,
``prep_launches_per_step`` and ``rank_launches`` (per rank of the
``parallel`` registration), the 2-D LM ``data_solve_launches``,
``oxford_solve_launches`` and ``rank_launches``, the 6-DoF LM
``rank_launches``, the 1-NN ``depth_launches``), the card's
``nvidia-smi`` name and power limit, and as the last line
``{"ok": true, "device": {...}}``.  A watchdog ends a hung run after
420 s with a traceback and a nonzero exit; any failed check exits nonzero
before the last line is printed.
"""
from __future__ import annotations

import contextlib
import faulthandler
import json
import math
import subprocess
import sys
import tempfile
import time

WATCHDOG_S = 420
T0 = time.perf_counter()

# main-path settings (the JAX package's bench.py)
BATCH = 32
N_INITS = 64
MAX_ITER = 24
SOLVER_STRIDE = 2
PROBE_ITER = 8

# H100 SXM peaks (NVIDIA data sheet): f32 outside the tensor cores, HBM3
PEAK_F32_OPS = 67e12
PEAK_F64_OPS = 34e12
PEAK_BYTES = 3.35e12

# the evaluation path (KITTI shape, the JAX icp_batch defaults)
EVAL_BATCH = 8
ICP_INITS = 60        # rounded up to 64 by init_chunk=8
ICP_ITERS = 30
PSEUDO_STRIDE = 4     # 160x512 depth -> M = 5120 pseudo points
NN1_SETS = 8          # one ICP init group

EVAL_INITS = 60      # the harness's frustum defaults (60 inits, 32
EVAL_MAX_ITER = 32   # iterations, every point)

# the serve phase: the subset ensemble of the JAX headline runs
# (ckpts/kitti_shape_r4, trained at N=8192) with 2 covers
SERVE_CLASSIFY_N = 8192
SERVE_REPEATS = 2
# PnP from the true pose's labels on the serve dump (config.kitti street
# scenes, B=8, seed 0): the JAX package's harness (method="pnp",
# use_labels, seed 0) solves 8 of 8 pairs on the CPU, as
# tests/test_torch_port_serve_floor.py measures and checks
PNP_LABELS_JAX_SUCCESS = 8
PNP_POSE_ATOL = 1e-3
PNP_THRESH_BAND = 1e-3

# the train phase: the committed KITTI-shaped training run
# (scripts/train_kitti_shape.sh: config.kitti street, N=8192, 128+128
# nodes, B=8, 160x512, bf16 activations, f32 parameters)
TRAIN_N = 8192
TRAIN_NODES = 128
TRAIN_WARMUP = 2
TRAIN_TIMED = 10
TRAIN_LEARN = 20
TRAIN_REF_BATCH = 2      # the card-against-CPU steps
TRAIN_SCAN_K = 4         # train_step_scan: K steps per call
TRAIN_SCAN_RUNS = 3      # runs of K single steps from one state
TRAIN_SCAN_CALLS = 3     # timed K-step calls
TRAIN_LOSS_RTOL = 1e-5
# the norm phase: the kernel pair against its plain version at the
# B = 64 train step's shapes, bf16: y and the running statistics bitwise
# (the same statistics, the same operations); the gradients norm-wise
# relative (the closed form rounds at other points than autograd's f32
# chain, then both round dx to bf16, 2^-8; the sums are f32)
NORM_BATCH = 64
NORM_RTOL = dict(dx=1e-2, dweight=1e-3, dbias=1e-3)
TRAIN_STATS_RTOL = 1e-5
# the f32 step's whole gradient against the float64 one: a gross check
# only, since f32 does not resolve this network's gradient leaf by leaf
# (train_reference)
TRAIN_F32_GRAD_RTOL = 5e-2
# the float64 copy: each gradient leaf, the loss and metrics, and the
# running statistics, card against CPU
TRAIN_F64_RTOL = 1e-8
# a gradient leaf both devices give as rounding noise (zero in exact
# arithmetic: biases that feed train-mode batch norm) stays below this
# fraction of the whole gradient's norm
TRAIN_NOISE_LEAF = 1e-6
# the data phase: a KITTI-layout tree (40 frames skipped at each end: 32
# train and 16 val samples), the loader at 1 and DATA_WORKERS threads,
# DATA_STEPS train steps from it, the dump of the val tree.  The loader is
# timed over one epoch of the 32 samples cycled (no epoch restart inside a
# window): the first DATA_WORKERS batches (all started together) untimed,
# then DATA_RATE_BATCHES; training times DATA_STEPS steps once a step has
# waited DATA_DRAINED_MS for its batch (or after DATA_DRAIN_MAX steps).
# With a 32-batch 8-thread window, 16 timed steps and a drain of 24 this
# phase took 146-160 s on some H100 hosts, and the whole smoke 351-379 s
# of its 420 s watchdog; these windows are half as long
DATA_TRAIN_FRAMES = 96
DATA_VAL_FRAMES = 88
DATA_POINTS = 60000
DATA_DISTINCT = 8
DATA_WORKERS = 8
DATA_RATE_BATCHES = {1: 3, DATA_WORKERS: 2 * DATA_WORKERS}
DATA_PROC_SAMPLES = 6    # per process, DATA_WORKERS processes
DATA_STEPS = 8
DATA_WARMUP = 2
DATA_DRAIN_MAX = 12
DATA_DRAINED_MS = 20.0

# the data phase's Oxford tree: the committed 1280x960 fixture JPEG (what
# data/prep/oxford_prep.py writes) for every camera frame, decoded at half
# size at config.oxford(); 32 train and 16 val clouds of OX_POINTS points
JPEG_FIXTURES = "tests/data/torch_port_jpeg"
OXFORD_JPEG = "oxford_1280x960_420_q95.jpg"
OX_TRAIN, OX_VAL = 32, 16
OX_POINTS = 50000
DECODE_REPS = 20

# the depth phase: the committed depth checkpoint's run
# (ckpts/depth_kitti_160x512_dense: train.depth_cli at 160x512 on dense
# street targets, B=8, f32 as config.tiny sets it), seeded weights
DEPTH_H, DEPTH_W = 160, 512
DEPTH_BATCH = 8
DEPTH_LR = 3e-4
DEPTH_WARMUP = 2
DEPTH_TIMED = 10
DEPTH_REF_BATCH = 2       # the card-against-CPU step
DEPTH_LOSS_RTOL = 1e-5
# the whole f32 gradient, card against the CPU's f32 and float64 ones
# (5.5e-05 and 3.0e-05 on an H100); a control step with TF32 convolutions
# must read above it, so the check sees a loss of precision.  A float64
# copy holds every gradient leaf, card against CPU.
DEPTH_F32_GRAD_RTOL = 1e-4
DEPTH_F64_RTOL = 1e-8
DEPTH_MAP_RTOL = 1e-4

KNN_RTOL = 1e-5
LM_COST_RTOL = 1e-4
LM_THETA_ATOL = 1e-3
REF_LOGIT_RTOL = 1e-4
REF_POSE_ATOL = 1e-3

# the device_data phase: train.cli --device-data at the train phase's
# configuration; the debug phase: the eval batch's dump
DD_STEPS = 12            # train steps per --device-data epoch
DD_K = 4                 # --steps-per-dispatch of the second run
DD_VAL = 16              # validation samples: 2 batches
DD_BATCH_REPS = 10       # synthetic_batch_device calls timed
DD_PROFILED = 3          # device-data steps under torch.profiler
RENDER_AGREE = 0.999     # point-pixel masks, card against CPU
DEBUG_INITS = 60         # the harness's frustum solve
DEBUG_ITERS = 32
# the fast-solve check takes 4 of the eval batch's 8 pairs: the CPU side
# of all 8 took 37.062 s on the host of an NVIDIA H100 80GB HBM3 (700.00 W)
DEBUG_FAST_PAIRS = 4
DEBUG_MODULE_RTOL = 1e-4
GATE_PAIRS = 6

# the prep phase: 4 raw velodyne scans (a 64-beam ring pattern, 120000 x 4)
# and 4 PNGs of 376x1241 through the port's KITTI prep (8 took 13.4-13.6
# s of the smoke on an H100 host), the 4 prepared frames cycled into a
# sequence of 88 (the loader skips 40 frames at each
# end: 16 train samples); a raw Oxford traversal of 4 Bayer PNGs of
# 1280x960 and a LUT through build_traversal
PREP_SCANS = 4
PREP_BEAMS, PREP_AZIMUTHS = 64, 1875
PREP_SEQ_FRAMES = 88
PREP_WORKERS = 8
PREP_STEPS = 2
PREP_OX_IMAGES = 4
PREP_ENCODE_REPS = 5
PREP_ENCODE_DIGESTS = "tests/data/torch_port_jpeg_encode"

# the parallel phase: two gloo ranks on the one card
PAR_RANKS = 2
PAR_BATCH = 8            # the KITTI-shaped step, 4 per rank
PAR_STEPS = 2            # the first held to one rank's, the second timed
PAR_CLI_K = 2            # --steps-per-dispatch of the NCCL train.cli run
PAR_PAIRS = 32           # the Oxford registration, 16 per rank
# held at the JAX dry run's bounds to one rank solving in chunks of a
# rank's 16 pairs, at the dry run's solve (8 inits, 4 iterations: one LM
# launch, no halving) and at the main path's (64 inits, 24 iterations,
# stride 2): the LM kernel's plan (its warps per init) follows the
# launch's pairs, and the sum order of another plan moved 4 of 512 pose
# entries of a whole-batch solve by up to 3.5e-4 on an H100 at the dry
# run's solve, and 17 of 512 by up to 0.325 at the main path's
PAR_HELD = (8, 4, 1)
PAR_MAIN = (64, 24, 2)
PAR_LOSS_RTOL = 1e-5
PAR_GRAD64_ATOL = 1e-8
# accuracies, precision and recall: one point whose argmax rounding flips
# moves them by 1/65536 at B=8, N=8192
PAR_RATIO_ATOL = 1e-4
# the running statistics are held in the float64 copy; the f32 ones are
# printed (a channel whose mean dwarfs its spread loses most of its
# variance's digits in f32)
PAR_STATS64_RTOL = 1e-6


def log(msg: str) -> None:
    print(msg, flush=True)


class CheckFailed(RuntimeError):
    pass


def require(ok: bool, msg: str) -> None:
    if not ok:
        raise CheckFailed(msg)


@contextlib.contextmanager
def phase(name: str):
    log(f"phase={name} start t={time.perf_counter() - T0:.1f}")
    yield
    log(f"phase={name} done t={time.perf_counter() - T0:.1f}")


def cuda_ms(torch, fn, reps: int) -> float:
    """Mean device time of ``fn()`` in ms, by CUDA events, after a warm-up
    call."""
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def dev_us(e) -> float:
    """Device time of a profiler event average, in us."""
    for key in ("self_device_time_total", "self_cuda_time_total"):
        if getattr(e, key, None) is not None:
            return float(getattr(e, key))
    return 0.0


def kernel_device_ms(torch, fn, reps: int, kernel: str,
                     tries: int = 6) -> float:
    """Mean device time in ms of the launches of kernels whose name holds
    ``kernel`` in ``reps`` calls of ``fn()``, from ``torch.profiler``
    after a warm-up call.  A trace that holds no such launch (one profiler
    session in sixteen on the H100 came back without it, and once three
    in a row did) is traced again, up to ``tries`` sessions; then the
    check fails, naming what each trace held."""
    fn()
    torch.cuda.synchronize()
    acts = [torch.profiler.ProfilerActivity.CUDA]
    seen = []
    for _ in range(tries):
        with torch.profiler.profile(activities=acts) as prof:
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
        evs = [e for e in prof.key_averages() if kernel in e.key]
        count = sum(e.count for e in evs)
        total = sum(dev_us(e) for e in evs)
        if count == reps and total > 0:
            return total / count / 1e3
        seen.append((count, round(total, 3)))
        time.sleep(0.5)
    raise CheckFailed(f"{tries} profiler traces hold no {reps} device "
                      f"launches of {kernel!r}: (launches, us) {seen}")


def nvidia_smi() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def frustum_labels(torch, pc, P, K, H: int, W: int):
    """Inside-frustum labels of the true pose (B, N) int64."""
    cam = pc @ P[:, :3, :3].transpose(1, 2) + P[:, None, :3, 3]
    hom = cam @ K.transpose(1, 2)
    z = hom[..., 2]
    px, py = hom[..., 0] / z, hom[..., 1] / z
    inside = (px >= 0) & (px <= W - 1) & (py >= 0) & (py <= H - 1) & (z > 0.1)
    return inside.long()


def check_knn(torch, name, q, db, k):
    """The kNN kernel against its plain version on one input: indices
    equal and in range, the same NaN distances, the others within
    KNN_RTOL of the largest; returns the max abs error of the finite
    distances."""
    from deepi2p_tpu_torch import _build
    from deepi2p_tpu_torch.ops import knn_plain
    from deepi2p_tpu_torch.ops.knn_cuda import knn_cuda

    B, N, _ = q.shape
    path = "warp" if _build.load_library().knn_path(B, N) else "rows"
    d2_k, idx_k = knn_cuda(q, db, k)
    d2_p, idx_p = knn_plain(q, db, k)
    torch.cuda.synchronize()
    require(bool(torch.equal(idx_k, idx_p)),
            f"knn {name}: indices differ from the plain version at "
            f"{int((idx_k != idx_p).sum())} places")
    require(int(idx_k.min()) >= 0 and int(idx_k.max()) < db.shape[1],
            f"knn {name}: index out of range")
    nan_k, nan_p = torch.isnan(d2_k), torch.isnan(d2_p)
    require(bool(torch.equal(nan_k, nan_p)),
            f"knn {name}: NaN distances differ from the plain version")
    fin = ~nan_p
    err = float((d2_k - d2_p).abs()[fin].max()) if bool(fin.any()) else 0.0
    scale = float(d2_p.abs()[fin].max()) if bool(fin.any()) else 0.0
    rel = err / max(scale, 1e-30)
    require(rel <= KNN_RTOL, f"knn {name}: d2 rel err {rel:.3g}")
    log(f"knn {name}: B={B} N={N} M={db.shape[1]} k={k} path={path}: "
        f"indices equal, NaN distances {int(nan_p.sum())}, d2 max abs err "
        f"{err:.3g}")
    return err


def knn_hard_cases(torch, pc, na, nb):
    """Inputs where the kernel's integer key and warp selection could part
    from a stable sort, at the forward's shapes (N=20480: the rows path;
    N=128: the warp path): duplicated database rows with queries on them
    (ties), NaN database rows and NaN queries, k = M = 16 (also with NaN
    rows, which then fill the last places), and M = 512 with k = 16."""
    gen = torch.Generator(device="cpu").manual_seed(7)

    def dup(db):
        db = db.clone()
        half = db.shape[1] // 2
        db[:, half:2 * half] = db[:, :half]
        return db

    def on_rows(q, db):
        q = q.clone()
        n = min(q.shape[1], db.shape[1])
        q[:, :n] = db[:, :n]
        return q

    def nans(x, every):
        x = x.clone()
        x[:, ::every] = float("nan")
        return x

    big = pc[:, ::40][:, :512].contiguous()           # (B, 512, 3)
    jitter = torch.rand(big.shape, generator=gen).to(big.device) * 1e-3
    big = (big + jitter).contiguous()
    cases = []
    for tag, q in (("rows", pc), ("warp", nb)):
        cases += [
            (f"ties ({tag})", on_rows(q, dup(na)), dup(na), 3),
            (f"ties k=16 ({tag})", on_rows(q, dup(na)), dup(na), 16),
            (f"NaN rows and queries ({tag})", nans(q, 97 if tag == "rows"
                                                   else 9),
             nans(na, 17), 16),
            (f"k=M=16 ({tag})", q, na[:, :16].contiguous(), 16),
            (f"k=M=16 with NaN rows ({tag})", q, nans(na[:, :16], 5), 16),
            (f"M=512 k=16 ({tag})", q, big, 16),
        ]
    return [(n, q.contiguous(), db.contiguous(), k) for n, q, db, k in cases]


def knn_phase(torch, batch, cfg):
    from deepi2p_tpu_torch.ops import knn_plain
    from deepi2p_tpu_torch.ops.knn_cuda import knn_cuda
    from deepi2p_tpu_torch.profile_knn import forward_calls, graph_ms

    pc, na, nb = batch["pc"], batch["node_a"], batch["node_b"]
    calls = forward_calls(batch, cfg)
    row = dict(ms=0.0, plain_ms=0.0, library_ms=0.0, bound_ms=0.0,
               max_abs_err=0.0, bound_by=None)
    event_total = device_total = 0.0
    for name, q, db, k in knn_hard_cases(torch, pc, na, nb):
        row["max_abs_err"] = max(row["max_abs_err"],
                                 check_knn(torch, name, q, db, k))
    for name, q, db, k in calls:
        err = check_knn(torch, name, q, db, k)
        # the kernel's time: CUDA events around 20 calls in a CUDA graph;
        # beside it the profiler's device time and CUDA events over 20
        # calls launched back to back from Python (the earlier yardstick,
        # which for the N=128 calls is the wrapper's launch rate)
        ms = graph_ms(lambda: knn_cuda(q, db, k), 20)
        device_ms = kernel_device_ms(torch, lambda: knn_cuda(q, db, k), 20,
                                     "knn_")
        event_ms = cuda_ms(torch, lambda: knn_cuda(q, db, k), 20)
        plain_ms = cuda_ms(torch, lambda: knn_plain(q, db, k), 3)
        lib_ms = cuda_ms(torch, lambda: torch.topk(
            torch.cdist(q, db), k, dim=-1, largest=False), 5)
        B, N, D = q.shape
        M = db.shape[1]
        nbytes = 4 * (B * N * D + B * M * D) + 8 * B * N * k
        ops = B * N * M * (3 * D - 1 + 1)   # distance, then one compare
        t_bytes, t_ops = nbytes / PEAK_BYTES * 1e3, ops / PEAK_F32_OPS * 1e3
        bound = max(t_bytes, t_ops)
        log(f"knn {name}: B={B} N={N} M={M} D={D} k={k} ms={ms:.4f} "
            f"(CUDA events over 20 calls in a CUDA graph; profiler device "
            f"time {device_ms:.4f}; CUDA events over 20 calls back to back "
            f"{event_ms:.4f}) plain_ms={plain_ms:.4f} library_ms={lib_ms:.4f} "
            f"bound_ms={bound:.5f} max_abs_err={err:.3g}")
        event_total += event_ms
        device_total += device_ms
        row["ms"] += ms
        row["plain_ms"] += plain_ms
        row["library_ms"] += lib_ms
        row["bound_ms"] += bound
        row["bound_by"] = "operations" if t_ops >= t_bytes else "bytes"
        row["max_abs_err"] = max(row["max_abs_err"], err)
    log(f"knn: the four calls {row['ms']:.4f} ms (CUDA events, CUDA graph), "
        f"profiler device time {device_total:.4f}, CUDA events back to back "
        f"{event_total:.4f}; bound {row['bound_ms']:.5f}")
    return row


def same_bits(torch, a, b) -> bool:
    """Equal values, NaN where the other has NaN."""
    return bool(((a == b) | (torch.isnan(a) & torch.isnan(b))).all())


def compare_lm(torch, tag, args, kw, bitwise: bool = False):
    """Kernel vs plain LM on the same inputs; NaN where one has NaN; with
    ``bitwise``, every cost and theta equal."""
    from deepi2p_tpu_torch.register import lm_solve_cuda, lm_solve_plain

    th_k, c_k = lm_solve_cuda(*args, **kw)
    th_p, c_p = lm_solve_plain(*args, **kw)
    torch.cuda.synchronize()
    require(bool(torch.equal(torch.isnan(c_k), torch.isnan(c_p))
                 and torch.equal(torch.isnan(th_k), torch.isnan(th_p))),
            f"lm {tag}: NaN pattern differs from the plain version")
    if bitwise:
        require(same_bits(torch, c_k, c_p) and same_bits(torch, th_k, th_p),
                f"lm {tag}: not bitwise equal to the plain version: costs "
                f"{int((c_k != c_p).sum())}, theta entries "
                f"{int((th_k != th_p).sum())} differ")
    fin = torch.isfinite(c_p)
    crel = float(((c_k - c_p).abs() / c_p.abs().clamp(min=1e-6))[fin]
                 .max()) if bool(fin.any()) else 0.0
    tfin = torch.isfinite(th_p)
    terr = float((th_k - th_p).abs()[tfin].max()) if bool(tfin.any()) else 0.0
    log(f"lm {tag}: cost max rel err {crel:.3g}, theta max abs err "
        f"{terr:.3g}; bitwise equal costs {int((c_k == c_p).sum())} of "
        f"{c_k.numel()}, non-finite costs {int((~fin).sum())}, non-finite "
        f"theta entries {int((~tfin).sum())}")
    require(crel <= LM_COST_RTOL, f"lm {tag}: cost rel err {crel:.3g}")
    require(terr <= LM_THETA_ATOL, f"lm {tag}: theta abs err {terr:.3g}")
    return th_p, c_p, terr


def lm_streamed_check(torch, batch, cfg, P: int = 4):
    """Pairs longer than the main path's, at the plan each one picks in
    mode P: two Oxford clouds end to end (40960 points, clusters of 8 that
    keep them in shared memory) and four (81920 points, more than 8 blocks
    keep, so the kernel reads them from device memory in each sweep); held
    to the plain version (P=6: bitwise)."""
    from deepi2p_tpu_torch.register import initial_guess, sample_inits
    from deepi2p_tpu_torch.register.frustum_cuda import lm_layout, lm_plan

    pc4 = batch["pc"][:4]
    for pc, resident in ((torch.cat([pc4[0:2], pc4[2:4]], dim=1), True),
                         (pc4.reshape(1, -1, 3), False)):
        pc = pc.contiguous()
        labels = torch.ones(pc.shape[:2], device=pc.device)
        ang, valid = initial_guess(pc, labels)
        theta = sample_inits(torch.Generator().manual_seed(4), ang, 8,
                             is_2d=P == 4)
        B, N, _ = pc.shape
        C, G, W = lm_plan(B, N, theta.shape[1], P)
        S, res = lm_layout(N, C, W)
        where = ("shared memory" if res else
                 f"device memory: {W * S} points per block")
        require(res == resident, f"lm: the {N}-point pair's plan keeps its "
                f"points in {where}")
        args = (pc, labels, valid.contiguous(),
                batch["K"][:B].contiguous(), theta.contiguous(),
                (-5.0, -0.1, -10.0), (5.0, 0.1, 10.0))
        compare_lm(torch, f"P={P} long pair (B={B} N={N}, C={C} G={G} "
                   f"W={W}, points in {where})", args,
                   dict(H=cfg.img_H, W=cfg.img_W, max_iter=3),
                   bitwise=P == 6)


def lm_bound(inputs, I: int, iters: int, P: int):
    """(bound ms, bound_by) of one LM launch from its inputs: the ops this
    launch's labels need (``lm_ops``: each point at its label's count, a
    cost-only last sweep) against each input read once (points, labels,
    valid, K, theta0) and each output written once (theta, cost)."""
    from deepi2p_tpu_torch.register.frustum_cuda import lm_ops
    B, N, _ = inputs[0].shape
    ops = lm_ops(inputs[1], I, iters, P)
    nbytes = 4 * (5 * B * N + 9 * B + 2 * P * B * I + B * I)
    t_bytes = nbytes / PEAK_BYTES * 1e3
    t_ops = ops / PEAK_F32_OPS * 1e3
    return max(t_bytes, t_ops), ("operations" if t_ops >= t_bytes
                                 else "bytes")


def lm_halving(torch, tag, pc, labels, K, *, H: int, W: int,
               solver_stride: int, n_inits: int, max_iter: int,
               timed: bool):
    """The 2-D LM kernel against its plain version at the two launches of
    ``solve_frustum_batch``'s halving solve on these inputs, at the plan
    each launch picks: the probe (every 4th point, the inits padded to a
    multiple of 8, 8 iterations), then the refine of the probe's best
    eighth on every ``solver_stride``-th point.  With ``timed``, each
    launch is timed (CUDA events over 5 launches) beside its plain version
    and its bound; returns one dict per launch."""
    from deepi2p_tpu_torch.register import (initial_guess, lm_solve_cuda,
                                            lm_solve_plain, sample_inits)
    from deepi2p_tpu_torch.register.frustum import I_BLK
    from deepi2p_tpu_torch.register.frustum_cuda import (lm_plan,
                                                         lm_smem_bytes)

    kw = dict(H=H, W=W)
    t_lb, t_ub = (-5.0, -0.1, -10.0), (5.0, 0.1, 10.0)
    ang, valid = initial_guess(pc, labels)
    theta = sample_inits(torch.Generator().manual_seed(1), ang, n_inits)
    pad = (-theta.shape[1]) % I_BLK
    theta = torch.cat([theta, theta[:, :1].expand(-1, pad, -1)], 1)
    theta = theta.contiguous()
    s, ps = solver_stride, max(1, 4 // solver_stride)
    probe_iter = min(8, max_iter)
    keep = max((theta.shape[1] // 8) // I_BLK * I_BLK, I_BLK)

    def sub(x, stride):
        return x[:, ::stride].contiguous()

    full = [sub(x, s) for x in (pc, labels.float(), valid)]
    probe = [sub(x, ps) for x in full]
    rows = []
    for name, inputs, iters in (("probe", probe, probe_iter),
                                ("refine", full, max_iter - probe_iter)):
        args = (*inputs, K, theta, t_lb, t_ub)
        B, N, _ = inputs[0].shape
        I = theta.shape[1]
        C, G, Wp = lm_plan(B, N, I, 4)
        th_p, c_p, terr = compare_lm(
            torch, f"{name} ({tag}, B={B} N={N} I={I} iters={iters}, "
            f"C={C} G={G} W={Wp})", args, dict(kw, max_iter=iters))
        row = dict(name=name, err=terr)
        if timed:
            row["ms"] = cuda_ms(torch, lambda: lm_solve_cuda(
                *args, max_iter=iters, **kw), 5)
            row["plain_ms"] = cuda_ms(torch, lambda: lm_solve_plain(
                *args, max_iter=iters, **kw), 1)
            row["bound_ms"], row["bound_by"] = lm_bound(inputs, I, iters, 4)
            log(f"lm {name} ({tag}): B={B} N={N} I={I} iters={iters} "
                f"C={C} G={G} W={Wp}: grid {(-(-I // G)) * C}x{B} blocks "
                f"of {32 * G * Wp} threads in clusters of {C}, "
                f"{lm_smem_bytes(N, C, Wp)} B dynamic shared memory per "
                f"block: ms={row['ms']:.4f} plain_ms={row['plain_ms']:.4f} "
                f"bound_ms={row['bound_ms']:.5f}")
        rows.append(row)
        if name == "probe":
            top = torch.argsort(c_p, dim=1, stable=True)[:, :keep]
            theta = torch.gather(
                th_p, 1, top[:, :, None].expand(-1, -1, 4)).contiguous()
    return rows


def log_lm_attrs(P: int) -> None:
    from deepi2p_tpu_torch.register.frustum_cuda import lm_attrs

    attrs = lm_attrs(P)
    log(f"lm: P={P} kernel {attrs['regs']} registers per thread, "
        f"{attrs['static_smem']} B static shared memory, "
        f"{attrs['spill_bytes']} B local memory per thread (spills and "
        f"stack; the build's ptxas lines split them), at most "
        f"{attrs['max_threads']} threads per block")


def lm_phase(torch, batch, cfg, pred):
    """The 2-D LM kernel at the main path's probe and refine, on its own
    inputs (the seeded model's labels) and on the labels of the true
    pose; pairs too long for one cluster's shared memory."""
    log_lm_attrs(4)
    pc, K = batch["pc"], batch["K"].contiguous()
    truth = frustum_labels(torch, pc, batch["P"], batch["K"], cfg.img_H,
                           cfg.img_W)
    row = dict(ms=0.0, plain_ms=0.0, library_ms=None, bound_ms=0.0,
               max_abs_err=0.0, bound_by=None)
    for lab_name, labels in (("truth labels", truth), ("model labels", pred)):
        timed = lab_name == "model labels"
        for r in lm_halving(torch, lab_name, pc, labels, K, H=cfg.img_H,
                            W=cfg.img_W, solver_stride=SOLVER_STRIDE,
                            n_inits=N_INITS, max_iter=MAX_ITER, timed=timed):
            row["max_abs_err"] = max(row["max_abs_err"], r["err"])
            if timed:
                for key in ("ms", "plain_ms", "bound_ms"):
                    row[key] += r[key]
                row["bound_by"] = r["bound_by"]
    lm_streamed_check(torch, batch, cfg)
    return row


def slice_phase(torch, model, batch, cfg):
    from deepi2p_tpu_torch.ops.knn_cuda import knn_cuda
    from deepi2p_tpu_torch.register import lm_solve_cuda, solve_frustum_batch

    gen = torch.Generator(device="cuda").manual_seed(0)
    args = [batch[k] for k in ("pc", "intensity", "sn", "node_a", "node_b",
                               "img")]

    def forward():
        coarse, fine = model(*args)
        return coarse, fine, torch.argmax(coarse, dim=-1)

    def solve(pred):
        return solve_frustum_batch(batch["pc"], pred, batch["K"], H=cfg.img_H,
                                   W=cfg.img_W, generator=gen,
                                   n_inits=N_INITS, max_iter=MAX_ITER,
                                   solver_stride=SOLVER_STRIDE)

    steps = 3
    _, _, pred = forward()                       # warm-up
    solve(pred)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    knn_cuda.launches = 0
    lm_solve_cuda.launches = 0
    t = time.perf_counter()
    outs = []
    for _ in range(steps):
        coarse, fine, pred = forward()
        P, cost = solve(pred)
        outs.append((coarse, fine, P, cost))
    torch.cuda.synchronize()
    dt = time.perf_counter() - t
    launches = {"knn": knn_cuda.launches, "lm_solve_p4": lm_solve_cuda.launches}
    log(f"slice: launches {launches} in {steps} steps")
    require(launches["knn"] == 4 * steps,
            f"knn launches {launches['knn']} != {4 * steps}")
    require(launches["lm_solve_p4"] == 2 * steps,
            f"lm launches {launches['lm_solve_p4']} != {2 * steps}")
    B, N = batch["pc"].shape[:2]
    for i, (coarse, fine, P, cost) in enumerate(outs):
        require(tuple(coarse.shape) == (B, N, 2), "coarse logits shape")
        require(tuple(fine.shape) == (B, N, cfg.num_fine_classes),
                "fine logits shape")
        require(tuple(P.shape) == (B, 4, 4) and tuple(cost.shape) == (B,),
                "pose / cost shape")
        for name, x in (("coarse", coarse), ("fine", fine), ("P", P),
                        ("cost", cost)):
            bad = (~torch.isfinite(x)).reshape(B, -1).any(1).nonzero().flatten()
            require(bad.numel() == 0,
                    f"step {i}: non-finite {name} in pairs {bad.tolist()}")
    peak = torch.cuda.max_memory_allocated()
    inside = float(outs[-1][0].argmax(-1).float().mean())

    fwd_ms = cuda_ms(torch, forward, steps)
    solve_ms = cuda_ms(torch, lambda: solve(pred), steps)
    log(f"slice: {steps} steps of B={B} in {dt:.4f} s -> "
        f"{steps * B / dt:.2f} pairs/s; forward {fwd_ms:.3f} ms, solve "
        f"{solve_ms:.3f} ms per batch (CUDA events); peak memory "
        f"{peak / 2**30:.3f} GiB; predicted-inside share {inside:.3f}; "
        f"card {torch.cuda.get_device_name(0)}")
    return launches


def kitti_eval_batch(torch, seed: int = 0):
    """The evaluation path's batch: ``config.kitti`` street scenes at B=8,
    N=20480, 160x512, with the ray-cast dense depth the pseudo clouds come
    from (numpy, host side)."""
    from deepi2p_tpu_torch import config
    from deepi2p_tpu_torch.data import synthetic_batch

    cfg = config.kitti(synthetic_scene="street", batch_size=EVAL_BATCH)
    return cfg, synthetic_batch(cfg, seed=seed, with_depth=True,
                                dense_depth=True)


def check_nn1(torch, name, q, db):
    """The 1-NN kernel against its plain version on one input, bitwise:
    indices equal and in range, distances equal (NaN where the plain
    version's are).  Returns the max abs error of the finite distances
    (0) and the kernel's indices."""
    from deepi2p_tpu_torch.ops import nn1_plain
    from deepi2p_tpu_torch.ops.knn_cuda import nn1_card, nn1_cuda, nn1_plan

    d2_k, idx_k = nn1_cuda(q, db)
    d2_p, idx_p = nn1_plain(q, db)
    torch.cuda.synchronize()
    S, N, D = q.shape
    B, M, _ = db.shape
    require(bool(torch.equal(idx_k, idx_p)),
            f"nn1 {name}: indices differ from the plain version at "
            f"{int((idx_k != idx_p).sum())} places")
    require(int(idx_k.min()) >= 0 and int(idx_k.max()) < M,
            f"nn1 {name}: index out of range")
    require(same_bits(torch, d2_k, d2_p),
            f"nn1 {name}: distances differ from the plain version at "
            f"{int((d2_k != d2_p).sum())} places")
    fin = ~torch.isnan(d2_p)
    err = float((d2_k - d2_p).abs()[fin].max()) if bool(fin.any()) else 0.0
    card = nn1_card(q.device.index or 0, D, M)
    plan = nn1_plan(S, N, M, D, B, card)
    log(f"nn1 {name}: S={S} N={N} B={B} M={M} D={D}, {plan.qt} queries "
        f"per thread, {plan.blocks} blocks per database, "
        f"{'resident' if plan.resident else 'streamed'} ({card.sms} SMs, "
        f"{card.block_smem} B per block, {card.per_sm} resident blocks "
        f"per SM): indices equal, "
        f"d2 bitwise equal (max abs err {err:.3g}), NaN distances "
        f"{int((~fin).sum())}")
    return err, idx_k


def nn1_hard_cases(torch, group, cloud):
    """Inputs at the 1-NN kernel's edges, made from one init group (8
    query sets of 20480 points) and one pseudo cloud (5120 rows): ties
    across its tracked tiles (each tile's last row repeated as the next
    tile's first, the last row a copy of the first, queries on them); NaN
    rows (row 0 all NaN) and NaN queries (every 101st all NaN); M = 5001
    rows (a multiple of neither the 64-row tile nor the 8 queries of a
    thread) against N = 20479 (8 sets: not a multiple of the 2048-query
    chunk); 20000 rows, more than shared memory holds (streamed); and
    D = 1 (integer coordinates: ties everywhere), 5 and 8 (the padded
    row widths 4 and 8), resident and streamed."""
    from deepi2p_tpu_torch.ops.knn_cuda import NN1_TRACK

    gen = torch.Generator(device="cpu").manual_seed(11)
    dev = group.device
    M = cloud.shape[1]
    nan = float("nan")
    tie = cloud.clone()
    edges = torch.arange(NN1_TRACK, M, NN1_TRACK, device=dev)
    tie[:, edges] = tie[:, edges - 1]
    tie[:, M - 1] = tie[:, 0]
    on_ties = group.clone()
    rows = torch.cat([edges - 1, torch.zeros(1, dtype=edges.dtype,
                                             device=dev)])
    on_ties[:, 1:1 + rows.numel()] = tie[0, rows]
    nan_db = cloud.clone()
    nan_db[:, 0] = nan
    nan_db[:, ::97, 1] = nan
    nan_q = group.clone()
    nan_q[:, ::101] = nan
    nan_q[:, 5::103, 2] = nan
    jitter = torch.rand((4, M, 3), generator=gen).to(dev)
    big = torch.cat([cloud[0] + 0.05 * jitter[j] for j in range(4)])[None]

    def rand(*shape, ints=False):
        x = torch.randn(shape, generator=gen) * 5.0
        return (x.round() if ints else x).to(dev)

    cases = [("ties across tiles", on_ties, tie),
             ("NaN rows and queries", nan_q, nan_db),
             ("ragged M=5001 N=20479", group[:, :20479], cloud[:, :5001]),
             ("streamed M=20000", group[:2], big[:, :20000]),
             ("D=1 integer ties", rand(4, 3000, 1, ints=True),
              rand(2, 2500, 1, ints=True)),
             ("D=5", rand(2, 3000, 5), rand(1, 2500, 5)),
             ("D=8", rand(4, 3000, 8), rand(2, 2500, 8)),
             ("D=8 streamed M=8000", rand(2, 3000, 8), rand(1, 8000, 8))]
    return [(n, q.contiguous(), db.contiguous()) for n, q, db in cases]


def nn1_phase(torch, raw):
    """The 1-NN kernel at the ICP path's launch shape (every pair x init of
    the evaluation batch against the pairs' pseudo clouds, as
    ``icp_batch`` calls it), at one init group against one cloud with
    sentinel rows and a ragged last tile, on the hard cases of
    :func:`nn1_hard_cases`, all bitwise; then one ICP batch under
    ``torch.profiler``."""
    from deepi2p_tpu_torch.ops import nn1_plain
    from deepi2p_tpu_torch.ops.knn_cuda import nn1_cuda
    from deepi2p_tpu_torch.profile_nn1 import icp_launch

    # the queries of an ICP iteration: every pair's 64 inits applied to
    # its source cloud, 64 query sets per pseudo cloud
    source, target, q = icp_launch(raw, -(-ICP_INITS // 8) * 8)
    B, N, D = source.shape
    M = target.shape[1]
    group = q[:NN1_SETS].contiguous()               # pair 0's first 8 inits
    padded = target[:1].clone()
    padded[:, 5000:] = 1e6                         # 5000 points + sentinels
    cases = [("icp launch", q, target), ("sentinel-padded", group, padded),
             ("M=5000", group, target[:1, :5000].contiguous())]
    cases += nn1_hard_cases(torch, group, target[:1].contiguous())
    row = dict(max_abs_err=0.0, library_ms=None)
    for name, qq, db in cases:
        err, idx = check_nn1(torch, name, qq, db)
        if name == "sentinel-padded":
            require(int(idx.max()) < 5000,
                    "nn1: a sentinel row was chosen as a nearest neighbour")
        row["max_abs_err"] = max(row["max_abs_err"], err)
        del idx

    # times at the ICP launch shape; no single PyTorch call computes this
    # 1-NN there (cdist would hold 512 x 20480 x 5120 distances, 215 GB),
    # so the library call is timed at one init group against one cloud
    S = q.shape[0]
    row["ms"] = cuda_ms(torch, lambda: nn1_cuda(q, target), 5)
    row["plain_ms"] = cuda_ms(torch, lambda: nn1_plain(q, target), 1)
    ops = S * N * M * ((3 * D - 1) + 1)   # distance, then one compare
    nbytes = 4 * (S * N * D + B * M * D) + 8 * S * N
    t_bytes, t_ops = nbytes / PEAK_BYTES * 1e3, ops / PEAK_F32_OPS * 1e3
    row["bound_ms"] = max(t_bytes, t_ops)
    row["bound_by"] = "operations" if t_ops >= t_bytes else "bytes"
    log(f"nn1 icp launch: S={S} N={N} B={B} M={M} D={D} ms={row['ms']:.4f} "
        f"plain_ms={row['plain_ms']:.4f} bound_ms={row['bound_ms']:.5f} "
        f"(bytes {t_bytes:.5f}, operations {t_ops:.5f})")
    db1 = target[:1]
    g_ms = cuda_ms(torch, lambda: nn1_cuda(group, db1), 10)
    g_lib = cuda_ms(torch, lambda: torch.min(torch.cdist(
        group, db1.expand(NN1_SETS, -1, -1),
        compute_mode="donot_use_mm_for_euclid_dist"), dim=-1), 2)
    log(f"nn1 init group: S={NN1_SETS} N={N} M={M} ms={g_ms:.4f} "
        f"cdist+min ms={g_lib:.4f}")
    row["icp"] = icp_launch_check(torch, source, target)
    row["icp"]["paths"] = icp_paths(torch, source, target)
    icp_profile(torch, source, target)
    return row


def icp_launch_check(torch, source, target) -> dict:
    """One ICP iteration's two ``icp_cuda`` kernels at the evaluation
    batch's launch shape (8 pairs x 64 inits: 512 sets of 20480 points
    against 8 clouds of 5120) against the plain path: the transform
    bitwise ``_transform``, the 1-NN of its output bitwise that of
    ``_transform``'s, each set's inlier count exact, its moments within
    1e-12 of a float64 sum (relative to the largest of each moment over
    the sets), the update's float64 R and t within 1e-9 of ``_kabsch`` in
    float64 where the set has at least 3 inliers and its S's second and
    third singular values lie 1e-3 sigma_1 apart (else the SVD's rounding
    moves R more), its float32 pose their rounding, and the poses of sets
    with too few inliers kept bitwise.  Then each kernel's device time
    by CUDA events, its bound and the plain chain's time."""
    from deepi2p_tpu_torch.ops.knn import nn1
    from deepi2p_tpu_torch.register import icp as ti
    from deepi2p_tpu_torch.register import icp_cuda as ic

    B, N, _ = source.shape
    M = target.shape[1]
    I = -(-ICP_INITS // 8) * 8
    S = B * I
    P0 = ti._draw_inits(torch.Generator().manual_seed(5), (B, I),
                        (5.0, 0.0, 10.0), math.pi).cuda()
    R0, t0 = P0[..., :3, :3], P0[..., :3, 3]
    thr = float(ti._thr_schedule(1.0, None, ICP_ITERS)[0])
    rt0 = ic.pose_rows(R0, t0)
    moved = torch.empty(S, N, 3, device="cuda")
    ic.transform(source, rt0, moved)
    want = ti._transform(source[:, None], R0, t0).reshape(S, N, 3)
    require(torch.equal(moved, want),
            "icp: the transform is not bitwise _transform at the launch")
    d2, idx = nn1(moved, target)
    d2p, idxp = nn1(want, target)
    require(torch.equal(d2, d2p) and torch.equal(idx, idxp),
            "icp: the 1-NN of the transform's output is not that of "
            "_transform's")
    del want, d2p, idxp
    tgt4 = ic.pad_rows(target)
    rt = rt0.clone()
    stats = torch.full((S, ic.STATS), float("nan"), dtype=torch.float64,
                       device="cuda")
    ic.update(source, tgt4, d2, idx, rt, thr, stats)

    w = (torch.sqrt(d2) < thr).reshape(B, I, N)
    dst = torch.gather(target[:, None].expand(-1, I, -1, -1), 2,
                       idx.long().reshape(B, I, N, 1).expand(-1, -1, -1, 3))
    sel = w[..., None]
    s64 = torch.where(sel, source[:, None].double(), 0.0)
    d64 = torch.where(sel, dst.double(), 0.0)
    m = torch.cat([w.sum(-1).double()[..., None], s64.sum(-2), d64.sum(-2),
                   (s64[..., :, None] * d64[..., None, :]).sum(-3)
                   .flatten(-2)], dim=-1).reshape(S, ic.SUMS)
    del s64, d64
    R, t = ti._kabsch(source[:, None].double(), dst.double(), w.double())
    R, t = R.reshape(S, 9), t.reshape(S, 3)
    del dst
    scale = m.abs().amax(0, keepdim=True).clamp(min=1.0)
    mom_err = float(((stats[:, :ic.SUMS] - m).abs() / scale).max())
    ok = m[:, 0] >= ic.MIN_INLIERS
    Wc = m[:, :1].clamp(min=1e-6)
    Smat = m[:, 7:].reshape(S, 3, 3) \
        - (m[:, 1:4] / Wc)[:, :, None] * m[:, None, 4:7]
    sv = torch.linalg.svdvals(Smat)
    apart = ok & (sv[:, 1] - sv[:, 2] > 1e-3 * sv[:, 0])
    r_err = float((stats[apart, ic.SUMS:ic.SUMS + 9] - R[apart]).abs()
                  .max()) if bool(apart.any()) else float("nan")
    t_err = float((stats[apart, ic.SUMS + 9:] - t[apart]).abs().max()) \
        if bool(apart.any()) else float("nan")
    out = dict(sets=S, sets_ok=int(ok.sum()), sets_compared=int(apart.sum()),
               inliers_min=int(m[:, 0].min()), inliers_max=int(m[:, 0].max()),
               moments_rel_err=mom_err, R_err=r_err, t_err=t_err,
               max_abs_err=max(r_err, t_err))
    log(f"icp launch: S={S} N={N} B={B} M={M} thr={thr}: "
        + json.dumps(out))
    require(torch.equal(stats[:, 0], m[:, 0]), "icp: inlier counts differ")
    require(mom_err < 1e-12, f"icp: moments off by {mom_err:.3g} relative")
    require(out["sets_compared"] >= 0.9 * out["sets_ok"],
            f"icp: only {out['sets_compared']} of {out['sets_ok']} sets "
            f"held to _kabsch")
    require(r_err < 1e-9 and t_err < 1e-9,
            f"icp: float64 R, t off _kabsch's by {r_err:.3g}, {t_err:.3g}")
    require(torch.equal(rt[ok], stats[ok, ic.SUMS:].float()),
            "icp: the float32 pose is not the float64 solve's rounding")
    require(torch.equal(rt[~ok], rt0[~ok]),
            "icp: a set with too few inliers moved")

    # times: each kernel by CUDA events over 20 calls, the plain chain
    # (_transform; weights, gather, _kabsch with its SVD, selects)
    rt_t = rt0.clone()
    tr_ms = cuda_ms(torch, lambda: ic.transform(source, rt0, moved), 20)
    up_ms = cuda_ms(torch, lambda: ic.update(source, tgt4, d2, idx, rt_t,
                                             thr), 20)
    src, tgt = source[:, None], target[:, None].expand(-1, I, -1, -1)
    d2r, idxr = d2.reshape(B, I, N), idx.reshape(B, I, N)

    def plain_update():
        wp = (torch.sqrt(d2r) < thr).to(torch.float32)
        dp = torch.gather(tgt, 2, idxr.long()[..., None].expand(-1, -1, -1, 3))
        Rn, tn = ti._kabsch(src, dp, wp)
        okp = torch.sum(wp, dim=-1) >= 3
        return (torch.where(okp[..., None, None], Rn, R0),
                torch.where(okp[..., None], tn, t0))

    ptr_ms = cuda_ms(torch, lambda: ti._transform(src, R0, t0), 3)
    pup_ms = cuda_ms(torch, plain_update, 3)
    tr_bytes = 4 * (B * N * 3 + S * 12 + S * N * 3)
    up_bytes = 4 * (2 * S * N + B * N * 3 + 2 * S * 12) + 16 * B * M
    up_ops = 25 * S * N       # per point: 16 float64 adds, 9 multiplies
    tr_bound = tr_bytes / PEAK_BYTES * 1e3
    up_bound = max(up_bytes / PEAK_BYTES, up_ops / PEAK_F64_OPS) * 1e3
    times = dict(ms=tr_ms + up_ms, plain_ms=ptr_ms + pup_ms,
                 bound_ms=tr_bound + up_bound, bound_by="bytes"
                 if up_bytes / PEAK_BYTES >= up_ops / PEAK_F64_OPS
                 else "transform bytes, update float64 operations",
                 transform_ms=tr_ms, transform_bound_ms=tr_bound,
                 transform_plain_ms=ptr_ms, update_ms=up_ms,
                 update_bound_ms=up_bound, update_plain_ms=pup_ms)
    log("icp launch times: " + json.dumps(times))
    out.update(times)
    return out


def icp_paths(torch, source, target) -> dict:
    """One ICP solve at the evaluation batch's shape (60 -> 64 inits, 30
    iterations) on the card's path and on the plain path run on the card,
    from the same inits: the card's path makes 2 ``icp_cuda`` launches an
    iteration and one for the fitness pass, its poses are finite, its
    best fitness per pair within 0.01 of the plain path's, and most
    inits end at the plain path's pose (an init may part where a point
    flips at the threshold within the f32 SVD's rounding)."""
    from deepi2p_tpu_torch.register import icp as ti
    from deepi2p_tpu_torch.register import icp_cuda

    B = source.shape[0]
    I = -(-ICP_INITS // 8) * 8
    P0 = ti._draw_inits(torch.Generator().manual_seed(0), (B, I),
                        (5.0, 0.0, 10.0), math.pi).cuda()
    thr = ti._thr_schedule(1.0, None, ICP_ITERS)
    before = icp_cuda.launches
    P, fit = ti._icp_solve(source, target, P0, thr, 1.0)
    launches = icp_cuda.launches - before
    Pp, fitp = ti._icp_solve_plain(source, target, P0, thr, 1.0)
    gap = (P - Pp).abs().amax(dim=(-2, -1)).flatten()
    out = dict(launches=launches,
               best_fitness_gap=float((fit.amax(1) - fitp.amax(1)).abs()
                                      .max()),
               fitness_gap_max=float((fit - fitp).abs().max()),
               pose_gap_median=float(gap.median()),
               pose_gap_max=float(gap.max()),
               inits_within_1e3=float((gap < 1e-3).double().mean()))
    log(f"icp paths: card vs plain on the card, B={B} inits={I} "
        f"iterations={ICP_ITERS}: " + json.dumps(out))
    require(launches == 2 * ICP_ITERS + 1,
            f"icp_cuda launches a batch {launches} != {2 * ICP_ITERS + 1}")
    require(bool(torch.isfinite(P).all()), "icp: a non-finite pose")
    require(out["best_fitness_gap"] <= 0.01,
            f"icp: best fitness parts from the plain path's by "
            f"{out['best_fitness_gap']}")
    require(out["inits_within_1e3"] >= 0.9,
            f"icp: only {out['inits_within_1e3']:.3f} of the inits end "
            f"within 1e-3 of the plain path's pose")
    return out


def icp_profile(torch, source, target):
    """One ICP batch of the evaluation path (the ``icp`` method's
    ``icp_batch`` call), timed by the host clock after a warm-up, then
    under ``torch.profiler``: device time of the 1-NN kernel, the
    ``icp_cuda`` kernels (transform, update) and the rest."""
    from torch.autograd import DeviceType
    from deepi2p_tpu_torch.register.icp import icp_batch
    from deepi2p_tpu_torch.utils.profiling import is_span_range

    def run():
        return icp_batch(source, target, torch.Generator().manual_seed(0),
                         n_inits=ICP_INITS, max_iter=ICP_ITERS, device="cuda")

    run()
    torch.cuda.synchronize()
    t = time.perf_counter()
    run()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        t = time.perf_counter()
        run()
        torch.cuda.synchronize()
        wall_prof = time.perf_counter() - t

    events = [e for e in prof.key_averages()
              if e.device_type == DeviceType.CUDA and dev_us(e) > 0
              and not is_span_range(e)]
    if not events:
        log(f"icp batch: wall {wall:.4f} s; the trace holds no device time "
            f"(split not measured)")
        return
    groups = (("nn1 kernel", ("nn1_kernel",)),
              ("icp transform", ("transform_kernel",)),
              ("icp update", ("update_kernel",)))
    split = {name: [0.0, 0] for name, _ in groups}
    split["rest"] = [0.0, 0]
    for e in events:
        key = e.key.lower()
        name = next((n for n, pats in groups
                     if any(p in key for p in pats)), "rest")
        split[name][0] += dev_us(e) / 1e3
        split[name][1] += e.count
    busy = sum(v[0] for v in split.values())
    log(f"icp batch: B={source.shape[0]} N={source.shape[1]} "
        f"M={target.shape[1]} {ICP_INITS} inits {ICP_ITERS} iterations: "
        f"wall {wall:.4f} s; profiled wall {wall_prof * 1e3:.3f} ms, device "
        f"busy {busy:.3f} ms; split " + ", ".join(
            f"{n} {ms:.3f} ms ({100 * ms / busy:.1f}%, {c} launches)"
            for n, (ms, c) in split.items()))


def lm6_phase(torch, batch, cfg, pred):
    """The 6-DoF LM kernel at the 6-DoF solve's probe and refine shapes,
    at the plans they pick, bitwise: the model's labels, the true pose's,
    and zero-angle inits; then pairs too long for the main path's plans,
    resident and streamed."""
    from deepi2p_tpu_torch.register import (initial_guess, lm_solve_cuda,
                                            lm_solve_plain, sample_inits)
    from deepi2p_tpu_torch.register.frustum_cuda import (lm_plan,
                                                         lm_smem_bytes)

    log_lm_attrs(6)

    kw = dict(H=cfg.img_H, W=cfg.img_W)
    t_lb, t_ub = (-5.0, -0.1, -10.0), (5.0, 0.1, 10.0)
    pc, K = batch["pc"], batch["K"].contiguous()
    truth = frustum_labels(torch, pc, batch["P"], batch["K"], cfg.img_H,
                           cfg.img_W)
    s, ps = SOLVER_STRIDE, max(1, 4 // SOLVER_STRIDE)
    keep = max((N_INITS // 8) // 8 * 8, 8)

    def sub(x, stride):
        return x[:, ::stride].contiguous()

    row = dict(ms=0.0, plain_ms=0.0, library_ms=None, bound_ms=0.0,
               max_abs_err=0.0, bound_by=None)
    for lab_name, labels, zero_angle in (("truth", truth, False),
                                         ("model", pred, False),
                                         ("truth, zero angles", truth, True)):
        ang, valid = initial_guess(pc, labels)
        gen = torch.Generator(device=pc.device).manual_seed(2)
        theta = sample_inits(gen, ang, N_INITS, is_2d=False)
        if zero_angle:
            theta[..., :3] = 0.0
        theta = theta.contiguous()
        full = [sub(x, s) for x in (pc, labels.float(), valid)]
        probe = [sub(x, ps) for x in full]
        for name, inputs, iters in (("probe", probe, PROBE_ITER),
                                    ("refine", full, MAX_ITER - PROBE_ITER)):
            args = (*inputs, K, theta, t_lb, t_ub)
            B, N, _ = inputs[0].shape
            C, G, Wp = lm_plan(B, N, theta.shape[1], 6)
            th_p, c_p, terr = compare_lm(
                torch, f"6-DoF {name} ({lab_name} labels, B={B} N={N} "
                f"I={theta.shape[1]} iters={iters}, C={C} G={G} W={Wp}: "
                f"blocks of {32 * G * Wp} threads in clusters of {C}, "
                f"{lm_smem_bytes(N, C, Wp)} B dynamic shared memory per "
                f"block)", args, dict(kw, max_iter=iters), bitwise=True)
            nonfinite_cost_points(torch, f"6-DoF {name} ({lab_name} "
                                  f"labels)", args, c_p, **kw)
            row["max_abs_err"] = max(row["max_abs_err"], terr)
            if lab_name == "model":
                ms = cuda_ms(torch, lambda: lm_solve_cuda(
                    *args, max_iter=iters, **kw), 5)
                plain_ms = cuda_ms(torch, lambda: lm_solve_plain(
                    *args, max_iter=iters, **kw), 1)
                I = theta.shape[1]
                bound, row["bound_by"] = lm_bound(inputs, I, iters, 6)
                log(f"lm6 {name}: B={B} N={N} I={I} iters={iters} "
                    f"ms={ms:.4f} plain_ms={plain_ms:.4f} "
                    f"bound_ms={bound:.5f}")
                row["ms"] += ms
                row["plain_ms"] += plain_ms
                row["bound_ms"] += bound
            if name == "probe":
                top = torch.argsort(c_p, dim=1, stable=True)[:, :keep]
                theta = torch.gather(
                    th_p, 1, top[:, :, None].expand(-1, -1, 6)).contiguous()
    lm_streamed_check(torch, batch, cfg, P=6)
    return row


def nonfinite_cost_points(torch, tag, args, cost, *, H: int,
                          W: int) -> None:
    """Name the points behind each non-finite cost of a 6-DoF LM run.

    A non-finite cost is never replaced (a proposal is taken only if its
    cost is below the current one), so it is the cost of the clipped
    init: the per-point cost terms at that theta show which points are
    not finite."""
    from deepi2p_tpu_torch.register.frustum_cuda import (_clip_t,
                                                         _residual_parts,
                                                         _rot6)

    pts, lab, val, K, theta0, t_lb, t_ub = args
    for b, i in (~torch.isfinite(cost)).nonzero().tolist()[:4]:
        th = _clip_t(theta0[b:b + 1, i:i + 1], t_lb, t_ub)      # (1, 1, 6)
        R, _ = _rot6(th)
        x, y, z = (pts[b, :, d] for d in range(3))
        p = [R[3 * r][0, 0] * x + R[3 * r + 1][0, 0] * y
             + R[3 * r + 2][0, 0] * z + th[0, 0, 3 + r] for r in range(3)]
        inv_z = 1.0 / p[2]
        px = K[b, 0, 0] * p[0] * inv_z + K[b, 0, 2]
        py = K[b, 1, 1] * p[1] * inv_z + K[b, 1, 2]
        r0_in, _, r1_in, _, r2_in, _, r_out, _, _, _ = _residual_parts(
            px, py, p[2], float(H - 1), float(W - 1))
        inn = lab[b] > 0.5
        zero = torch.zeros((), device=pts.device)
        r0 = torch.where(inn, r0_in, r_out) * val[b]
        r1 = torch.where(inn, r1_in, zero) * val[b]
        r2 = torch.where(inn, r2_in, zero) * val[b]
        term = 0.5 * torch.log1p(r0 * r0 + r1 * r1 + r2 * r2) * val[b]
        bad = (~torch.isfinite(term)).nonzero().flatten().tolist()
        log(f"lm {tag}: cost {float(cost[b, i])} at pair {b} init {i}, "
            f"theta {[float(v) for v in th[0, 0]]}: non-finite cost terms "
            f"at points {bad[:8]} of {len(bad)}")
        for n in bad[:8]:
            log(f"  point {n}: xyz {[float(v) for v in pts[b, n]]} label "
                f"{float(lab[b, n])} valid {float(val[b, n])} p "
                f"{[float(v[n]) for v in p]} px {float(px[n])} py "
                f"{float(py[n])} r0 {float(r0[n])} r1 {float(r1[n])} r2 "
                f"{float(r2[n])} term {float(term[n])}")


def solve6_phase(torch, model, batch, cfg):
    """forward -> argmax -> the 6-DoF solve, at the main path's settings."""
    from deepi2p_tpu_torch.ops.knn_cuda import knn_cuda
    from deepi2p_tpu_torch.register import (lm_solve_cuda, pose_diff,
                                            registration_summary,
                                            solve_frustum_batch)

    gen = torch.Generator(device="cuda").manual_seed(0)
    args = [batch[k] for k in ("pc", "intensity", "sn", "node_a", "node_b",
                               "img")]

    def solve(pred):
        return solve_frustum_batch(batch["pc"], pred, batch["K"], H=cfg.img_H,
                                   W=cfg.img_W, generator=gen,
                                   n_inits=N_INITS, max_iter=MAX_ITER,
                                   solver_stride=SOLVER_STRIDE, is_2d=False)

    steps = 3
    solve(torch.argmax(model(*args)[0], dim=-1))      # warm-up
    torch.cuda.synchronize()
    knn_cuda.launches = 0
    lm_solve_cuda.launches = 0
    lm_solve_cuda.launches_p6 = 0
    t = time.perf_counter()
    outs = []
    for _ in range(steps):
        pred = torch.argmax(model(*args)[0], dim=-1)
        outs.append(solve(pred))
    torch.cuda.synchronize()
    dt = time.perf_counter() - t
    launches = {"knn": knn_cuda.launches, "lm_p4": lm_solve_cuda.launches,
                "lm_p6": lm_solve_cuda.launches_p6}
    log(f"solve6: launches {launches} in {steps} steps")
    require(launches["lm_p6"] == 2 * steps,
            f"6-DoF LM launches {launches['lm_p6']} != {2 * steps}")
    require(launches["knn"] == 4 * steps,
            f"knn launches {launches['knn']} != {4 * steps}")
    require(launches["lm_p4"] == 0, "the 6-DoF solve ran the 2-D LM")
    B = batch["pc"].shape[0]
    for i, (P, cost) in enumerate(outs):
        require(tuple(P.shape) == (B, 4, 4) and tuple(cost.shape) == (B,),
                "6-DoF pose / cost shape")
        require(bool(torch.isfinite(P).all() and torch.isfinite(cost).all()),
                f"step {i}: non-finite 6-DoF pose or cost")
    solve_ms = cuda_ms(torch, lambda: solve(pred), steps)
    truth = frustum_labels(torch, batch["pc"], batch["P"], batch["K"],
                           cfg.img_H, cfg.img_W)
    P_t, _ = solve(truth)
    P_gt = torch.eye(4, device=P_t.device).repeat(B, 1, 1)
    P_gt[:, :3] = batch["P"]
    rte, rre = pose_diff(P_t.double(), P_gt.double())
    summ = registration_summary(rte.cpu().numpy(), rre.cpu().numpy())
    log(f"solve6: {steps} steps of B={B} in {dt:.4f} s -> "
        f"{steps * B / dt:.2f} pairs/s (forward + 6-DoF solve); solve "
        f"{solve_ms:.3f} ms per batch (CUDA events); from the true pose's "
        f"labels: success rate {summ['success_rate']:.4f}, RTE mean "
        f"{summ['rte_mean']:.4f} m, RRE mean {summ['rre_mean']:.4f} deg")
    return launches


def eval_lm_check(torch, cfg, dump_dir):
    """The 2-D LM kernel at the two launches of the harness's frustum
    solve (KITTI B=8, every point, 60 inits padded to 64, 32 iterations:
    probe N=5120 I=64, refine N=20480 I=8), on the dump's labels and
    predictions, each at the plan it picks: held to the plain version and
    timed."""
    import numpy as np
    from deepi2p_tpu_torch.eval.dump import list_dump_prefixes, load_dump

    dumps = [load_dump(dump_dir, p) for p in list_dump_prefixes(dump_dir)]

    def stack(field, dtype=torch.float32):
        return torch.as_tensor(np.stack([d[field] for d in dumps])).to(
            "cuda", dtype).contiguous()

    pc, K = stack("pc"), stack("K")
    for field, tag in (("coarse_label", "KITTI eval labels"),
                       ("coarse_pred", "KITTI eval predictions")):
        lm_halving(torch, tag, pc, stack(field, torch.int64), K,
                   H=cfg.img_H, W=cfg.img_W, solver_stride=1,
                   n_inits=EVAL_INITS, max_iter=EVAL_MAX_ITER, timed=True)


def eval_phase(torch, cfg, raw):
    """The evaluation path end to end, over a dump the port's detector
    writes, at the KITTI shape."""
    from deepi2p_tpu_torch.eval.depth import dump_pseudo_pointclouds
    from deepi2p_tpu_torch.eval.dump import dump_predictions
    from deepi2p_tpu_torch.eval.harness import evaluate_registration
    from deepi2p_tpu_torch.models import build_detector
    from deepi2p_tpu_torch.ops.knn_cuda import knn_cuda, nn1_cuda
    from deepi2p_tpu_torch.register import icp_cuda, lm_solve_cuda

    model = build_detector(cfg, device="cuda", seed=0)
    B = raw["pc"].shape[0]
    with tempfile.TemporaryDirectory(prefix="deepi2p_eval_") as tmp:
        dump_dir, pseudo_dir = f"{tmp}/dump", f"{tmp}/pseudo"
        knn_cuda.launches = nn1_cuda.launches = icp_cuda.launches = 0
        lm_solve_cuda.launches = lm_solve_cuda.launches_p6 = 0
        t = time.perf_counter()
        acc = dump_predictions(model, [raw], cfg, dump_dir)
        torch.cuda.synchronize()
        log(f"eval: dump_predictions {time.perf_counter() - t:.4f} s, "
            f"coarse/fine accuracy {acc[0]:.4f}/{acc[1]:.4f}")
        t = time.perf_counter()
        items = [(f"{b:06d}_00", raw["depth"][b]) for b in range(B)]
        dump_pseudo_pointclouds(items, raw["K"][0], lambda d: d, pseudo_dir,
                                stride=PSEUDO_STRIDE, device="cuda")
        log(f"eval: dump_pseudo_pointclouds {time.perf_counter() - t:.4f} s")
        kw = dict(H=cfg.img_H, W=cfg.img_W, batch_size=B, device="cuda")
        runs = [("icp", dict(method="icp", n_inits=ICP_INITS,
                             max_iter=ICP_ITERS, pseudo_dir=pseudo_dir)),
                ("frustum (labels)", dict(method="frustum", use_labels=True)),
                ("frustum (predictions)", dict(method="frustum")),
                ("random", dict(method="random"))]
        counts = {}
        for name, args in runs:
            before = (nn1_cuda.launches, lm_solve_cuda.launches,
                      icp_cuda.launches)
            t = time.perf_counter()
            summ = evaluate_registration(dump_dir, **kw, **args)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t
            counts[name] = (nn1_cuda.launches - before[0],
                            lm_solve_cuda.launches - before[1],
                            icp_cuda.launches - before[2])
            log(f"eval {name}: wall {wall:.4f} s, launches (nn1, lm_p4, "
                f"icp) {counts[name]}, summary {json.dumps(summ)}")
            require(summ["num_pairs"] == B, f"eval {name}: pair count")
            for key in ("rte_mean", "rre_mean", "success_rate"):
                require(math.isfinite(summ[key]),
                        f"eval {name}: non-finite {key}")
        launches = {"knn": knn_cuda.launches, "nn1": nn1_cuda.launches,
                    "lm_p4": lm_solve_cuda.launches,
                    "icp": icp_cuda.launches}
        log(f"eval: launches {launches}")
        eval_lm_check(torch, cfg, dump_dir)
    require(counts["icp"][0] >= ICP_ITERS + 1,
            f"nn1 launches per ICP batch {counts['icp'][0]} < "
            f"{ICP_ITERS + 1}")
    # one batch of B pairs: 2 icp_cuda launches an iteration, 1 for fitness
    require(counts["icp"][2] == 2 * ICP_ITERS + 1
            and launches["icp"] == 2 * ICP_ITERS + 1,
            f"icp_cuda launches in the ICP batch {counts['icp'][2]}, in the "
            f"phase {launches['icp']}, not {2 * ICP_ITERS + 1}")
    require(launches["knn"] > 0, "the dump's forward launched no kNN")
    require(launches["lm_p4"] > 0, "the frustum method launched no 2-D LM")
    return launches


def depth_net_flops(H: int, W: int) -> float:
    """Multiply-adds x 2 of one DepthNet forward on an H x W image (the
    convolutions; the norms and the activations are noise beside them)."""
    from deepi2p_tpu_torch.models.depth import WIDTHS

    def conv(cin, cout, h, w):
        return 2.0 * cin * cout * 9 * h * w

    sizes, h, w, cin, total = [], H, W, 3, 0.0
    for i, c in enumerate(WIDTHS):
        if i:
            h, w = -(-h // 2), -(-w // 2)
        sizes.append((h, w))
        total += conv(cin, c, h, w) + conv(c, c, h, w)
        cin = c
    for i in reversed(range(len(WIDTHS) - 1)):
        h, w = sizes[i]
        total += conv(cin + WIDTHS[i], WIDTHS[i], h, w)
        cin = WIDTHS[i]
    return total + conv(cin, 1, H, W)


def depth_reference(torch, dcfg):
    """One step (B=2) of the DepthNet on the card against the same step on
    the CPU from the same weights and batch: in f32 (loss within
    DEPTH_LOSS_RTOL, the whole gradient within DEPTH_F32_GRAD_RTOL of the
    CPU's f32 and float64 ones; the card's step with TF32 convolutions,
    the control, outside it) and in a float64 copy (loss, and every
    gradient leaf within DEPTH_F64_RTOL)."""
    from deepi2p_tpu_torch.models.depth import DepthNet, build_depth_net
    from deepi2p_tpu_torch.train.depth_cli import DepthTrainer, depth_batch

    img, depth = depth_batch(dcfg, DEPTH_REF_BATCH, 7, True, "cpu")
    weights = build_depth_net(seed=1).state_dict()
    res = {}
    for dtype, dev in (("float32", "cuda"), ("float32", "cpu"),
                       ("float64", "cuda"), ("float64", "cpu"),
                       ("tf32", "cuda")):
        name = "float64" if dtype == "float64" else "float32"
        dt = getattr(torch, name)
        m = DepthNet(compute_dtype=name)
        m.load_state_dict(weights)
        m = m.to(dev, dt)
        torch.backends.cudnn.allow_tf32 = dtype == "tf32"
        try:
            loss, grads = DepthTrainer(m, DEPTH_LR, 1).loss_and_grads(
                img.to(dev, dt), depth.to(dev, dt))
            res[dtype, dev] = (float(loss),
                               [g.detach().double().cpu() for g in grads])
        finally:
            torch.backends.cudnn.allow_tf32 = False
    names = [n for n, _ in DepthNet().named_parameters()]

    def whole(a, b):
        x = torch.cat([g.flatten() for g in a])
        y = torch.cat([g.flatten() for g in b])
        return float((x - y).norm() / y.norm())

    def lrel(a, b):
        return abs(a - b) / abs(b)

    f32c, f32h = res["float32", "cuda"], res["float32", "cpu"]
    f64c, f64h = res["float64", "cuda"], res["float64", "cpu"]
    loss32 = lrel(f32c[0], f32h[0])
    g_card_cpu = whole(f32c[1], f32h[1])
    g_card_64 = whole(f32c[1], f64h[1])
    g_cpu_64 = whole(f32h[1], f64h[1])
    g_tf32 = whole(res["tf32", "cuda"][1], f64h[1])
    leaf64 = {n: float((a - b).norm() / b.norm())
              for n, a, b in zip(names, f64c[1], f64h[1])}
    worst = max(leaf64, key=leaf64.get)
    log(f"depth reference (B={DEPTH_REF_BATCH}, {DEPTH_H}x{DEPTH_W}, "
        f"TF32 off): f32 loss card {f32c[0]:.8f} cpu {f32h[0]:.8f} (rel "
        f"{loss32:.3g}); whole f32 gradient card vs cpu {g_card_cpu:.3g}, "
        f"card vs cpu float64 {g_card_64:.3g}, cpu f32 vs cpu float64 "
        f"{g_cpu_64:.3g}, control: card TF32 vs cpu float64 {g_tf32:.3g}; "
        f"float64 copy: loss rel "
        f"{lrel(f64c[0], f64h[0]):.3g}, worst gradient leaf {worst} "
        f"{leaf64[worst]:.3g}")
    require(loss32 <= DEPTH_LOSS_RTOL,
            f"depth: f32 loss card vs cpu {loss32:.3g}")
    require(g_card_cpu <= DEPTH_F32_GRAD_RTOL,
            f"depth: f32 gradient card vs cpu {g_card_cpu:.3g}")
    require(g_card_64 <= DEPTH_F32_GRAD_RTOL,
            f"depth: f32 gradient vs float64 {g_card_64:.3g}")
    require(g_tf32 > DEPTH_F32_GRAD_RTOL,
            f"depth: the TF32 control's gradient {g_tf32:.3g} is within "
            f"{DEPTH_F32_GRAD_RTOL:g}: the check does not see precision")
    require(lrel(f64c[0], f64h[0]) <= DEPTH_F64_RTOL,
            "depth: float64 loss card vs cpu")
    require(leaf64[worst] <= DEPTH_F64_RTOL,
            f"depth: float64 gradient leaf {worst} {leaf64[worst]:.3g}")


def estimated_icp_launch(torch, dump_dir, pseudo_dir):
    """The 1-NN launch of the ``icp`` method on estimated clouds, as the
    harness forms it: each pseudo cloud scaled to its pair's GT-visible
    mean depth and padded with 1e6 sentinels, every pair's inits applied
    to its dumped cloud."""
    import os
    import numpy as np
    from deepi2p_tpu_torch.eval.dump import list_dump_prefixes, load_dump
    from deepi2p_tpu_torch.register.icp import _draw_inits, _transform

    clouds, targets = [], []
    for prefix in list_dump_prefixes(dump_dir):
        d = load_dump(dump_dir, prefix)
        pseudo = np.load(os.path.join(pseudo_dir, prefix + "_pc.npy")).T
        cam = d["pc"] @ d["P"][:3, :3].T + d["P"][:3, 3]
        inside = d["coarse_label"].astype(np.float32)
        mean_gt = np.sum(cam[:, 2] * inside) / max(np.sum(inside), 1.0)
        targets.append(pseudo.astype(np.float32)
                       * (mean_gt / max(float(np.mean(pseudo[:, 2])), 1e-6)))
        clouds.append(d["pc"].astype(np.float32))
    M = max(t.shape[0] for t in targets)
    target = np.full((len(targets), M, 3), 1e6, np.float32)
    for i, t in enumerate(targets):
        target[i, :t.shape[0]] = t
    source = torch.as_tensor(np.stack(clouds)).cuda()
    B, N, D = source.shape
    inits = -(-ICP_INITS // 8) * 8
    P0 = _draw_inits(torch.Generator().manual_seed(5), (B, inits),
                     (5.0, 0.0, 10.0), math.pi).cuda()
    q = _transform(source[:, None], P0[..., :3, :3], P0[..., :3, 3])
    return (q.reshape(B * inits, N, D).contiguous(),
            torch.as_tensor(target).cuda())


def depth_phase(torch, cfg, raw):
    """The estimated-depth ICP path at the committed depth run's shape:
    DepthNet training (warm-up, timed steps, peak memory), one step held
    to the CPU, ``eval.cli depth-dump`` of the ``eval`` batch (saved with
    its images) on the card held to the CPU, and ``eval.cli solve
    --method icp --pseudo-dir`` on the estimated clouds, whose 1-NN launch
    is held bitwise to the plain version."""
    import os
    import numpy as np
    from deepi2p_tpu_torch import config
    from deepi2p_tpu_torch.eval import cli as eval_cli
    from deepi2p_tpu_torch.eval.dump import (dump_predictions,
                                             list_dump_prefixes)
    from deepi2p_tpu_torch.models import build_detector
    from deepi2p_tpu_torch.models.depth import build_depth_net
    from deepi2p_tpu_torch.ops.knn_cuda import nn1_cuda
    from deepi2p_tpu_torch.register import icp_cuda
    from deepi2p_tpu_torch.train.depth_cli import (DepthTrainer, depth_batch,
                                                   load_depth_fn,
                                                   save_depth_params)

    dcfg = config.tiny(synthetic_scene="street", img_H=DEPTH_H,
                       img_W=DEPTH_W)
    B = DEPTH_BATCH
    model = build_depth_net(dcfg.compute_dtype, seed=0, device="cuda")
    trainer = DepthTrainer(model, DEPTH_LR, DEPTH_WARMUP + DEPTH_TIMED)
    t = time.perf_counter()
    batches = [depth_batch(dcfg, B, 1 + i, True, "cuda") for i in range(2)]
    make_s = time.perf_counter() - t
    with torch.enable_grad():
        for i in range(DEPTH_WARMUP):
            trainer.step(*batches[i % 2])
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        t = time.perf_counter()
        losses = [trainer.step(*batches[i % 2]) for i in range(DEPTH_TIMED)]
        torch.cuda.synchronize()
        dt = time.perf_counter() - t
    losses = [float(x) for x in losses]
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    ms = dt / DEPTH_TIMED * 1e3
    fwd = depth_net_flops(DEPTH_H, DEPTH_W) * B
    require(all(math.isfinite(x) for x in losses),
            f"depth: non-finite loss in {losses}")
    log(f"depth train: DepthNet (16, 32, 64, 128) f32, B={B}, "
        f"{DEPTH_H}x{DEPTH_W}, dense street targets, {DEPTH_WARMUP} warm-up "
        f"+ {DEPTH_TIMED} timed steps on 2 batches made before the clock "
        f"({make_s:.2f} s to make): {ms:.3f} ms/step, "
        f"{B * DEPTH_TIMED / dt:.2f} samples/s, peak {peak:.3f} GiB; "
        f"forward {fwd / 1e9:.2f} GFLOP per batch "
        f"({fwd / B / 1e9:.3f} per image), a step ~3x: "
        f"{3 * fwd / (ms * 1e-3) / 1e12:.2f} TFLOP/s; losses "
        + " ".join(f"{x:.4f}" for x in losses))
    depth_reference(torch, dcfg)

    with tempfile.TemporaryDirectory(prefix="deepi2p_depth_") as tmp:
        dump_dir, pseudo = f"{tmp}/dump", f"{tmp}/pseudo"
        det = build_detector(cfg, device="cuda", seed=0)
        dump_predictions(det, [raw], cfg, dump_dir, save_images=True)
        del det
        ckpt = save_depth_params(model, f"{tmp}/depth", step=trainer.count)
        args = ["depth-dump", "--data-dir", dump_dir, "--depth-checkpoint",
                ckpt]
        eval_cli.main(args + ["--out", pseudo])     # warm-up
        torch.cuda.synchronize()
        t = time.perf_counter()
        n = eval_cli.main(args + ["--out", pseudo])
        torch.cuda.synchronize()
        dump_s = time.perf_counter() - t
        eval_cli.main(args + ["--out", f"{tmp}/pseudo_cpu", "--device",
                              "cpu"])
        prefixes = list_dump_prefixes(dump_dir)
        require(n == len(prefixes) == raw["pc"].shape[0],
                f"depth: {n} pseudo clouds for {len(prefixes)} pairs")
        card_fn = load_depth_fn(ckpt, config.tiny(), device="cuda")
        cpu_fn = load_depth_fn(ckpt, config.tiny(), device="cpu")
        map_err = pc_err = 0.0
        for p in prefixes:
            img = np.load(os.path.join(dump_dir, p + "_img.npy"))
            a, b = card_fn(img), cpu_fn(img)
            map_err = max(map_err, float(np.abs(a - b).max()
                                         / np.abs(b).max()))
            a, b = (np.load(os.path.join(d, p + "_pc.npy"))
                    for d in (pseudo, f"{tmp}/pseudo_cpu"))
            pc_err = max(pc_err, float(np.abs(a - b).max()
                                       / np.abs(b).max()))
        log(f"depth: eval.cli depth-dump of the eval batch ({n} images "
            f"{cfg.img_H}x{cfg.img_W}, stride 4): {dump_s:.4f} s per batch "
            f"of {n} on the card; card vs CPU depth maps {map_err:.3g}, "
            f"pseudo clouds {pc_err:.3g} (max abs err / max abs)")
        require(map_err <= DEPTH_MAP_RTOL and pc_err <= DEPTH_MAP_RTOL,
                f"depth: card vs CPU depth {map_err:.3g}, clouds "
                f"{pc_err:.3g}")

        nn1_cuda.launches = icp_cuda.launches = 0
        t = time.perf_counter()
        summ = eval_cli.main(["solve", "--data-dir", dump_dir, "--method",
                              "icp", "--pseudo-dir", pseudo, "--img-h",
                              str(cfg.img_H), "--img-w", str(cfg.img_W),
                              "--n-inits", str(ICP_INITS), "--max-iter",
                              str(ICP_ITERS)])
        torch.cuda.synchronize()
        icp_s = time.perf_counter() - t
        launches, icp_launches = nn1_cuda.launches, icp_cuda.launches
        require(launches == ICP_ITERS + 1,
                f"depth: {launches} nn1 launches in one ICP batch, not "
                f"{ICP_ITERS + 1}")
        require(icp_launches == 2 * ICP_ITERS + 1,
                f"depth: {icp_launches} icp_cuda launches in one ICP batch, "
                f"not {2 * ICP_ITERS + 1}")
        require(summ["num_pairs"] == n and all(
            math.isfinite(summ[k]) for k in ("rte_mean", "rre_mean")),
            f"depth: ICP summary {summ}")
        q, target = estimated_icp_launch(torch, dump_dir, pseudo)
        err, idx = check_nn1(torch, "icp launch, estimated clouds", q,
                             target)
        nn1_ms = cuda_ms(torch, lambda: nn1_cuda(q, target), 3)
        share = launches * nn1_ms / (icp_s * 1e3)
        log(f"depth: eval.cli solve --method icp --pseudo-dir on the "
            f"estimated clouds ({ICP_INITS} inits, {ICP_ITERS} iterations): "
            f"{icp_s:.4f} s per batch of {n}, nn1 launches {launches}, "
            f"icp_cuda launches {icp_launches}, the "
            f"1-NN {launches} x {nn1_ms:.4f} ms = {100 * share:.1f}% of it; "
            f"summary {json.dumps(summ)}")
        del idx
    return dict(launches=launches, icp_launches=icp_launches, ms=ms,
                peak_gib=peak, dump_s=dump_s, icp_s=icp_s, nn1_share=share,
                nn1_err=err)


def pnp_profile(torch, pnp_args, W_fine: int):
    """One PnP batch (pc, coarse, fine, K on the card) under
    ``torch.profiler``: CUDA kernel launches, the device's busy time, each
    ``pnp.*`` range's span on the card and the kernel time inside it (the
    draw of the minimal sets, the DLT of the 500 hypotheses, their
    reprojection and inlier count, the polish of 4 candidates and its GN
    steps), the top kernels."""
    from deepi2p_tpu_torch.register import pnp

    def run():
        pnp.solve_pnp_batch(*pnp_args, torch.Generator().manual_seed(0),
                            W_fine=W_fine)

    run()
    torch.cuda.synchronize()
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        run()
        torch.cuda.synchronize()
    on_card = [e for e in prof.events()
               if str(getattr(e, "device_type", "")).endswith("CUDA")]
    # the pnp.* ranges appear on the card's timeline as spans; the rest
    # are kernels and copies
    spans = [e for e in on_card if e.name.startswith("pnp.")]
    kernels = [e for e in on_card if not e.name.startswith("pnp.")]
    busy = sum(e.time_range.elapsed_us() for e in kernels) / 1e3
    split = {}
    for r in spans:
        inside = sum(e.time_range.elapsed_us() for e in kernels
                     if r.time_range.start <= e.time_range.start
                     < r.time_range.end)
        span, ms = split.get(r.name, (0.0, 0.0))
        split[r.name] = (round(span + r.time_range.elapsed_us() / 1e3, 3),
                         round(ms + inside / 1e3, 3))
    log(f"serve: pnp profile: {len(kernels)} CUDA kernel launches and "
        f"copies, device busy {busy:.3f} ms; per range (span ms, busy ms) "
        + json.dumps(dict(sorted(split.items()))))
    by_name = {}
    for e in kernels:
        ms, n = by_name.get(e.name, (0.0, 0))
        by_name[e.name] = (ms + e.time_range.elapsed_us() / 1e3, n + 1)
    for name, (ms, n) in sorted(by_name.items(), key=lambda kv: -kv[1][0])[:6]:
        log(f"serve: pnp kernel {ms:9.3f} ms in {n:5d} launches: "
            f"{name[:100]}")


def serve_phase(torch, cfg, raw):
    """The evaluation stage on the ``eval`` batch: ensemble dump, PnP from
    predictions and labels, PnP on the card against the CPU, and the
    solver knobs."""
    import numpy as np
    from deepi2p_tpu_torch.eval.dump import (SubsampleEnsemble,
                                             dump_predictions,
                                             list_dump_prefixes, load_dump)
    from deepi2p_tpu_torch.eval.harness import evaluate_registration
    from deepi2p_tpu_torch.ops.knn_cuda import knn_cuda
    from deepi2p_tpu_torch.register import lm_solve_cuda, pnp
    from deepi2p_tpu_torch.register import solve_frustum_batch
    from deepi2p_tpu_torch.train.engine import Engine

    B, N = raw["pc"].shape[:2]
    H, W = cfg.img_H, cfg.img_W
    engine = Engine(cfg.replace(input_pt_num=SERVE_CLASSIFY_N),
                    device="cuda")
    state = engine.init_state(seed=0)
    takes = SERVE_REPEATS * -(-N // SERVE_CLASSIFY_N)
    with tempfile.TemporaryDirectory(prefix="deepi2p_serve_") as dump_dir:
        # (a) the subset-ensemble dump
        knn_cuda.launches = 0
        t = time.perf_counter()
        acc = dump_predictions(
            SubsampleEnsemble(engine, seed=0, repeats=SERVE_REPEATS), [raw],
            cfg, dump_dir, state=state, save_probs=True)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t
        knn_launches = knn_cuda.launches
        log(f"serve: ensemble dump (classify N={SERVE_CLASSIFY_N}, "
            f"{SERVE_REPEATS} covers, {takes} takes of B={B}) wall "
            f"{wall:.4f} s, kNN launches {knn_launches}, coarse/fine "
            f"accuracy {acc[0]:.4f}/{acc[1]:.4f}")
        require(knn_launches > 0, "the ensemble dump launched no kNN")
        require(knn_launches == 4 * takes,
                f"kNN launches {knn_launches} != 4 per take x {takes}")

        # (b) PnP from the predictions and from the labels
        kw = dict(method="pnp", H=H, W=W, batch_size=B, device="cuda")
        summ = {}
        for name, use_labels in (("predictions", False), ("labels", True)):
            before = (knn_cuda.launches, lm_solve_cuda.launches)
            t = time.perf_counter()
            summ[name] = evaluate_registration(dump_dir,
                                               use_labels=use_labels, **kw)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t
            require(before == (knn_cuda.launches, lm_solve_cuda.launches),
                    "PnP launched a kernel of the port")
            log(f"serve: pnp ({name}) wall {wall:.4f} s per batch of {B}, "
                f"summary {json.dumps(summ[name])}")
            require(summ[name]["num_pairs"] == B, f"pnp ({name}) pair count")
            for key in ("rte_mean", "rre_mean", "success_rate"):
                require(math.isfinite(summ[name][key]),
                        f"pnp ({name}): non-finite {key}")
        ok = round(summ["labels"]["success_rate"] * B)
        require(ok >= PNP_LABELS_JAX_SUCCESS - 1,
                f"pnp from labels solves {ok} of {B} pairs; the JAX harness "
                f"solves {PNP_LABELS_JAX_SUCCESS}")

        dumps = [load_dump(dump_dir, p)
                 for p in list_dump_prefixes(dump_dir)]

        def stack(field, dev, dtype=torch.float32):
            return torch.as_tensor(np.stack([d[field] for d in dumps])).to(
                dev, dtype)

        W_fine = int(round(W / 32))
        args = {dev: (stack("pc", dev), stack("coarse_label", dev,
                                              torch.int64),
                      stack("fine_label", dev, torch.int64), stack("K", dev))
                for dev in ("cpu", "cuda")}
        pnp_profile(torch, args["cuda"], W_fine)

        # (c) the card against the CPU on the same minimal sets
        res = {}
        for dev in ("cuda", "cpu"):
            t = time.perf_counter()
            res[dev] = pnp.solve_pnp_batch(
                *args[dev], torch.Generator().manual_seed(0), W_fine=W_fine)
            if dev == "cuda":
                torch.cuda.synchronize()
            log(f"serve: pnp on {dev} (labels) {time.perf_counter() - t:.4f} "
                f"s, inliers {res[dev].n_inliers.tolist()}")
        P_gpu, P_cpu = res["cuda"].P.cpu(), res["cpu"].P
        perr = float((P_gpu - P_cpu).abs().max())
        pc, mask, fine, K = args["cpu"]
        K_fine = K / 32.0
        K_fine[:, 2, 2] = 1.0
        err = pnp._reproj_err(P_cpu[:, :3, :3], P_cpu[:, :3, 3], pc,
                              pnp.fine_label_to_cell(fine, W_fine, True),
                              K_fine)
        near = ((err - 0.6).abs() <= PNP_THRESH_BAND) & (mask > 0)
        d_inl = (res["cuda"].n_inliers.cpu() - res["cpu"].n_inliers).abs()
        log(f"serve: pnp card vs CPU: pose max abs err {perr:.3g}, inlier "
            f"differences {d_inl.tolist()}, points within "
            f"{PNP_THRESH_BAND} px of the threshold "
            f"{near.sum(-1).tolist()}")
        require(perr <= PNP_POSE_ATOL, f"pnp card vs CPU pose err {perr:.3g}")
        require(bool(torch.all(d_inl <= near.sum(-1))),
                "pnp card vs CPU: inlier counts differ beyond the points "
                "at the threshold")

        # (d) the successive-halving knobs on the labels
        gen_kw = dict(H=H, W=W, n_inits=EVAL_INITS, max_iter=EVAL_MAX_ITER)
        pc_g, lab_g, _, K_g = args["cuda"]

        def solve(**knobs):
            lm_solve_cuda.launches = 0
            P, cost = solve_frustum_batch(
                pc_g, lab_g, K_g, generator=torch.Generator().manual_seed(0),
                **gen_kw, **knobs)
            return P, cost, lm_solve_cuda.launches

        P0, c0, n0 = solve()
        # 60 inits run as 64: the default keeps the best 8
        P1, c1, n1 = solve(probe_stride=4, survivors=8)
        P2, c2, n2 = solve(probe_stride=8, survivors=16)
        same = same_bits(torch, P0, P1) and same_bits(torch, c0, c1)
        log(f"serve: frustum knobs: defaults spelled out bitwise "
            f"{same}; probe_stride=8 survivors=16: LM launches {n2}, cost "
            f"mean {float(c2.mean()):.4f} vs {float(c0.mean()):.4f}")
        require(same and n0 == n1 == 2,
                "frustum solve with the default knobs spelled out differs")
        require(n2 == 2 and bool(torch.isfinite(P2).all()),
                "frustum solve with knobs set")


def reference_phase(torch):
    from deepi2p_tpu_torch import config
    from deepi2p_tpu_torch.data import batch_to_torch, synthetic_batch
    from deepi2p_tpu_torch.models import build_detector
    from deepi2p_tpu_torch.register import sample_inits, initial_guess
    from deepi2p_tpu_torch.register import solve_frustum_batch

    cfg = config.tiny()                          # f32 compute dtype
    raw = synthetic_batch(cfg, seed=3)
    outs = {}
    for dev in ("cpu", "cuda"):
        b = batch_to_torch(raw, device=dev)
        model = build_detector(cfg, device=dev, seed=0)
        coarse, fine = model(b["pc"], b["intensity"], b["sn"], b["node_a"],
                             b["node_b"], b["img"])
        outs[dev] = (b, coarse, fine)
    b_cpu, c_cpu, f_cpu = outs["cpu"]
    b_gpu, c_gpu, f_gpu = outs["cuda"]
    scale = max(float(c_cpu.abs().max()), float(f_cpu.abs().max()), 1e-6)
    err = max(float((c_gpu.cpu() - c_cpu).abs().max()),
              float((f_gpu.cpu() - f_cpu).abs().max())) / scale
    log(f"reference: logits max rel err card vs CPU {err:.3g}")
    require(err <= REF_LOGIT_RTOL, f"reference logits rel err {err:.3g}")

    pred = c_cpu.argmax(-1)
    ang, _ = initial_guess(b_cpu["pc"], pred)
    # one seed, a CPU generator: the same inits with ang on either device
    for is_2d in (True, False):
        inits = {dev: sample_inits(torch.Generator().manual_seed(5),
                                   ang.to(dev), N_INITS, is_2d=is_2d)
                 for dev in ("cpu", "cuda")}
        require(inits["cuda"].device.type == "cuda"
                and bool(torch.equal(inits["cuda"].cpu(), inits["cpu"])),
                f"reference: sample_inits (is_2d={is_2d}) draws differ "
                f"between ang on the card and on the CPU")
    log("reference: sample_inits from one seed equal with ang on the card "
        "and on the CPU (2-D and 6-DoF)")
    theta0 = sample_inits(torch.Generator().manual_seed(0), ang, N_INITS)
    res = {}
    for dev, b in (("cpu", b_cpu), ("cuda", b_gpu)):
        P, cost = solve_frustum_batch(
            b["pc"], pred.to(dev), b["K"], H=cfg.img_H, W=cfg.img_W,
            theta0=theta0.to(dev), max_iter=MAX_ITER,
            solver_stride=SOLVER_STRIDE)
        res[dev] = (P.cpu(), cost.cpu())
    theta6 = sample_inits(torch.Generator().manual_seed(0), ang, N_INITS,
                          is_2d=False)
    res6 = {}
    for dev, b in (("cpu", b_cpu), ("cuda", b_gpu)):
        P, cost = solve_frustum_batch(
            b["pc"], pred.to(dev), b["K"], H=cfg.img_H, W=cfg.img_W,
            theta0=theta6.to(dev), max_iter=MAX_ITER,
            solver_stride=SOLVER_STRIDE, is_2d=False)
        res6[dev] = (P.cpu(), cost.cpu())
    for tag, r in (("2-D", res), ("6-DoF", res6)):
        perr = float((r["cuda"][0] - r["cpu"][0]).abs().max())
        crel = float(((r["cuda"][1] - r["cpu"][1]).abs()
                      / r["cpu"][1].abs().clamp(min=1e-6)).max())
        log(f"reference: {tag} solve pose max abs err {perr:.3g}, cost max "
            f"rel err {crel:.3g}")
        require(perr <= REF_POSE_ATOL, f"reference {tag} pose err {perr:.3g}")
        require(crel <= LM_COST_RTOL,
                f"reference {tag} cost rel err {crel:.3g}")


def train_state_equal(torch, a, b) -> bool:
    sa, sb = a.model.state_dict(), b.model.state_dict()
    return (a.step == b.step and all(torch.equal(sa[k], sb[k]) for k in sa)
            and all(torch.equal(x, y) for x, y in zip(a.mu + a.nu,
                                                      b.mu + b.nu)))


def ref_step(torch, engine, state, raw, seed: int):
    """One step's loss, metrics, gradients and running statistics (the
    last two on the CPU in float64); dropout drawn from a CPU generator
    of ``seed``."""
    loss, metrics, grads = engine.loss_and_grads(
        state, raw, torch.Generator().manual_seed(seed))
    return (float(loss), {k: float(v) for k, v in metrics.items()},
            [g.detach().cpu().double() for g in grads],
            {k: v.detach().cpu().double()
             for k, v in state.model.state_dict().items() if "running" in k})


def train_reference(torch, config):
    """One step (B=2, N=8192, 160x512, dropout uniforms from one CPU
    generator) on the card and on the CPU from the same weights and batch,
    in f32 (TF32 off) and in a float64 copy of the model
    (``compute_dtype="float64"``, weights in f64; the kNN kernel and the
    labels stay f32, as they are data).

    f32 does not resolve this network's gradient leaf by leaf: its
    rounding flips ReLU masks and max-pool winners next to ties, and each
    flip moves the gradient, so two f32 evaluations that differ only in
    their sum order (the card's and the CPU's) differ by up to about a
    percent in a leaf, and by how much in which leaf is chance.  So the f32 step holds the loss and metrics within
    TRAIN_LOSS_RTOL and the running statistics within TRAIN_STATS_RTOL of
    the CPU's, and its whole gradient within TRAIN_F32_GRAD_RTOL of the
    float64 one; the float64 copy, where no rounding reaches a tie, holds
    every gradient leaf, the loss, the metrics and the running statistics
    within TRAIN_F64_RTOL of the CPU's.  Leaves that are rounding noise
    on both devices stay below TRAIN_NOISE_LEAF of the whole gradient."""
    from deepi2p_tpu_torch.data import synthetic_batch
    from deepi2p_tpu_torch.ops.knn_cuda import knn_cuda
    from deepi2p_tpu_torch.train.engine import Engine

    runs = {}
    for dtype in ("float32", "float64"):
        cfg = config.kitti(synthetic_scene="street", input_pt_num=TRAIN_N,
                           node_a_num=TRAIN_NODES, node_b_num=TRAIN_NODES,
                           batch_size=TRAIN_REF_BATCH, compute_dtype=dtype)
        raw = synthetic_batch(cfg, seed=2)
        for dev in ("cuda", "cpu"):
            engine = Engine(cfg, device=dev)
            state = engine.init_state(seed=3)
            if dtype == "float64":
                state.model.double()
            before = knn_cuda.launches
            runs[dev, dtype] = ref_step(torch, engine, state, raw, seed=4)
            if dev == "cuda":
                require(knn_cuda.launches - before == 4,
                        f"train: the card's {dtype} reference step did not "
                        "launch the kNN kernel 4 times")

    def rel(a, b):
        return float((a - b).norm() / b.norm().clamp(min=1e-300))

    def flat(r):
        return torch.cat([g.reshape(-1) for g in r[2]])

    for dtype, tol in (("float32", TRAIN_LOSS_RTOL),
                       ("float64", TRAIN_F64_RTOL)):
        card, cpu = runs["cuda", dtype], runs["cpu", dtype]
        for k, v in {"loss": cpu[0], **cpu[1]}.items():
            got = card[0] if k == "loss" else card[1][k]
            r = abs(got - v) / max(abs(v), 1e-30)
            require(r <= tol, f"train: {dtype} card {k} {got!r} vs CPU "
                    f"{v!r} (rel {r:.3g} > {tol:g})")
        stats = max(rel(card[3][k], cpu[3][k]) for k in cpu[3])
        stol = TRAIN_STATS_RTOL if dtype == "float32" else TRAIN_F64_RTOL
        require(stats <= stol, f"train: {dtype} running statistics rel "
                f"{stats:.3g} > {stol:g}")
        log(f"train: {dtype} step card vs CPU (B={TRAIN_REF_BATCH}, "
            f"N={TRAIN_N}, {cfg.img_H}x{cfg.img_W}): loss {card[0]!r} vs "
            f"{cpu[0]!r} (rel {abs(card[0] - cpu[0]) / abs(cpu[0]):.3g}); "
            f"running statistics max rel {stats:.3g}")

    ref = runs["cpu", "float64"]
    total = float(flat(ref).norm())
    noise, leaves = [], []
    for i, g in enumerate(ref[2]):
        if all(float(r[2][i].norm()) <= TRAIN_NOISE_LEAF * total
               for r in runs.values()):
            noise.append(i)
        else:
            leaves.append(i)

    def leaf_errs(a, b):
        return sorted(rel(a[2][i], b[2][i]) for i in leaves)
    readings = {
        "card f64 vs CPU f64": leaf_errs(runs["cuda", "float64"], ref),
        "card f32 vs CPU f32": leaf_errs(runs["cuda", "float32"],
                                         runs["cpu", "float32"]),
        "card f32 vs f64": leaf_errs(runs["cuda", "float32"], ref),
        "CPU f32 vs f64": leaf_errs(runs["cpu", "float32"], ref)}
    whole = {dev: rel(flat(runs[dev, "float32"]), flat(ref))
             for dev in ("cuda", "cpu")}
    log(f"train: gradients of {len(leaves)} leaves ({len(noise)} rounding "
        "noise on every run), rel norm per leaf: " + "; ".join(
            f"{k} max {e[-1]:.3g} median {e[len(e) // 2]:.3g} over 1e-4 "
            f"{sum(x > 1e-4 for x in e)}" for k, e in readings.items())
        + f"; whole f32 gradient vs f64: card {whole['cuda']:.3g}, CPU "
        f"{whole['cpu']:.3g}")
    worst = readings["card f64 vs CPU f64"][-1]
    require(worst <= TRAIN_F64_RTOL, f"train: a float64 gradient leaf, card "
            f"vs CPU, rel {worst:.3g} > {TRAIN_F64_RTOL:g}")
    require(whole["cuda"] <= TRAIN_F32_GRAD_RTOL,
            f"train: the card's whole f32 gradient rel {whole['cuda']:.3g} "
            f"from float64 > {TRAIN_F32_GRAD_RTOL:g}")


def _train_snapshot(torch, state, metrics) -> dict:
    """Copies of a state's parameters, statistics and Adam moments (on the
    card) and of its metrics (on the host), each part one f64 vector."""
    def flat(ts):
        return torch.cat([t.detach().double().reshape(-1) for t in ts])
    sd = state.model.state_dict()
    names = {n for n, _ in state.model.named_parameters()}
    return dict(
        step=state.step,
        params=flat([sd[k] for k in sorted(names)]),
        stats=flat([sd[k] for k in sorted(sd) if "running" in k]),
        mu=flat(state.mu), nu=flat(state.nu),
        metrics=torch.tensor([float(metrics[k]) for k in sorted(metrics)],
                             dtype=torch.float64))


SCAN_PARTS = ("metrics", "params", "stats", "mu", "nu")
SCAN_SPREAD_FACTOR = 3   # where the single-step runs are not bitwise


def scan_check(torch, engine, state0, batches) -> dict:
    """One ``train_step_scan`` of TRAIN_SCAN_K steps against
    TRAIN_SCAN_RUNS runs of TRAIN_SCAN_K ``train_step`` calls, each from a
    copy of ``state0`` and a generator of one seed, on the stack of
    ``batches`` cycled, with cuDNN deterministic, PyTorch's deterministic
    algorithms (``warn_only``: an op without one warns, and the warnings
    are returned) and TF32 off.  Where the runs are bitwise equal, the
    call must be bitwise equal to them in every part (metrics,
    parameters, running statistics, Adam moments); else the relative norm
    of its difference from the nearest run must stay within
    SCAN_SPREAD_FACTOR times the largest between two runs."""
    import copy
    import warnings
    from deepi2p_tpu_torch.ops.knn_cuda import knn_cuda

    K = TRAIN_SCAN_K
    steps = [batches[i % len(batches)] for i in range(K)]
    stack = {k: torch.stack([b[k] for b in steps]) for k in steps[0]}
    det = (torch.backends.cudnn.deterministic,
           torch.are_deterministic_algorithms_enabled(),
           torch.is_deterministic_algorithms_warn_only_enabled())
    torch.backends.cudnn.deterministic = True
    torch.use_deterministic_algorithms(True, warn_only=True)
    try:
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("default")
            runs = []
            for _ in range(TRAIN_SCAN_RUNS):
                state = copy.deepcopy(state0)
                gen = torch.Generator(device="cuda").manual_seed(7)
                for b in steps:
                    _, metrics = engine.train_step(state, b, gen)
                runs.append(_train_snapshot(torch, state, metrics))
                del state
            state = copy.deepcopy(state0)
            gen = torch.Generator(device="cuda").manual_seed(7)
            before = knn_cuda.launches
            _, metrics = engine.train_step_scan(state, stack, gen)
            torch.cuda.synchronize()
            launches = knn_cuda.launches - before
            scan = _train_snapshot(torch, state, metrics)
            del state
    finally:
        torch.backends.cudnn.deterministic = det[0]
        torch.use_deterministic_algorithms(det[1], warn_only=det[2])
    nondet = sorted({str(w.message).split(".")[0][:120] for w in caught
                     if "determinis" in str(w.message)})
    require(launches == 4 * K, f"train: a {K}-step call launched the kNN "
            f"kernel {launches} times, not {4 * K}")
    require(all(r["step"] == scan["step"] == state0.step + K for r in runs),
            f"train: steps {[r['step'] for r in runs]}, scan {scan['step']}")

    def rel(a, b):
        return float((a - b).norm() / b.norm().clamp(min=1e-300))
    same = {p: all(torch.equal(runs[0][p], r[p]) for r in runs[1:])
            for p in SCAN_PARTS}
    bitwise = {p: all(torch.equal(scan[p], r[p]) for r in runs)
               for p in SCAN_PARTS}
    spread = {p: max(rel(a[p], b[p]) for i, a in enumerate(runs)
                     for b in runs[i + 1:]) for p in SCAN_PARTS}
    dev = {p: min(rel(scan[p], r[p]) for r in runs) for p in SCAN_PARTS}
    for p in SCAN_PARTS:
        require(bitwise[p] if same[p] else
                dev[p] <= SCAN_SPREAD_FACTOR * spread[p],
                f"train: the {K}-step call's {p} {dev[p]:.3g} from the "
                f"nearest of {TRAIN_SCAN_RUNS} runs of {K} steps, whose "
                f"spread is {spread[p]:.3g} (runs bitwise: {same[p]})")
    return dict(bitwise=all(bitwise.values()), runs_bitwise=same,
                spread=spread, dev=dev, launches=launches, nondet=nondet,
                loss=float(metrics["loss"]))


def norm_phase(torch) -> dict:
    """The norm kernel pair at the B = 64 train step's shapes: against
    its plain version, bitwise repeatable, its times."""
    from deepi2p_tpu_torch import profile_norm
    from deepi2p_tpu_torch.ops.norm_cuda import norm_cuda

    rows = {}
    for name, (shape, ch, cl) in profile_norm.shapes(NORM_BATCH).items():
        before = norm_cuda.launches
        gaps = profile_norm.compare(shape, ch, cl)
        launches = norm_cuda.launches - before
        log(f"norm {name} {shape}{' channels-last' if cl else ''}: "
            + json.dumps(gaps) + f", {launches} launches")
        bad = {k: v for k, v in gaps.items()
               if k in NORM_RTOL and not v < NORM_RTOL[k]}
        exact = all(gaps[k] == 0 for k in ("y", "running_mean",
                                           "running_var"))
        require(not bad and exact and gaps["bitwise_repeat"]
                and launches == 2 * 6,
                f"norm {name}: kernel against plain version {bad}, y and "
                f"running statistics bitwise {exact}, repeat bitwise "
                f"{gaps['bitwise_repeat']}, {launches} launches for two "
                "kernel forward and backward calls")
        t = profile_norm.times(shape, ch, cl)
        log(f"norm {name}: " + json.dumps(t))
        rows[name] = dict(**gaps, **t)
        torch.cuda.empty_cache()
    return rows


def train_phase(torch):
    """The training path at the committed KITTI-shaped run: timed bf16
    steps, kNN launches per step, the kNN at the training forward's four
    calls, K steps per call against K single steps, learning on one
    batch, checkpoints, and the card against the CPU."""
    from deepi2p_tpu_torch import config
    from deepi2p_tpu_torch.data import batch_to_torch, synthetic_batch
    from deepi2p_tpu_torch.models.layers import Norm
    from deepi2p_tpu_torch.ops.knn_cuda import knn_cuda
    from deepi2p_tpu_torch.ops.norm_cuda import norm_cuda
    from deepi2p_tpu_torch.profile_knn import forward_calls
    from deepi2p_tpu_torch.train.checkpoint import (CheckpointManager,
                                                    export_npz,
                                                    warm_start_npz)
    from deepi2p_tpu_torch.train.engine import Engine

    cfg = config.kitti(synthetic_scene="street", input_pt_num=TRAIN_N,
                       node_a_num=TRAIN_NODES, node_b_num=TRAIN_NODES)
    B = cfg.batch_size
    require(B == 8 and cfg.compute_dtype == "bfloat16",
            "train: the KITTI preset is B=8, bf16")
    t = time.perf_counter()
    batches = [batch_to_torch(synthetic_batch(cfg, seed=s), device="cuda")
               for s in (10, 11)]
    log(f"train: two street batches of B={B}, N={TRAIN_N} generated in "
        f"{time.perf_counter() - t:.2f} s (before the clock)")
    err = max(check_knn(torch, f"train {name}", q, db, k)
              for name, q, db, k in forward_calls(batches[0], cfg))

    engine = Engine(cfg, steps_per_epoch=1000, device="cuda")
    state = engine.init_state(seed=0)
    gen = torch.Generator(device="cuda").manual_seed(0)
    for i in range(TRAIN_WARMUP):
        engine.train_step(state, batches[i % 2], gen)
    torch.cuda.synchronize()
    scan = scan_check(torch, engine, state, batches)
    K = TRAIN_SCAN_K
    log(f"train: one {K}-step train_step_scan against {TRAIN_SCAN_RUNS} "
        f"runs of {K} train_step calls from one state and generator seed "
        f"(cuDNN deterministic, deterministic algorithms, TF32 off): "
        + ("bitwise equal in every metric, parameter, running statistic "
           "and Adam moment" if scan["bitwise"] else
           "not bitwise; relative norm from the nearest run against the "
           "runs' own spread: " + ", ".join(
               f"{p} {scan['dev'][p]:.3g} vs {scan['spread'][p]:.3g}"
               + (" (runs bitwise)" if scan["runs_bitwise"][p] else "")
               for p in SCAN_PARTS))
        + f"; kNN launches per call {scan['launches']}; last-trip loss "
        f"{scan['loss']:.6f}; ops without a deterministic algorithm: "
        + ("; ".join(scan["nondet"]) or "none"))
    torch.cuda.reset_peak_memory_stats()
    knn_cuda.launches = 0
    norm_cuda.launches = 0
    losses = []
    t = time.perf_counter()
    for i in range(TRAIN_TIMED):
        _, metrics = engine.train_step(state, batches[i % 2], gen)
        losses.append(metrics["loss"])
    torch.cuda.synchronize()
    dt = time.perf_counter() - t
    launches = knn_cuda.launches
    norms = sum(isinstance(m, Norm) for m in state.model.modules())
    norm_per_step = norm_cuda.launches // TRAIN_TIMED
    require(norm_cuda.launches == 6 * norms * TRAIN_TIMED,
            f"train: {norm_cuda.launches} norm launches in {TRAIN_TIMED} "
            f"steps, not 6 for each of the model's {norms} norms")
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    losses = [float(x) for x in losses]
    require(all(math.isfinite(x) for x in losses),
            f"train: non-finite loss in {losses}")
    require(launches == 4 * TRAIN_TIMED,
            f"train: {launches} kNN launches in {TRAIN_TIMED} steps, not "
            f"{4 * TRAIN_TIMED}")
    ms = dt / TRAIN_TIMED * 1e3
    log(f"train: {TRAIN_TIMED} bf16 steps (B={B}, N={TRAIN_N}, "
        f"{cfg.img_H}x{cfg.img_W}, after {TRAIN_WARMUP} warm-up): "
        f"{ms:.3f} ms/step, {B * TRAIN_TIMED / dt:.2f} samples/s, peak "
        f"memory {peak:.3f} GiB, kNN launches {launches} "
        f"({launches // TRAIN_TIMED} per step), norm launches "
        f"{norm_per_step} per step ({norms} norms); losses "
        + " ".join(f"{x:.4f}" for x in losses))

    stack = {k: torch.stack([batches[i % 2][k] for i in range(K)])
             for k in batches[0]}
    knn_cuda.launches = 0
    scan_losses = []
    t = time.perf_counter()
    for _ in range(TRAIN_SCAN_CALLS):
        _, metrics = engine.train_step_scan(state, stack, gen)
        scan_losses.append(metrics["loss"])
    torch.cuda.synchronize()
    dt_scan = time.perf_counter() - t
    scan_losses = [float(x) for x in scan_losses]
    require(all(math.isfinite(x) for x in scan_losses)
            and knn_cuda.launches == 4 * K * TRAIN_SCAN_CALLS,
            f"train: {K}-step calls: losses {scan_losses}, kNN launches "
            f"{knn_cuda.launches}")
    ms_scan = dt_scan / (K * TRAIN_SCAN_CALLS) * 1e3
    per_call = knn_cuda.launches // TRAIN_SCAN_CALLS
    log(f"train: {TRAIN_SCAN_CALLS} train_step_scan calls of {K} steps "
        f"right after: {ms_scan:.3f} ms/step at K={K} against {ms:.3f} at "
        f"K=1, kNN launches {knn_cuda.launches} ({per_call} per call); "
        "last-trip losses "
        + " ".join(f"{x:.4f}" for x in scan_losses))

    learn = []
    for _ in range(TRAIN_LEARN):
        _, metrics = engine.train_step(state, batches[0], gen)
        learn.append(metrics["loss"])
    learn = [float(x) for x in learn]
    require(all(math.isfinite(x) for x in learn) and learn[-1] < learn[0],
            f"train: the loss did not fall over {TRAIN_LEARN} steps on one "
            f"batch: {learn}")
    log(f"train: {TRAIN_LEARN} steps on one batch: loss {learn[0]:.4f} -> "
        f"{learn[-1]:.4f}")

    with tempfile.TemporaryDirectory(prefix="deepi2p_train_") as d:
        mgr = CheckpointManager(d, max_to_keep=2)
        mgr.save(state)
        other = engine.init_state(seed=1)
        mgr.restore(other)
        require(train_state_equal(torch, state, other),
                "train: CheckpointManager restore differs from the save")
        path = f"{d}/latest.npz"
        export_npz(state, path)
        other = warm_start_npz(engine.init_state(seed=1), path)
        sa, sb = state.model.state_dict(), other.model.state_dict()
        require(other.step == state.step
                and all(torch.equal(sa[k], sb[k]) for k in sa),
                "train: export_npz -> warm_start_npz differs")
    log(f"train: checkpoint round trip (CheckpointManager, export_npz -> "
        f"warm_start_npz) exact at step {state.step}")
    del state, other, batches
    torch.cuda.empty_cache()

    train_reference(torch, config)
    return dict(ms=ms, samples_s=B * TRAIN_TIMED / dt, peak_gib=peak,
                launches_per_step=launches // TRAIN_TIMED, knn_err=err,
                norm_launches_per_step=norm_per_step,
                ms_scan=ms_scan, scan_launches_per_call=scan["launches"],
                scan_bitwise=scan["bitwise"])


KITTI_K = ("7.215377e+02 0 6.095593e+02 {tx} 0 7.215377e+02 1.728540e+02 "
           "0 0 0 1 0")
KITTI_TR = "0 -1 0 0 0 0 -1 -0.08 1 0 0 -0.27"


def kitti_calib(calib_dir) -> None:
    """A KITTI-like ``calib.txt`` (P0-P3, Tr) in ``calib_dir``."""
    calib_dir.mkdir(parents=True)
    (calib_dir / "calib.txt").write_text("".join(
        f"{cam}: {KITTI_K.format(tx=tx)}\n" for cam, tx in
        (("P0", 0), ("P1", -386.1448), ("P2", 44.85728),
         ("P3", -337.2877))) + f"Tr: {KITTI_TR}\n")


def kitti_tree(root, seed: int = 0) -> int:
    """A KITTI-layout tree under ``root``, made from ``seed``: sequence 00
    (train) with DATA_TRAIN_FRAMES frames and 09 (val) with
    DATA_VAL_FRAMES, each frame DATA_POINTS points x 7 channels (street
    scenes of the synthetic generator in NWU: xyz, intensity, normals) and
    two 376x1241x3 uint8 images (image_3 a symlink to image_2), poses
    0.5 m apart along x and a KITTI-like calib.txt.  The frames cycle
    through DATA_DISTINCT distinct clouds and images.  Returns the bytes
    written."""
    import os
    from pathlib import Path
    import numpy as np
    from deepi2p_tpu_torch.data.synthetic import _street_scene

    root = Path(root)
    rng = np.random.default_rng(seed)
    clouds, images = [], []
    for _ in range(DATA_DISTINCT):
        pc, sn, inten, _ = _street_scene(rng, DATA_POINTS)
        # camera (x right, y down, z forward) -> NWU (x fwd, y left, z up)
        nwu = np.stack([pc[:, 2], -pc[:, 0], -pc[:, 1]], 1)
        nsn = np.stack([sn[:, 2], -sn[:, 0], -sn[:, 1]], 1)
        clouds.append(np.concatenate([nwu, inten, nsn], 1).T.astype(
            np.float32))
        images.append(rng.integers(0, 256, (376, 1241, 3), dtype=np.uint8))
    written = 0
    for seq, n in (("00", DATA_TRAIN_FRAMES), ("09", DATA_VAL_FRAMES)):
        pcdir = (root / "data_odometry_velodyne_NWU" / "sequences" / seq
                 / "voxel0.1-SNr0.6")
        imgdir = root / "data_odometry_color_npy" / "sequences" / seq
        posedir = root / "poses" / seq
        kitti_calib(root / "calib" / seq)
        for d in (pcdir, imgdir / "image_2", imgdir / "image_3", posedir):
            d.mkdir(parents=True)
        for i in range(n):
            np.save(pcdir / f"{i:06d}.npy", clouds[i % DATA_DISTINCT])
            np.save(imgdir / "image_2" / f"{i:06d}.npy",
                    images[i % DATA_DISTINCT])
            os.symlink(f"../image_2/{i:06d}.npy",
                       imgdir / "image_3" / f"{i:06d}.npy")
            pose = np.eye(4, dtype=np.float32)
            pose[0, 3] = 0.5 * i
            np.savez(posedir / f"{i:06d}.npz", pose=pose)
            written += clouds[0].nbytes + images[0].nbytes
    return written


class Cycled:
    """``n`` samples of ``ds``, index i read as ``ds[i % len(ds)]``: one
    epoch as long as a timed window needs."""

    def __init__(self, ds, n: int):
        self.ds, self.n = ds, n

    def __len__(self):
        return self.n

    def __getitem__(self, i):
        return self.ds[i % len(self.ds)]


def loader_rate(cfg, root, workers: int, loader=None) -> float:
    """Host samples/s of a train loader (KITTI's unless ``loader`` names
    another) through ``BatchLoader`` with ``workers`` threads:
    ``DATA_RATE_BATCHES[workers]`` batches timed after the first
    ``workers`` (untimed: they start together), all in one epoch, so
    every thread has a batch to make throughout the window."""
    from deepi2p_tpu_torch.data import BatchLoader, KittiLoader

    B, timed = cfg.batch_size, DATA_RATE_BATCHES[workers]
    data = Cycled((loader or KittiLoader)(root, "train", cfg),
                  B * (workers + timed))
    it = iter(BatchLoader(data, B, num_workers=workers, seed=workers))
    for _ in range(workers):
        next(it)
    t = time.perf_counter()
    for _ in range(timed):
        next(it)
    dt = time.perf_counter() - t
    it.close()
    return timed * B / dt


def _loader_proc(cfg, root, rank: int, barrier, out):
    """One process of ``loader_rate_processes``: a warm-up sample, then
    DATA_PROC_SAMPLES timed samples after every process is ready."""
    from deepi2p_tpu_torch.data import KittiLoader

    loader = KittiLoader(root, "train", cfg, seed=rank)
    loader[rank]
    barrier.wait()
    t = time.perf_counter()
    for i in range(DATA_PROC_SAMPLES):
        loader[(rank * DATA_PROC_SAMPLES + i) % len(loader)]
    out.put((t, time.perf_counter()))


def _threads_proc(cfg, root, workers: int, out):
    """``loader_rate`` in a process of its own."""
    out.put(loader_rate(cfg, root, workers))


BLAS_THREAD_VARS = ("OMP_NUM_THREADS", "OPENBLAS_NUM_THREADS",
                    "MKL_NUM_THREADS")


@contextlib.contextmanager
def spawned(target, args_of, n: int, blas_threads: int = 0):
    """``target(*args_of(rank), out)`` in ``n`` spawned processes, each
    with at most ``blas_threads`` BLAS threads (0: numpy's default, one
    per core); yields ``out``, the queue they answer on.  Every process
    is joined (or terminated) on the way out."""
    import multiprocessing as mp
    import os

    ctx = mp.get_context("spawn")
    out = ctx.Queue()
    ps = [ctx.Process(target=target, args=(*args_of(r), out))
          for r in range(n)]
    saved = {k: os.environ.get(k) for k in BLAS_THREAD_VARS}
    try:
        if blas_threads:
            os.environ.update({k: str(blas_threads)
                               for k in BLAS_THREAD_VARS})
        for p in ps:
            p.start()
    finally:
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v
    try:
        yield out
    finally:
        for p in ps:
            p.join(timeout=30)
            if p.is_alive():
                p.terminate()
                p.join()
    require(all(p.exitcode == 0 for p in ps),
            f"data: processes exited {[p.exitcode for p in ps]}")


def answers(out, n: int) -> list:
    return [out.get(timeout=180) for _ in range(n)]


def loader_rate_processes(cfg, root, procs: int,
                          blas_threads: int = 0) -> float:
    """Host samples/s of ``procs`` processes, each with its own KITTI
    train loader (no shared interpreter lock), from the first start to
    the last end of DATA_PROC_SAMPLES samples each."""
    import multiprocessing as mp

    barrier = mp.get_context("spawn").Barrier(procs)
    with spawned(_loader_proc, lambda r: (cfg, root, r, barrier), procs,
                 blas_threads) as out:
        spans = answers(out, procs)
    span = max(b for _, b in spans) - min(a for a, _ in spans)
    return procs * DATA_PROC_SAMPLES / span


def _loader_spin(cfg, root, rank: int, barrier, stop, out):
    """One background process of ``steps_beside_processes``: samples
    from a warm loader until ``stop``; answers (samples, seconds)."""
    from deepi2p_tpu_torch.data import KittiLoader

    loader = KittiLoader(root, "train", cfg, seed=rank)
    loader[rank]
    barrier.wait(timeout=180)
    t, n = time.perf_counter(), 0
    while not stop.is_set():
        loader[(rank + n * DATA_WORKERS) % len(loader)]
        n += 1
    out.put((n, time.perf_counter() - t))


def steps_beside_processes(torch, engine, state, batch, gen, cfg, root):
    """ms per train step on ``batch`` (already on the card) while
    DATA_WORKERS processes, one BLAS thread each, load KITTI samples
    beside it (the host's cores busy, no shared interpreter lock), and
    the processes' samples/s meanwhile."""
    import multiprocessing as mp

    ctx = mp.get_context("spawn")
    barrier, stop = ctx.Barrier(DATA_WORKERS + 1), ctx.Event()
    with spawned(_loader_spin, lambda r: (cfg, root, r, barrier, stop),
                 DATA_WORKERS, 1) as out:
        barrier.wait(timeout=180)
        try:
            torch.cuda.synchronize()
            t = time.perf_counter()
            for _ in range(DATA_STEPS):
                engine.train_step(state, batch, gen)
            torch.cuda.synchronize()
            dt = time.perf_counter() - t
        finally:
            stop.set()
        got = answers(out, DATA_WORKERS)
    return dt / DATA_STEPS * 1e3, sum(n / s for n, s in got)


DATA_SPLIT = ("_accumulate", "resample_points", "voxel_downsample_np",
              "process_image", "resize_linear", "maybe_color_jitter",
              "_pick_j", "assemble_sample")


def loader_split(cfg, root, samples: int = 8) -> dict:
    """Host seconds per sample of the KITTI train loader's stages, one
    thread, from ``cProfile`` over ``samples`` samples (cumulative time of
    each function; the profiler's own cost inflates the total a little)."""
    import cProfile
    import pstats
    from deepi2p_tpu_torch.data import KittiLoader

    loader = KittiLoader(root, "train", cfg, seed=1)
    prof = cProfile.Profile()
    t = time.perf_counter()
    prof.runcall(lambda: [loader[i] for i in range(samples)])
    total = time.perf_counter() - t
    split = {"total": total / samples}
    for (_, _, name), row in pstats.Stats(prof).stats.items():
        if name in DATA_SPLIT:
            split[name] = split.get(name, 0.0) + row[3] / samples
    return split


def data_phase(torch, train):
    """The real-dataset path on a KITTI-layout tree: the native core, the
    loader's host rate, training from disk through the threaded loader and
    the pinned prefetch, and the dump and frustum solve of the val
    split."""
    import numpy as np
    from deepi2p_tpu_torch import config
    from deepi2p_tpu_torch.data import (BatchLoader, KittiLoader,
                                        device_prefetch, native)
    from deepi2p_tpu_torch.ops.knn_cuda import knn_cuda
    from deepi2p_tpu_torch.train.engine import Engine

    with tempfile.TemporaryDirectory(prefix="deepi2p_kitti_") as tmp:
        root = f"{tmp}/kitti"
        t = time.perf_counter()
        written = kitti_tree(root)
        log(f"data: KITTI tree of {DATA_TRAIN_FRAMES} + {DATA_VAL_FRAMES} "
            f"frames ({DATA_POINTS} points x 7, 376x1241x3 uint8 images, "
            f"image_3 linked to image_2): {written / 2 ** 30:.3f} GiB "
            f"written in {time.perf_counter() - t:.2f} s")

        t = time.perf_counter()
        lib = native.build()
        require(native.available(), "data: the native core did not load")
        log(f"data: native core {lib.name} (built in the build phase) "
            f"loaded in {time.perf_counter() - t:.2f} s")

        cfg = config.kitti(input_pt_num=TRAIN_N, node_a_num=TRAIN_NODES,
                           node_b_num=TRAIN_NODES)
        B = cfg.batch_size
        train_ds = KittiLoader(root, "train", cfg)
        require(len(train_ds) == 32 and train_ds.native,
                f"data: {len(train_ds)} train samples, native "
                f"{train_ds.native}")
        rates = {w: loader_rate(cfg, root, w) for w in DATA_RATE_BATCHES}
        log(f"data: KITTI train loader (N={TRAIN_N}, {TRAIN_NODES} + "
            f"{TRAIN_NODES} nodes, 3 + 3 accumulated frames, color jitter; "
            f"reads from the page cache: the tree was just written): "
            + ", ".join(f"{w} thread(s) {r:.2f} samples/s over "
                        f"{DATA_RATE_BATCHES[w]} batches"
                        for w, r in rates.items()))
        with spawned(_threads_proc, lambda r: (cfg, root, DATA_WORKERS),
                     1, 1) as out:
            threads1, = answers(out, 1)
        log(f"data: {DATA_WORKERS} threads in a process with one BLAS "
            f"thread (numpy's default is one per core): {threads1:.2f} "
            f"samples/s")
        procs = {b: loader_rate_processes(cfg, root, DATA_WORKERS, b)
                 for b in (0, 1)}
        log(f"data: the same loader in {DATA_WORKERS} processes (one "
            f"interpreter each, {DATA_PROC_SAMPLES} samples each): "
            f"{procs[0]:.2f} samples/s with numpy's default BLAS threads, "
            f"{procs[1]:.2f} with one BLAS thread per process")
        split = loader_split(cfg, root)
        log("data: host ms per sample, one thread, under cProfile: "
            + ", ".join(f"{k} {v * 1e3:.1f}" for k, v in split.items()))

        # training from disk.  The engine takes DATA_WARMUP steps on one
        # host batch moved by the prefetch (held bitwise to it) before the
        # loader starts, so its slow first steps fill no buffer; then steps
        # run until one after the first waits DATA_DRAINED_MS for its batch
        # (the batches made ahead are used up) or DATA_DRAIN_MAX steps,
        # and DATA_STEPS steps are timed, all in one epoch of the 32 train
        # samples cycled, through DATA_WORKERS threads and the prefetch
        engine = Engine(cfg, steps_per_epoch=len(train_ds) // B,
                        device="cuda")
        state = engine.init_state(seed=0)
        gen = torch.Generator(device="cuda").manual_seed(0)
        one = iter(BatchLoader(train_ds, B, seed=1))
        host = next(one)
        one.close()
        first, = device_prefetch([host], "cuda")
        require(first["img"].is_cuda and all(
            np.array_equal(first[k].cpu().numpy(), host[k]) for k in host),
            "data: the prefetched batch differs from its host batch")
        for _ in range(DATA_WARMUP):
            engine.train_step(state, first, gen)
        torch.cuda.synchronize()
        stream = device_prefetch(BatchLoader(
            Cycled(train_ds, B * (DATA_DRAIN_MAX + DATA_STEPS
                                  + DATA_WORKERS)),
            B, seed=0, num_workers=DATA_WORKERS), "cuda")

        def step():
            t0 = time.perf_counter()
            batch = next(stream)
            wait = time.perf_counter() - t0
            _, metrics = engine.train_step(state, batch, gen)
            return wait, metrics["loss"]

        drain = 0
        while drain < DATA_DRAIN_MAX:
            drain += 1
            if step()[0] * 1e3 >= DATA_DRAINED_MS and drain > 1:
                break
        torch.cuda.synchronize()
        knn_cuda.launches = 0
        t = time.perf_counter()
        runs = [step() for _ in range(DATA_STEPS)]
        torch.cuda.synchronize()
        dt = time.perf_counter() - t
        stream.close()
        waits = [w for w, _ in runs]
        launches = knn_cuda.launches
        losses = [float(x) for _, x in runs]
        require(all(math.isfinite(x) for x in losses),
                f"data: non-finite loss in {losses}")
        require(launches == 4 * DATA_STEPS,
                f"data: {launches} kNN launches in {DATA_STEPS} steps")
        ms = dt / DATA_STEPS * 1e3
        log(f"data: prefetched batch bitwise its host batch; "
            f"{DATA_STEPS} bf16 steps from disk (B={B}, N={TRAIN_N}, "
            f"{DATA_WORKERS} loader threads, after {DATA_WARMUP} warm-up "
            f"steps and {drain} more to use up the batches made ahead; "
            f"reads from the page cache): {ms:.3f} ms/step, "
            f"{B * DATA_STEPS / dt:.2f} samples/s end to end; the step "
            f"waited for its batch {sum(waits) / DATA_STEPS * 1e3:.3f} ms "
            f"on average (least {min(waits) * 1e3:.3f}, first "
            f"{waits[0] * 1e3:.3f}), against {train['ms']:.3f} ms/step, "
            f"{train['samples_s']:.2f} samples/s on batches already on the "
            f"card (train phase); kNN launches {launches} "
            f"({launches // DATA_STEPS} per step); losses "
            + " ".join(f"{x:.4f}" for x in losses))
        torch.cuda.synchronize()
        t = time.perf_counter()
        for _ in range(DATA_STEPS):
            engine.train_step(state, first, gen)
        torch.cuda.synchronize()
        alone_ms = (time.perf_counter() - t) / DATA_STEPS * 1e3
        beside_ms, beside_rate = steps_beside_processes(
            torch, engine, state, first, gen, cfg, root)
        log(f"data: {DATA_STEPS} steps on one batch already on the card: "
            f"{alone_ms:.3f} ms/step alone, {beside_ms:.3f} while "
            f"{DATA_WORKERS} loader processes (one BLAS thread each) load "
            f"beside them at {beside_rate:.2f} samples/s, against "
            f"{ms:.3f} from disk beside {DATA_WORKERS} loader threads")

        def failing():
            yield host
            raise IOError("data: a failing loader")

        moved = device_prefetch(failing(), "cuda")
        next(moved)
        try:
            next(moved)
            require(False, "data: the prefetch lost its loader's failure")
        except IOError:
            pass
        del state, first, engine, moved, stream
        torch.cuda.empty_cache()

        with torch.no_grad():
            lm_launches = dump_and_solve(torch, root, f"{tmp}/dump")
        oxford = oxford_data(torch, tmp)
    return dict(knn_per_step=launches // DATA_STEPS, lm=lm_launches,
                rates=rates, procs=procs, ms=ms, oxford=oxford)


def oxford_tree(root, jpeg_path) -> int:
    """An Oxford-layout tree under ``root``: traversal ``t0`` in train.txt
    with OX_TRAIN clouds, ``v0`` in val.txt with OX_VAL, each cloud
    OX_POINTS points of a synthetic street scene in camera coordinates plus
    intensity (4, N), two camera frames per cloud, every frame a link to
    one copy of the 1280x960 JPEG ``jpeg_path``; poses 2 m apart per
    cloud along the stored x (the camera's z).  Returns the bytes
    written."""
    import os
    import shutil
    from pathlib import Path
    import numpy as np
    from deepi2p_tpu_torch.data.synthetic import _street_scene

    root = Path(root)
    root.mkdir(parents=True)
    rng = np.random.default_rng(0)
    clouds = []
    for _ in range(DATA_DISTINCT):
        pc, _, inten, _ = _street_scene(rng, OX_POINTS)
        clouds.append(np.concatenate([pc, inten], 1).T.astype(np.float32))
    shutil.copy(jpeg_path, root / "frame.jpg")
    written = os.path.getsize(root / "frame.jpg")
    for split, trav, n in (("train", "t0", OX_TRAIN), ("val", "v0", OX_VAL)):
        (root / f"{split}.txt").write_text(f"{trav}\n")
        tdir = root / trav
        (tdir / "lms_front").mkdir(parents=True)
        (tdir / "stereo" / "centre").mkdir(parents=True)
        pc_ts = np.arange(n) * 1000 + 100
        cam_ts = np.arange(2 * n) * 500 + 50

        def poses(ts):
            out = np.tile(np.eye(4), (len(ts), 1, 1))
            out[:, 0, 3] = np.asarray(ts) * 2e-3
            return out
        np.save(tdir / "pc_timestamps.npy", pc_ts)
        np.save(tdir / "pc_poses.npy", poses(pc_ts))
        np.save(tdir / "camera_timestamps.npy", cam_ts)
        np.save(tdir / "camera_poses.npy", poses(cam_ts))
        for i, ts in enumerate(pc_ts):
            np.save(tdir / "lms_front" / f"{ts}.npy",
                    clouds[i % DATA_DISTINCT])
            written += clouds[0].nbytes
        for ts in cam_ts:
            os.symlink(root / "frame.jpg",
                       tdir / "stereo" / "centre" / f"{ts}.jpg")
    return written


def jpeg_checks() -> dict:
    """Every committed fixture decoded at scales 1, 1/2, 1/4 and 1/8 held
    to its cv2 digest; the Oxford frame's decode timed at full and half
    size (ms per image)."""
    import hashlib
    from pathlib import Path
    from deepi2p_tpu_torch.data import jpeg

    here = Path(__file__).resolve().parent / JPEG_FIXTURES
    table = json.loads((here / "digests.json").read_text())
    for name, scales in table.items():
        for denom, (h, w, digest) in scales.items():
            rgb = jpeg.decode(here / name, int(denom))
            require(rgb.shape == (h, w, 3) and hashlib.sha256(
                rgb.tobytes()).hexdigest() == digest,
                f"jpeg: {name} at 1/{denom} differs from its cv2 digest")
    data = (here / OXFORD_JPEG).read_bytes()
    ms = {}
    for denom in (1, 2):
        jpeg.decode(data, denom)
        t = time.perf_counter()
        for _ in range(DECODE_REPS):
            jpeg.decode(data, denom)
        ms[denom] = (time.perf_counter() - t) / DECODE_REPS * 1e3
    log(f"data: {len(table)} fixture JPEGs decoded to their cv2 digests at "
        f"scales 1, 1/2, 1/4, 1/8; {OXFORD_JPEG} ({len(data)} bytes) "
        f"{ms[1]:.3f} ms per image at full size, {ms[2]:.3f} ms at half "
        f"(one thread, mean of {DECODE_REPS})")
    return dict(full_ms=ms[1], half_ms=ms[2], path=here / OXFORD_JPEG)


def oxford_data(torch, tmp) -> dict:
    """The Oxford path on a tree of the committed fixture JPEG: the train
    loader's host samples/s at ``config.oxford()`` with 1 and
    DATA_WORKERS threads, ``eval.cli dump --dataset oxford`` of the val
    split (2 batches of 8, 8 kNN launches) and ``eval.cli solve --method
    frustum`` on the card (2-D LM launches)."""
    from deepi2p_tpu_torch import config
    from deepi2p_tpu_torch.data import OxfordLoader
    from deepi2p_tpu_torch.eval import cli as eval_cli
    from deepi2p_tpu_torch.eval.dump import list_dump_prefixes
    from deepi2p_tpu_torch.ops.knn_cuda import knn_cuda
    from deepi2p_tpu_torch.register import lm_solve_cuda

    dec = jpeg_checks()
    root = f"{tmp}/oxford"
    written = oxford_tree(root, dec["path"])
    cfg = config.oxford()
    train_ds = OxfordLoader(root, "train", cfg)
    require(len(train_ds) == OX_TRAIN and train_ds.native,
            f"data: {len(train_ds)} Oxford train samples")
    img = train_ds[0]["img"]
    require(img.shape == (cfg.img_H, cfg.img_W, 3),
            f"data: Oxford sample image {img.shape}")
    rates = {w: loader_rate(cfg, root, w, OxfordLoader)
             for w in DATA_RATE_BATCHES}
    log(f"data: Oxford tree ({OX_TRAIN} + {OX_VAL} clouds of {OX_POINTS} "
        f"points, 1280x960 JPEG frames decoded at half size): "
        f"{written / 2 ** 20:.1f} MiB; train loader at config.oxford() "
        f"(N={cfg.input_pt_num}, B={cfg.batch_size}): "
        + ", ".join(f"{w} thread(s) {r:.2f} samples/s over "
                    f"{DATA_RATE_BATCHES[w]} batches"
                    for w, r in rates.items()))
    dump_dir = f"{tmp}/oxford_dump"
    knn_cuda.launches = 0
    t = time.perf_counter()
    with torch.no_grad():
        acc = eval_cli.main(["dump", "--dataset", "oxford", "--dataroot",
                             root, "--out", dump_dir, "--max-batches", "2"])
    torch.cuda.synchronize()
    dump_s = time.perf_counter() - t
    dump_knn = knn_cuda.launches
    n = len(list_dump_prefixes(dump_dir))
    require(n == 2 * cfg.batch_size, f"data: {n} Oxford pairs dumped")
    require(dump_knn == 8, f"data: Oxford dump kNN launches {dump_knn}")
    lm_solve_cuda.launches = 0
    t = time.perf_counter()
    with torch.no_grad():
        summ = eval_cli.main(["solve", "--data-dir", dump_dir, "--method",
                              "frustum", "--img-h", str(cfg.img_H),
                              "--img-w", str(cfg.img_W), "--max-iter",
                              str(EVAL_MAX_ITER)])
    torch.cuda.synchronize()
    solve_s = time.perf_counter() - t
    lm = lm_solve_cuda.launches
    require(summ["num_pairs"] == n and all(
        math.isfinite(summ[k]) for k in ("rte_mean", "rre_mean",
                                         "success_rate")),
        f"data: Oxford solve summary {summ}")
    require(lm >= 2, f"data: Oxford solve {lm} LM launches")
    log(f"data: eval.cli dump --dataset oxford (val_random_Ry, "
        f"N={cfg.input_pt_num}, {cfg.img_H}x{cfg.img_W}, 2 batches of "
        f"{cfg.batch_size}, seeded weights): {dump_s:.3f} s wall, kNN "
        f"launches {dump_knn}, accuracy {json.dumps(acc)}; solve --method "
        f"frustum {solve_s:.3f} s wall, 2-D LM launches {lm}")
    return dict(decode=dec, rates=rates, lm=lm)


def dump_and_solve(torch, root, dump_dir) -> int:
    """``eval.cli dump --dataset kitti`` of the tree's val split at
    ``config.kitti()`` with seeded weights, ``eval.cli solve --method
    frustum`` on the card, and the 2-D LM held to its plain version on the
    dump's labels and predictions; returns the solve's LM launches."""
    import numpy as np
    from deepi2p_tpu_torch import config
    from deepi2p_tpu_torch.eval import cli as eval_cli
    from deepi2p_tpu_torch.eval.dump import list_dump_prefixes, load_dump
    from deepi2p_tpu_torch.ops.knn_cuda import knn_cuda
    from deepi2p_tpu_torch.register import lm_solve_cuda

    ecfg = config.kitti()
    knn_cuda.launches = 0
    t = time.perf_counter()
    acc = eval_cli.main(["dump", "--dataset", "kitti", "--dataroot",
                         root, "--out", dump_dir, "--max-batches", "2"])
    torch.cuda.synchronize()
    dump_wall = time.perf_counter() - t
    dump_knn = knn_cuda.launches
    prefixes = list_dump_prefixes(dump_dir)
    require(len(prefixes) == 2 * ecfg.batch_size,
            f"data: {len(prefixes)} dumped pairs")
    d0 = load_dump(dump_dir, prefixes[0])
    require(d0["pc"].shape == (ecfg.input_pt_num, 3)
            and all(np.isfinite(load_dump(dump_dir, p)["pc"]).all()
                    for p in prefixes), "data: dumped clouds")
    require(dump_knn == 8, f"data: dump kNN launches {dump_knn} != 8")
    log(f"data: eval.cli dump --dataset kitti (val_random_Ry, "
        f"N={ecfg.input_pt_num}, {ecfg.img_H}x{ecfg.img_W}, 2 batches of "
        f"{ecfg.batch_size}, seeded weights): {dump_wall:.3f} s wall, "
        f"kNN launches {dump_knn}, accuracy {json.dumps(acc)}")
    lm_solve_cuda.launches = 0
    t = time.perf_counter()
    summ = eval_cli.main(["solve", "--data-dir", dump_dir, "--method",
                          "frustum", "--img-h", str(ecfg.img_H),
                          "--img-w", str(ecfg.img_W),
                          "--max-iter", str(EVAL_MAX_ITER)])
    torch.cuda.synchronize()
    solve_wall = time.perf_counter() - t
    lm_launches = lm_solve_cuda.launches
    require(summ["num_pairs"] == 2 * ecfg.batch_size
            and all(math.isfinite(summ[k]) for k in
                    ("rte_mean", "rre_mean", "success_rate")),
            f"data: solve summary {summ}")
    require(lm_launches >= 2, f"data: {lm_launches} LM launches")
    log(f"data: eval.cli solve --method frustum: {solve_wall:.3f} s "
        f"wall, 2-D LM launches {lm_launches}")
    dumps = [load_dump(dump_dir, p) for p in prefixes[:ecfg.batch_size]]

    def stack(field, dtype=torch.float32):
        return torch.as_tensor(np.stack([d[field] for d in dumps])).to(
            "cuda", dtype).contiguous()

    pc, K = stack("pc"), stack("K")
    for field in ("coarse_label", "coarse_pred"):
        lm_halving(torch, f"KITTI tree {field}", pc,
                   stack(field, torch.int64), K, H=ecfg.img_H,
                   W=ecfg.img_W, solver_stride=1, n_inits=EVAL_INITS,
                   max_iter=EVAL_MAX_ITER, timed=False)
    return lm_launches


def _device_data_steps(torch, cfg):
    """``train.cli --dataset synthetic --device-data`` at the train
    phase's configuration for two epochs of DD_STEPS steps on the card:
    the kNN launches of each train step, the end-to-end time of the second
    epoch's steps (batch generation included), and the validation batches
    of both epochs."""
    from deepi2p_tpu_torch.ops.knn_cuda import knn_cuda
    from deepi2p_tpu_torch.train import cli as train_cli
    from deepi2p_tpu_torch.train.engine import Engine

    B = cfg.batch_size
    per_step, losses, val, stamps = [], [], [], []
    train_step, eval_step = Engine.train_step, Engine.eval_step

    def counted_train(self, state, batch, gen):
        before = knn_cuda.launches
        state, metrics = train_step(self, state, batch, gen)
        per_step.append(knn_cuda.launches - before)
        losses.append(metrics["loss"])
        # the clock: from the end of the second epoch's first step to the
        # end of its last, each step with the making of its batch
        if len(per_step) in (DD_STEPS + 1, 2 * DD_STEPS):
            torch.cuda.synchronize()
            stamps.append(time.perf_counter())
        return state, metrics

    def recorded_eval(self, state, batch):
        val.append({k: v.clone() for k, v in batch.items()})
        return eval_step(self, state, batch)

    Engine.train_step, Engine.eval_step = counted_train, recorded_eval
    try:
        with tempfile.TemporaryDirectory(prefix="deepi2p_dd_") as d:
            knn_cuda.launches = 0
            state = train_cli.main([
                "--dataset", "synthetic", "--device-data",
                "--synthetic-preset", "kitti", "--synthetic-scene",
                "street", "--points", str(TRAIN_N), "--nodes",
                str(TRAIN_NODES), "--synthetic-len", str(DD_STEPS * B),
                "--val-len", str(DD_VAL), "--epochs", "2", "--log-every",
                "1000", "--checkpoints-dir", f"{d}/ck", "--log-dir",
                f"{d}/log"])
            launches = knn_cuda.launches
    finally:
        Engine.train_step, Engine.eval_step = train_step, eval_step
    require(state.step == 2 * DD_STEPS, f"device_data: step {state.step}")
    losses = [float(x) for x in losses]
    require(all(math.isfinite(x) for x in losses),
            f"device_data: non-finite loss in {losses}")
    require(per_step == [4] * (2 * DD_STEPS),
            f"device_data: kNN launches per step {per_step}, not 4 each")
    half = len(val) // 2
    require(half == DD_VAL // B and len(val) == 2 * half,
            f"device_data: {len(val)} validation batches")
    same = all(torch.equal(a[k], b[k]) for a, b in zip(val[:half],
                                                        val[half:])
               for k in a)
    require(same, "device_data: the validation batches differ between the "
            "two epochs")
    ms = (stamps[1] - stamps[0]) / (DD_STEPS - 1) * 1e3
    return dict(ms=ms, samples_s=B * 1e3 / ms, launches=launches,
                per_step=per_step[0], losses=losses)


def _device_data_scan(torch, cfg):
    """``train.cli --device-data --steps-per-dispatch DD_K`` at the train
    phase's configuration for two epochs of DD_STEPS steps on the card:
    the kNN launches of each call, the end-to-end time of the second
    epoch's calls after its first, the final step and the last loss."""
    from deepi2p_tpu_torch.ops.knn_cuda import knn_cuda
    from deepi2p_tpu_torch.train import cli as train_cli
    from deepi2p_tpu_torch.train.engine import Engine

    calls = DD_STEPS // DD_K
    per_call, losses, stamps = [], [], []
    scan, step = Engine.train_step_scan, Engine.train_step

    def counted(self, state, batches, gen):
        before = knn_cuda.launches
        state, metrics = scan(self, state, batches, gen)
        per_call.append(knn_cuda.launches - before)
        losses.append(metrics["loss"])
        if len(per_call) in (calls + 1, 2 * calls):
            torch.cuda.synchronize()
            stamps.append(time.perf_counter())
        return state, metrics

    def single(*a, **k):
        raise CheckFailed("device_data: a single train step in a "
                          f"--steps-per-dispatch {DD_K} run")

    Engine.train_step_scan, Engine.train_step = counted, single
    try:
        with tempfile.TemporaryDirectory(prefix="deepi2p_ddk_") as d:
            state = train_cli.main([
                "--dataset", "synthetic", "--device-data",
                "--synthetic-preset", "kitti", "--synthetic-scene",
                "street", "--points", str(TRAIN_N), "--nodes",
                str(TRAIN_NODES), "--synthetic-len",
                str(DD_STEPS * cfg.batch_size), "--val-len", str(DD_VAL),
                "--epochs", "2", "--log-every", "1000",
                "--steps-per-dispatch", str(DD_K),
                "--checkpoints-dir", f"{d}/ck", "--log-dir", f"{d}/log"])
    finally:
        Engine.train_step_scan, Engine.train_step = scan, step
    losses = [float(x) for x in losses]
    require(state.step == 2 * DD_STEPS,
            f"device_data: K={DD_K} run ended at step {state.step}")
    require(per_call == [4 * DD_K] * (2 * calls),
            f"device_data: kNN launches per {DD_K}-step call {per_call}")
    require(all(math.isfinite(x) for x in losses),
            f"device_data: non-finite loss in {losses}")
    ms = (stamps[1] - stamps[0]) / (DD_STEPS - DD_K) * 1e3
    return dict(ms=ms, step=state.step, per_call=per_call[0],
                loss=losses[-1])


def _htod_bytes(torch, cfg, steps: int, tries: int = 4):
    """The host-to-device copies of ``steps`` device-data train steps
    under ``torch.profiler`` (Chrome trace), traced again when a trace
    holds no kernel: (largest copy in bytes, copies, kernels)."""
    from deepi2p_tpu_torch.data.synthetic_device import (
        synthetic_batch_device)
    from deepi2p_tpu_torch.train.engine import Engine

    engine = Engine(cfg, steps_per_epoch=1000, device="cuda")
    state = engine.init_state(seed=0)
    gen = torch.Generator(device="cuda").manual_seed(0)
    dgen = torch.Generator(device="cuda").manual_seed(1)
    engine.train_step(state, synthetic_batch_device(cfg, dgen), gen)
    torch.cuda.synchronize()
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    seen = []
    for _ in range(tries):
        with tempfile.TemporaryDirectory(prefix="deepi2p_prof_") as d:
            with torch.profiler.profile(activities=acts) as prof:
                for _ in range(steps):
                    engine.train_step(state,
                                      synthetic_batch_device(cfg, dgen), gen)
                torch.cuda.synchronize()
            path = f"{d}/trace.json"
            prof.export_chrome_trace(path)
            with open(path) as f:
                events = json.load(f).get("traceEvents", [])
        kernels = sum(1 for e in events if e.get("cat") == "kernel")
        copies = [e for e in events if e.get("cat") == "gpu_memcpy"
                  and "HtoD" in e.get("name", "")]
        sizes = [int(e.get("args", {}).get("bytes", 0)) for e in copies]
        if kernels:
            return max(sizes, default=0), len(copies), kernels
        seen.append((kernels, len(copies)))
        time.sleep(0.5)
    raise CheckFailed(f"device_data: {tries} profiler traces hold no "
                      f"kernel: {seen}")


def device_data_phase(torch, train):
    """Batches made on the card at the train phase's configuration:
    ``synthetic_batch_device`` timed and checked, its renderer against the
    CPU's, ``train.cli --device-data`` end to end, and no image-sized
    host-to-device copy per step."""
    import numpy as np
    from deepi2p_tpu_torch import config
    from deepi2p_tpu_torch.data import synthetic_batch
    from deepi2p_tpu_torch.data.synthetic_device import (
        _render, synthetic_batch_device)

    cfg = config.kitti(synthetic_scene="street", input_pt_num=TRAIN_N,
                       node_a_num=TRAIN_NODES, node_b_num=TRAIN_NODES)
    B, H, W = cfg.batch_size, cfg.img_H, cfg.img_W
    require(B == 8 and cfg.compute_dtype == "bfloat16",
            "device_data: the KITTI preset is B=8, bf16")
    gen = torch.Generator(device="cuda").manual_seed(0)
    batch = synthetic_batch_device(cfg, gen)
    host = synthetic_batch(cfg.replace(input_pt_num=64), batch_size=B)
    for k, v in host.items():
        want = v.shape if k not in ("pc", "intensity", "sn") else (
            B, TRAIN_N, v.shape[2])
        require(k in batch and tuple(batch[k].shape) == want
                and batch[k].dtype == torch.float32
                and batch[k].device.type == "cuda",
                f"device_data: {k} {tuple(batch[k].shape)} "
                f"{batch[k].dtype} {batch[k].device}, host {want}")
        require(bool(torch.isfinite(batch[k]).all()),
                f"device_data: non-finite {k}")
    require(set(batch) == set(host), f"device_data: keys {sorted(batch)}")
    ms_batch = cuda_ms(torch, lambda: synthetic_batch_device(cfg, gen),
                       DD_BATCH_REPS)
    log(f"device_data: synthetic_batch_device (B={B}, N={TRAIN_N}, "
        f"{H}x{W}, street): {ms_batch:.4f} ms per batch (CUDA events, "
        f"{DD_BATCH_REPS} calls)")

    cpu = synthetic_batch_device(cfg, torch.Generator().manual_seed(5))
    args = [cpu[k] for k in ("pc", "intensity", "P", "K")]
    img_c, depth_c = _render(*args, H, W, torch.Generator(), True)
    img_g, depth_g = _render(*(a.cuda() for a in args), H, W, gen, True)
    mc, mg = img_c[..., 2] == 128.0, img_g[..., 2].cpu() == 128.0
    agree = float((mc == mg).float().mean())
    both = mc & mg
    dz = float(((depth_g.cpu() - depth_c).abs()[both]
                / depth_c[both]).max())
    require(agree >= RENDER_AGREE,
            f"device_data: render masks agree on {agree:.6f} of pixels")
    log(f"device_data: _render card vs CPU on one CPU-made batch: masks "
        f"agree on {agree:.6f} of pixels ({int(mc.sum())} point pixels), "
        f"depth max rel diff {dz:.3e}")
    del batch, cpu

    run = _device_data_steps(torch, cfg)
    log(f"device_data: train.cli --device-data, 2 epochs of {DD_STEPS} "
        f"bf16 steps (B={B}, N={TRAIN_N}, {H}x{W}): {run['ms']:.3f} ms/step "
        f"end to end, {run['samples_s']:.2f} samples/s (train phase, "
        f"batches made before the clock: {train['ms']:.3f} ms/step, "
        f"{train['samples_s']:.2f} samples/s); kNN launches "
        f"{run['launches']} ({run['per_step']} per train step); validation "
        f"batches bitwise equal across the epochs; losses "
        + " ".join(f"{x:.4f}" for x in run["losses"][-4:]))

    scan = _device_data_scan(torch, cfg)
    log(f"device_data: train.cli --device-data --steps-per-dispatch {DD_K}"
        f", 2 epochs of {DD_STEPS} bf16 steps: {scan['ms']:.3f} ms/step end"
        f" to end (second epoch, after its first call) against "
        f"{run['ms']:.3f} at K=1; final step {scan['step']}, kNN launches "
        f"{scan['per_call']} per call, last loss {scan['loss']:.4f}")

    img_bytes = B * H * W * 3 * 4
    biggest, copies, kernels = _htod_bytes(torch, cfg, DD_PROFILED)
    require(biggest < img_bytes,
            f"device_data: a {biggest}-byte host-to-device copy in "
            f"{DD_PROFILED} steps (an image batch is {img_bytes})")
    log(f"device_data: {DD_PROFILED} steps under torch.profiler: "
        f"{copies} host-to-device copies, the largest {biggest} bytes "
        f"(an image batch is {img_bytes}), {kernels} kernels")
    return dict(ms_batch=ms_batch, scan=scan, **run)


def _edge_codes(torch, pts, K, theta, H: int, W: int):
    """Per point (B, I, N): which side of each frame edge, of the camera
    plane and of the frame's centre lines (the kinks of the outside
    residual) its projection under theta (B, I, 4) lies on."""
    from deepi2p_tpu_torch.register.frustum_fast import _forward
    xs, ys, zs = (pts[:, None, :, d] for d in range(3))
    f = [K[:, None, i:i + 1, j] for i, j in ((0, 0), (1, 1), (0, 2), (1, 2))]
    _, _, p2, px, py = _forward(theta, xs, ys, zs, *f)
    W1, H1 = W - 1.0, H - 1.0
    bits = [px < 0, px > W1, py < 0, py > H1, p2 <= 0, px > W1 / 2,
            py > H1 / 2]
    return sum(b.to(torch.int64) << i for i, b in enumerate(bits))


def _theta_of(torch, P):
    """2-D params [ry, tx, ty, tz] of poses (B, 4, 4)."""
    ry = torch.atan2(P[:, 0, 2], P[:, 0, 0])
    return torch.cat([ry[:, None], P[:, :3, 3]], dim=1)


def _fast_solve_check(torch, cfg, dumps):
    """``solve_frustum_batch(backend="fast")`` on the card against the
    same call on the CPU from the same inits: poses within LM_THETA_ATOL
    and costs within LM_COST_RTOL, apart from pairs whose best inits' points
    lie on different sides of a frame edge (or centre line) in the two
    answers."""
    import numpy as np
    from deepi2p_tpu_torch.register.frustum import (initial_guess,
                                                    sample_inits,
                                                    solve_frustum_batch)

    def stack(field, dtype=torch.float32):
        return torch.as_tensor(np.stack([d[field] for d in dumps])).to(dtype)

    pc, K, pred = stack("pc"), stack("K"), stack("coarse_pred", torch.int64)
    ang, _ = initial_guess(pc, pred)
    theta0 = sample_inits(torch.Generator().manual_seed(0), ang, DEBUG_INITS)
    kw = dict(H=cfg.img_H, W=cfg.img_W, max_iter=DEBUG_ITERS,
              backend="fast")
    t = time.perf_counter()
    P_c, c_c = solve_frustum_batch(pc, pred, K, theta0=theta0, **kw)
    cpu_s = time.perf_counter() - t
    args = [x.cuda() for x in (pc, pred, K, theta0)]
    solve_frustum_batch(args[0], args[1], args[2], theta0=args[3], **kw)
    torch.cuda.synchronize()
    t = time.perf_counter()
    P_g, c_g = solve_frustum_batch(args[0], args[1], args[2],
                                   theta0=args[3], **kw)
    torch.cuda.synchronize()
    card_s = time.perf_counter() - t
    P_g, c_g = P_g.cpu(), c_g.cpu()
    pose_ok = ((P_g - P_c).abs().amax(dim=(1, 2)) <= LM_THETA_ATOL)
    cost_ok = (c_g - c_c).abs() <= LM_COST_RTOL * c_c.abs()
    agree = pose_ok & cost_ok
    codes = [_edge_codes(torch, pc, K, _theta_of(torch, P)[:, None],
                         cfg.img_H, cfg.img_W)[:, 0] for P in (P_g, P_c)]
    crossed = (codes[0] != codes[1]).any(dim=1)
    bad = ~agree & ~crossed
    require(bool(torch.isfinite(c_g).all() and torch.isfinite(P_g).all()),
            "debug: non-finite fast solve on the card")
    require(not bool(bad.any()),
            f"debug: fast solve card vs CPU differs in pairs "
            f"{bad.nonzero().flatten().tolist()} with no point across a "
            f"frame edge: pose diff {(P_g - P_c).abs().amax().item():.3e}, "
            f"costs {c_g.tolist()} vs {c_c.tolist()}")
    require(int(agree.sum()) * 2 >= len(agree),
            f"debug: fast solve agrees on only {int(agree.sum())} pairs")
    log(f"debug: solve_frustum_batch(backend='fast') B={len(dumps)}, "
        f"N={pc.shape[1]}, {DEBUG_INITS} inits, {DEBUG_ITERS} iterations: "
        f"card {card_s:.3f} s, CPU {cpu_s:.3f} s; {int(agree.sum())} of "
        f"{len(agree)} pairs within {LM_THETA_ATOL} (pose) and "
        f"{LM_COST_RTOL} (cost), {int((~agree & crossed).sum())} apart "
        f"with points across a frame edge; max pose diff "
        f"{(P_g - P_c).abs().amax().item():.3e}")


def _debug_vis_cli(torch, cfg, dump_dir, vis_dir):
    """``eval.cli solve --method frustum --debug-vis`` on the card: its
    ``{"debug_vis": ...}`` lines, three decodable PNGs per prefix and
    finite numbers."""
    import contextlib as cl
    import io
    from deepi2p_tpu_torch.data.jpeg import read_png
    from deepi2p_tpu_torch.eval import cli as eval_cli
    from deepi2p_tpu_torch.register import lm_solve_cuda

    lm_solve_cuda.launches = 0
    out = io.StringIO()
    t = time.perf_counter()
    with cl.redirect_stdout(out):
        summ = eval_cli.main(["solve", "--data-dir", dump_dir, "--method",
                              "frustum", "--img-h", str(cfg.img_H),
                              "--img-w", str(cfg.img_W), "--debug-vis",
                              vis_dir])
    torch.cuda.synchronize()
    wall = time.perf_counter() - t
    reports = [json.loads(x)["debug_vis"] for x in out.getvalue().splitlines()
               if x.startswith('{"debug_vis"')]
    require(len(reports) == 4, f"debug: {len(reports)} debug_vis lines")
    for r in reports:
        require(all(math.isfinite(r[k]) for k in ("final_cost", "rte",
                                                  "rre")),
                f"debug: non-finite report {r}")
        for suffix in ("_trace.png", "_scene.png", "_overlay.png"):
            img = read_png(f"{vis_dir}/{r['prefix']}{suffix}")
            require(img.ndim == 3 and img.shape[0] > 100,
                    f"debug: {r['prefix']}{suffix} {img.shape}")
    require(math.isfinite(summ["rte_mean"]), f"debug: summary {summ}")
    require(lm_solve_cuda.launches >= 2,
            f"debug: {lm_solve_cuda.launches} LM launches in the solve")
    log(f"debug: eval.cli solve --method frustum --debug-vis: {wall:.3f} s "
        f"wall, 2-D LM launches {lm_solve_cuda.launches}; "
        + "; ".join(json.dumps(r) for r in reports))


def _modules_check(torch):
    """``KNNModule``, ``KNNFusionModule`` and ``query_topk`` on the card
    against the CPU, with the kNN kernel's launches."""
    from deepi2p_tpu_torch.models.extra_layers import (KNNFusionModule,
                                                       KNNModule)
    from deepi2p_tpu_torch.ops.knn_cuda import knn_cuda
    from deepi2p_tpu_torch.ops.som import query_topk

    g = torch.Generator().manual_seed(0)
    coords = torch.randn(8, TRAIN_NODES, 3, generator=g) * 10.0
    feats = torch.randn(8, TRAIN_NODES, 64, generator=g)
    pts = torch.randn(8, TRAIN_N, 3, generator=g) * 10.0
    torch.manual_seed(0)
    mods = [KNNModule(64, [64, 128], k=16).eval(),
            KNNFusionModule(64, [64, 64], [128, 128], k=16).eval()]
    err = 0.0
    knn_cuda.launches = 0
    for m in mods:
        want = m(coords, feats)
        got = m.cuda()(coords.cuda(), feats.cuda())
        for w, o in zip(want, got):
            scale = max(float(w.abs().max()), 1.0)
            e = float((o.cpu() - w).abs().max()) / scale
            require(e <= DEBUG_MODULE_RTOL,
                    f"debug: {type(m).__name__} card vs CPU {e:.3e}")
            err = max(err, e)
    want = query_topk(coords, pts, TRAIN_NODES, 3)
    got = query_topk(coords.cuda(), pts.cuda(), TRAIN_NODES, 3)
    for w, o in zip(want, got):
        require(torch.equal(o.cpu(), w), "debug: query_topk card vs CPU")
    launches = knn_cuda.launches
    require(launches == 3, f"debug: {launches} kNN launches, not 3")
    log(f"debug: KNNModule, KNNFusionModule (k=16, {TRAIN_NODES} nodes) "
        f"and query_topk (N={TRAIN_N}, k=3) card vs CPU: max rel diff "
        f"{err:.3e}, query_topk equal; kNN launches {launches}")
    return launches, err


def _quality_gate(torch):
    """The frustum gate of tests/test_torch_port_quality_gates.py on the
    card: ring clouds from seed 0, labels corrupted by the port's
    ``flip_border_band`` and ``flip_iid`` at the committed error
    structure, the bench solve; at least 4 of 6 solved."""
    import numpy as np
    from deepi2p_tpu_torch.ops.projection import (coarse_labels,
                                                  project_points)
    from deepi2p_tpu_torch.register import noise
    from deepi2p_tpu_torch.register.frustum import solve_frustum_batch
    from deepi2p_tpu_torch.register.metrics import pose_diff_np

    with open("tests/fixtures/error_structure.json") as f:
        fix = json.load(f)
    H, W = 160, 512
    K = np.array([[300.0, 0, W / 2], [0, 300.0, H / 2], [0, 0, 1]],
                 np.float32)
    rng = np.random.default_rng(0)
    pcs, labs, Ps = [], [], []
    for _ in range(GATE_PAIRS):
        yaw = rng.uniform(-np.pi, np.pi)
        t = np.array([rng.uniform(-2, 2), 0.0, rng.uniform(-2, 2)],
                     np.float32)
        n = 4096
        th, r = rng.uniform(0, 2 * np.pi, n), rng.uniform(5, 40, n)
        pc = np.stack([r * np.cos(th), rng.uniform(-2, 2, n),
                       r * np.sin(th)], -1).astype(np.float32)
        c, s = np.cos(yaw), np.sin(yaw)
        P = np.eye(4, dtype=np.float32)
        P[:3, :3] = np.array([[c, 0, s], [0, 1, 0], [-s, 0, c]], np.float32)
        P[:3, 3] = t
        pxpy, z = project_points(torch.as_tensor(pc[None]),
                                 torch.as_tensor(P[None, :3]),
                                 torch.as_tensor(K[None]))
        labels = coarse_labels(pxpy, z, H, W)[0].numpy()
        labels = noise.flip_border_band(rng, labels, pc, P, K, H, W,
                                        band_px=fix["band_px"],
                                        rate=fix["band_error_rate"])
        labels = noise.flip_iid(rng, labels, fix["offband_error_rate"])
        pcs.append(pc), labs.append(labels), Ps.append(P)
    P_pred, _ = solve_frustum_batch(
        torch.as_tensor(np.stack(pcs)).cuda(),
        torch.as_tensor(np.stack(labs).astype(np.float32)).cuda(),
        torch.as_tensor(np.tile(K, (GATE_PAIRS, 1, 1))).cuda(), H=H, W=W,
        generator=torch.Generator().manual_seed(0), n_inits=N_INITS,
        max_iter=MAX_ITER, solver_stride=SOLVER_STRIDE)
    errs = [pose_diff_np(P_pred[b].double().cpu().numpy(),
                         Ps[b].astype(np.float64)) for b in range(GATE_PAIRS)]
    ok = sum(rte < 2.0 and rre < 5.0 for rte, rre in errs)
    gate = fix.get("gate_min_success", 4)
    require(ok >= gate, f"debug: frustum gate {ok}/{GATE_PAIRS} < {gate}")
    log(f"debug: frustum quality gate on the card (border band "
        f"{fix['band_error_rate']}, off band {fix['offband_error_rate']}, "
        f"port noise models): {ok}/{GATE_PAIRS} solved (gate {gate})")


def debug_phase(torch, cfg, raw):
    """The debug images and the library modules on the card: the eval
    phase's dump made again with ``viz_dir``, the fast 2-D LM against the
    CPU, ``eval.cli solve --debug-vis``, the kNN layers and the frustum
    quality gate under the port's noise models."""
    from deepi2p_tpu_torch.data.jpeg import read_png
    from deepi2p_tpu_torch.eval.dump import (dump_predictions,
                                             list_dump_prefixes, load_dump)
    from deepi2p_tpu_torch.models import build_detector

    model = build_detector(cfg, device="cuda", seed=0)
    with tempfile.TemporaryDirectory(prefix="deepi2p_debug_") as tmp:
        dump_dir, viz, vis = f"{tmp}/dump", f"{tmp}/viz", f"{tmp}/vis"
        t = time.perf_counter()
        dump_predictions(model, [raw], cfg, dump_dir, viz_dir=viz)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t
        prefixes = list_dump_prefixes(dump_dir)
        for p in prefixes:
            for suffix in ("_img.png", "_prediction.png"):
                img = read_png(f"{viz}/{p}{suffix}")
                require(img.shape[2] == 3, f"debug: {p}{suffix} {img.shape}")
        log(f"debug: dump_predictions(viz_dir=...) of the eval batch: "
            f"{wall:.3f} s, {len(prefixes)} samples x 2 PNGs decoded")
        del model
        _fast_solve_check(torch, cfg, [load_dump(dump_dir, p) for p in
                                       prefixes[:DEBUG_FAST_PAIRS]])
        _debug_vis_cli(torch, cfg, dump_dir, vis)
    launches, err = _modules_check(torch)
    _quality_gate(torch)
    return dict(knn_launches=launches, module_err=err)


def lidar_scan(rng, n_beams: int = PREP_BEAMS,
               n_az: int = PREP_AZIMUTHS):
    """A (n_beams * n_az, 4) float32 velodyne scan in NWU: rays at
    elevations -24.9..2 deg over a full turn from 1.73 m above the road
    hit the road, the facades 8-30 m to either side, or stop at 80 m;
    range noise 2 cm, intensity uniform."""
    import numpy as np
    el = np.deg2rad(np.linspace(-24.9, 2.0, n_beams))[:, None]
    az = (np.linspace(-np.pi, np.pi, n_az, endpoint=False)[None]
          + rng.uniform(0, 2 * np.pi / n_az, (n_beams, 1)))
    dx, dy = np.cos(el) * np.cos(az), np.cos(el) * np.sin(az)
    dz = np.sin(el) * np.ones_like(az)
    t_road = np.where(dz < -1e-3, -1.73 / np.minimum(dz, -1e-3), np.inf)
    wall = 8 + 22 * (0.5 + 0.5 * np.sin(3 * az))
    t_wall = np.where(np.abs(dy) > 1e-3, wall / np.maximum(np.abs(dy),
                                                           1e-3), np.inf)
    t = np.minimum(np.minimum(t_road, t_wall), 80.0)
    t = t + rng.normal(0, 0.02, t.shape)
    pts = np.stack([dx * t, dy * t, dz * t], -1).reshape(-1, 3)
    return np.concatenate([pts, rng.uniform(0, 1, (len(pts), 1))],
                          1).astype(np.float32)


def prep_kitti(torch, tmp) -> dict:
    """Raw scans and PNGs through the port's KITTI prep into a tree the
    ``KittiLoader`` reads, then PREP_STEPS bf16 train steps on the card."""
    import os
    from pathlib import Path
    import numpy as np
    from deepi2p_tpu_torch import config
    from deepi2p_tpu_torch.data import (BatchLoader, KittiLoader,
                                        device_prefetch, jpeg)
    from deepi2p_tpu_torch.data.prep import kitti_prep
    from deepi2p_tpu_torch.ops.knn_cuda import knn_cuda
    from deepi2p_tpu_torch.train.engine import Engine
    from deepi2p_tpu_torch.utils.png import encode_png

    rng = np.random.default_rng(0)
    raw, root = Path(tmp) / "kitti_raw", Path(tmp) / "kitti"
    seq = raw / "sequences" / "00"
    (seq / "velodyne").mkdir(parents=True)
    (seq / "image_2").mkdir()
    picture = jpeg.decode(Path(__file__).resolve().parent / JPEG_FIXTURES
                          / "kitti_1241x376_420_q95.jpg")
    images = []
    for i in range(PREP_SCANS):
        lidar_scan(rng).tofile(seq / "velodyne" / f"{i:06d}.bin")
        images.append(np.roll(picture, 37 * i, axis=1))
        (seq / "image_2" / f"{i:06d}.png").write_bytes(
            encode_png(images[-1]))
    velo = root / "data_odometry_velodyne_NWU"
    color = root / "data_odometry_color_npy"
    t = time.perf_counter()
    n = kitti_prep.prepare_kitti_velodyne(str(raw), str(velo), [0],
                                          workers=PREP_WORKERS)
    scan_s = time.perf_counter() - t
    t = time.perf_counter()
    m = kitti_prep.kitti_png_to_npy(str(raw), str(color), [0],
                                    workers=PREP_WORKERS)
    png_s = time.perf_counter() - t
    require(n == m == PREP_SCANS, f"prep: {n} scans and {m} PNGs prepared")
    pcdir = velo / "sequences" / "00" / "voxel0.1-SNr0.6"
    imgdir = color / "sequences" / "00"
    points = []
    for i in range(PREP_SCANS):
        d = np.load(pcdir / f"{i:06d}.npy")
        points.append(d.shape[1])
        norms = np.linalg.norm(d[4:7], axis=0)
        require(d.shape[0] == 7 and np.isfinite(d).all()
                and np.abs(norms - 1).max() < 1e-4 and d[6].min() >= -1e-6,
                f"prep: frame {i} cloud {d.shape}")
        require(np.array_equal(np.load(imgdir / "image_2" / f"{i:06d}.npy"),
                               images[i]), f"prep: image {i} pixels")
    # the loader's sequence: the prepared frames cycled, image_3 linked
    (imgdir / "image_3").mkdir()
    for i in range(PREP_SEQ_FRAMES):
        f = f"{i:06d}.npy"
        if i >= PREP_SCANS:
            os.symlink(f"{i % PREP_SCANS:06d}.npy", pcdir / f)
            os.symlink(f"{i % PREP_SCANS:06d}.npy", imgdir / "image_2" / f)
        os.symlink(f"../image_2/{f}", imgdir / "image_3" / f)
    poses = np.tile(np.eye(3, 4).reshape(1, 12), (PREP_SEQ_FRAMES, 1))
    poses[:, 3] = 0.5 * np.arange(PREP_SEQ_FRAMES)
    np.savetxt(raw / "00.txt", poses)
    require(kitti_prep.kitti_poses_to_npz(str(raw / "00.txt"),
                                          str(root / "poses" / "00"))
            == PREP_SEQ_FRAMES, "prep: poses")
    kitti_calib(root / "calib" / "00")
    cfg = config.kitti(input_pt_num=TRAIN_N, node_a_num=TRAIN_NODES,
                       node_b_num=TRAIN_NODES)
    B = cfg.batch_size
    train_ds = KittiLoader(str(root), "train", cfg)
    require(len(train_ds) == PREP_STEPS * B,
            f"prep: {len(train_ds)} KITTI train samples")
    engine = Engine(cfg, steps_per_epoch=PREP_STEPS, device="cuda")
    state = engine.init_state(seed=0)
    gen = torch.Generator(device="cuda").manual_seed(0)
    knn_cuda.launches = 0
    losses = []
    for batch in device_prefetch(BatchLoader(train_ds, B, seed=0,
                                             num_workers=4), "cuda"):
        state, metrics = engine.train_step(state, batch, gen)
        losses.append(float(metrics["loss"]))
    launches = knn_cuda.launches
    require(len(losses) == PREP_STEPS and all(map(math.isfinite, losses)),
            f"prep: KITTI train losses {losses}")
    require(launches == 4 * PREP_STEPS, f"prep: {launches} kNN launches")
    log(f"prep: KITTI: {PREP_SCANS} raw scans of {PREP_BEAMS * PREP_AZIMUTHS}"
        f" x 4 points -> voxel 0.1 + normals (k=16, native core) with "
        f"{PREP_WORKERS} workers: {scan_s:.3f} s, "
        f"{scan_s / PREP_SCANS:.3f} s per frame ({min(points)}-"
        f"{max(points)} points kept); {PREP_SCANS} PNGs of 376x1241 -> "
        f".npy (bitwise their pixels): {png_s / PREP_SCANS:.3f} s per "
        f"image; the prepared frames cycled into a sequence of "
        f"{PREP_SEQ_FRAMES} -> KittiLoader ({len(train_ds)} train "
        f"samples) -> {PREP_STEPS} bf16 train steps on the card (B={B}, "
        f"N={TRAIN_N}): losses {' '.join(f'{x:.4f}' for x in losses)}, "
        f"kNN launches {launches}")
    return dict(frame_s=scan_s / PREP_SCANS, png_s=png_s / PREP_SCANS,
                knn_per_step=launches // PREP_STEPS)


def bayer(rgb, pattern: str = "gbrg"):
    """The (H, W) uint8 Bayer mosaic of an RGB image."""
    import numpy as np
    raw = np.zeros(rgb.shape[:2], np.uint8)
    for idx, ch in enumerate(pattern):
        r, c = divmod(idx, 2)
        raw[r::2, c::2] = rgb[r::2, c::2, "rgb".index(ch)]
    return raw


def prep_oxford(torch, tmp) -> dict:
    """A raw Oxford traversal (VO, LMS scans, PREP_OX_IMAGES Bayer PNGs of
    1280x960, a LUT) through ``build_traversal``; its JPEGs through the
    ``OxfordLoader`` into ``eval.cli dump`` on the card."""
    from pathlib import Path
    import numpy as np
    from deepi2p_tpu_torch.data import jpeg
    from deepi2p_tpu_torch.data.prep import oxford_prep
    from deepi2p_tpu_torch.eval import cli as eval_cli
    from deepi2p_tpu_torch.eval.dump import list_dump_prefixes
    from deepi2p_tpu_torch.ops.knn_cuda import knn_cuda
    from deepi2p_tpu_torch.utils.png import encode_png

    rng = np.random.default_rng(1)
    us, trav = 1_000_000, "2014-05-19-13-20-57"
    raw, lms, out = (Path(tmp) / d for d in ("ox_raw", "ox_lms", "oxford"))
    tdir = raw / trav
    (tdir / "vo").mkdir(parents=True)
    (tdir / "stereo" / "centre").mkdir(parents=True)
    ldir = lms / trav / "lms_front"
    ldir.mkdir(parents=True)
    cam_ts = [i * us // 10 for i in range(PREP_OX_IMAGES)]
    (tdir / "vo" / "vo.csv").write_text(
        "source_timestamp,destination_timestamp,x,y,z,roll,pitch,yaw\n"
        + "".join(f"{ts},{ts - us // 10},2.5,0,0,0,0,0\n" for ts in cam_ts))
    (tdir / "stereo" / "stereo.timestamps").write_text(
        "".join(f"{ts} 1\n" for ts in cam_ts))
    picture = jpeg.decode(Path(__file__).resolve().parent / JPEG_FIXTURES
                          / OXFORD_JPEG)
    for i, ts in enumerate(cam_ts):
        (tdir / "stereo" / "centre" / f"{ts}.png").write_bytes(encode_png(
            bayer(np.roll(picture, 53 * i, axis=1))))
    lms_ts = [i * us // 50 for i in range(5 * PREP_OX_IMAGES)]
    (lms / trav / "lms_front.timestamps").write_text(
        "".join(f"{ts} 1\n" for ts in lms_ts))
    for ts in lms_ts:      # 541 beams of a 2-D scanner, x toward the road
        ang = np.linspace(-np.pi / 2, np.pi / 2, 541)
        r = rng.uniform(2, 20, 541)
        np.stack([r * np.cos(ang) - 1.5, r * np.sin(ang),
                  rng.uniform(0, 255, 541)], 1).tofile(ldir / f"{ts}.bin")
    H, W = picture.shape[:2]
    y, x = np.mgrid[0:H, 0:W].astype(np.float64)
    cx, cy = (W - 1) / 2, (H - 1) / 2
    r2 = ((x - cx) ** 2 + (y - cy) ** 2) / (cx * cx + cy * cy)
    lut = raw / "stereo_narrow_left_distortion_lut.bin"
    np.stack([(cx + (x - cx) * (1 + 0.1 * r2)).ravel(),
              (cy + (y - cy) * (1 + 0.1 * r2)).ravel()]).tofile(lut)
    ext = raw / "extrinsics"
    ext.mkdir()
    for name in ("stereo", "lms_front"):
        (ext / f"{name}.txt").write_text("0 0 0 0 0 0\n")
    sdk = oxford_prep.sdk_from_extrinsics(str(ext), lut_path=str(lut))
    png = tdir / "stereo" / "centre" / f"{cam_ts[0]}.png"
    sdk.load_image(str(png))            # the LUT parsed and cached
    t = time.perf_counter()
    decoded = sdk.load_image(str(png))
    load_s = time.perf_counter() - t
    t = time.perf_counter()
    summary = oxford_prep.build_traversal(
        trav, str(lms), str(raw), str(out), sdk, pc_sample_distance=2.0,
        accumulation_distance=2.0, ignore_first_n_second=-1.0)
    build_s = time.perf_counter() - t
    require(summary == {"n_pc": PREP_OX_IMAGES - 2,
                        "n_img": PREP_OX_IMAGES},
            f"prep: build_traversal {summary}")
    jpgs = sorted((out / trav / "stereo" / "centre").iterdir())
    first = jpeg.decode(jpgs[0])
    require(first.shape == (H, W, 3) and np.abs(
        first.astype(int) - decoded.astype(int)).mean() < 3,
        f"prep: the written JPEG decodes to {first.shape}")
    for split in ("train", "val"):
        (out / f"{split}.txt").write_text(f"{trav}\n")
    knn_cuda.launches = 0
    with torch.no_grad():
        eval_cli.main(["dump", "--dataset", "oxford", "--dataroot",
                       str(out), "--out", f"{tmp}/ox_dump",
                       "--batch-size", str(summary["n_pc"])])
    torch.cuda.synchronize()
    n = len(list_dump_prefixes(f"{tmp}/ox_dump"))
    require(n == summary["n_pc"] and knn_cuda.launches == 4,
            f"prep: Oxford dump of {n} pairs, {knn_cuda.launches} kNN")
    log(f"prep: Oxford: build_traversal of {PREP_OX_IMAGES} Bayer PNGs of "
        f"{W}x{H} (demosaic + LUT undistortion + JPEG) and "
        f"{len(lms_ts)} LMS scans: {build_s:.3f} s ({summary}); one image "
        f"demosaiced and undistorted {load_s:.3f} s; the JPEGs through the "
        f"OxfordLoader into eval.cli dump on the card: {n} pairs, kNN "
        f"launches {knn_cuda.launches}")
    return dict(image_s=build_s / PREP_OX_IMAGES, load_s=load_s)


def prep_encoder() -> dict:
    """The port's JPEG encoder against the committed cv2 digests; a
    1280x960 encode timed."""
    import importlib.util
    from pathlib import Path
    from deepi2p_tpu_torch.data import jpeg

    path = (Path(__file__).resolve().parent / PREP_ENCODE_DIGESTS
            / "make_digests.py")
    spec = importlib.util.spec_from_file_location("make_digests", path)
    cases = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cases)
    want = cases.load_digests()
    for case in cases.CASES:
        require(cases.digest(jpeg.encode_jpeg(cases.image(case)))
                == want[case], f"prep: encoder bytes of {case} differ from "
                               f"cv2's (OpenCV {want['opencv']})")
    img = cases.image("noise_960x1280")
    t = time.perf_counter()
    for _ in range(PREP_ENCODE_REPS):
        jpeg.encode_jpeg(img)
    ms = (time.perf_counter() - t) / PREP_ENCODE_REPS * 1e3
    log(f"prep: JPEG encoder: {len(cases.CASES)} images (1x1 to 960x1280, "
        f"flat, gradient, noise) byte for byte the committed digests of "
        f"cv2.imencode (OpenCV {want['opencv']}); a 1280x960 noise image "
        f"{ms:.3f} ms per encode (mean of {PREP_ENCODE_REPS})")
    return dict(encode_ms=ms)


def prep_nuscenes(tmp) -> int:
    """``build_dataset_info`` on a one-scene nuScenes tree (the tables of
    ``tests/torch_port_data_trees.py::mini_nuscenes``)."""
    import math as m
    from pathlib import Path
    from deepi2p_tpu_torch.data.nuscenes import CAMERA_NAMES
    from deepi2p_tpu_torch.data.nuscenes_tables import NuScenesTables
    from deepi2p_tpu_torch.data.prep.nuscenes_prep import build_dataset_info

    def quat(a):
        return [m.cos(a / 2), 0.0, 0.0, m.sin(a / 2)]

    root, version, n = Path(tmp) / "nusc", "v1.0-trainval", 8
    (root / version).mkdir(parents=True)
    tables = {"sensor": [], "calibrated_sensor": [], "ego_pose": [],
              "sample_data": []}
    for ch in ("LIDAR_TOP", *CAMERA_NAMES):
        tables["sensor"].append({"token": f"sen_{ch}", "channel": ch,
                                 "modality": "lidar" if ch == "LIDAR_TOP"
                                 else "camera"})
        tables["calibrated_sensor"].append({
            "token": f"cs_{ch}", "sensor_token": f"sen_{ch}",
            "rotation": quat(0.3), "translation": [0.9, 0.0, 1.8],
            "camera_intrinsic": [] if ch == "LIDAR_TOP" else
            [[620.0, 0.0, 320.0], [0.0, 620.0, 176.0], [0.0, 0.0, 1.0]]})
    for i in range(n):
        tok = f"lidar_{i:03d}"
        tables["ego_pose"].append({"token": f"ep_{tok}",
                                   "rotation": quat(0.02 * i),
                                   "translation": [2.0 * i, 0.1, 0.0]})
        tables["sample_data"].append({
            "token": tok, "sample_token": "samp_0",
            "filename": f"samples/{tok}.pcd.bin",
            "ego_pose_token": f"ep_{tok}",
            "calibrated_sensor_token": "cs_LIDAR_TOP",
            "is_key_frame": i == 0,
            "prev": f"lidar_{i - 1:03d}" if i else "",
            "next": f"lidar_{i + 1:03d}" if i < n - 1 else ""})
    for ch in CAMERA_NAMES:
        tables["ego_pose"].append({"token": f"ep_cam_{ch}",
                                   "rotation": quat(0.05),
                                   "translation": [1.0, 0.0, 0.0]})
        tables["sample_data"].append({
            "token": f"cam_{ch}", "sample_token": "samp_0",
            "filename": "samples/cam.jpg", "ego_pose_token": f"ep_cam_{ch}",
            "calibrated_sensor_token": f"cs_{ch}", "is_key_frame": True,
            "prev": "", "next": ""})
    tables["sample"] = [{"token": "samp_0", "timestamp": 0, "prev": "",
                         "next": "", "scene_token": "scene_0"}]
    tables["scene"] = [{"token": "scene_0", "log_token": "log_0",
                        "nbr_samples": 1, "first_sample_token": "samp_0",
                        "last_sample_token": "samp_0", "name": "scene-0001",
                        "description": "Sunny day, parked cars"}]
    for name, records in tables.items():
        (root / version / f"{name}.json").write_text(json.dumps(records))
    info = build_dataset_info(NuScenesTables(version, str(root)),
                              max_translation=1e9, frame_skip=2,
                              out_path=str(root / "dataset_info.list"))
    require([tok for tok, _ in info] == [f"lidar_{i:03d}" for i in
                                         range(0, n, 2)]
            and set(info[0][1]) == set(CAMERA_NAMES),
            f"prep: nuScenes dataset_info {info[:1]}")
    log(f"prep: nuScenes build_dataset_info on a one-scene tree: "
        f"{len(info)} LiDAR frames, each paired with all "
        f"{len(CAMERA_NAMES)} cameras")
    return len(info)


def prep_phase(torch) -> dict:
    """The offline prep tools on raw files, their outputs into the
    loaders and onto the card."""
    with tempfile.TemporaryDirectory(prefix="deepi2p_prep_") as tmp:
        kitti = prep_kitti(torch, tmp)
        torch.cuda.empty_cache()
        oxford = prep_oxford(torch, tmp)
        enc = prep_encoder()
        prep_nuscenes(tmp)
    log(f"prep: host {host_cpu()}; card {nvidia_smi()}")
    return dict(**kitti, **oxford, **enc)


def host_cpu() -> str:
    """The host CPU as ``lscpu`` names it (vendor, model name, BIOS model
    name, family/model) and its logical CPU count."""
    import os
    fields = ("Vendor ID", "Model name", "BIOS Model name", "CPU family",
              "Model")
    found = {}
    try:
        out = subprocess.run(["lscpu"], capture_output=True, text=True,
                             timeout=30).stdout
        for line in out.splitlines():
            key, _, value = line.partition(":")
            if key.strip() in fields and key.strip() not in found:
                found[key.strip()] = value.strip()
    except (OSError, subprocess.SubprocessError):
        pass
    desc = "; ".join(f"{k} {found[k]}" for k in fields if found.get(k))
    return f"{desc or 'lscpu unavailable'}; {os.cpu_count()} logical CPUs"


def parallel_phase(torch) -> dict:
    """Two gloo ranks on the one card (``parallel/dryrun.py``): the DP and
    the 1x2 TP train step held to one rank's, the sharded Oxford
    registration held to the one-rank solve; then ``train.cli`` at world
    size 1 over NCCL (:func:`nccl_train_cli`)."""
    import numpy as np
    from deepi2p_tpu_torch import config
    from deepi2p_tpu_torch.data.synthetic import synthetic_batch
    from deepi2p_tpu_torch.parallel import dryrun
    from deepi2p_tpu_torch.parallel.mesh import make_mesh

    kcfg = dict(input_pt_num=TRAIN_N, node_a_num=TRAIN_NODES,
                node_b_num=TRAIN_NODES, synthetic_scene="street",
                batch_size=PAR_BATCH, compute_dtype="float32")
    with tempfile.TemporaryDirectory(prefix="deepi2p_ranks_") as tmp:
        train = f"{tmp}/train.npz"
        np.savez(train, **synthetic_batch(config.kitti(**kcfg), seed=3))
        reg = f"{tmp}/reg.npz"
        np.savez(reg, **synthetic_batch(config.oxford(), PAR_PAIRS, seed=0))
        step = {"batch": train, "preset": "kitti", "cfg": kcfg,
                "steps": PAR_STEPS}
        register = {"batch": reg, "preset": "oxford",
                    "forward_chunk": PAR_PAIRS // PAR_RANKS}
        solves = {key: dict(register, n_inits=n, max_iter=it,
                            solver_stride=st)
                  for key, (n, it, st) in (("register", PAR_HELD),
                                           ("register_main", PAR_MAIN))}
        job = {"train": dict(step, n_model=1),
               "train_tp": dict(step, n_model=2, steps=1), **solves}
        t = time.perf_counter()
        results = dryrun.launch(PAR_RANKS, job, tmp, device="cuda",
                                timeout_s=300)
        wall = time.perf_counter() - t
        require(results[0]["backend"] == "gloo"
                and all(r["device"] == "cuda:0" for r in results),
                f"parallel: ranks on {[r['device'] for r in results]}")
        kw = dict(loss_rtol=PAR_LOSS_RTOL, stats_rtol=None,
                  stats64_rtol=PAR_STATS64_RTOL, ratio_atol=PAR_RATIO_ATOL)
        try:
            dp = dryrun.check_train(results, **kw)
            tp = dryrun.check_train(results, key="train_tp", **kw)
        except AssertionError as e:
            raise CheckFailed(f"parallel: train step: {e}") from e
        require(dp["grad64_err"] <= PAR_GRAD64_ATOL
                and tp["grad64_err"] <= PAR_GRAD64_ATOL and tp["n_split"] > 0
                and results[0]["train_tp"]["mesh"] == {"data": 1, "model": 2}
                and "points" in tp and "points" not in dp,
                f"parallel: DP {dp}, TP {tp}")
        log(f"parallel: {PAR_RANKS} gloo ranks on one card "
            f"({wall:.1f} s from spawn to results): DP step of the "
            f"KITTI-shaped config (B={PAR_BATCH}, {PAR_BATCH // PAR_RANKS} "
            f"per rank, N={TRAIN_N}, f32): loss {dp['loss']:.6f} against "
            f"one rank's {dp['loss_ref']:.6f}, float64 gradient within "
            f"{dp['grad64_err']:.3e} of one rank's, parameters bitwise "
            f"equal across ranks, statistics within {dp['stats64_err']:.2e} "
            f"in the float64 copy ({dp['stats_err']:.2e} in f32); "
            f"{dp['step_s'] * 1e3:.3f} "
            f"ms per step on each rank (least of {PAR_STEPS}) against "
            f"{dp['step_s_ref'] * 1e3:.3f} ms for one rank at B={PAR_BATCH}"
            f"; 1x2 TP step: {tp['n_split']} split tensors, loss "
            f"{tp['loss']:.6f}, float64 gradient within "
            f"{tp['grad64_err']:.3e}, {tp['step_s'] * 1e3:.3f} ms")
        pts = tp["points"]
        log(f"parallel: the 1x2 TP layout with the point axis split too "
            f"(each rank {pts['points']} of pc, gathered at the step's "
            f"entry): eval loss {pts['eval_loss']!r} against the DP "
            f"layout's {pts['eval_loss_dp']!r} (relative difference "
            f"{pts['eval_rel_diff']:.3g}, held within "
            f"{dryrun.POINTS_RTOL:g}), a train step from it to loss "
            f"{pts['loss']:.6f}, parameters bitwise equal across ranks")
        mesh1 = make_mesh(1, device="cuda")
        try:
            held, main = (dryrun.check_register(
                results, dryrun.register_job(mesh1, config.oxford(), dict(
                    solves[key], solve_chunk=PAR_PAIRS // PAR_RANKS)),
                key=key) for key in ("register", "register_main"))
        except AssertionError as e:
            raise CheckFailed(f"parallel: registration: {e}") from e
        for name, read, lm in (("held", held, 1), ("main", main, 2)):
            for mode in ("2d", "6dof"):
                r = read[mode]
                require(r["finite"] and all(k == 4 for k in r["knn_launches"])
                        and all(k == lm for k in r["lm_launches"]),
                        f"parallel: {name} {mode} solve {r}")
        log(f"parallel: sharded Oxford registration (B={PAR_PAIRS}, "
            f"{PAR_PAIRS // PAR_RANKS} pairs per rank, the forward in "
            f"chunks of {PAR_PAIRS // PAR_RANKS} on both sides): inits "
            f"bitwise one rank's; poses and costs at the JAX dry run's "
            f"bounds against one rank solving in chunks of "
            f"{PAR_PAIRS // PAR_RANKS}"
            + "".join(f"; at {n} inits, {it} iterations, stride {st} ("
                      f"{name}): " + ", ".join(
                          f"{m} {r[m]['s']:.3f} s on rank 0 against "
                          f"{r[m]['s_ref']:.3f} s for one rank, "
                          f"{r[m]['bitwise']} of {PAR_PAIRS} poses bitwise"
                          for m in ("2d", "6dof"))
                      for name, r, (n, it, st) in (
                          ("the JAX dry run's", held, PAR_HELD),
                          ("the main path's", main, PAR_MAIN)))
            + f"; launches per rank: kNN {main['2d']['knn_launches']}, 2-D "
            f"LM {main['2d']['lm_launches']}, 6-DoF LM "
            f"{main['6dof']['lm_launches']}")
        cli_s, out = nccl_train_cli(torch, tmp)
        log(f"parallel: train.cli in this process with the environment of "
            f"torch.distributed.run at world size 1 (NCCL), 2 bf16 steps of "
            f"--device-data at the KITTI shape in one call of "
            f"--steps-per-dispatch {PAR_CLI_K}: {cli_s:.1f} s wall, "
            f"checkpoint written; it said: {out.strip().splitlines()[0]}")
    return dict(dp=dp, tp=tp, register=main)


def nccl_train_cli(torch, tmp):
    """``train.cli --device-data --steps-per-dispatch PAR_CLI_K`` for 2
    steps (one call) in this process, with the environment
    ``torch.distributed.run`` gives a world of one rank: it joins an NCCL
    process group of one on this card and leaves it at the end.  Returns
    (seconds, what it printed)."""
    import contextlib
    import io
    import os
    import socket
    import torch.distributed as dist
    from deepi2p_tpu_torch.train import cli as train_cli
    from deepi2p_tpu_torch.train.engine import Engine

    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        port = sock.getsockname()[1]
    env = {"RANK": "0", "WORLD_SIZE": "1", "LOCAL_RANK": "0",
           "MASTER_ADDR": "127.0.0.1", "MASTER_PORT": str(port)}
    saved = {k: os.environ.get(k) for k in env}
    backends = []
    init = dist.init_process_group

    def recorded(backend=None, *a, **kw):
        backends.append(backend)
        return init(backend, *a, **kw)

    scan, calls = Engine.train_step_scan, []

    def counted(self, state, batches, gen):
        calls.append(tuple(batches["pc"].shape[:2]))
        return scan(self, state, batches, gen)

    buf = io.StringIO()
    os.environ.update(env)
    dist.init_process_group = recorded
    Engine.train_step_scan = counted
    t = time.perf_counter()
    try:
        with contextlib.redirect_stdout(buf):
            train_cli.main([
                "--dataset", "synthetic", "--device-data",
                "--synthetic-preset", "kitti", "--synthetic-scene", "street",
                "--points", str(TRAIN_N), "--nodes", str(TRAIN_NODES),
                "--synthetic-len", "16", "--val-len", "8", "--epochs", "1",
                "--log-every", "1", "--steps-per-dispatch", str(PAR_CLI_K),
                "--checkpoints-dir", f"{tmp}/ck", "--log-dir", f"{tmp}/log"])
        torch.cuda.synchronize()
    finally:
        dist.init_process_group = init
        Engine.train_step_scan = scan
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v
    cli_s = time.perf_counter() - t
    out = buf.getvalue()
    require(backends == ["nccl"] and not dist.is_initialized()
            and calls == [(PAR_CLI_K, 8)]
            and "over 1 ranks" in out and "epoch 0 step 2:" in out
            and os.path.isfile(f"{tmp}/ck/latest.npz"),
            f"parallel: train.cli at world size 1 (backends {backends}, "
            f"{PAR_CLI_K}-step calls {calls}): "
            f"{out[-800:]}")
    return cli_s, out


def main() -> int:
    faulthandler.dump_traceback_later(WATCHDOG_S, exit=True)
    import torch

    with phase("device"):
        if not torch.cuda.is_available():
            raise CheckFailed("no CUDA device (torch.cuda.is_available() is "
                              "False)")
        smi = nvidia_smi()
        log(f"card: {smi}; torch {torch.__version__} cuda "
            f"{torch.version.cuda}")
        # f32 comparisons below must be true f32: no TF32 in matmuls or
        # cuDNN convolutions
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False

    from deepi2p_tpu_torch import _build, config
    from deepi2p_tpu_torch.data import batch_to_torch, synthetic_batch
    from deepi2p_tpu_torch.models import build_detector

    with phase("build"):
        # the data phase's native core (g++) builds beside the kernels
        from concurrent.futures import ThreadPoolExecutor
        from deepi2p_tpu_torch.data import native
        t = time.perf_counter()
        with ThreadPoolExecutor(1) as ex:
            core = ex.submit(native.build)
            _build.build(verbose=True)
            _build.load_library()
            kernels_s = time.perf_counter() - t
            core.result()
        log(f"build: {kernels_s:.1f} s; the native data core built beside "
            f"them, {time.perf_counter() - t:.1f} s in all")

    cfg = config.oxford(batch_size=BATCH)
    with phase("batch"):
        batch = batch_to_torch(synthetic_batch(cfg, seed=0), device="cuda")

    with torch.no_grad():
        with phase("model"):
            model = build_detector(cfg, device="cuda", seed=0)
            coarse, _ = model(*(batch[k] for k in (
                "pc", "intensity", "sn", "node_a", "node_b", "img")))
            pred = torch.argmax(coarse, dim=-1)
        with phase("knn"):
            knn_row = knn_phase(torch, batch, cfg)
        with phase("lm"):
            lm_row = lm_phase(torch, batch, cfg, pred)
        with phase("slice"):
            launches = slice_phase(torch, model, batch, cfg)
        with phase("nn1"):
            eval_cfg, eval_raw = kitti_eval_batch(torch)
            nn1_row = nn1_phase(torch, eval_raw)
        with phase("lm6"):
            lm6_row = lm6_phase(torch, batch, cfg, pred)
        with phase("solve6"):
            launches6 = solve6_phase(torch, model, batch, cfg)
        del model
        torch.cuda.empty_cache()
        with phase("eval"):
            launches_eval = eval_phase(torch, eval_cfg, eval_raw)
        with phase("depth"):
            depth = depth_phase(torch, eval_cfg, eval_raw)
        with phase("serve"):
            serve_phase(torch, eval_cfg, eval_raw)
        with phase("reference"):
            reference_phase(torch)
    with torch.enable_grad(), phase("norm"):
        norm_row = norm_phase(torch)
    with torch.enable_grad(), phase("train"):
        train = train_phase(torch)
    with torch.enable_grad(), phase("data"):
        data = data_phase(torch, train)
    with torch.enable_grad(), phase("device_data"):
        device_data = device_data_phase(torch, train)
    with torch.no_grad(), phase("debug"):
        debug = debug_phase(torch, eval_cfg, eval_raw)
    with torch.enable_grad(), phase("prep"):
        prep = prep_phase(torch)
    with phase("parallel"):
        par = parallel_phase(torch)

    lm_src = "deepi2p_tpu_torch/csrc/frustum_lm.cu"
    icp_row = nn1_row.pop("icp")
    kernels = [
        dict(name="knn", route="cuda", source="deepi2p_tpu_torch/csrc/knn.cu",
             replaces="deepi2p_tpu/ops/knn_pallas.py:60",
             launches=launches["knn"],
             train_launches_per_step=train["launches_per_step"],
             train_scan_launches_per_call=train["scan_launches_per_call"],
             device_data_scan_launches_per_call=device_data["scan"][
                 "per_call"],
             data_launches_per_step=data["knn_per_step"],
             device_data_launches_per_step=device_data["per_step"],
             debug_launches=debug["knn_launches"],
             prep_launches_per_step=prep["knn_per_step"],
             rank_launches=par["register"]["2d"]["knn_launches"],
             **{**knn_row, "max_abs_err": max(knn_row["max_abs_err"],
                                              train["knn_err"])}),
        dict(name="lm_p4", route="cuda", source=lm_src,
             replaces="deepi2p_tpu/register/frustum_pallas.py:336",
             launches=launches["lm_solve_p4"],
             data_solve_launches=data["lm"],
             oxford_solve_launches=data["oxford"]["lm"],
             rank_launches=par["register"]["2d"]["lm_launches"], **lm_row),
        dict(name="lm_p6", route="cuda", source=lm_src,
             replaces="deepi2p_tpu/register/frustum_pallas.py:336",
             launches=launches6["lm_p6"],
             rank_launches=par["register"]["6dof"]["lm_launches"],
             **lm6_row),
        dict(name="nn1", route="cuda", source="deepi2p_tpu_torch/csrc/nn1.cu",
             replaces="deepi2p_tpu/ops/knn_pallas.py:141",
             launches=launches_eval["nn1"], depth_launches=depth["launches"],
             **{**nn1_row, "max_abs_err": max(nn1_row["max_abs_err"],
                                              depth["nn1_err"])}),
    ]
    kernels.append(dict(
        name="norm", route="cuda", source="deepi2p_tpu_torch/csrc/norm.cu",
        replaces=None, train_launches_per_step=train["norm_launches_per_step"],
        shapes=norm_row))
    kernels.append(dict(
        name="icp", route="cuda", source="deepi2p_tpu_torch/csrc/icp.cu",
        replaces=None, launches=launches_eval["icp"],
        depth_launches=depth["icp_launches"], **icp_row))
    log("kernels=" + json.dumps([k["name"] for k in kernels]))
    log(json.dumps({"kernels": kernels}))
    log(smi)
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    faulthandler.cancel_dump_traceback_later()
    return 0


if __name__ == "__main__":
    try:
        sys.exit(main())
    except CheckFailed as e:
        print(f"CHECK FAILED: {e}", file=sys.stderr, flush=True)
        sys.exit(1)
