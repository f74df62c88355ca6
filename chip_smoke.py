#!/usr/bin/env python3
"""Smoke run of the PyTorch port (deeplabv3p_torch) on one NVIDIA GPU.

    python3 chip_smoke.py          # from the root of a checkout; one GPU
    python3 chip_smoke.py --aspp   # steps 1-2 and the ASPP kernel alone
    python3 chip_smoke.py --export # steps 1-2 and the export phase (15) alone
    python3 chip_smoke.py --onnx   # steps 1-2, the learning proof and the ONNX phase (15b)
    python3 chip_smoke.py --tf     # steps 1-2, the learning proof and the TF graph phase (15g)
    python3 chip_smoke.py --tflite # steps 1-2, the learning proof, the TF graph phase (which
                                   # times the fp32 and int8 .tflite executors too) and the
                                   # .tflite phase (15h, int8 included)
    python3 chip_smoke.py --parallel  # steps 1-2 and the data-parallel phase (15c) alone
    python3 chip_smoke.py --spatial   # steps 1-2 and the spatial phase (15d) alone
    python3 chip_smoke.py --tools     # steps 1-2 and the tools phase (15e) alone
    python3 chip_smoke.py --diagnostics  # steps 1-2 and the diagnostics phase (15f) alone

1. prints the card (`nvidia-smi` name and power limit) and the versions;
2. builds the CUDA kernels from deeplabv3p_torch/ops/kernels/csrc with nvcc;
3. holds each kernel against its plain PyTorch version on the card, at the
   main paths' shapes and at ragged ones, with TF32 off: the ASPP kernel in
   f32 and bf16 at the serving (b1) and eval (b8) shapes, OS8, OS32's rates,
   rates past the map, ragged channel counts and 4 rates, fused and bare,
   printing each plan (channels a thread, blocks, band, shared memory); the
   decoder kernel in f32 and bf16 at the serving shape, a
   ragged one with non-integer scales, batch 8, OS8's scale 2 and channel
   counts that are no multiple of 4, printing for each the channels a thread
   owns and the blocks and shared memory of its plan; the loss tail's forward
   and backward (csrc/upsample_ce.cu) at the training slice's (16,128,128,21)
   -> 512^2, the lite head's (2,32,32,21) -> 512^2 and a ragged (3,29,37,21)
   -> (116,148), each kernel also alone at scale 1 and at an odd scale and
   twice in a row for bit-equal results, the forward besides at 6 and 151
   classes, at scale 2 and at a width that is no multiple of 4, with its lse
   held against torch.logsumexp; the confusion kernel (csrc/confusion.cu,
   EQUAL) at the eval
   slice's (8,512,512,21) in f32 and bf16, a ragged (3,37,41,6) and C = 151;
   the inverted-residual kernel (csrc/mbconv.cu) at the 13 block shapes of
   the batch-8 512x512 OS16 body, the JAX tests' four, a ragged map and
   OS8's rate 4, bf16 and f32; torch.argmax (`mask_argmax`) on the card
   against numpy's argmax on logits with planted ties and NaNs;
4. the serving path: 8 requests through `DeepLab` (mobilenetv2, full ASPP +
   decoder head, 512x512, OS16, 21 VOC classes, bf16, seeded weights) as
   built by default (fused ASPP kernel), then 8 more with the fused decoder
   kernel too, checking that each kernel's launch count rose by one a
   request, and the masks and logits against the same weights in f32 with
   both kernels off;
5. the training path: `deeplabv3p_torch.train.main` on a seeded synthetic
   dataset (32 pairs of 512x512, 21 classes, 255 bands) written to build/,
   mobilenetv2 OS16 b16 bf16 `--fused_loss --no_augment`, a frozen-backbone
   stage of 2 steps and a fine-tuning stage of 2; the loss kernels must run
   once a step each and the ASPP and decoder kernels never, the frozen
   backbone must not move in stage 1 and must in stage 2, and the final
   .npz must serve a request through `DeepLab`;
6. the fused against the unfused train step on the same weights and batch
   (f64 and f32 activations with TF32 off, then bf16);
7. the evaluation path: `deeplabv3p_torch.eval.main` on the same synthetic
   set and a seeded .npz, mobilenetv2 OS16 b8 bf16, 4 batches, once as built
   by default and once with `--fused_mbconv`; the confusion and ASPP kernels
   must run once a batch, the inverted-residual kernel never and then 13
   times a batch; the matrix must equal the one `torch.argmax` + `bincount`
   give on the same logits and count every valid label pixel, and stay
   within stated bounds of the same weights with every kernel off (bf16 and
   f32);
8. the train CLI with its own defaults (no --model_type, no --no_augment:
   mobilenetv3large_lite, 512x512, OS16, b16, bf16, the 12-op stochastic
   augmentation on the card) for 2+2 steps on a seeded set whose every other
   pair is 720x1280 (the random crop can fire), then with --fused_loss (the
   loss kernels at a x16 upsample) and with --device_cache (orig_hw is the
   input shape); the augmentation on the card against its CPU run on the
   same parameters (labels equal, images within 1e-3);
9. mobilenetv3large and mobilenetv3small serving (bf16, b1) with the ASPP
   kernel at 160 and 96 channels and the decoder kernel, masks against the
   f32 model with no kernel; the eval CLI with its own default model, its
   matrix equal to torch.argmax + bincount;
10. (a) the learning proof: the train CLI on the toy set of data/toy.py
   with bench.py's `learn` recipe (mobilenetv2, 256x256, b8, adam 1e-3,
   cosine, adaptive weights, --no_augment, 2 + 118 epochs,
   --bn_recalibrate), the eval CLI on its output: mIoU >= 0.95, seconds to
   it; the same weights as a .ckpt give the same matrix; (b) on those
   weights, the masks of --fused_mbconv against the default's, each against
   the f32 model with no kernel (>= 0.98), and each eval matrix (default and
   --fused_mbconv) equal to torch.argmax + bincount (the kernels at this
   eval's shapes are also held in steps 3-4);
11. (c) xception served (bf16, b1, the ASPP kernel at 2048 channels and the
   decoder kernel; masks against the f32 model with no kernel, >= 0.98) and
   evaluated at b8 through the eval CLI (the ASPP kernel at (8,32,32,2048));
   (d) the train CLI on xception b8 with --fused_loss and
   --optim_state_dtype bfloat16;
12. the rest of the zoo: resnet50, peleenet, ghostnet, mobilevit_s and
   mobilevit_xs served (bf16, b1, 4 requests, the ASPP kernel at 2048, 704,
   960, 640 and 384 channels and the decoder kernel, in turns with no
   kernel; masks against the f32 model with no kernel, >= 0.98 but for
   seeded ghostnet, whose bf16 is as far from its f32 in the JAX package;
   the f32 model with both kernels against it, >= 0.999, as for
   mobilenetv3 and xception) and peleenet_lite with no kernel; resnet50 and mobilevit_s trained b8
   through the train CLI with --fused_loss (2 + 2 steps on 16 pairs, the
   loss kernels once a step, the loss falling); peleenet_lite and
   ghostnet_lite evaluated b8 through the eval CLI, each matrix equal to
   torch.argmax + bincount;
13. UNet and Fast-SCNN: (a) unet_standard, unet_lite and unet_simple served at
   512x512 with 21 classes and fast_scnn at Cityscapes' 1024x2048 with its 19
   (bf16, b1, 4 requests a turn, original sizes around 1024x2048 for
   fast_scnn): no kernel on the path, masks against the f32 model (>= 0.98),
   median and p90 latency, one unet_standard request profiled with its
   convolutions' device time against their bound at the dense bf16 rate;
   (b) unet_standard (512x512) and fast_scnn (1024x2048, 16 synthetic pairs
   of 19 classes written to build/) trained b8 through the train CLI at its
   own --freeze_level 1, which must move every parameter in stage 1 (no
   backbone), 2 + 2 steps; (c) fast_scnn (1024x2048) and unet_simple evaluated
   b8 through the eval CLI, the confusion kernel at (8,1024,2048,19) once a
   batch, each matrix equal to torch.argmax + bincount; (d) mobilenetv2 with
   the subpixel head, its ASPP and decoder kernels in f32 against none
   (>= 0.999 of pixels);
14. the dense CRF (postprocess.py, torch ops, no kernel of its own):
   `crf_inference` on the card against the same on the CPU (both example/
   pairs at 48x64 with space_step 4 and at 512x512 with the defaults, 21- and
   2-class unaries, argmax >= 0.999) and two card calls bit-equal; the grid
   against `crf_exact_dense` on the card with tests/test_crf_parity.py's
   floors at 48x64, printed at 128x170; `DeepLab(mobilenetv2, do_crf=True)`
   bf16 b1, 4 requests (the ASPP kernel once a request), one mask against
   the CRF on the CPU, in turns with 4 without the CRF, and fast_scnn at
   1024x2048 with 19 classes and the CRF; the eval CLI with --do_crf, 2
   batches of b8 (the ASPP and confusion kernels once a batch), its matrix
   equal to argmax -> crf_postprocess -> bincount image by image; the CRF's
   times at 512x512 with 2, 5 and 21 labels, rgb and luma, one call
   profiled (build/profile_one_crf.txt);
15. export (PR 12): mobilenetv2 (bf16, 512x512, OS16, seeded) with the ASPP
   and decoder kernels exported as a .pt2 program (`export.pt2`), saved to
   build/, loaded and called 4 times: each kernel one graph node, each call
   moving its launch count by 1, the probabilities against the eager model
   (mask agreement >= 0.9999); the same with --fused_mbconv (13 nodes and
   launches a call); `Runner` on the first artifact (probabilities sum to 1
   and equal the program's); eager against the artifact in turns; each
   operator's host us a call against its CUDA implementation called bare
   (and the ASPP one through a `torch.library.custom_op`); on the toy set at
   512x512, `deeplab --dump_model x.pt2` then `eval --model_path x.pt2`
   against eval on the same weights as an .npz (the same matrix), and
   `tools/export_model.py --format pt2|int8|ckpt`, its .pt2 through
   `Runner`; int8
   (`export.quantize`) on mobilenetv2_lite as the JAX bench's int8 cell sets
   it: every eligible conv calibrated, swapped and run through
   `torch._int_mm` once a call, masks against bf16, a request in turns with
   bf16; the learning proof's trained mobilenetv2 in int8 on the toy set
   (mask agreement > 0.98, |dmIoU| < 0.01);
15b. ONNX: `tools/export_onnx.py --device cuda` on mobilenetv2 (f32,
   512x512, OS16, 21 classes, seeded weights as an .npz): nodes,
   initializers, bytes, seconds; its op types inside the native engine's
   table, no `deeplabv3p` node; the ASPP and decoder kernels launched once
   each by the export's warm-up forward; `export.onnx.interp` on the card
   against the eager f32 model on 4 requests (TF32 off; mask agreement >=
   0.999), in turns P A A P and profiled once each; the eval CLI on the
   learning proof's trained weights as an .onnx against the .npz (the toy
   set at 256x256, b4: mIoU within 1e-3, the confusion kernel once a
   batch); `tools/validate_deeplab.py` on the .npz, .onnx and .pt2 of the
   seeded weights (mask agreement >= 0.999); unet_standard at 512x512
   exported and run against its eager model (>= 0.999);
15c. data parallelism (`parallel/mesh.py`, `Trainer(mesh=...)`): mobilenetv2
   (bf16, 512x512, OS16, 21 classes, seeded weights, dropout off, SGD 1e-2,
   the fused loss) trained 2 steps on two seeded global batches of 16 by (a)
   one process at b16, (b) two gloo ranks sharing the card at b8 each and (c)
   a one-rank NCCL group; (b) and (c) against (a): the loss and jaccard of
   each step, every parameter and BN buffer after step 1 (max |d| printed),
   the ranks' parameters bit-equal after step 2, each loss kernel once a
   step on each rank; before the steps, one eval pass over 32 seeded images
   (the confusion kernel once a batch of 8 on each rank) whose summed matrix
   equals (a)'s; each configuration's step times;
15d. spatial partitioning (`parallel/spatial.py`): the ASPP, decoder (with
   its global row offsets) and inverted-residual kernels on every row slab
   the phase's ranks hand them, against their plain versions and the whole
   map's call, and the confusion kernel on an eval rank's block;
   then, in this process and as four gloo ranks sharing the card (sub-meshes
   (1, 2), twice, and (2, 2) of the (1, 4) world): `DeepLab(mesh=...)`
   (mobilenetv2, seeded, the ASPP and decoder kernels) on (1, 2) at
   1024x2048 with 19 classes and on (1, 4) at 512x512 with 21, the f32
   logits gathered against one process's and the bf16 masks, the two kernels
   once a request on every rank; unet_simple (seeded, no kernel) on (1, 2)
   at a 1080x1920 frame, whose maps of one width take two heights and whose
   logits are 1088 rows high, gathered at that height: the f32 logits and
   masks held the same way, the bf16 mask by its agreement with one
   process's f32 mask against one process's own bf16 one (its seeded bf16
   logits tie on a share of pixels); eval with --fused_mbconv on (1, 2), the
   ASPP, inverted-residual and confusion kernels on every rank and the
   summed matrix against one process's and against torch.argmax + bincount
   of the same logits; training on (1, 2) at b2 and (2, 2) at b4 (plain CE,
   2 steps, bf16 and f32) at the data-parallel phase's bounds, bf16's step
   2 against one process at the ranks' parameters after step 1, the ranks'
   parameters bit-equal; each rank's request latency and step time;
15e. the dataset and evaluation tools (deeplabv3p_torch/tools/, the card
   machine has no JAX): the toy set of data/toy.py packed at 512x512 by
   `dataset_converter.pack_dataset` (the shards equal to the dataset's
   decode; seconds and img/s), mobilenetv2 b4 trained 2 steps from the
   packed path through the train CLI, `label_statistics` and
   `dataset_visualize` on the toy set, the trained model's masks of the toy
   images as gray PNGs through `onboard_png_convert` and
   `onboard_segment_eval` on the card (its matrix equal to np.bincount over
   the same PNGs), `model_statistics` of mobilenetv2 at 512 on the card
   (FLOPs >= the convolutions'), every dataset tool's --help in one process;
15f. the profiler and the diagnostics tools (`diagnostics_phase`):
   train_phase_profile on mobilenetv2_lite and mobilenetv2 b16 at 512x512
   (six phases each: ms, TFLOP/s, GB/s, shares of the card's peaks; both
   JSON records printed with the card), `utils.profiler.trace` + `annotate`
   around two served mobilenetv2 requests (the trace holds the annotation
   and the ASPP and decoder kernels), featuremap_check, convkernel_check and
   export_native_bench_model on the card against the CPU, augment_test on
   the card, the five tools' --help with no JAX;
15g. the frozen TF graph (`tf_phase`; no tensorflow on the card machine or
   anywhere on the path): `tools/export_model.py --format pb --device cuda`
   on mobilenetv2 (f32, 512x512, OS16, 21 classes, seeded weights as an
   .npz): nodes, op types, bytes, seconds, the ASPP and decoder kernels
   launched once each by the export's warm-up forward; `FrozenGraphRunner`
   on the card against the eager f32 model on 4 requests (TF32 off; max
   |dprob| <= 1e-5, mask agreement >= 0.999), timed in turns with the eager
   model, the .onnx executor on the same weights and the .tflite executor
   on this graph's .tflite, each profiled once; the eval CLI on the
   learning proof's trained weights as a .pb against the .npz (mIoU within
   1e-3, the confusion kernel once a batch) and the f32 model's matrix (<=
   1e-4 of pixels elsewhere); validate_deeplab on the .npz and the .pb
   (<= 1e-5); unet_standard at 512x512 and fast_scnn at 1024x2048 with 19
   classes exported and run against their eager models (<= 1e-5);
15h. `.tflite` and the SavedModel (`tflite_phase`; no tensorflow anywhere):
   `tools/export_model.py --format tflite`, `tflite_f16`, `pb` and
   `saved_model --device cuda` on mobilenetv2 (f32, 512x512, OS16, 21
   classes, seeded weights as an .npz): bytes, builtin counts, seconds, the
   ASPP and decoder kernels once each in each warm-up; `TFLiteRunner` on the
   card against the eager f32 model on 4 requests (fp32 within 1e-5, masks
   >= 0.999; the float16 file within 1e-3, masks >= 0.99); the CPU's
   .tflite of the same .npz equal to the card's, byte for byte; the
   SavedModel's GraphDef, decoded by the port's codec, bit-equal to the .pb's
   through `GraphProgram`; the eval CLI on a .tflite of the learning proof's
   weights against the .npz (mIoU within 1e-3, the confusion kernel once a
   batch) and the f32 model's matrix; validate_deeplab on the .npz and the
   .tflite (<= 1e-5); unet_standard at 512x512 and fast_scnn at 1024x2048
   with 19 classes as .tflite against their eager models (<= 1e-5); the
   int8 .tflite (`--format tflite_int8`, calibrated on 4 synthetic images):
   under half the fp32 file, the card's byte-equal to the CPU's, the card's
   executor within 1 LSB of the CPU's and to the JAX package's int8
   criteria against eager f32, the eval CLI on an int8 file of the trained
   weights (masks >= 0.98 of the f32 model's); the int8 executor timed in
   15g's turns;
16. latency of the serving path, train-step time and peak memory fused and
   unfused in turns, images/s of the eval loop (default, `--fused_mbconv`,
   no kernels, in turns), the CLI default's step with the augmentation's
   share of it, xception's step unfused, fused and with bf16 optimizer
   state in turns (time, peak memory, the state's bytes), resnet50's b8
   step unfused and fused in turns, mobilevit_s's fused, unet_standard's b8
   step against its bound at the dense bf16 rate and fast_scnn's at
   1024x2048 (time, img/s, peak memory, a profile each), device-time profiles of one request (also
   of resnet50 and mobilevit_s), one train step and one eval batch, and
   each kernel's time against its plain version, its bound and, where there
   is one, the library's calls (the ASPP kernel's, the loss tail's and the
   confusion kernel's rows also at the later slices' shapes, `at_other_shapes`, and launches at a
   shape already timed under `also_on`; the decoder runs at the serving
   shapes on every path).

Exits non-zero on any failure, and without printing a result when there is
no CUDA device or no checkout around the script. The line before the last is
the kernels' JSON record; the last is
{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}.

`--aspp` runs only steps 1-2 and the ASPP kernel's checks and times (bf16 b1
and b8, f32 b1), through the wrapper's public interface alone, so that the
script can also time the kernel of another checkout: copy it into that
checkout's root and run it there, in turns with this one.
"""

from __future__ import annotations

import json
import os
import statistics
import subprocess
import sys
import time

import numpy as np

REPO = os.path.dirname(os.path.abspath(__file__))
OUT_DIR = os.path.join(REPO, "build")  # gitignored
N_REQUESTS = 8
INPUT = (512, 512)
# original (h, w) of the 8 requests: all differ from the model size and
# none is square, so mask_resize does real work
REQUEST_SHAPES = [(375, 500), (480, 640), (333, 517), (600, 400),
                  (512, 384), (281, 419), (720, 1280), (427, 640)]
WARMUP = 3
TRAIN_IMAGES, TRAIN_BATCH, TRAIN_SEED = 32, 16, 0
# the CLI-defaults training set: every other pair at 720x1280, larger than the
# input on both axes, so the random crop can fire
V3_LARGE_HW, V3_SEED = (720, 1280), 5
V3_REQUESTS_SMALL = 4
EVAL_BATCH, EVAL_SEED = 8, 4
# the learning proof (bench.py:790-858): the toy set at 256x256, b8, 120 epochs
LEARN_HW, LEARN_BATCH, LEARN_EPOCHS, LEARN_TARGET = 256, 8, 120, 0.95
# the rest of the zoo: the full heads served with both kernels and
# peleenet_lite (the bench's baseline) with none, 4 requests a turn;
# resnet50 and mobilevit_s trained b8 (as xception is) through the train CLI
# on the first 16 pairs (2 steps an epoch); the lite heads of two backbones
# evaluated b8
ZOO_SERVED = ("resnet50", "peleenet", "ghostnet", "mobilevit_s", "mobilevit_xs", "peleenet_lite")
ZOO_REQUESTS = 4
MODEL_TRAIN_BATCH, ZOO_TRAIN_IMAGES = 8, 16
ZOO_EVALUATED = ("peleenet_lite", "ghostnet_lite")
PROFILED_SERVING = ("mobilenetv3large", "xception", "resnet50", "mobilevit_s")
# seeded ghostnet is as ill-conditioned in bf16 in the JAX package: at 256 px
# its bf16 masks agree with its f32 ones on ~0.98 of pixels in both packages
# (tests/test_torch_ghostnet.py). Its bf16 agreement is printed, not held to
# 0.98; its kernels are held in f32 at 0.999, as every full head's are
BF16_FLOOR_NOT_HELD = ("ghostnet",)
# UNet x3 served at 512x512 with 21 classes; Fast-SCNN served, trained and
# evaluated at Cityscapes' 1024x2048 with its 19 classes (Poudel et al., 2019),
# its requests of original sizes around the Cityscapes frame; unet_standard and
# fast_scnn trained b8 through the train CLI (2 + 2 steps on 16 pairs), then
# timed; fast_scnn and unet_simple evaluated b8 through the eval CLI
UNET_SERVED = ("unet_standard", "unet_lite", "unet_simple")
CITYSCAPES_HW = (1024, 2048)
CITYSCAPES_REQUEST_SHAPES = [(1024, 2048), (1080, 1920), (960, 1920), (1024, 2048)]
FAMILY_REQUESTS, FAMILY_TRAIN_IMAGES, CITYSCAPES_SEED = 4, 16, 7
# the dense CRF: the example/ pairs against the CPU and the oracle; mobilenetv2
# served with do_crf (4 requests a turn), timed alone at 2, 5 and 21 labels;
# eval --do_crf on the first 16 synthetic pairs (2 batches of b8)
CRF_PAIRS = ("2007_000039", "2007_000346")
CRF_REQUESTS, CRF_LABEL_COUNTS, CRF_EVAL_IMAGES = 4, (2, 5, 21), 16
# export and int8: 4 calls of each loaded .pt2, 20-call turns of the A/Bs, the
# int8 calibration batches' seed
EXPORT_REQUESTS, EXPORT_ITERS, INT8_SEED = 4, 20, 11
# the int8 .tflite: calibrated on 4 images (the export tool's default) of a
# synthetic 512x512 set for mobilenetv2, on the toy set's for the trained
# weights; its masks against the f32 model's on the trained weights held to
# the bf16 floor (PERF.md section 2), its output against eager f32 to the JAX
# package's int8 criteria (tests/test_tf_export.py:69-99)
INT8_CALIB, INT8_MASK_FLOOR, INT8_CORRELATION, INT8_MEAN_DPROB = 4, 0.98, 0.9, 0.1
# data parallelism: 2 steps on global batches of TRAIN_BATCH, an eval pass over
# 32 images in batches of 8 a rank, the data's and the weights' seeds, in bf16 (the
# train CLI's) and f32. (b) and (c) against (a) in f32: the loss within 1e-4
# relative at step 1 and 1e-2 at step 2, jaccard within 1e-2, every parameter
# within 5e-3 and BN buffer within 1e-3 after step 1, step 1's update within 5e-2
# of its size. In bf16: each of those gaps within 2x the gap between (a) in bf16
# and (a) in f32, plus a floor (parallel_phase says why)
PARALLEL_STEPS, PARALLEL_VAL, PARALLEL_VAL_BATCH, PARALLEL_SEEDS = 2, 32, 8, (13, 9)
PARALLEL_DTYPES = ("bfloat16", "float32")
# then PARALLEL_TIMED more steps a configuration, timed only, and one bf16 step
# profiled (rank 0 of (b), (a) and (c)); profile_one calls its step 4 times
PARALLEL_TIMED, PROFILE_CALLS = 4, 4
PARALLEL_F32_BOUNDS = {"loss": (1e-4, 1e-2), "jaccard": 1e-2, "parameters": 5e-3,
                       "BN buffers": 1e-3, "update": 5e-2}  # loss: relative, at each step
PARALLEL_BF16_FACTOR = 2.0
PARALLEL_BF16_FLOOR = {"loss": 1e-3, "jaccard": 1e-2, "parameters": 1e-3, "BN buffers": 1e-4,
                       "update": 1e-2}  # loss: relative
# spatial partitioning (15d): serving (mesh, H x W, classes) on Cityscapes' size
# and on VOC's, SPATIAL_REQUESTS requests a run; eval on (1, 2) over 8 of the
# data-parallel phase's val images, 4 a batch; training (mesh, global batch) on
# its train set, SPATIAL_STEPS steps held, SPATIAL_TIMED more timed; the seeds
# of the request, the eval weights and the kernel checks. Bounds set before the
# first card run: f32 logits within 1e-4 of max|logits| (the blocks' convs may
# take other cuDNN algorithms than the whole map's), bf16 masks agree on >= 0.999
# of pixels, the eval matrix within 1e-4 of its pixels (bf16, --fused_mbconv),
# training at the data-parallel phase's bounds: in bf16 against one process at
# the same parameters (step 2 from the ranks' parameters after step 1), within
# twice one process's own bf16-vs-f32 gap there plus the floors (spatial_phase)
SPATIAL_SERVING = [((1, 2), (1024, 2048), 19), ((1, 4), INPUT, 21)]
# ... and unet_simple on a full-HD frame, no multiple of 16 high: its SAME pools
# round 1080 -> 540 -> 270 -> 135 -> 68, its decoder doubles 68 -> ... -> 1088,
# so maps of one width have two heights and the logits are 1088 rows high. Its
# seeded bf16 logits are rounded to steps of 2^-5 at their scale (max ~7), and a
# share of its pixels tie in bf16 (the phase prints it): one process's own bf16
# masks leave its f32 ones on ~2 % of pixels, so a rank's bf16 mask is held by
# what it adds to that: its agreement with one process's f32 mask within
# SPATIAL_BF16_VS_F32 of one process's bf16 agreement (held to SPATIAL_MASK_FLOOR
# against one process's bf16 mask instead, it failed on an H100 at 0.998288 on
# every rank, with f32 logits within 1.2e-06 of max|logits|)
SPATIAL_UNET = ((1, 2), (1080, 1920), 19)
SPATIAL_BF16_VS_F32 = 1e-3
SPATIAL_REQUESTS, SPATIAL_EVAL_IMAGES, SPATIAL_EVAL_BATCH = 6, 8, 4
SPATIAL_TRAINING = [((1, 2), 2), ((2, 2), 4)]
SPATIAL_STEPS, SPATIAL_TIMED, SPATIAL_SEEDS = 2, 3, (21, 22, 23)
SPATIAL_F32_LOGITS, SPATIAL_MASK_FLOOR, SPATIAL_EVAL_DISAGREE = 1e-4, 0.999, 1e-4
# the dataset and evaluation tools (15e): the toy set of data/toy.py packed at
# 512x512 in shards of 4, mobilenetv2 trained b4 for TOOLS_STEPS steps on the
# shards, its masks of the toy images scored by the PNG tools
TOOLS_HW, TOOLS_BATCH, TOOLS_SHARD, TOOLS_STEPS = (512, 512), 4, 4, 2
# every module of the dataset tools' package and the evaluation tools, each
# imported and, where it has a main, run with --help (one process)
TOOLS_HELP = """
import contextlib, importlib, io, pkgutil, sys
import deeplabv3p_torch.tools.dataset_converter as tools
names = sorted(m.name for m in pkgutil.walk_packages(tools.__path__, tools.__name__ + "."))
names += ["deeplabv3p_torch.tools." + n for n in sys.argv[1:]]
ran = []
for name in names:
    mod = importlib.import_module(name)
    if hasattr(mod, "main"):
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            try:
                mod.main(["--help"])
            except SystemExit as e:
                assert e.code == 0, (name, e.code)
        assert buf.getvalue().startswith("usage:"), name
        ran.append(name)
leaked = [m for m in sys.modules if m.split(".")[0] in ("jax", "deeplabv3p_tpu", "tools")]
assert not leaked, leaked
print(len(names), "modules,", len(ran), "tools")
print(" ".join(ran))
"""
EVAL_TOOLS = ("onboard_png_convert", "onboard_segment_eval", "model_statistics")
# the diagnostics tools (15f), their --help run the same way
DIAGNOSTICS_TOOLS = ("featuremap_check", "convkernel_check", "augment_test",
                     "export_native_bench_model", "train_phase_profile")
# (15f) the phase profiler's cases at its defaults (512x512, 21 classes, 8 timed
# calls), the trace's requests, the convolution kernels' ascent, the augmented
# samples and the file the native engine's benchmark reads
DIAG_PROFILED = (("mobilenetv2_lite", 16), ("mobilenetv2", 16))
DIAG_PHASES = ["backbone_fwd", "forward", "forward+loss", "grad (fwd+bwd)", "train_step",
               "loss_only"]
DIAG_TRACED_REQUESTS = 2
# the profiler's events where the host waits for the card: a tensor's value
# read on the host (`.item()`, as CUDA's bincount reads its input's max) and
# the copy and synchronisation under it
DIAG_HOST_WAITS = ("aten::item", "aten::_local_scalar_dense", "aten::bincount",
                   "cudaStreamSynchronize", "cudaDeviceSynchronize", "cudaMemcpyAsync")
DIAG_ANNOTATION = "chip_smoke_diagnostics_requests"
DIAG_KERNEL_NAMES = ("multirate_dw_kernel", "decoder_frontend_kernel")  # csrc aspp.cu, decoder.cu
DIAG_MAP_RTOL = 1e-3  # of max|map|, the card's f32 maps against the CPU's
DIAG_KERNEL_ARGS = ["--layer", "Conv", "--num_filters", "4", "--image_size", "128",
                    "--steps", "5"]
DIAG_AUGMENT_COUNT = 4
DIAG_ONNX_ATOL = 1e-4
# (logits shape, logits dtype name, labels dtype name): the eval slice's call first
CONFUSION_CASES = [((8, 512, 512, 21), "float32", "int32"),
                   ((8, 512, 512, 21), "bfloat16", "uint8"),
                   ((3, 37, 41, 6), "float32", "int64"),
                   ((2, 50, 30, 151), "float32", "uint8"),
                   ((8, 256, 256, 4), "bfloat16", "int32"),  # the learning proof's eval
                   ((8, 1024, 2048, 19), "float32", "int32")]  # Fast-SCNN's Cityscapes eval
# (n, h, w, cin, cexp, cout, rate, residual) of tests/test_pallas_mbconv.py
MBCONV_TEST_CASES = [(2, 16, 16, 24, 144, 24, 1, True), (1, 16, 16, 64, 384, 96, 1, False),
                     (2, 8, 8, 32, 192, 32, 2, True), (1, 32, 16, 16, 96, 24, 1, False)]
# ... a map whose sides are no multiple of the 8x8 tile, and OS8's rate 4
MBCONV_EXTRA_CASES = [(3, 37, 29, 24, 144, 24, 1, True), (1, 64, 64, 160, 960, 160, 4, True)]
# (x shape, rates) ASPP cases: the serving path's (b1) and the eval path's (b8)
# calls, OS8, OS32's rates, a C that is no multiple of 8 with a rate past the
# map, a ragged map with rates past it, and 4 rates with C = 7
ASPP_CASES = [((1, 32, 32, 320), (6, 12, 18)), ((8, 32, 32, 320), (6, 12, 18)),
              ((1, 64, 64, 320), (12, 24, 36)), ((1, 16, 16, 320), (3, 6, 9)),
              ((1, 16, 16, 100), (6, 12, 18)), ((2, 37, 29, 136), (12, 24, 36)),
              ((3, 5, 4, 7), (3, 6, 9, 1)),
              ((1, 32, 32, 160), (6, 12, 18)), ((1, 32, 32, 96), (6, 12, 18)),
              ((1, 32, 32, 2048), (6, 12, 18)), ((8, 32, 32, 2048), (6, 12, 18)),
              ((8, 16, 16, 320), (6, 12, 18)),
              ((1, 32, 32, 704), (6, 12, 18)), ((1, 32, 32, 960), (6, 12, 18)),
              ((1, 32, 32, 640), (6, 12, 18)), ((1, 32, 32, 384), (6, 12, 18))]
# the serving calls of mobilenetv3large (160 channels) and mobilenetv3small (96),
# xception's serving (2048, resnet50's too) and eval (b8) calls, the serving
# calls of peleenet (704), ghostnet (960), mobilevit_s (640) and mobilevit_xs
# (384); the learning proof's eval call (256 px, OS16) is held but not timed
ASPP_SHAPE_CASES = {7: "aspp_c160", 8: "aspp_c96", 9: "aspp_c2048", 10: "aspp_c2048_b8",
                    12: "aspp_c704", 13: "aspp_c960", 14: "aspp_c640", 15: "aspp_c384"}
# each new shape's model, whose serving run gives its row's launches
ZOO_ASPP_ROWS = (("aspp_c704", "peleenet"), ("aspp_c960", "ghostnet"),
                 ("aspp_c640", "mobilevit_s"), ("aspp_c384", "mobilevit_xs"))
# (x_enc shape, skip shape) decoder cases: the serving path's, a ragged one with
# non-integer scales, the serving maps at batch 8, OS8's scale 2, and channel
# counts that are no multiple of 4 (one channel a thread)
DECODER_CASES = [((1, 32, 32, 256), (1, 128, 128, 48)), ((2, 13, 11, 200), (2, 50, 41, 48)),
                 ((8, 32, 32, 256), (8, 128, 128, 48)), ((1, 64, 64, 256), (1, 128, 128, 48)),
                 ((1, 16, 16, 100), (1, 64, 64, 46))]
# (B, h, w, C) -> (H, W) loss-tail cases; the first is the training slice's, the
# fourth mobilenetv3large_lite's --fused_loss call (OS16 logits, x16), the last
# xception's at b8
UPSAMPLE_CE_CASES = [((16, 128, 128, 21), (512, 512)), ((2, 32, 32, 21), (512, 512)),
                     ((3, 29, 37, 21), (116, 148)), ((16, 32, 32, 21), (512, 512)),
                     ((8, 128, 128, 21), (512, 512))]
# the backward kernel alone also at scale 1 and at an odd scale
UPSAMPLE_CE_BACKWARD_CASES = [((2, 24, 40, 21), (24, 40)), ((2, 24, 40, 21), (72, 120))]
# the forward kernel alone also there, at 6 and 151 classes (above 32 the batch-
# at-a-time kernel), at scale 2 and at a width that is no multiple of 32 or 4
UPSAMPLE_CE_FORWARD_CASES = UPSAMPLE_CE_BACKWARD_CASES + [
    ((2, 64, 64, 6), (256, 256)), ((1, 16, 24, 151), (64, 96)), ((2, 50, 30, 21), (100, 60)),
    ((2, 9, 7, 4), (27, 7))]

failures: list[str] = []


def die(msg: str) -> None:
    print(f"chip_smoke: {msg}", file=sys.stderr)
    sys.exit(1)


def check(ok: bool, what: str) -> None:
    print(f"  [{'ok' if ok else 'FAIL'}] {what}")
    if not ok:
        failures.append(what)


ZERO_LAUNCHES = {"multirate_atrous_depthwise": 0, "fused_decoder_frontend": 0,
                 "upsample_ce_forward": 0, "upsample_ce_backward": 0,
                 "confusion_matrix_fused": 0, "fused_inverted_residual": 0}


def run_cli(torch, kernels, cli_main, args, quiet: bool = True):
    """(result, wall s, launch counts, captured output) of one in-process CLI
    run, the counts set to 0 just before it and read just after; its prints
    captured when `quiet` (they are long), else shown."""
    import contextlib
    import io

    text = io.StringIO()
    kernels.reset_launch_counts()                    # the path starts here
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(text) if quiet else contextlib.nullcontext():
        out = cli_main(args)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    return out, wall, kernels.launch_counts(), text.getvalue()  # ... and ends here


def tolerance(ref_max: float, dtype) -> float:
    """f32: 1e-5 * max|ref| + 1e-5 (summation order only). bf16: one
    rounding of the f32 sum, at most a bf16 ulp (2^-7 relative):
    2e-2 * max(1, max|ref|)."""
    import torch

    if dtype == torch.float32:
        return 1e-5 * ref_max + 1e-5
    return 2e-2 * max(1.0, ref_max)


def event_ms(fn, iters: int) -> float:
    """Mean device time of fn() in ms, by CUDA events around `iters` calls."""
    import torch

    for _ in range(5):
        fn()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def ab_ms(kernel_fn, plain_fn, iters: int = 200) -> tuple[float, float]:
    """(kernel ms, plain ms), measured in turns plain, kernel, kernel, plain."""
    p1 = event_ms(plain_fn, iters)
    k1 = event_ms(kernel_fn, iters)
    k2 = event_ms(kernel_fn, iters)
    p2 = event_ms(plain_fn, iters)
    return (k1 + k2) / 2, (p1 + p2) / 2


def nbytes(*tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors)


def bound(n_bytes: float, flops: float) -> tuple[float, str]:
    """(least ms the card could take, which of the two sets it): the bytes
    (each input read once, each output written once) over the memory rate,
    or the f32 operations over the f32 FMA rate, whichever is larger."""
    from deeplabv3p_torch.utils.card import F32_FLOPS, HBM_BYTES_PER_S

    by_bytes, by_ops = n_bytes / HBM_BYTES_PER_S * 1e3, flops / F32_FLOPS * 1e3
    return (by_bytes, "bytes") if by_bytes >= by_ops else (by_ops, "operations")


def aspp_case(torch, shape, rates, dtype, seed):
    gen = torch.Generator().manual_seed(seed)
    r, c = len(rates), shape[-1]
    x = torch.randn(shape, generator=gen).cuda().to(dtype)
    k = (torch.randn((r, 3, 3, c), generator=gen) / 3.0).cuda()
    scale = (0.5 + torch.rand((r, c), generator=gen)).cuda()
    bias = (0.1 * torch.randn((r, c), generator=gen)).cuda()
    return x, k, tuple(rates), scale, bias


def decoder_case(torch, enc_shape, skip_shape, dtype, seed):
    gen = torch.Generator().manual_seed(seed)
    c = enc_shape[-1] + skip_shape[-1]
    x = torch.randn(enc_shape, generator=gen).cuda().to(dtype)
    skip = torch.randn(skip_shape, generator=gen).relu().cuda().to(dtype)
    k = (torch.randn((3, 3, c), generator=gen) / 3.0).cuda()
    scale = (0.5 + torch.rand((c,), generator=gen)).cuda()
    bias = (0.1 * torch.randn((c,), generator=gen)).cuda()
    return x, skip, k, scale, bias


def max_err(got, want) -> tuple[float, float]:
    got = got if isinstance(got, (tuple, list)) else [got]
    want = want if isinstance(want, (tuple, list)) else [want]
    err = max((g.float() - w.float()).abs().max().item() for g, w in zip(got, want))
    ref = max(w.float().abs().max().item() for w in want)
    return err, ref


def aspp_plan_text(torch, kaspp, x, rates) -> str:
    """The wrapper's launch plan for x, where the checkout's wrapper has one."""
    if not hasattr(kaspp, "launch_plan"):
        return "no plan (an older wrapper)"
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    p = kaspp.launch_plan(*x.shape, rates, x.dtype, True, x.data_ptr() % 16 == 0, sms)
    return (f"{p.vec} channel(s) a thread, {p.blocks} blocks of {p.threads} threads, bands of "
            f"{p.band} rows, {'segmented' if p.segmented else 'one-range'} slab of "
            f"{p.slab_rows} rows, {p.smem_bytes} B shared")


def aspp_checks(torch, kaspp) -> dict:
    """The ASPP kernel against its plain version at ASPP_CASES in f32 and
    bf16, fused (BN + ReLU) and, at the main path's two shapes, bare; a
    second call with the same signature (the wrapper's kept plan) gives the
    same bits. Returns the records the timing phase reuses: the serving
    path's bf16 b1 call, the eval path's bf16 b8 call and the f32 model's b1."""
    f32, bf16 = torch.float32, torch.bfloat16
    records = {}
    print("multirate_atrous_depthwise (csrc/aspp.cu) vs plain:")
    for i, (shape, rates) in enumerate(ASPP_CASES):
        for dtype in (f32, bf16):
            for fuse in (True, False) if i < 2 else (True,):
                x, k, r, s, b = aspp_case(torch, shape, rates, dtype, seed=1)
                s, b = (s, b) if fuse else (None, None)
                got = kaspp.multirate_atrous_depthwise(x, k, r, s, b)
                again = kaspp.multirate_atrous_depthwise(x, k, r, s, b)
                torch.cuda.synchronize()
                err, ref = max_err(got, kaspp.multirate_atrous_depthwise_reference(x, k, r, s, b))
                tol = tolerance(ref, dtype)
                same = all(torch.equal(a, c) for a, c in zip(got, again))
                check(err <= tol and same and all(g.dtype == dtype for g in got),
                      f"aspp {shape} rates {rates} {dtype} {'bn_relu' if fuse else 'bare'}: "
                      f"max|err| {err:.3g} <= {tol:.3g} (max|ref| {ref:.3g}), two calls "
                      f"bit-equal: {same}; {aspp_plan_text(torch, kaspp, x, rates)}")
                key = {(0, bf16): "aspp", (1, bf16): "aspp_b8", (0, f32): "aspp_f32",
                       (9, f32): "aspp_c2048_f32",
                       **{(j, bf16): name for j, name in ASPP_SHAPE_CASES.items()}}.get(
                    (i, dtype))
                if key and fuse:
                    records[key] = {"max_abs_err": err, "case": (x, k, r, s, b)}
    return records


def aspp_timing(torch, kaspp, args, iters: int) -> dict:
    """One ASPP call's times: CUDA events around back-to-back calls of the
    wrapper (its host work included) and of the plain version, the
    profiler's device time a call, and the bound: x and the weights read
    once, one output a rate written once, or 9 multiply-adds and the BN fold
    an output at the f32 rate."""
    fn = kaspp.multirate_atrous_depthwise
    ref_fn = kaspp.multirate_atrous_depthwise_reference
    x, k = args[0], args[1]
    outs = len(args[2]) * x.numel()
    bound_ms, bound_by = bound(nbytes(x, k, *args[3:]) + outs * x.element_size(),
                               outs * (9 * 2 + 2))
    ms, plain_ms = ab_ms(lambda: fn(*args), lambda: ref_fn(*args), iters=iters)
    dev_us, dev_launches = device_us(torch, lambda: fn(*args))
    plain_us, plain_launches = device_us(torch, lambda: ref_fn(*args))
    print(f"multirate_atrous_depthwise {tuple(x.shape)} {x.dtype}: kernel {ms * 1e3:.2f} us, "
          f"plain {plain_ms * 1e3:.2f} us a call (CUDA events, mean of 2x{iters} calls each); "
          f"device time a call (profiler): kernel {us_text(dev_us)} in {dev_launches} "
          f"launch(es), plain {us_text(plain_us)} in {plain_launches}; bound "
          f"{bound_ms * 1e3:.2f} us by {bound_by}  [{card_line()}]")
    return {"shape": list(x.shape), "dtype": str(x.dtype), "ms": ms, "plain_ms": plain_ms,
            "device_us": dev_us, "plain_device_us": plain_us, "bound_ms": bound_ms,
            "bound_by": bound_by}


def aspp_host_breakdown(torch, kaspp, args, calls: int = 2000) -> None:
    """Host time of one ASPP wrapper call and of its parts (host clock over
    `calls` back-to-back calls, the card synchronized after them): what
    CUDA events around back-to-back calls measure when the kernel is
    shorter than the host's work."""
    x, k, r, s, b = args
    out = torch.empty((len(r), *x.shape), dtype=x.dtype, device=x.device)
    parts = {"the wrapper": lambda: kaspp.multirate_atrous_depthwise(x, k, r, s, b),
             "torch.empty of the output": lambda: torch.empty(
                 (len(r), *x.shape), dtype=x.dtype, device=x.device),
             "out.unbind(0)": lambda: out.unbind(0),
             "torch.cuda.current_stream().cuda_stream":
                 lambda: torch.cuda.current_stream().cuda_stream,
             "torch.cuda.current_device()": torch.cuda.current_device,
             "four is_contiguous()": lambda: (x.is_contiguous(), k.is_contiguous(),
                                              s.is_contiguous(), b.is_contiguous()),
             "five data_ptr()": lambda: (x.data_ptr(), k.data_ptr(), s.data_ptr(),
                                         b.data_ptr(), out.data_ptr())}
    if hasattr(kaspp, "_signature"):
        parts["the signature key"] = lambda: kaspp._signature(x, k, r, s, b)
        lib, plan = kaspp.load_library(), kaspp._plans[kaspp._signature(x, k, r, s, b)][1]
        stream = torch.cuda.current_stream().cuda_stream
        ptrs = (x.data_ptr(), k.data_ptr(), s.data_ptr(), b.data_ptr(), out.data_ptr(), plan)
        parts["the library call alone (ctypes + launch)"] = (
            lambda: lib.multirate_atrous_depthwise(*ptrs, stream))
        parts["torch._C._cuda_getCurrentRawStream"] = (
            lambda: torch._C._cuda_getCurrentRawStream(x.device.index))
    text = []
    for name, fn in parts.items():
        for _ in range(50):
            fn()
        torch.cuda.synchronize()
        t = time.perf_counter()
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
        text.append(f"{name} {(time.perf_counter() - t) / calls * 1e6:.2f}")
    print(f"  host us a call ({tuple(x.shape)} {x.dtype}, {calls} calls): " + ", ".join(text))


def aspp_plan_sweep(torch, kaspp, records) -> None:
    """Device time of the kernel at the b1 and b8 bf16 calls for other
    targets of blocks an SM (the plan's BLOCKS_PER_SM), the plans printed."""
    if not hasattr(kaspp, "BLOCKS_PER_SM"):
        return
    chosen = kaspp.BLOCKS_PER_SM
    for target in (1, 2, 4, 8, 16):
        kaspp.BLOCKS_PER_SM = target
        kaspp._plans.clear()
        for key in ("aspp", "aspp_b8"):
            args = records[key]["case"]
            dev, _ = device_us(torch, lambda: kaspp.multirate_atrous_depthwise(*args))
            print(f"  plan sweep, {target} blocks an SM aimed at, {tuple(args[0].shape)}: device "
                  f"{us_text(dev)}; {aspp_plan_text(torch, kaspp, args[0], args[2])}")
    kaspp.BLOCKS_PER_SM = chosen
    kaspp._plans.clear()


def aspp_times(torch, kaspp, records, launches) -> dict:
    """The ASPP kernel's kernels-JSON row: the serving path's bf16 b1 call,
    with the eval path's bf16 b8 call and the f32 model's b1 call beside it."""
    row = aspp_timing(torch, kaspp, records["aspp"]["case"], iters=200)
    b8 = aspp_timing(torch, kaspp, records["aspp_b8"]["case"], iters=100)
    f32_b1 = aspp_timing(torch, kaspp, records["aspp_f32"]["case"], iters=200)
    return {"name": "multirate_atrous_depthwise", "route": "cuda",
            "source": "deeplabv3p_torch/ops/kernels/csrc/aspp.cu",
            "replaces": "deeplabv3p_tpu/ops/pallas/aspp.py:85", "launches": launches,
            "max_abs_err": records["aspp"]["max_abs_err"], "ms": row["ms"],
            "plain_ms": row["plain_ms"], "bound_ms": row["bound_ms"],
            "bound_by": row["bound_by"], "library_ms": None, "device_us": row["device_us"],
            "shape": row["shape"], "dtype": row["dtype"], "b8": b8, "f32_b1": f32_b1}


def make_requests(preprocess_image, shapes=REQUEST_SHAPES, input_hw=INPUT):
    """Seeded uint8 images at the original sizes `shapes`, preprocessed as a
    user's request is (PIL bicubic resize to `input_hw` + normalise), or,
    where PIL is missing, seeded arrays at the model size."""
    rng = np.random.default_rng(0)
    try:
        from PIL import Image
    except ImportError:
        print("  PIL missing: requests are seeded arrays at the model size")
        return [(rng.uniform(-1, 1, (1, *input_hw, 3)).astype(np.float32), hw)
                for hw in shapes]
    requests = []
    for h, w in shapes:
        # smooth random image: a coarse noise field, bilinearly enlarged
        coarse = rng.integers(0, 256, (h // 16 + 1, w // 16 + 1, 3), dtype=np.uint8)
        img = Image.fromarray(coarse).resize((w, h), Image.BILINEAR)
        requests.append((preprocess_image(img, input_hw), (h, w)))
    return requests


def serve_requests(torch, deeplab, requests):
    """(masks, ms a request): each request through `predict`, host clock
    around it, synchronized."""
    masks, times = [], []
    for data, hw in requests:
        torch.cuda.synchronize()
        t = time.perf_counter()
        masks.append(deeplab.predict(data, hw))
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t) * 1e3)
    return masks, times


def main() -> None:
    try:
        import torch
    except ImportError:
        die("torch is not installed")
    if not torch.cuda.is_available():
        die("torch.cuda.is_available() is False: this smoke run needs an NVIDIA GPU")
    sys.path.insert(0, REPO)
    try:
        from deeplabv3p_torch.inference import DeepLab, preprocess_image
        from deeplabv3p_torch.ops import kernels
        from deeplabv3p_torch.ops.kernels import _build
        from deeplabv3p_torch.ops.kernels import aspp as kaspp
        from deeplabv3p_torch.ops.kernels import confusion as kconf
        from deeplabv3p_torch.ops.kernels import decoder as kdec
        from deeplabv3p_torch.ops.kernels import mbconv as kmb
        from deeplabv3p_torch.ops.kernels import upsample_ce as kce
        from deeplabv3p_torch import postprocess
        from deeplabv3p_torch.postprocess import mask_argmax
        from deeplabv3p_torch.train import main as train_main
        from deeplabv3p_torch.train import parse_args as train_args
        from deeplabv3p_torch.utils.card import BF16_TENSOR_FLOPS
    except ImportError as e:
        die(f"cannot import deeplabv3p_torch ({e}): run from a checkout of the repository")
    classes_path = os.path.join(REPO, "configs", "voc_classes.txt")
    if not os.path.exists(classes_path):
        die(f"{classes_path} missing: run from a checkout of the repository")

    # -- 1. the card -------------------------------------------------------
    card = card_line()
    print(card)
    kind = torch.cuda.get_device_name(0)
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}, python "
          f"{sys.version.split()[0]}, device 0: {kind}, "
          f"{torch.cuda.device_count()} visible")
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    print(f"plain side: cudnn.allow_tf32={torch.backends.cudnn.allow_tf32}, "
          f"cuda.matmul.allow_tf32={torch.backends.cuda.matmul.allow_tf32}")

    # -- 2. build ------------------------------------------------------------
    t0 = time.perf_counter()
    _build.load_library()  # builds, unless this source hash is built already
    info = _build.build_info
    print(f"built and loaded {info['path']} in {time.perf_counter() - t0:.2f} s "
          f"(nvcc {info['seconds']:.2f} s, cached={info['cached']}); "
          f"flags: {' '.join(_build.NVCC_FLAGS)}")
    for line in info.get("ptxas", "").splitlines():
        if "Compiling entry" in line or "Used" in line or "spill" in line:
            print("  ptxas:", line.strip())

    f32, bf16 = torch.float32, torch.bfloat16
    if "--aspp" in sys.argv[1:]:  # the ASPP kernel alone
        aspp_records = aspp_checks(torch, kaspp)
        row = aspp_times(torch, kaspp, aspp_records, None)
        for key in ("aspp", "aspp_b8"):
            aspp_host_breakdown(torch, kaspp, aspp_records[key]["case"])
        aspp_plan_sweep(torch, kaspp, aspp_records)
        print(json.dumps({"kernels": [row]}))
        if failures:
            die(f"{len(failures)} check(s) failed: {failures}")
        print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                                 "count": torch.cuda.device_count()}}))
        return
    if "--onnx" in sys.argv[1:]:  # the ONNX phase alone, on the learning proof's weights
        requests = make_requests(preprocess_image)
        learn = learning_proof(torch, kernels, train_main, train_args)
        launches = onnx_phase(torch, kernels, classes_path, requests, learn)
        leaked = [m for m in ("jax", "flax", "deeplabv3p_tpu") if m in sys.modules]
        check(not leaked, f"no JAX module imported ({leaked or 'none'})")
        print(json.dumps({"onnx_launches": launches}))
        if failures:
            die(f"{len(failures)} check(s) failed: {failures}")
        print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                                 "count": torch.cuda.device_count()}}))
        return
    if "--tf" in sys.argv[1:]:  # the frozen TF graph phase alone, on the learning proof's weights
        requests = make_requests(preprocess_image)
        learn = learning_proof(torch, kernels, train_main, train_args)
        launches = tf_phase(torch, kernels, classes_path, requests, learn)
        leaked = [m for m in ("jax", "flax", "deeplabv3p_tpu") if m in sys.modules]
        check(not leaked, f"no JAX module imported ({leaked or 'none'})")
        print(json.dumps({"tf_launches": launches}))
        if failures:
            die(f"{len(failures)} check(s) failed: {failures}")
        print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                                 "count": torch.cuda.device_count()}}))
        return
    if "--tflite" in sys.argv[1:]:  # the TF graph and .tflite / SavedModel phases, on the
        # learning proof's weights
        requests = make_requests(preprocess_image)
        learn = learning_proof(torch, kernels, train_main, train_args)
        launches = {**tf_phase(torch, kernels, classes_path, requests, learn),
                    **tflite_phase(torch, kernels, classes_path, requests, learn)}
        leaked = [m for m in ("jax", "flax", "deeplabv3p_tpu") if m in sys.modules]
        check(not leaked, f"no JAX module imported ({leaked or 'none'})")
        print(json.dumps({"tflite_launches": launches}))
        if failures:
            die(f"{len(failures)} check(s) failed: {failures}")
        print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                                 "count": torch.cuda.device_count()}}))
        return
    if "--parallel" in sys.argv[1:]:  # the data-parallel phase alone
        launches = parallel_phase(torch)
        print(json.dumps({"parallel_launches": launches}))
        if failures:
            die(f"{len(failures)} check(s) failed: {failures}")
        print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                                 "count": torch.cuda.device_count()}}))
        return
    if "--spatial" in sys.argv[1:]:  # the spatial phase alone
        launches = spatial_phase(torch, kaspp, kdec, kmb, kconf)
        print(json.dumps({"spatial_launches": launches}))
        if failures:
            die(f"{len(failures)} check(s) failed: {failures}")
        print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                                 "count": torch.cuda.device_count()}}))
        return
    if "--tools" in sys.argv[1:]:  # the dataset and evaluation tools alone
        launches = tools_phase(torch, kernels, train_main, train_args)
        print(json.dumps({"tools_launches": launches}))
        if failures:
            die(f"{len(failures)} check(s) failed: {failures}")
        print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                                 "count": torch.cuda.device_count()}}))
        return
    if "--diagnostics" in sys.argv[1:]:  # the profiler and the diagnostics tools alone
        launches = diagnostics_phase(torch, kernels, classes_path)
        print(json.dumps({"diagnostics_launches": launches}))
        if failures:
            die(f"{len(failures)} check(s) failed: {failures}")
        print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                                 "count": torch.cuda.device_count()}}))
        return
    if "--export" in sys.argv[1:]:  # the export phase alone
        requests = make_requests(preprocess_image)
        launches = export_phase(torch, kernels, classes_path, requests, kaspp, kdec, kmb)
        int8_phase(torch, requests)
        print(json.dumps({"export_launches": launches}))
        if failures:
            die(f"{len(failures)} check(s) failed: {failures}")
        print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                                 "count": torch.cuda.device_count()}}))
        return
    records = {}

    # -- 3. ASPP kernel vs plain ---------------------------------------------
    records.update(aspp_checks(torch, kaspp))

    # -- 4. decoder kernel vs plain ------------------------------------------
    print("fused_decoder_frontend (csrc/decoder.cu) vs plain:")
    for enc, skip in DECODER_CASES:
        for dtype in (f32, bf16):
            args = decoder_case(torch, enc, skip, dtype, seed=2)
            got = kdec.fused_decoder_frontend(*args)
            torch.cuda.synchronize()
            err, ref = max_err(got, kdec.fused_decoder_reference(*args))
            tol = tolerance(ref, dtype)
            tile, smem = kdec.launch_plan(enc[2], skip[2])
            blocks = skip[0] * -(-skip[1] // tile) * -(-enc[3] // 32)
            check(err <= tol, f"decoder {enc}+{skip} {dtype}: max|err| {err:.3g} "
                              f"<= {tol:.3g} (max|ref| {ref:.3g}); "
                              f"{kdec.vector_width(enc[3], skip[3], *args[:3], got)} channel(s) a "
                              f"thread, {blocks} encoder blocks of {tile} rows, {smem} B shared")
            if enc == DECODER_CASES[0][0] and dtype == bf16:  # the serving path's call
                records["decoder"] = {"max_abs_err": err, "case": args}

    # -- 4b. loss-tail kernels vs plain ----------------------------------------
    print("upsample_ce_forward / upsample_ce_backward (csrc/upsample_ce.cu) vs plain:")
    for shape, out_hw in UPSAMPLE_CE_CASES:
        rec = upsample_ce_check(torch, kce, shape, out_hw)
        if shape == UPSAMPLE_CE_CASES[0][0]:  # the training path's call
            records["upsample_ce"] = rec
        if shape == UPSAMPLE_CE_CASES[3][0]:  # mobilenetv3large_lite --fused_loss
            records["upsample_ce_x16"] = rec
        if shape == UPSAMPLE_CE_CASES[4][0]:  # xception --fused_loss
            records["upsample_ce_b8"] = rec
    for shape, out_hw in UPSAMPLE_CE_BACKWARD_CASES:
        upsample_ce_backward_check(torch, kce, shape, out_hw)
    for shape, out_hw in UPSAMPLE_CE_FORWARD_CASES:
        upsample_ce_forward_check(torch, kce, shape, out_hw)

    # -- 4c. confusion and inverted-residual kernels vs plain ---------------------
    print("confusion_matrix_fused (csrc/confusion.cu) vs plain, EQUAL:")
    for i, case in enumerate(CONFUSION_CASES):
        rec = confusion_check(torch, kconf, *case)
        if i == 0:  # the eval path's call
            records["confusion"] = rec
        if case[0] == (EVAL_BATCH, *CITYSCAPES_HW, 19):  # fast_scnn's eval call
            records["confusion_cityscapes"] = rec
    argmax_check(torch, kconf, mask_argmax)
    print("fused_inverted_residual (csrc/mbconv.cu) vs plain:")
    body_shapes = body_block_shapes(EVAL_BATCH, INPUT)
    check(len(body_shapes) == 13, f"the OS16 body has 13 stride-1 expanded blocks: "
                                  f"{[(s[1], s[3], s[4], s[5], s[6]) for s in body_shapes]}")
    records["mbconv"] = mbconv_checks(torch, kmb, body_shapes)
    learn_shapes = body_block_shapes(LEARN_BATCH, (LEARN_HW, LEARN_HW))
    print(f"  ... and at the learning proof's {len(learn_shapes)} body shapes (256 px, b8):")
    mbconv_checks(torch, kmb, learn_shapes, others=())

    # -- 5. the serving path ---------------------------------------------------
    common = dict(model_type="mobilenetv2", classes_path=classes_path,
                  model_input_shape=INPUT, output_stride=16, device="cuda")
    served = DeepLab(**common)                      # bf16, fused ASPP (the default)
    served_dec = DeepLab(fused_decoder=True, **common)
    requests = make_requests(preprocess_image)
    print(f"serving: DeepLab(mobilenetv2, {served.num_classes} classes, {INPUT}, OS16, "
          f"{served.dtype}), {N_REQUESTS} requests of original sizes {REQUEST_SHAPES}")
    for deeplab in (served, served_dec):
        for data, hw in requests[:WARMUP]:
            deeplab.predict(data, hw)
    torch.cuda.synchronize()

    def serve(deeplab):
        return serve_requests(torch, deeplab, requests)

    kernels.reset_launch_counts()                    # the main path starts here
    masks, times = serve(served)
    after_first = kernels.launch_counts()
    masks_dec, times_dec = serve(served_dec)
    launches = kernels.launch_counts()               # ... and ends here
    check(after_first == {**ZERO_LAUNCHES, "multirate_atrous_depthwise": N_REQUESTS},
          f"default DeepLab: launch counts {after_first} (ASPP one a request, every other "
          "kernel none)")
    check(launches == {**ZERO_LAUNCHES, "multirate_atrous_depthwise": 2 * N_REQUESTS,
                       "fused_decoder_frontend": N_REQUESTS},
          f"with fused_decoder=True: launch counts {launches}")
    for m, (_, hw) in zip(masks + masks_dec, requests + requests):
        if m.shape != hw or m.dtype != np.int32 or m.min() < 0 or m.max() >= served.num_classes:
            check(False, f"mask {m.shape} {m.dtype} [{m.min()}, {m.max()}] for a {hw} request")
            break
    else:
        check(True, "every mask has its request's original size and labels in [0, 21)")

    # -- reference: same weights, f32, both kernels off ------------------------
    plain = DeepLab(dtype=f32, fused_aspp=False, fused_decoder=False, **common)
    fused32 = DeepLab(dtype=f32, fused_aspp=True, fused_decoder=True, **common)
    same = all(torch.equal(a, b) for a, b in zip(served.model.state_dict().values(),
                                                 plain.model.state_dict().values()))
    check(same, "all DeepLabs hold the same seeded weights")

    def logits(deeplab, data):
        with torch.inference_mode():
            x = torch.from_numpy(data).cuda().permute(0, 3, 1, 2)
            return deeplab.model(x)

    stats = {"f32_fused": [], "bf16_served": [], "bf16_served_dec": []}
    mask_agree = {k: [] for k in stats}
    for i, (data, hw) in enumerate(requests):
        ref = logits(plain, data)
        ref_max = ref.abs().max().item()
        ref_mask = plain.predict(data, hw)
        for key, deeplab, mask in (("f32_fused", fused32, None),
                                   ("bf16_served", served, masks[i]),
                                   ("bf16_served_dec", served_dec, masks_dec[i])):
            out = logits(deeplab, data)
            if not torch.isfinite(out).all():
                check(False, f"{key}: non-finite logits on request {i}")
            stats[key].append(((out - ref).abs().max().item(), ref_max,
                               (mask_argmax(out, 1) == mask_argmax(ref, 1)).float().mean().item()))
            mask = deeplab.predict(data, hw) if mask is None else mask
            mask_agree[key].append(float((mask == ref_mask).mean()))
    for key, tol_rel, floor in (("f32_fused", 1e-3, 0.999),
                                ("bf16_served", 5e-2, 0.98),
                                ("bf16_served_dec", 5e-2, 0.98)):
        err = max(s[0] for s in stats[key])
        ref_max = max(s[1] for s in stats[key])
        agree = min(mask_agree[key])
        check(err <= tol_rel * ref_max,
              f"{key} vs f32 plain: max|dlogits| {err:.3g} <= {tol_rel:g} * max|logits| "
              f"({ref_max:.3g}); 512x512 argmax agreement min "
              f"{min(s[2] for s in stats[key]):.5f}")
        check(agree >= floor, f"{key} vs f32 plain: mask agreement at the original size, "
                              f"min over requests {agree:.5f} >= {floor}")

    # -- 5b. the training path, through its entry point ---------------------------
    train_launches, train_dir = training_path(torch, kernels, train_main, train_args,
                                              classes_path, requests[0])
    batch = train_batch(torch, train_dir, classes_path)
    fused_vs_unfused(torch, batch)

    # -- 5c. the evaluation path, through its entry point ---------------------------
    eval_launches, eval_state = evaluation_path(torch, kernels, classes_path, train_dir)

    # -- 5d. the train CLI with its own defaults (mobilenetv3large_lite, the
    # stochastic augmentation), then --fused_loss and --device_cache ---------------
    v3_launches, v3_root = default_training_path(torch, kernels, train_main, train_args,
                                                 classes_path)
    v3_batch = v3_train_batch(torch, v3_root)
    augment_card_vs_cpu(torch, v3_batch)

    # -- 5e. mobilenetv3 serving: the ASPP kernel at 160 and 96 channels ---------------
    v3_serve = more_serving(torch, kernels, classes_path, [
        ("mobilenetv3large", requests), ("mobilenetv3small", requests[:V3_REQUESTS_SMALL])])

    # -- 5f. the eval CLI with its own default model ----------------------------------
    default_evaluation_path(torch, kernels, classes_path, train_dir)

    # -- 5g. (a) the learning proof, (b) fused_mbconv on its trained weights ---------
    learn = learning_proof(torch, kernels, train_main, train_args)
    fused_mbconv_on_trained_weights(torch, learn)

    # -- 5h. (c) xception served (the ASPP kernel at 2048 channels, the decoder
    # kernel) and evaluated at b8 ------------------------------------------------------
    x_serve = more_serving(torch, kernels, classes_path, [("xception", requests)])
    x_eval_aspp = model_evaluation_path(torch, kernels, classes_path, train_dir,
                                        "xception")["multirate_atrous_depthwise"]

    # -- 5i. (d) xception trained, --fused_loss and bf16 optimizer state --------------
    x_train_launches = model_training_path(torch, kernels, train_main, train_args, classes_path,
                                           train_dir, "xception", TRAIN_IMAGES,
                                           "--optim_state_dtype", "bfloat16")

    # -- 5j. the rest of the zoo served: resnet50 (the ASPP kernel at 2048 channels),
    # peleenet (704), ghostnet (960), mobilevit_s (640), mobilevit_xs (384), each with
    # the decoder kernel too, and peleenet_lite with no kernel ---------------------------
    zoo_serve = more_serving(torch, kernels, classes_path,
                             [(m, requests[:ZOO_REQUESTS]) for m in ZOO_SERVED])

    # -- 5k. resnet50 and mobilevit_s (the attention's backward) trained b8 with
    # --fused_loss; the lite heads of peleenet and ghostnet evaluated b8 ------------------
    zoo_train = {m: model_training_path(torch, kernels, train_main, train_args, classes_path,
                                        train_dir, m, ZOO_TRAIN_IMAGES)
                 for m in ("resnet50", "mobilevit_s")}
    zoo_eval = {m: model_evaluation_path(torch, kernels, classes_path, train_dir, m)
                for m in ZOO_EVALUATED}

    # -- 5l. (a) UNet x3 served at 512x512 with 21 classes, Fast-SCNN at Cityscapes'
    # 1024x2048 with its 19, no kernel on either path ------------------------------------
    city_classes = os.path.join(REPO, "configs", "cityscapes_classes.txt")
    city_requests = make_requests(preprocess_image, CITYSCAPES_REQUEST_SHAPES, CITYSCAPES_HW)
    print(f"UNet x3 and Fast-SCNN serving (bf16, b1, {FAMILY_REQUESTS} requests a turn):")
    family_serving(torch, kernels, [
        *((m, classes_path, INPUT, requests[:FAMILY_REQUESTS]) for m in UNET_SERVED),
        ("fast_scnn", city_classes, CITYSCAPES_HW, city_requests)])

    # -- 5m. (b) unet_standard (512x512) and fast_scnn (1024x2048, a Cityscapes-sized
    # synthetic set) trained b8 through the train CLI; (c) fast_scnn and unet_simple
    # evaluated b8 through the eval CLI, the confusion kernel at (8,1024,2048,19) ----------
    nearest_resize_on_card(torch)
    city_root = os.path.join(OUT_DIR, "smoke_cityscapes_data")
    t0 = time.perf_counter()
    write_train_dataset(city_root, [CITYSCAPES_HW] * FAMILY_TRAIN_IMAGES, 19, CITYSCAPES_SEED)
    print(f"wrote {FAMILY_TRAIN_IMAGES} pairs of {CITYSCAPES_HW} with 19 classes in "
          f"{time.perf_counter() - t0:.1f} s")
    family_training_path(torch, kernels, train_main, train_args, classes_path, train_dir,
                         "unet_standard", INPUT)
    family_training_path(torch, kernels, train_main, train_args, city_classes, city_root,
                         "fast_scnn", CITYSCAPES_HW)
    family_eval = {"fast_scnn": model_evaluation_path(torch, kernels, city_classes, city_root,
                                                      "fast_scnn", CITYSCAPES_HW,
                                                      FAMILY_TRAIN_IMAGES),
                   "unet_simple": model_evaluation_path(torch, kernels, classes_path, train_dir,
                                                        "unet_simple")}

    # -- 5n. (d) the subpixel head: mobilenetv2's forward with its two kernels -------------
    subpixel_launches = subpixel_head(torch, kernels, requests[:FAMILY_REQUESTS])

    # -- 5o. the dense CRF: the card against the CPU, the oracle on the card, serving
    # with do_crf (mobilenetv2, fast_scnn at 1024x2048), eval --do_crf, its times -------
    t0 = time.perf_counter()
    crf_card_vs_cpu(torch, postprocess)
    crf_oracle_on_card(torch, postprocess)
    crf_serve_launches = crf_serving(torch, kernels, DeepLab, postprocess, common, served,
                                     requests, (city_classes, city_requests))
    crf_eval_launches = crf_evaluation_path(torch, kernels, classes_path, train_dir)
    crf_times(torch, postprocess)
    print(f"the CRF phase took {time.perf_counter() - t0:.1f} s")

    # -- 5p. export: .pt2 programs keeping the kernels as graph nodes, the embedded
    # runner, the operators' host cost; int8 on mobilenetv2_lite and on the learning
    # proof's trained weights ------------------------------------------------------------
    t0 = time.perf_counter()
    export_launches = export_phase(torch, kernels, classes_path, requests, kaspp, kdec, kmb)
    int8_phase(torch, requests, learn)
    print(f"the export phase took {time.perf_counter() - t0:.1f} s")

    # -- 5q. ONNX: the export tool on the card, the executor against the eager
    # model, the eval CLI and validate_deeplab on .onnx, unet_standard ----------------
    t0 = time.perf_counter()
    onnx_launches = onnx_phase(torch, kernels, classes_path, requests, learn)
    print(f"the ONNX phase took {time.perf_counter() - t0:.1f} s")

    # -- 5q'. the frozen TF graph: the export tool on the card, the port's executor
    # against the eager model and the .onnx executor, eval and validate_deeplab on .pb
    tf_launches = tf_phase(torch, kernels, classes_path, requests, learn)
    # -- 5q''. .tflite (fp32, float16) and the SavedModel: the tool on the card,
    # the .tflite executor against the eager model and the .pb's, eval and
    # validate_deeplab on .tflite
    tflite_launches = tflite_phase(torch, kernels, classes_path, requests, learn)

    # -- 5r. data parallelism: one process, two gloo ranks on the card, a
    # one-rank NCCL group, the same weights and global batches ---------------------
    parallel_launches = parallel_phase(torch)
    spatial_launches = spatial_phase(torch, kaspp, kdec, kmb, kconf)
    tools_launches = tools_phase(torch, kernels, train_main, train_args)
    diagnostics_launches = diagnostics_phase(torch, kernels, classes_path)

    # -- 6. latency and kernel times ---------------------------------------------
    def pct(v, q):
        return float(np.percentile(v, q))

    print(f"latency of the counted run, {N_REQUESTS} requests each (host clock around "
          "predict, synchronized):")
    for name, ts in (("served (bf16, fused ASPP)", times), ("served + fused decoder", times_dec)):
        print(f"  {name}: median {statistics.median(ts):.3f} ms, p90 {pct(ts, 90):.3f} ms")
    served_plain = DeepLab(fused_aspp=False, **common)
    for data, hw in requests[:WARMUP]:
        served_plain.predict(data, hw)
    configs = {"bf16, no kernels": served_plain, "served (bf16, fused ASPP)": served,
               "served + fused decoder": served_dec}
    pooled = {name: [] for name in configs}
    for name in [*configs, *reversed(configs)]:  # in turns: P S D D S P
        pooled[name] += serve(configs[name])[1]
    print(f"latency A/B in turns (P S D D S P, {N_REQUESTS} requests a turn):")
    for name, ts in pooled.items():
        print(f"  {name}: median {statistics.median(ts):.3f} ms, p90 {pct(ts, 90):.3f} ms "
              f"over {len(ts)} requests")

    profile_one_request(torch, served, requests[0])

    train_step_numbers(torch, batch)
    eval_numbers(torch, eval_state)
    default_train_numbers(torch, v3_batch)
    xception_train_numbers(torch, train_dir, classes_path)
    model_train_numbers(torch, train_dir, classes_path, "resnet50", MODEL_TRAIN_BATCH,
                        (("U unfused", False, None), ("F --fused_loss", True, None)),
                        profile="profile_one_train_step_resnet50.txt")
    model_train_numbers(torch, train_dir, classes_path, "mobilevit_s", MODEL_TRAIN_BATCH,
                        (("F --fused_loss", True, None),),
                        profile="profile_one_train_step_mobilevit_s.txt")
    unet_step = model_train_numbers(torch, train_dir, classes_path, "unet_standard",
                                    MODEL_TRAIN_BATCH, (("U unfused", False, None),),
                                    l2_factor=0.0,
                                    profile="profile_one_train_step_unet_standard.txt")
    train_flops = 3 * conv_flops(torch, "unet_standard", 21, INPUT, MODEL_TRAIN_BATCH)
    step_bound_ms = train_flops / BF16_TENSOR_FLOPS * 1e3
    med = unet_step["U unfused"][0]
    print(f"unet_standard b{MODEL_TRAIN_BATCH} step: convolutions {train_flops / 1e12:.3f} TFLOP "
          f"(3x the forward's), bound {step_bound_ms:.3f} ms at the dense bf16 rate; median step "
          f"{med:.3f} ms, {step_bound_ms / med:.3f} of the bound  [{card}]")
    city_batch = train_batch(torch, city_root, city_classes, MODEL_TRAIN_BATCH, CITYSCAPES_HW, 19)
    model_train_numbers(torch, city_root, city_classes, "fast_scnn", MODEL_TRAIN_BATCH,
                        (("U unfused", False, None),), input_hw=CITYSCAPES_HW, num_classes=19,
                        batch=city_batch, profile="profile_one_train_step_fast_scnn.txt")
    del city_batch

    kernels = [aspp_times(torch, kaspp, records, launches["multirate_atrous_depthwise"])]
    # the decoder: both inputs read once, the concat's depthwise output written
    # once; each upsampled element interpolated once (3 lerps) and 9 multiply-adds
    # + the BN fold an output
    args = records["decoder"]["case"]
    x, skip = args[0], args[1]
    pixels = skip.shape[0] * skip.shape[1] * skip.shape[2]
    outs = pixels * (x.shape[-1] + skip.shape[-1])
    bound_ms, bound_by = bound(nbytes(*args) + outs * x.element_size(),
                               pixels * x.shape[-1] * 6 + outs * (9 * 2 + 2))
    fn, ref_fn = kdec.fused_decoder_frontend, kdec.fused_decoder_reference
    ms, plain_ms = ab_ms(lambda: fn(*args), lambda: ref_fn(*args))
    dev_us, dev_launches = device_us(torch, lambda: fn(*args))
    plain_dev_us, plain_launches = device_us(torch, lambda: ref_fn(*args))
    print(f"fused_decoder_frontend: kernel {ms * 1e3:.2f} us, plain {plain_ms * 1e3:.2f} us a "
          f"call (CUDA events, mean of 2x200 calls each, serving-path shapes); device time a "
          f"call (profiler): kernel {us_text(dev_us)} in {dev_launches} launch(es), plain "
          f"{us_text(plain_dev_us)} in {plain_launches}")
    kernels.append({"name": "fused_decoder_frontend", "route": "cuda",
                    "source": "deeplabv3p_torch/ops/kernels/csrc/decoder.cu",
                    "replaces": "deeplabv3p_tpu/ops/pallas/decoder.py:81",
                    "launches": launches["fused_decoder_frontend"],
                    "max_abs_err": records["decoder"]["max_abs_err"],
                    "ms": ms, "plain_ms": plain_ms, "bound_ms": bound_ms,
                    "bound_by": bound_by, "library_ms": None, "device_us": dev_us,
                    # the same serving shapes on every full head's run
                    "also_on": {f"{m} serving": served_more[m]["fused_decoder_frontend"]
                                for served_more in (v3_serve, x_serve, zoo_serve)
                                for m in served_more if served_more[m]["fused_decoder_frontend"]}})
    kernels += upsample_ce_times(torch, kce, records["upsample_ce"], train_launches)
    kernels.append(confusion_times(torch, kconf, records["confusion"], eval_launches[0]))
    evaluated = {**zoo_eval, "unet_simple": family_eval["unet_simple"]}
    kernels[-1]["also_on"] = {f"{m} eval b{EVAL_BATCH}": launches_of["confusion_matrix_fused"]
                              for m, launches_of in evaluated.items()}
    city_row = confusion_times(torch, kconf, records.pop("confusion_cityscapes"),
                               family_eval["fast_scnn"])
    city_row["path"] = f"fast_scnn eval b{EVAL_BATCH} {CITYSCAPES_HW[0]}x{CITYSCAPES_HW[1]}"
    kernels[-1]["at_other_shapes"] = [city_row]
    kernels.append(mbconv_times(torch, kmb, records["mbconv"], eval_launches[1], eval_state))
    # this slice's new shapes, each held and timed on its own path's run
    aspp_rows = [
        aspp_shape_row(torch, kaspp, records[key], served_more[model]["multirate_atrous_depthwise"],
                       f"{model} serving")
        for key, model, served_more in (("aspp_c160", "mobilenetv3large", v3_serve),
                                        ("aspp_c96", "mobilenetv3small", v3_serve),
                                        ("aspp_c2048", "xception", x_serve))]
    aspp_rows[-1]["f32_b1"] = aspp_timing(torch, kaspp, records["aspp_c2048_f32"]["case"], 200)
    # resnet50's serving calls are xception's shape: counted, not timed again
    aspp_rows[-1]["also_on"] = {"resnet50 serving":
                                zoo_serve["resnet50"]["multirate_atrous_depthwise"]}
    aspp_rows.append(aspp_shape_row(torch, kaspp, records["aspp_c2048_b8"], x_eval_aspp,
                                    "xception eval b8"))
    aspp_rows += [aspp_shape_row(torch, kaspp, records[key],
                                 zoo_serve[model]["multirate_atrous_depthwise"], f"{model} serving")
                  for key, model in ZOO_ASPP_ROWS]
    kernels[0]["at_other_shapes"] = aspp_rows
    # the subpixel head's forward calls both at the serving shapes, in f32
    for row in kernels[:2]:
        row.setdefault("also_on", {})["mobilenetv2 subpixel head, f32"] = \
            subpixel_launches[row["name"]]
    # the CRF paths: mobilenetv2 served with do_crf=True, and eval --do_crf
    kernels[0]["also_on"]["mobilenetv2 serving, do_crf"] = \
        crf_serve_launches["multirate_atrous_depthwise"]
    for row in kernels:
        if row["name"] in ("multirate_atrous_depthwise", "confusion_matrix_fused"):
            row["also_on"][f"mobilenetv2 eval --do_crf b{EVAL_BATCH}"] = \
                crf_eval_launches[row["name"]]
    for path, counts in {**export_launches, **onnx_launches, **tf_launches,
                         **tflite_launches, **parallel_launches, **spatial_launches,
                         **tools_launches, **diagnostics_launches}.items():  # .pt2, ONNX,
        # .pb, .tflite, data-parallel, spatial, the tools' flow, the traced requests
        for row in kernels:
            if counts[row["name"]]:
                row.setdefault("also_on", {})[path] = counts[row["name"]]
    for key, launches_of, path in (("upsample_ce_x16", v3_launches,
                                    "mobilenetv3large_lite --fused_loss"),
                                   ("upsample_ce_b8", x_train_launches, "xception --fused_loss")):
        for row in upsample_ce_times(torch, kce, records[key], launches_of):
            row["path"] = path
            if key == "upsample_ce_b8":  # the same shape on the zoo's b8 training runs
                row["also_on"] = {f"{m} --fused_loss": zoo_train[m][row["name"]]
                                  for m in zoo_train}
            next(r for r in kernels if r["name"] == row["name"]).setdefault(
                "at_other_shapes", []).append(row)
    for row in kernels:
        for r in [row, *row.get("at_other_shapes", [])]:
            print(f"  {r['name']}{' (' + r['path'] + ')' if 'path' in r else ''}: "
                  f"{r['ms'] * 1e3:.2f} us, bound {r['bound_ms'] * 1e3:.2f} us "
                  f"by {r['bound_by']} ({r['bound_ms'] / r['ms']:.3f} of it), plain "
                  f"{r['plain_ms'] * 1e3:.2f} us, library "
                  f"{'none' if r['library_ms'] is None else format(r['library_ms'] * 1e3, '.2f') + ' us'}"
                  f", {r['launches']} launches on its path"
                  f"{', and ' + str(r['also_on']) if 'also_on' in r else ''}  [{card}]")

    leaked = [m for m in ("jax", "flax", "deeplabv3p_tpu") if m in sys.modules]
    check(not leaked, f"no JAX module imported ({leaked or 'none'})")
    print(json.dumps({"kernels": kernels}))
    if failures:
        die(f"{len(failures)} check(s) failed: {failures}")
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                             "count": torch.cuda.device_count()}}))


def device_us(torch, fn, calls: int = 50) -> tuple[float | None, float]:
    """(device time in us, device launches) a call of fn(), from the
    profiler's CUDA kernel events: what the card spends, without the host's
    dispatch time that CUDA events around short calls also take in. Some
    runs' traces miss kernels: a launch count below the call's whole
    number of kernels shows it, and the time is then short by as much. A
    trace with no device time at all is taken once more; if that one is
    empty too the time is None: not measured (the CUDA-event time stands)."""
    from torch.profiler import ProfilerActivity, profile

    for _ in range(5):
        fn()
    torch.cuda.synchronize()
    for _ in range(2):
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            for _ in range(calls):
                fn()
            torch.cuda.synchronize()
        events = [e for e in prof.key_averages() if e.device_type.name == "CUDA"]
        total = sum(e.self_device_time_total for e in events)
        if total > 0:
            return total / calls, sum(e.count for e in events) / calls
    return None, 0.0


def us_text(us: float | None, digits: int = 2) -> str:
    """A device time for print: 'not measured' where the trace gave none."""
    return "not measured" if us is None else f"{us:.{digits}f} us"


def profile_one_request(torch, deeplab, request) -> None:
    """Device time by kernel for one request (torch.profiler). The full
    table goes to build/profile_one_request.txt."""
    data, hw = request
    profile_one(torch, lambda: deeplab.predict(data, hw), "one served request",
                "profile_one_request.txt")


def profile_one(torch, fn, what: str, filename: str, top: int = 12):
    """Profile one fn() (after an unprofiled and a profiled warm-up window,
    since the first window pays the tracer's start-up; PROFILE_CALLS calls
    of fn in all): device operations,
    device busy time against the wall, idle share, the top rows by device
    time; the full table goes to build/<filename>. Returns (the profiler's
    key averages, busy us, wall us), or None when it recorded no device
    time."""
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU, ProfilerActivity.CUDA]
    for _ in range(2):
        fn()
        torch.cuda.synchronize()
        with profile(activities=activities) as prof:
            t = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            wall_us = (time.perf_counter() - t) * 1e6
    events = prof.key_averages()
    rows = sorted(((e.device_time_total, e.count, e.key) for e in events
                   if e.device_time_total > 0 and e.device_type.name == "CUDA"), reverse=True)
    if not rows:
        print(f"profile of {what}: torch.profiler recorded no device time")
        return None
    busy_us = sum(r[0] for r in rows)
    print(f"profile of {what}: {sum(r[1] for r in rows)} device operations "
          f"(kernels and copies), device busy {busy_us:.1f} us of {wall_us:.1f} us wall "
          f"under the profiler (idle share {1 - busy_us / wall_us:.3f}); top by device time:")
    for total, count, key in rows[:top]:
        print(f"  {total:9.1f} us  {count:4d}x  {key[:90]}")
    os.makedirs(OUT_DIR, exist_ok=True)
    with open(os.path.join(OUT_DIR, filename), "w") as f:
        f.write(events.table(sort_by="device_time_total", row_limit=80))
    return events, busy_us, wall_us


# -- the loss tail and the training path -------------------------------------


def upsample_ce_case(torch, shape, out_hw, seed=0):
    """Seeded logits, labels with an ignore band and labels >= C, sample and
    class weights, on the card."""
    gen = torch.Generator().manual_seed(seed)
    b, _, _, c = shape
    logits = (2.0 * torch.randn(shape, generator=gen)).cuda()
    labels = torch.randint(0, c, (b, *out_hw), generator=gen, dtype=torch.int32)
    labels[:, : out_hw[0] // 8] = 255
    labels[0, -3:, : out_hw[1] // 2] = c
    labels[-1, -2:, out_hw[1] // 2:] = c + 7
    sw = (0.2 + 1.8 * torch.rand((b, *out_hw), generator=gen)).cuda()
    cw = (0.5 + 1.5 * torch.rand((c,), generator=gen)).cuda()
    return logits, labels.cuda(), sw, cw


def upsample_ce_check(torch, kce, shape, out_hw) -> dict:
    """Both loss-tail kernels, through the autograd Function, against the
    plain forward and backward: loss within 1e-5 relative, preds equal where
    the top-2 gap exceeds 1e-5, gradient within 1e-5 max|ref| + 1e-7."""
    logits, labels, sw, cw = upsample_ce_case(torch, shape, out_hw)
    z = logits.clone().requires_grad_(True)
    loss, preds = kce.fused_upsample_ce(z, labels, out_hw, sample_weights=sw, class_weights=cw)
    (loss * 0.37).backward()
    torch.cuda.synchronize()
    ref_loss, ref_preds = kce.upsample_ce_reference(logits, labels, out_hw, sw, cw)
    loss_err = abs(loss.item() - ref_loss.item())
    check(loss_err <= 1e-5 * abs(ref_loss.item()),
          f"upsample_ce {shape}->{out_hw} forward: loss {loss.item():.7g} vs plain "
          f"{ref_loss.item():.7g}, |err| {loss_err:.3g} <= 1e-5 relative")
    full = torch.nn.functional.interpolate(logits.permute(0, 3, 1, 2), size=out_hw,
                                           mode="bilinear", align_corners=False)
    top2 = full.topk(2, dim=1).values
    clear = (top2[:, 0] - top2[:, 1]) > 1e-5
    same = torch.equal(preds[clear], ref_preds[clear])
    check(same, f"upsample_ce {shape}->{out_hw} forward: preds equal where the top-2 gap "
                f"> 1e-5 ({clear.float().mean().item():.6f} of pixels; all pixels equal: "
                f"{torch.equal(preds, ref_preds)})")
    wpx = kce.pixel_weights(labels, shape[-1], sw, cw)
    ref_grad = kce.upsample_ce_backward_reference(logits, labels, wpx, out_hw) * 0.37
    grad_err = (z.grad - ref_grad).abs().max().item()
    ref_max = ref_grad.abs().max().item()
    check(grad_err <= 1e-5 * ref_max + 1e-7,
          f"upsample_ce {shape}->{out_hw} backward: max|err| {grad_err:.3g} <= "
          f"1e-5 * {ref_max:.3g} + 1e-7")
    upsample_ce_forward_check(torch, kce, shape, out_hw, (logits, labels, wpx))
    lse = upsample_ce_backward_check(torch, kce, shape, out_hw, (logits, labels, wpx))
    return {"fwd_err": loss_err, "bwd_err": grad_err,
            "case": (logits, labels, wpx, tuple(out_hw), lse)}


def upsample_ce_forward_check(torch, kce, shape, out_hw, case=None) -> float:
    """The forward kernel by itself against the plain version: loss within
    1e-5 relative, preds equal where the top-2 gap exceeds 1e-5, lse within
    1e-5 max|plain| + 1e-6 of torch.logsumexp of the plain upsample (the
    kernel's exp2 and log2 are the approximate instructions, ~2 ulp), and two
    calls in a row bit-equal in loss, preds and lse (one partial sum a block,
    summed in a fixed order, no atomics). Returns the loss's error."""
    if case is None:
        logits, labels, sw, cw = upsample_ce_case(torch, shape, out_hw)
        case = (logits, labels, kce.pixel_weights(labels, shape[-1], sw, cw))
    logits, labels, wpx = case
    first = kce.upsample_ce_forward(logits, labels, wpx, out_hw)
    second = kce.upsample_ce_forward(logits, labels, wpx, out_hw)
    torch.cuda.synchronize()
    loss, preds, lse = first
    same_bits = all(torch.equal(a, b) for a, b in zip(first, second))
    ref_loss, ref_preds = kce.upsample_ce_reference(logits, labels, out_hw, sample_weights=wpx)
    loss_err = abs(loss.item() - ref_loss.item())
    full = kce._upsample(logits, out_hw)
    top2 = full.topk(2, dim=-1).values
    clear = (top2[..., 0] - top2[..., 1]) > 1e-5
    ref_lse = torch.logsumexp(full, dim=-1)
    lse_err, lse_max = (lse - ref_lse).abs().max().item(), ref_lse.abs().max().item()
    smem, blocks = kce.forward_plan(*shape, *out_hw)
    check(loss_err <= 1e-5 * abs(ref_loss.item()) and same_bits
          and torch.equal(preds[clear], ref_preds[clear]) and lse_err <= 1e-5 * lse_max + 1e-6,
          f"upsample_ce_forward {shape}->{tuple(out_hw)} alone: loss |err| {loss_err:.3g} <= 1e-5 "
          f"* {abs(ref_loss.item()):.6g}; preds equal where the top-2 gap > 1e-5 "
          f"({clear.float().mean().item():.6f} of pixels); lse max|err| {lse_err:.3g} <= 1e-5 * "
          f"{lse_max:.3g} + 1e-6; two calls bit-equal: {same_bits}; {blocks} blocks of {smem} B "
          "shared")
    return loss_err


def upsample_ce_backward_check(torch, kce, shape, out_hw, case=None):
    """The backward kernel by itself, from the forward kernel's lse: within
    1e-5 max|plain| + 1e-7 of the plain version (its sums run in another
    order, and its softmax is exp2 of log2(e)-scaled logits), and two calls
    in a row bit-equal (one owner thread a cell, a fixed order of summation,
    no atomics). Returns lse."""
    if case is None:
        logits, labels, sw, cw = upsample_ce_case(torch, shape, out_hw)
        case = (logits, labels, kce.pixel_weights(labels, shape[-1], sw, cw))
    logits, labels, wpx = case
    lse = kce.upsample_ce_forward(logits, labels, wpx, out_hw)[2]
    first = kce.upsample_ce_backward(logits, labels, wpx, lse, out_hw)
    second = kce.upsample_ce_backward(logits, labels, wpx, lse, out_hw)
    torch.cuda.synchronize()
    ref = kce.upsample_ce_backward_reference(logits, labels, wpx, out_hw)
    err, ref_max = (first - ref).abs().max().item(), ref.abs().max().item()
    check(err <= 1e-5 * ref_max + 1e-7 and torch.equal(first, second),
          f"upsample_ce_backward {shape}->{tuple(out_hw)} alone: max|err| {err:.3g} <= "
          f"1e-5 * {ref_max:.3g} + 1e-7; two calls bit-equal: {torch.equal(first, second)}")
    return lse


def write_train_dataset(root: str, sizes, num_classes: int, seed: int) -> str:
    """Seeded pairs <root>/images/<id>.jpg + labels/<id>.png, one a (h, w) of
    `sizes`: smooth random images, labels of 64-px class cells with 4-px 255
    bands on their borders; returns the list file."""
    from PIL import Image

    rng = np.random.default_rng(seed)
    os.makedirs(os.path.join(root, "images"), exist_ok=True)
    os.makedirs(os.path.join(root, "labels"), exist_ok=True)
    names = []
    for i, (h, w) in enumerate(sizes):
        band = (np.arange(h)[:, None] % 64 < 4) | (np.arange(w)[None, :] % 64 < 4)
        coarse = rng.integers(0, 256, (h // 32 + 1, w // 32 + 1, 3), dtype=np.uint8)
        Image.fromarray(coarse).resize((w, h), Image.BILINEAR).save(
            os.path.join(root, "images", f"s{i:03d}.jpg"), quality=90)
        cells = rng.integers(0, num_classes, (h // 64 + 1, w // 64 + 1), dtype=np.uint8)
        label = np.kron(cells, np.ones((64, 64), np.uint8))[:h, :w]
        label[band] = 255
        Image.fromarray(label).save(os.path.join(root, "labels", f"s{i:03d}.png"))
        names.append(f"s{i:03d}")
    list_path = os.path.join(root, "list.txt")
    with open(list_path, "w") as f:
        f.write("\n".join(names) + "\n")
    return list_path


def training_path(torch, kernels, train_main, train_args, classes_path, request):
    """`deeplabv3p_torch.train.main` in-process: two stages of 2 steps on the
    synthetic dataset. Returns the run's launch counts and the dataset dir."""
    import shutil

    from deeplabv3p_torch.inference import DeepLab
    from deeplabv3p_torch.models.factory import build_deeplab_model
    from deeplabv3p_torch.models.layers import init_parameters
    from deeplabv3p_torch.utils.weights import from_jax_variables, load_npz

    root = os.path.join(OUT_DIR, "smoke_train_data")
    log_dir = os.path.join(OUT_DIR, "smoke_train_logs")
    shutil.rmtree(log_dir, ignore_errors=True)
    t0 = time.perf_counter()
    list_path = write_train_dataset(root, [INPUT] * TRAIN_IMAGES, 21, TRAIN_SEED)
    print(f"training path: wrote {TRAIN_IMAGES} pairs of {INPUT} in "
          f"{time.perf_counter() - t0:.1f} s; python -m deeplabv3p_torch.train ...")
    argv = ["--model_type", "mobilenetv2", "--model_input_shape", "512x512",
            "--output_stride", "16", "--batch_size", str(TRAIN_BATCH), "--fused_loss",
            "--no_augment", "--transfer_epoch", "1", "--total_epoch", "2",
            "--freeze_level", "1", "--optimizer", "sgd", "--decay_type", "cosine",
            "--dataset_path", root, "--dataset_file", list_path,
            "--classes_path", classes_path, "--log_dir", log_dir,
            "--seed", str(TRAIN_SEED), "--device", "cuda"]
    print("  " + " ".join(argv))
    trainer, wall, launches, _ = run_cli(torch, kernels, train_main, train_args(argv),
                                         quiet=False)
    steps = 2 * (TRAIN_IMAGES // TRAIN_BATCH)
    print(f"  trained {steps} steps in {wall:.1f} s wall (set-up and first-call cuDNN "
          f"tuning included); launch counts {launches}")
    check(launches == {**ZERO_LAUNCHES, "upsample_ce_forward": steps,
                       "upsample_ce_backward": steps},
          f"training: each loss kernel launched once a step ({steps}), every other "
          "kernel never")
    with open(os.path.join(log_dir, "history.jsonl")) as f:
        records = [json.loads(line) for line in f]
    check(len(records) == 2 and all(np.isfinite(r["loss"]) and r["steps"] == 2
                                    for r in records),
          f"history.jsonl: 2 records, 2 steps each, finite losses "
          f"{[round(r['loss'], 5) for r in records]}")
    check(trainer.history == records, "the trainer's history is what history.jsonl holds")

    init = build_deeplab_model("mobilenetv2", 21, device="cpu")
    init_parameters(init, torch.Generator().manual_seed(TRAIN_SEED), bn_identity=True)
    start = {k: v.clone() for k, v in init.state_dict().items()}
    model = build_deeplab_model("mobilenetv2", 21, device="cpu")

    def load(name):
        model.load_state_dict(from_jax_variables(load_npz(os.path.join(log_dir, name)), model))
        return {k: v.clone() for k, v in model.state_dict().items()}

    stage1 = load(next(p for p in sorted(os.listdir(log_dir)) if p.startswith("ep000-")))
    final = load("trained_final.npz")
    backbone = [k for k in start if k.startswith("backbone.")]
    bn_bufs = [k for k in backbone if "running_" in k]
    check(all(torch.equal(stage1[k], start[k]) for k in backbone),
          f"stage 1 (freeze level 1): the {len(backbone)} backbone tensors, its "
          f"{len(bn_bufs)} BN buffers included, are as initialised")
    head = [k for k in start if not k.startswith("backbone.")]
    # Three head BN scales reach a training-mode BN through per-channel ops only,
    # which normalises their scale away but for its epsilon: from this init their
    # gradients are 1e-6 to 1e-5 of the head's largest (tests/test_torch_train.py),
    # so two steps move them by a few ulps or not at all. Every other head weight
    # must move; theirs is printed.
    invariant = ("aspp.concat_projection_BN.weight", "decoder.feature_projection0_BN.weight",
                 "decoder.decoder_conv0.pointwise_BN.weight")
    unmoved = [k for k in head if k.endswith(".weight") and k not in invariant
               and torch.equal(stage1[k], start[k])]
    ulps = {k.split(".")[-2]: int(((stage1[k] - start[k]).abs()
                                   / (torch.finfo(torch.float32).eps * start[k].abs())).max())
            for k in invariant}
    check(not unmoved, f"stage 1 moved every head weight but the 3 nearly scale-invariant BN "
                       f"scales (unmoved: {unmoved or 'none'}; those 3 moved by at most "
                       f"{ulps} ulps)")
    convs = [k for k in backbone if k.endswith(".weight") and "_BN." not in k]
    moved = [k for k in convs + bn_bufs if not torch.equal(final[k], start[k])]
    check(len(moved) == len(convs + bn_bufs),
          f"stage 2 (freeze level 0) moved every backbone conv weight and BN buffer "
          f"({len(moved)}/{len(convs + bn_bufs)})")
    data, hw = request
    served = DeepLab(model_type="mobilenetv2", classes_path=classes_path,
                     model_input_shape=INPUT, output_stride=16, device="cuda",
                     weights_path=os.path.join(log_dir, "trained_final.npz"))
    mask = served.predict(data, hw)
    check(mask.shape == hw and mask.min() >= 0 and mask.max() < 21,
          f"trained_final.npz serves a request through DeepLab: mask {mask.shape} for {hw}")
    return launches, root


def default_training_path(torch, kernels, train_main, train_args, classes_path):
    """`python -m deeplabv3p_torch.train` with its own defaults (no
    --model_type, no --no_augment, no --fused_loss: mobilenetv3large_lite,
    512x512, OS16, b16, bf16, the stochastic augmentation), 2+2 steps on a
    seeded set whose every other pair is 720x1280; then the same with
    --fused_loss and with --device_cache. Returns the --fused_loss run's
    launch counts and the dataset dir."""
    import shutil

    from deeplabv3p_torch.data import augment
    from deeplabv3p_torch.inference import DeepLab

    root = os.path.join(OUT_DIR, "smoke_v3_train_data")
    sizes = [V3_LARGE_HW if i % 2 == 0 else INPUT for i in range(TRAIN_IMAGES)]
    t0 = time.perf_counter()
    list_path = write_train_dataset(root, sizes, 21, V3_SEED)
    print(f"training with the CLI's defaults: wrote {TRAIN_IMAGES} pairs, half {V3_LARGE_HW} "
          f"and half {INPUT}, in {time.perf_counter() - t0:.1f} s")
    seen = []
    real = augment.apply_augment

    def spy(params, images, labels, orig_hw, cfg=augment.AugmentConfig()):
        larger = (orig_hw[:, 0] > images.shape[1]) & (orig_hw[:, 1] > images.shape[2])
        seen.append((int(larger.sum()), int((params.crop & larger).sum())))
        return real(params, images, labels, orig_hw, cfg)

    augment.apply_augment = spy
    steps = 2 * (TRAIN_IMAGES // TRAIN_BATCH)
    fused_launches = None
    try:
        for extra in ((), ("--fused_loss",), ("--device_cache",)):
            log_dir = os.path.join(OUT_DIR, "smoke_v3_logs" + "".join(extra).replace("-", "_"))
            shutil.rmtree(log_dir, ignore_errors=True)
            argv = ["--dataset_path", root, "--dataset_file", list_path, "--classes_path",
                    classes_path, "--transfer_epoch", "1", "--total_epoch", "2",
                    "--log_dir", log_dir, *extra]
            args = train_args(argv)
            what = " ".join(extra) or "(defaults)"
            check((args.model_type, args.augment, args.batch_size, args.model_input_shape,
                   args.device) == ("mobilenetv3large_lite", True, 16, "512x512", "cuda"),
                  f"train CLI {what}: mobilenetv3large_lite, --augment, b16, 512x512, cuda "
                  "by default")
            print("  python -m deeplabv3p_torch.train " + " ".join(argv))
            seen.clear()
            trainer, wall, launches, _ = run_cli(torch, kernels, train_main, args, quiet=False)
            larger, cropped = sum(a for a, _ in seen), sum(b for _, b in seen)
            print(f"  {what}: {steps} steps in {wall:.1f} s wall (set-up, caching and first-call "
                  f"cuDNN tuning included); {len(seen)} augmented batches, {larger} samples "
                  f"larger than the input, the crop fired on {cropped}; launch counts {launches}")
            want = dict(ZERO_LAUNCHES)
            if "--fused_loss" in extra:
                want.update(upsample_ce_forward=steps, upsample_ce_backward=steps)
                fused_launches = launches
            check(launches == want, f"train CLI {what}: launch counts as the path runs them "
                                    f"(the loss kernels {want['upsample_ce_forward']} times "
                                    "each, every other kernel never)")
            check(len(seen) == steps, f"train CLI {what}: every batch augmented ({len(seen)})")
            if "--device_cache" in extra:
                check(larger == 0, "train CLI --device_cache: orig_hw is the input shape, "
                                   "the crop cannot fire")
            else:
                check(larger > 0, f"train CLI {what}: {larger} samples larger than the input "
                                  "reach the augmentation, the crop can fire")
            with open(os.path.join(log_dir, "history.jsonl")) as f:
                hist = [json.loads(line) for line in f]
            check(len(hist) == 2 and all(np.isfinite(r["loss"]) and r["steps"] == 2
                                         for r in hist) and trainer.history == hist,
                  f"train CLI {what}: history.jsonl has 2 records of 2 steps, finite losses "
                  f"{[round(r['loss'], 5) for r in hist]}")
    finally:
        augment.apply_augment = real
    served = DeepLab(model_type="mobilenetv3large_lite", classes_path=classes_path,
                     model_input_shape=INPUT, device="cuda",
                     weights_path=os.path.join(log_dir, "trained_final.npz"))
    data = np.random.default_rng(1).uniform(-1, 1, (1, *INPUT, 3)).astype(np.float32)
    mask = served.predict(data, (375, 500))
    check(mask.shape == (375, 500) and mask.min() >= 0 and mask.max() < 21,
          f"the last run's trained_final.npz loads strictly and serves: mask {mask.shape}")
    return fused_launches, root


def v3_train_batch(torch, root):
    """The first TRAIN_BATCH pairs of the CLI-defaults set as the loader
    gives them, on the card: (images u8, labels u8, orig_hw f32)."""
    from deeplabv3p_torch.data.pipeline import SegmentationDataset

    ids = [f"s{i:03d}" for i in range(TRAIN_BATCH)]
    ds = SegmentationDataset(root, ids, batch_size=TRAIN_BATCH, num_classes=21,
                             input_shape=INPUT, augment=False, shuffle=False)
    return tuple(torch.from_numpy(a).cuda() for a in next(iter(ds.epoch_batches())))


def augment_card_vs_cpu(torch, batch) -> None:
    """The chain on the card against its CPU run on one b16 batch, the
    parameters drawn once on the CPU with every gate at 0.5 (each op fires
    on some samples): labels EQUAL, images within 1e-3 on the 0..255 scale,
    then the weight maps equal."""
    from deeplabv3p_torch.data import augment

    images, labels, orig_hw = batch
    b, h, w = labels.shape
    cfg = augment.AugmentConfig(flip_prob=0.5, vflip_prob=0.5, zoom_rotate_prob=0.5,
                                gridmask_prob=0.5, grayscale_prob=0.5, blur_prob=0.5,
                                crop_prob=0.5)
    params = augment.draw_augment_params(torch.Generator().manual_seed(3), b, h, w, cfg)
    larger = (orig_hw[:, 0] > h) & (orig_hw[:, 1] > w)
    gates = {g: int(getattr(params, g).sum()) for g in (
        "hflip", "vflip", "zoom_rotate", "gridmask", "grayscale", "blur")}
    gates["crop"] = int((params.crop & larger.cpu()).sum())
    cpu_i, cpu_l = augment.apply_augment(params, images.cpu(), labels.cpu(), orig_hw.cpu(), cfg)
    card_i, card_l = augment.apply_augment(params.to("cuda"), images, labels, orig_hw, cfg)
    torch.cuda.synchronize()
    err = (card_i.cpu() - cpu_i).abs().max().item()
    diff = int((card_l.cpu() != cpu_l).sum())
    check(all(v > 0 for v in gates.values()),
          f"augmentation check: every gated op fires on some of the {b} samples {gates}")
    check(diff == 0 and err <= 1e-3,
          f"augmentation, card vs CPU on the same parameters ({b}x{h}x{w}): labels equal "
          f"({diff} differ), images max|err| {err:.3g} <= 1e-3 (0..255)")
    same_w = torch.equal(augment.adaptive_class_weights(card_l).cpu(),
                         augment.adaptive_class_weights(cpu_l))
    check(same_w, "augmentation, card vs CPU: the adaptive weight maps are equal")


def more_serving(torch, kernels, classes_path, runs) -> dict:
    """Each (model type, requests) of `runs` served (bf16, b1) with the ASPP
    and decoder kernels: launch counts (a full head once a request each, a
    lite head none), masks against the same weights in f32 with no kernel
    (>= 0.98 of pixels, but for BF16_FLOOR_NOT_HELD), a full head's f32
    masks with both kernels against them (>= 0.999), latency in turns with
    no kernel (a lite head has none to turn off: its turns are one model),
    and the profile of one request of the models in PROFILED_SERVING.
    Returns each run's launch counts."""
    from deeplabv3p_torch.inference import DeepLab

    card = card_line()
    out = {}
    for model_type, reqs in runs:
        common = dict(model_type=model_type, classes_path=classes_path,
                      model_input_shape=INPUT, output_stride=16, device="cuda")
        served = DeepLab(fused_aspp=True, fused_decoder=True, **common)
        plain = DeepLab(dtype=torch.float32, fused_aspp=False, fused_decoder=False, **common)
        for data, hw in reqs[:WARMUP]:
            served.predict(data, hw)
        kernels.reset_launch_counts()                # this path starts here
        masks, times = serve_requests(torch, served, reqs)
        launches = kernels.launch_counts()           # ... and ends here
        n = len(reqs)
        lite = served.model.lite
        check(launches == {**ZERO_LAUNCHES, "multirate_atrous_depthwise": 0 if lite else n,
                           "fused_decoder_frontend": 0 if lite else n},
              f"{model_type} serving: " + ("a lite head, no kernel to launch" if lite else
                                           f"the ASPP kernel ({served.model.backbone.out_channels}"
                                           f" channels) and the decoder kernel once a request "
                                           f"({n})") + f": {launches}")
        ref_masks = [plain.predict(data, hw) for data, hw in reqs]
        agree = min(float((m == r).mean()) for m, r in zip(masks, ref_masks))
        shapes_ok = all(m.shape == hw and m.min() >= 0 and m.max() < 21
                        for m, (_, hw) in zip(masks, reqs))
        held = model_type not in BF16_FLOOR_NOT_HELD
        check(shapes_ok and (agree >= 0.98 or not held),
              f"{model_type} serving, bf16 with both kernels vs f32 with none: masks of the "
              f"requests' sizes agree on " + (">= 0.98" if held else
                                              "(floor not held: bf16-ill-conditioned weights)")
              + f" of pixels (min {agree:.5f})")
        configs = {"bf16, lite head (no kernel)": served} if lite else {
            "bf16, no kernels": DeepLab(fused_aspp=False, **common),
            "bf16, ASPP + decoder kernels": served}
        if not lite:
            # the kernels in f32, against the same model without them
            fused32 = DeepLab(dtype=torch.float32, fused_aspp=True, fused_decoder=True, **common)
            agree32 = min(float((fused32.predict(data, hw) == r).mean())
                          for (data, hw), r in zip(reqs, ref_masks))
            check(agree32 >= 0.999,
                  f"{model_type} serving, f32 with both kernels vs f32 with none: masks agree on "
                  f">= 0.999 of pixels (min {agree32:.5f})")
            del fused32
        if not held:  # whether the kernels move the bf16 masks at all
            plain16 = configs["bf16, no kernels"]
            print(f"  {model_type} bf16 with no kernel vs f32: min "
                  f"{min(float((plain16.predict(d, hw) == r).mean()) for (d, hw), r in zip(reqs, ref_masks)):.5f}")
        for data, hw in reqs[:WARMUP]:
            for deeplab in configs.values():
                deeplab.predict(data, hw)
        pooled = {name: [] for name in configs}
        for name in [*configs, *reversed(configs)]:  # in turns: P K K P
            pooled[name] += serve_requests(torch, configs[name], reqs)[1]
        print(f"  {model_type} latency in turns P K K P of {n} requests (host clock around "
              f"predict, synchronized)  [{card}]:")
        for name, ts in pooled.items():
            print(f"    {name}: median {statistics.median(ts):.3f} ms, p90 "
                  f"{float(np.percentile(ts, 90)):.3f} ms over {len(ts)} requests")
        if model_type in PROFILED_SERVING:
            name = {"mobilenetv3large": "v3large"}.get(model_type, model_type)
            profile_one(torch, lambda: served.predict(*reqs[0]), f"one {model_type} request",
                        f"profile_one_request_{name}.txt", top=8)
        out[model_type] = launches
        del served, plain, configs
        torch.cuda.empty_cache()
    return out


def default_evaluation_path(torch, kernels, classes_path, root) -> None:
    """`python -m deeplabv3p_torch.eval` with its own default model
    (mobilenetv3large_lite), b8 512x512, on the 32 synthetic pairs and a
    seeded .npz: the confusion kernel once a batch, no other kernel, and
    the matrix EQUAL to torch.argmax + bincount on the same model's
    logits."""
    from deeplabv3p_torch import eval as eval_cli
    from deeplabv3p_torch.models.factory import build_deeplab_model
    from deeplabv3p_torch.models.layers import init_parameters
    from deeplabv3p_torch.utils.weights import save_npz, to_jax_variables

    weights = os.path.join(OUT_DIR, "smoke_v3_eval_weights.npz")
    seeded = build_deeplab_model("mobilenetv3large_lite", 21, device="cpu")
    init_parameters(seeded, torch.Generator().manual_seed(EVAL_SEED))
    save_npz(weights, to_jax_variables(seeded))
    argv = ["--model_path", weights, "--dataset_path", root, "--dataset_file",
            os.path.join(root, "list.txt"), "--classes_path", classes_path,
            "--out_dir", os.path.join(OUT_DIR, "smoke_v3_eval_result")]
    args = eval_cli.parse_args(argv)
    check((args.model_type, args.batch_size, args.model_input_shape) ==
          ("mobilenetv3large_lite", EVAL_BATCH, "512x512"),
          "eval CLI defaults: mobilenetv3large_lite, b8, 512x512")
    print("  python -m deeplabv3p_torch.eval " + " ".join(argv))
    m, wall, launches, text = run_cli(torch, kernels, eval_cli.main, args)
    batches = TRAIN_IMAGES // EVAL_BATCH
    summary = [ln for ln in text.splitlines() if "=" in ln and ":" not in ln]
    print(f"  {wall:.2f} s wall (set-up and first-call cuDNN tuning included); "
          f"{' '.join(summary)}; launch counts {launches}  [{card_line()}]")
    check(launches == {**ZERO_LAUNCHES, "confusion_matrix_fused": batches},
          f"eval CLI, default model: the confusion kernel once a batch ({batches}), the lite "
          "head runs no other kernel")
    want = library_confusion(torch, "mobilenetv3large_lite", weights, root)
    check(np.array_equal(m.confusion, want) and int(want.sum()) > 0,
          "eval CLI, default model: the matrix EQUALS torch.argmax + bincount on the same "
          f"model's logits (sum|diff| {int(np.abs(m.confusion - want).sum())})")


def library_confusion(torch, model_type, weights, root, input_hw=INPUT, num_classes=21):
    """The (C, C) matrix of `model_type` (bf16, OS16) with the weights of
    the .npz `weights` over the synthetic set at b8, by `torch.argmax` and
    `bincount` of its logits: what the eval CLI's matrix must EQUAL."""
    from deeplabv3p_torch import metrics as metrics_lib
    from deeplabv3p_torch.data.augment import preprocess_eval_batch
    from deeplabv3p_torch.data.pipeline import SegmentationDataset
    from deeplabv3p_torch.models.factory import build_segmentation_model
    from deeplabv3p_torch.train import accumulate_confusion
    from deeplabv3p_torch.utils.config import get_data_list
    from deeplabv3p_torch.utils.weights import from_jax_variables, load_npz

    model = build_segmentation_model(model_type, num_classes, fused_aspp=True,
                                     dtype=torch.bfloat16, device="cuda")
    model.load_state_dict(from_jax_variables(load_npz(weights), model), strict=True)

    @torch.no_grad()
    def library_step(images_u8, labels_u8):
        images, labels = preprocess_eval_batch(images_u8, labels_u8, num_classes=num_classes)
        preds = torch.argmax(model(images.permute(0, 3, 1, 2)), dim=1)
        return metrics_lib.confusion_matrix(labels, preds, num_classes)

    ds = SegmentationDataset(root, get_data_list(os.path.join(root, "list.txt"), shuffle=False),
                             batch_size=EVAL_BATCH, num_classes=num_classes,
                             input_shape=input_hw, augment=False, shuffle=False,
                             drop_remainder=False)
    return accumulate_confusion(library_step, ds, num_classes, "cuda")


def model_evaluation_path(torch, kernels, classes_path, root, model_type, input_hw=INPUT,
                          images=TRAIN_IMAGES) -> dict:
    """`python -m deeplabv3p_torch.eval --model_type <model_type>` b8 at
    `input_hw` on the `images` synthetic pairs of `root` and a seeded .npz:
    the confusion kernel once a batch, the ASPP kernel too for a full
    DeepLab head, no other kernel, and the matrix EQUAL to torch.argmax +
    bincount of the same model's logits. Returns the launch counts."""
    from deeplabv3p_torch import eval as eval_cli
    from deeplabv3p_torch.models.factory import build_segmentation_model
    from deeplabv3p_torch.models.layers import init_parameters
    from deeplabv3p_torch.utils.config import get_classes
    from deeplabv3p_torch.utils.weights import save_npz, to_jax_variables

    num_classes = len(get_classes(classes_path))
    weights = os.path.join(OUT_DIR, f"smoke_{model_type}_weights.npz")
    seeded = build_segmentation_model(model_type, num_classes, device="cpu")
    init_parameters(seeded, torch.Generator().manual_seed(EVAL_SEED))
    save_npz(weights, to_jax_variables(seeded))
    aspp = hasattr(seeded, "aspp") and not seeded.lite  # a full DeepLab head
    del seeded
    argv = eval_argv(weights, root, classes_path, os.path.join(OUT_DIR, f"smoke_{model_type}_eval"))
    argv[argv.index("mobilenetv2")] = model_type
    argv[argv.index(f"{INPUT[0]}x{INPUT[1]}")] = f"{input_hw[0]}x{input_hw[1]}"
    print("  python -m deeplabv3p_torch.eval " + " ".join(argv))
    m, wall, launches, _ = run_cli(torch, kernels, eval_cli.main, eval_cli.parse_args(argv))
    batches = images // EVAL_BATCH
    print(f"  {model_type} eval at {input_hw[0]}x{input_hw[1]}, {num_classes} classes: "
          f"{wall:.2f} s wall for {images} images (set-up and first-call cuDNN tuning "
          f"included), mIoU {m.miou:.5f} (seeded weights); launch counts {launches}  "
          f"[{card_line()}]")
    check(launches == {**ZERO_LAUNCHES, "confusion_matrix_fused": batches,
                       "multirate_atrous_depthwise": batches if aspp else 0},
          f"{model_type} eval b{EVAL_BATCH}: the confusion kernel" +
          (" and the ASPP kernel once a batch" if aspp else
           " once a batch, no other kernel on this model's path") + f" ({batches})")
    want = library_confusion(torch, model_type, weights, root, input_hw, num_classes)
    check(np.array_equal(m.confusion, want) and int(want.sum()) > 0,
          f"{model_type} eval CLI: the matrix EQUALS torch.argmax + bincount on the same "
          f"model's logits (sum|diff| {int(np.abs(m.confusion - want).sum())})")
    return launches


def model_training_path(torch, kernels, train_main, train_args, classes_path, root, model_type,
                        images: int, *extra) -> dict:
    """`python -m deeplabv3p_torch.train --model_type <model_type>` b8 bf16
    512x512 --no_augment --fused_loss (and `extra`) at the CLI's own LR (SGD
    1e-2), 1 + 1 epochs on the first `images` synthetic pairs: the loss
    kernels once a step, no other kernel, finite losses, the second epoch's
    below the first's; the peak memory of the run. Returns the launch
    counts."""
    import shutil

    list_path = os.path.join(root, f"list{images}.txt")
    with open(list_path, "w") as f:
        f.write("\n".join(f"s{i:03d}" for i in range(images)) + "\n")
    log_dir = os.path.join(OUT_DIR, f"smoke_{model_type}_train_logs")
    shutil.rmtree(log_dir, ignore_errors=True)
    argv = ["--model_type", model_type, "--model_input_shape", f"{INPUT[0]}x{INPUT[1]}",
            "--batch_size", str(MODEL_TRAIN_BATCH), "--no_augment", "--fused_loss", *extra,
            "--transfer_epoch", "1", "--total_epoch", "2",
            "--dataset_path", root, "--dataset_file", list_path,
            "--classes_path", classes_path, "--log_dir", log_dir, "--device", "cuda"]
    print("  python -m deeplabv3p_torch.train " + " ".join(argv))
    torch.cuda.reset_peak_memory_stats()
    trainer, wall, launches, _ = run_cli(torch, kernels, train_main, train_args(argv))
    steps = 2 * (images // MODEL_TRAIN_BATCH)
    print(f"  {model_type}: {steps} steps in {wall:.1f} s wall (set-up and first-call cuDNN "
          f"tuning included), peak memory {torch.cuda.max_memory_allocated() / 2**20:.1f} MiB; "
          f"launch counts {launches}  [{card_line()}]")
    check(launches == {**ZERO_LAUNCHES, "upsample_ce_forward": steps,
                       "upsample_ce_backward": steps},
          f"{model_type} training --fused_loss: each loss kernel once a step ({steps}), every "
          "other kernel never")
    losses = [r["loss"] for r in trainer.history]
    check(len(losses) == 2 and all(np.isfinite(losses)) and losses[1] < losses[0],
          f"{model_type} training: 2 epochs, finite losses, falling {[round(x, 5) for x in losses]}")
    del trainer
    torch.cuda.empty_cache()
    return launches


def default_train_numbers(torch, batch, steps: int = 6) -> None:
    """The CLI default's step (mobilenetv3large_lite b16 bf16, SGD at the
    CLI's LR, freeze level 0), each step augmenting the same uint8 batch
    anew on the card, unfused and --fused_loss in turns U F F U of `steps`
    after 2 warm-up steps each: step time (host clock, synchronized,
    augmentation included), img/s, peak memory, the augmentation's own time
    by CUDA events and its share of the step; the loss must be finite and
    fall over the steps."""
    from deeplabv3p_torch.data.augment import AugmentConfig, augment_batch
    from deeplabv3p_torch.losses import get_loss_fn
    from deeplabv3p_torch.models.factory import build_deeplab_model
    from deeplabv3p_torch.models.layers import init_parameters
    from deeplabv3p_torch.train import StageConfig, Trainer

    images_u8, labels_u8, orig_hw = batch
    model = build_deeplab_model("mobilenetv3large_lite", 21, dtype=torch.bfloat16,
                                device="cuda")
    init_parameters(model, torch.Generator().manual_seed(V3_SEED), bn_identity=True)
    trainer = Trainer(model, 21, get_loss_fn("crossentropy"), device="cuda",
                      log_dir=os.path.join(OUT_DIR, "smoke_v3_step_logs"))
    stage = StageConfig(freeze_level=0, optim_type="sgd", learning_rate=1e-2)
    state = trainer.build_stage_state(stage)
    variants = {}
    for fused in (False, True):
        trainer.fused_loss = fused
        variants["--fused_loss" if fused else "default"] = trainer.make_train_step(stage)
    gen = torch.Generator(device="cuda").manual_seed(V3_SEED)
    cfg = AugmentConfig()
    losses = []
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)

    def run(step, n):
        times, aug = [], []
        for _ in range(n):
            torch.cuda.synchronize()
            t = time.perf_counter()
            start.record()
            images, labels, weights = augment_batch(gen, images_u8, labels_u8, orig_hw, cfg,
                                                    num_classes=21)
            end.record()
            metrics = step(state, images, labels, weights)
            torch.cuda.synchronize()
            times.append((time.perf_counter() - t) * 1e3)
            aug.append(start.elapsed_time(end))
            losses.append(metrics["loss"].item())
        return times, aug

    for step in variants.values():
        run(step, 2)
    times = {k: [] for k in variants}
    aug = {k: [] for k in variants}
    peak = {k: 0 for k in variants}
    for name in ("default", "--fused_loss", "--fused_loss", "default"):
        torch.cuda.reset_peak_memory_stats()
        t, a = run(variants[name], steps)
        times[name] += t
        aug[name] += a
        peak[name] = max(peak[name], torch.cuda.max_memory_allocated())
    card = card_line()
    print(f"train step with the CLI's defaults, mobilenetv3large_lite OS16 512x512 "
          f"b{TRAIN_BATCH} bf16, SGD, freeze level 0, the augmentation on the card each step, "
          f"in turns U F F U of {steps} steps (host clock, synchronized)  [{card}]:")
    for name, ts in times.items():
        med, aug_ms = statistics.median(ts), statistics.mean(aug[name])
        print(f"  {name}: median {med:.3f} ms, p90 {float(np.percentile(ts, 90)):.3f} ms over "
              f"{len(ts)} steps, {TRAIN_BATCH / med * 1e3:.1f} img/s; peak memory "
              f"{peak[name] / 2**20:.1f} MiB; augmentation {aug_ms:.3f} ms a b{TRAIN_BATCH} "
              f"batch by CUDA events (median {statistics.median(aug[name]):.3f}), "
              f"{aug_ms / med:.3f} of the step  [{card}]")
    profile_one(torch, lambda: augment_batch(gen, images_u8, labels_u8, orig_hw, cfg, 21),
                f"the augmentation of one b{TRAIN_BATCH} batch", "profile_one_augment.txt",
                top=12)
    profile_one(torch, lambda: variants["default"](state, *augment_batch(
        gen, images_u8, labels_u8, orig_hw, cfg, 21)), "one CLI-default step",
        "profile_one_train_step_v3.txt", top=8)
    first, last = statistics.mean(losses[:4]), statistics.mean(losses[-4:])
    check(all(np.isfinite(losses)) and last < first,
          f"CLI-default training: {len(losses)} losses finite and falling (first four "
          f"{first:.4f}, last four {last:.4f}): {[round(x, 3) for x in losses]}")


def learning_proof(torch, kernels, train_main, train_args):
    """(a) The learning proof on the card: bench.py's `learn` recipe through
    `python -m deeplabv3p_torch.train` (mobilenetv2, the toy set of
    data/toy.py, 256x256, b8, adam 1e-3, cosine, adaptive weights,
    --no_augment, --freeze_level 1, 2 + 118 epochs, --bn_recalibrate), then
    `python -m deeplabv3p_torch.eval` on trained_final.npz: mIoU >= 0.95.
    The same weights written as the JAX package's .ckpt give the eval CLI
    the same matrix. Returns what phase (b) reuses."""
    import shutil

    from deeplabv3p_torch import eval as eval_cli
    from deeplabv3p_torch.data.toy import build_overfit_dataset
    from deeplabv3p_torch.utils.checkpoint import save_variables
    from deeplabv3p_torch.utils.weights import load_npz

    root = os.path.join(OUT_DIR, "smoke_learn_data")
    log_dir = os.path.join(OUT_DIR, "smoke_learn_logs")
    for d in (root, log_dir):
        shutil.rmtree(d, ignore_errors=True)
    list_path = build_overfit_dataset(root, source_dir=os.path.join(REPO, "example"))
    common = ["--model_type", "mobilenetv2", "--model_input_shape", str(LEARN_HW),
              "--batch_size", str(LEARN_BATCH), "--dataset_path", root, "--dataset_file",
              list_path, "--classes_path", os.path.join(root, "classes.txt")]
    argv = [*common, "--optimizer", "adam", "--learning_rate", "1e-3", "--decay_type", "cosine",
            "--weighted_type", "adaptive", "--no_augment", "--freeze_level", "1",
            "--transfer_epoch", "2", "--total_epoch", str(LEARN_EPOCHS), "--bn_recalibrate",
            "--log_dir", log_dir, "--device", "cuda"]
    print("learning proof: python -m deeplabv3p_torch.train " + " ".join(argv))
    trainer, train_s, train_launches, _ = run_cli(torch, kernels, train_main, train_args(argv))
    losses = [r["loss"] for r in trainer.history]
    check(len(losses) == LEARN_EPOCHS and all(np.isfinite(losses)),
          f"learning proof: {len(losses)} epochs of finite loss, first {losses[0]:.4f}, last "
          f"{losses[-1]:.4f}; train jaccard last {trainer.history[-1]['jaccard']:.4f}")
    check(train_launches == ZERO_LAUNCHES,
          f"learning proof, training: no hand-written kernel on this path (unfused loss, "
          f"training mode): {train_launches}")
    final = os.path.join(log_dir, "trained_final.npz")

    def evaluate(path, *extra):
        args = eval_cli.parse_args([*common, "--model_path", path, "--device", "cuda",
                                    "--out_dir", os.path.join(OUT_DIR, "smoke_learn_eval"),
                                    *extra])
        return run_cli(torch, kernels, eval_cli.main, args)

    m, eval_s, eval_launches, _ = evaluate(final)
    card = card_line()
    print(f"  trained {LEARN_EPOCHS} epochs ({LEARN_EPOCHS} steps of b{LEARN_BATCH}) in "
          f"{train_s:.2f} s (the CLI's wall: set-up, first-call cuDNN tuning and the BN "
          f"recalibration included); eval CLI {eval_s:.2f} s; {train_s + eval_s:.2f} s to the "
          f"eval's mIoU {m.miou:.5f} (FWIoU {m.fwiou:.5f}, PixelAcc {m.pixel_acc:.5f})  [{card}]")
    check(m.miou >= LEARN_TARGET, f"learning proof: eval mIoU {m.miou:.5f} >= {LEARN_TARGET}")
    batches = -(-8 // LEARN_BATCH)
    check(eval_launches == {**ZERO_LAUNCHES, "confusion_matrix_fused": batches,
                            "multirate_atrous_depthwise": batches},
          f"learning proof, eval: the confusion and ASPP kernels once a batch ({batches}): "
          f"{eval_launches}")
    ckpt = os.path.join(log_dir, "trained_final.ckpt")
    save_variables(ckpt, load_npz(final))
    m_ckpt = evaluate(ckpt)[0]
    check(np.array_equal(m_ckpt.confusion, m.confusion),
          f"learning proof: the weights as a .ckpt (save_variables) give the eval CLI the "
          f".npz's matrix (sum|diff| {int(np.abs(m_ckpt.confusion - m.confusion).sum())})")
    m_mb, _, mb_launches, _ = evaluate(final, "--fused_mbconv")
    check(mb_launches["fused_inverted_residual"] == 13 * batches,
          f"learning proof, eval --fused_mbconv: the inverted-residual kernel 13 times a batch "
          f"({mb_launches['fused_inverted_residual']})")
    print(f"  eval CLI --fused_mbconv on the trained weights: mIoU {m_mb.miou:.5f} against "
          f"{m.miou:.5f} by default")
    return {"root": root, "list": list_path, "weights": final, "launches": eval_launches,
            "miou": m.miou, "confusion": {"default": m.confusion, "fused_mbconv": m_mb.confusion}}


def fused_mbconv_on_trained_weights(torch, learn) -> None:
    """(b) ROADMAP Queue C item 1: the masks of --fused_mbconv against the
    default's, on the learning proof's trained weights and the toy images
    (bf16, 256x256, as the eval CLI builds the model); printed. Each route's
    masks agree with the f32 model's with no kernel on >= 0.98 of pixels, and
    torch.argmax + bincount of them EQUALS the eval CLI's matrix of (a) for
    that route (the confusion kernel at (8,256,256,4)). The default does not
    change here."""
    from deeplabv3p_torch import metrics as metrics_lib
    from deeplabv3p_torch.data.augment import preprocess_eval_batch
    from deeplabv3p_torch.data.pipeline import SegmentationDataset
    from deeplabv3p_torch.models.factory import build_deeplab_model
    from deeplabv3p_torch.utils.config import get_data_list
    from deeplabv3p_torch.utils.weights import from_jax_variables, load_npz

    variables = load_npz(learn["weights"])
    ds = SegmentationDataset(learn["root"], get_data_list(learn["list"], shuffle=False),
                             batch_size=LEARN_BATCH, num_classes=4,
                             input_shape=(LEARN_HW, LEARN_HW), augment=False, shuffle=False,
                             drop_remainder=False)
    batches = [(b[0], b[1]) for b in ds.epoch_batches()]
    labels = torch.cat([preprocess_eval_batch(torch.from_numpy(images_u8).cuda(),
                                              torch.from_numpy(labels_u8).cuda(), 4)[1]
                        for images_u8, labels_u8 in batches])

    @torch.no_grad()
    def masks_of(dtype, **flags):
        model = build_deeplab_model("mobilenetv2", 4, dtype=dtype, device="cuda", **flags)
        model.load_state_dict(from_jax_variables(variables, model), strict=True)
        out = []
        for images_u8, labels_u8 in batches:
            images, _ = preprocess_eval_batch(torch.from_numpy(images_u8).cuda(),
                                              torch.from_numpy(labels_u8).cuda(), 4)
            out.append(torch.argmax(model(images.permute(0, 3, 1, 2)), dim=1))
        return torch.cat(out)

    default = masks_of(torch.bfloat16, fused_aspp=True)
    fused = masks_of(torch.bfloat16, fused_aspp=True, fused_mbconv=True)
    f32 = masks_of(torch.float32)
    agree = (fused == default).float().mean().item()
    check(fused.shape == default.shape == (8, LEARN_HW, LEARN_HW),
          f"Queue C item 1, trained weights: --fused_mbconv masks agree with the default's "
          f"on {agree:.5f} of {default.numel()} pixels (0.98152 on seeded random weights)")
    for route, masks in (("default", default), ("fused_mbconv", fused)):
        to_f32 = (masks == f32).float().mean().item()
        check(to_f32 >= 0.98, f"trained weights, bf16 {route} vs f32 with no kernel: masks "
                              f"agree on {to_f32:.5f} >= 0.98 of pixels")
        want = metrics_lib.confusion_matrix(labels, masks, 4).cpu().numpy()
        got = learn["confusion"][route]
        check(np.array_equal(got, want) and int(want.sum()) > 0,
              f"learning proof, eval CLI ({route}): the matrix EQUALS torch.argmax + bincount "
              f"on the same model's logits (sum|diff| {int(np.abs(got - want).sum())})")


def xception_train_numbers(torch, root, classes_path, steps: int = 6) -> None:
    """(d) xception b8 bf16 512x512 train steps: unfused with f32 state (U),
    --fused_loss (F) and --optim_state_dtype bfloat16 (B), in turns U F B B
    F U (`model_train_numbers`)."""
    model_train_numbers(torch, root, classes_path, "xception", MODEL_TRAIN_BATCH,
                        (("U unfused, f32 state", False, None),
                         ("F --fused_loss, f32 state", True, None),
                         ("B unfused, bf16 state", False, "bfloat16")), steps)


def model_train_numbers(torch, root, classes_path, model_type, batch_size, variants_of,
                        steps: int = 6, profile: str | None = None, input_hw=INPUT,
                        num_classes: int = 21, l2_factor: float = 2e-5,
                        batch=None) -> dict:
    """`model_type` b`batch_size` bf16 512x512 train steps (SGD 1e-2, the
    CLI's, freeze level 0, one fixed batch of the synthetic set), one model
    from the same seed a (name, fused loss, optimizer state dtype) of
    `variants_of`, in turns (A B .. B A) of `steps` after 2 warm-up steps
    each: step time, img/s, peak memory, the optimizer state's bytes; the
    loss must fall in each run. With `profile`, the profile of one step of
    the first variant goes to build/<profile>. Returns {name: (median ms,
    peak bytes)}."""
    from deeplabv3p_torch.losses import get_loss_fn
    from deeplabv3p_torch.models.factory import build_segmentation_model
    from deeplabv3p_torch.models.layers import init_parameters
    from deeplabv3p_torch.train import StageConfig, Trainer

    images, labels = batch or train_batch(torch, root, classes_path)
    images, labels = images[:batch_size], labels[:batch_size]
    variants = {}
    for name, fused, state_dtype in variants_of:
        model = build_segmentation_model(model_type, num_classes, dtype=torch.bfloat16,
                                         device="cuda")
        init_parameters(model, torch.Generator().manual_seed(TRAIN_SEED), bn_identity=True)
        trainer = Trainer(model, num_classes, get_loss_fn("crossentropy"), device="cuda",
                          log_dir=os.path.join(OUT_DIR, f"smoke_{model_type}_step_logs"),
                          fused_loss=fused, l2_factor=l2_factor)
        stage = StageConfig(freeze_level=0, optim_type="sgd", learning_rate=1e-2,
                            state_dtype=state_dtype)
        variants[name] = (trainer.build_stage_state(stage), trainer.make_train_step(stage))
    losses = {name: [] for name in variants}

    def run(name, n):
        state, step = variants[name]
        times = []
        for _ in range(n):
            torch.cuda.synchronize()
            t = time.perf_counter()
            metrics = step(state, images, labels, None)
            torch.cuda.synchronize()
            times.append((time.perf_counter() - t) * 1e3)
            losses[name].append(metrics["loss"].item())
        return times

    for name in variants:
        run(name, 2)
    times = {name: [] for name in variants}
    peak = {name: 0 for name in variants}
    for name in [*variants, *reversed(variants)]:
        torch.cuda.reset_peak_memory_stats()
        times[name] += run(name, steps)
        peak[name] = max(peak[name], torch.cuda.max_memory_allocated())

    def resident(name):
        """Bytes of a variant's weights and optimizer state (its gradients are
        freed after each step)."""
        state = variants[name][0]
        opt = sum(t.numel() * t.element_size() for s in state.optimizer.state.values()
                  for t in s.values() if isinstance(t, torch.Tensor))
        params = sum(p.numel() * p.element_size() for p in state.params.values())
        return params, opt

    card = card_line()
    first_name = next(iter(variants))
    n_params = sum(p.numel() for p in variants[first_name][0].params.values())
    order = " ".join(n.split()[0] for n in [*variants, *reversed(variants)])
    print(f"train step, {model_type} OS16 {input_hw[0]}x{input_hw[1]} b{batch_size} bf16, "
          f"SGD, freeze level 0, L2 {l2_factor:g}, "
          f"{n_params} parameters, in turns {order} of {steps} steps (host clock, "
          f"synchronized)  [{card}]:")
    out = {}
    for name, ts in times.items():
        med = statistics.median(ts)
        params, opt = resident(name)
        others = sum(sum(resident(o)) for o in variants if o != name)
        print(f"  {name}: median {med:.3f} ms, p90 {float(np.percentile(ts, 90)):.3f} ms over "
              f"{len(ts)} steps, {batch_size / med * 1e3:.1f} img/s; peak memory "
              f"{peak[name] / 2**20:.1f} MiB with all {len(variants)} variant(s) resident, "
              f"{(peak[name] - others) / 2**20:.1f} MiB less the others' weights and "
              f"state; its optimizer state {opt / 2**20:.1f} MiB, weights {params / 2**20:.1f} "
              f"MiB  [{card}]")
        first, last = statistics.mean(losses[name][:4]), statistics.mean(losses[name][-4:])
        check(all(np.isfinite(losses[name])) and last < first,
              f"{model_type} training {name}: {len(losses[name])} losses finite and falling "
              f"(first four {first:.4f}, last four {last:.4f})")
        out[name] = (med, peak[name])
    bf16 = [name for name, _, dtype in variants_of if dtype == "bfloat16"]
    if bf16:
        state_saved = resident(first_name)[1] - resident(bf16[0])[1]
        print(f"  bf16 optimizer state saves {state_saved / 2**20:.1f} MiB "
              f"({state_saved / n_params:.2f} bytes a parameter)")
    if profile:
        state, step = variants[first_name]
        profile_one(torch, lambda: step(state, images, labels, None),
                    f"one {model_type} b{batch_size} train step ({first_name})", profile, top=10)
    del variants
    torch.cuda.empty_cache()
    return out


def aspp_shape_row(torch, kaspp, rec, launches, path) -> dict:
    """The ASPP kernel's kernels-JSON record at a new shape: its check's
    error, its times against the plain version, and its launches on `path`,
    the run that calls it at that shape."""
    t = aspp_timing(torch, kaspp, rec["case"], iters=200)
    return {"name": "multirate_atrous_depthwise", "route": "cuda",
            "source": "deeplabv3p_torch/ops/kernels/csrc/aspp.cu",
            "replaces": "deeplabv3p_tpu/ops/pallas/aspp.py:85", "launches": launches,
            "max_abs_err": rec["max_abs_err"], "ms": t["ms"], "plain_ms": t["plain_ms"],
            "bound_ms": t["bound_ms"], "bound_by": t["bound_by"], "library_ms": None,
            "device_us": t["device_us"], "shape": t["shape"], "dtype": t["dtype"],
            "path": path}


def train_batch(torch, root, classes_path, n=TRAIN_BATCH, input_hw=INPUT, num_classes=21):
    """The first `n` pairs of the synthetic set, preprocessed on the card:
    (images f32 NHWC, labels int32)."""
    from deeplabv3p_torch.data.augment import preprocess_eval_batch
    from deeplabv3p_torch.data.pipeline import SegmentationDataset

    ids = [f"s{i:03d}" for i in range(n)]
    ds = SegmentationDataset(root, ids, batch_size=n, num_classes=num_classes,
                             input_shape=input_hw, augment=False, shuffle=False)
    images, labels, _ = next(iter(ds.epoch_batches()))
    return preprocess_eval_batch(torch.from_numpy(images).cuda(),
                                 torch.from_numpy(labels).cuda(), num_classes=num_classes)


def make_train_model(torch, dtype, seed):
    from deeplabv3p_torch.models.factory import build_deeplab_model
    from deeplabv3p_torch.models.layers import init_parameters

    model = build_deeplab_model("mobilenetv2", 21, dtype=dtype, device="cuda")
    init_parameters(model, torch.Generator().manual_seed(seed), bn_identity=True)
    return model


def fused_vs_unfused(torch, batch) -> None:
    """Forward + loss + backward of the train step, fused and unfused, from
    the same weights on the same batch, dropout off, TF32 off, deterministic
    cuDNN. Losses: f32 within 1e-5 relative, bf16 within 1e-2. Gradients:
    each within 1e-4 of its max|grad| (floored at 1e-2 of the model's
    largest: the linear bottlenecks' project_BN biases feed a 1x1 conv and a
    training-mode BN, so their gradient is exactly 0 and carries only
    rounding), with f64 activations (f32 parameters, f32 loss tail and
    kernels, as in training). In f32 activations the backward's own
    reductions over 4 M pixels, in a random-init stack of training-mode BNs,
    amplify rounding past 1e-4 on a few BN scales whichever loss tail runs;
    that worst ratio is printed too."""
    from deeplabv3p_torch.losses import get_loss_fn
    from deeplabv3p_torch.models.layers import Dropout
    from deeplabv3p_torch.train import make_train_step

    images, labels = batch
    torch.backends.cudnn.deterministic = True
    results = {}
    for dtype in (torch.float64, torch.float32, torch.bfloat16):
        for fused in (False, True):
            model = make_train_model(torch, dtype, seed=1)
            for m in model.modules():
                if isinstance(m, Dropout):
                    m.rate = 0.0
            step = make_train_step(model, get_loss_fn("crossentropy"), num_classes=21,
                                   fused_loss=fused)
            loss, _ = step.forward_loss(images, labels, None)
            loss.backward()
            grads = {n: p.grad.double() for n, p in model.named_parameters()}
            results[dtype, fused] = (loss.item(), grads)
            del model, step, loss
            torch.cuda.empty_cache()
    torch.backends.cudnn.deterministic = False

    def worst(dtype):
        gu, gf = results[dtype, False][1], results[dtype, True][1]
        top = max(g.abs().max().item() for g in gu.values())
        ratios = sorted((((gf[n] - gu[n]).abs().max().item()
                          / max(gu[n].abs().max().item(), 1e-2 * top), n) for n in gu),
                        reverse=True)
        return ratios, top

    for dtype, tol in ((torch.float64, 1e-5), (torch.float32, 1e-5), (torch.bfloat16, 1e-2)):
        lu, lf = results[dtype, False][0], results[dtype, True][0]
        check(abs(lf - lu) <= tol * abs(lu),
              f"train step {dtype}: fused loss {lf:.8g} vs unfused {lu:.8g} ({tol:g} relative)")
    ratios, top = worst(torch.float64)
    check(ratios[0][0] <= 1e-4,
          f"train step, f64 activations: every gradient within 1e-4 of its max|grad| "
          f"(largest {top:.3g}); worst {ratios[0][0]:.3g} {ratios[0][1]}")
    ratios, top = worst(torch.float32)
    print(f"  (f32 activations, for the record: worst {ratios[0][0]:.3g} {ratios[0][1]}, "
          f"then {ratios[1][0]:.3g} {ratios[1][1]}, {ratios[2][0]:.3g} {ratios[2][1]})")


def train_step_numbers(torch, batch, steps: int = 12) -> None:
    """bf16 train-step time (host clock, synchronized), fused and unfused
    in turns U F F U of `steps` steps after 2 warm-up steps, img/s and peak
    memory; then the profile of one fused step."""
    from deeplabv3p_torch.losses import get_loss_fn
    from deeplabv3p_torch.train import StageConfig, Trainer

    images, labels = batch
    model = make_train_model(torch, torch.bfloat16, seed=2)
    trainer = Trainer(model, 21, get_loss_fn("crossentropy"), device="cuda",
                      log_dir=os.path.join(OUT_DIR, "smoke_step_logs"))
    stage = StageConfig(freeze_level=0, optim_type="sgd", learning_rate=1e-3)
    state = trainer.build_stage_state(stage)
    variants = {}
    for fused in (False, True):
        trainer.fused_loss = fused
        variants["fused" if fused else "unfused"] = trainer.make_train_step(stage)

    def run(step, n):
        times = []
        for _ in range(n):
            torch.cuda.synchronize()
            t = time.perf_counter()
            step(state, images, labels, None)
            torch.cuda.synchronize()
            times.append((time.perf_counter() - t) * 1e3)
        return times

    for step in variants.values():
        run(step, 2)
    times = {k: [] for k in variants}
    peak = {k: 0 for k in variants}
    for name in ("unfused", "fused", "fused", "unfused"):
        torch.cuda.reset_peak_memory_stats()
        times[name] += run(variants[name], steps)
        peak[name] = max(peak[name], torch.cuda.max_memory_allocated())
    print(f"train step, mobilenetv2 OS16 512x512 b{TRAIN_BATCH} bf16, SGD, freeze level 0, "
          f"in turns U F F U of {steps} steps (host clock, synchronized):")
    for name, ts in times.items():
        med = statistics.median(ts)
        print(f"  {name}: median {med:.3f} ms, p90 {float(np.percentile(ts, 90)):.3f} ms "
              f"over {len(ts)} steps, {TRAIN_BATCH / med * 1e3:.1f} img/s; peak memory "
              f"{peak[name] / 2**20:.1f} MiB (max_memory_allocated)")
    profile_one(torch, lambda: variants["fused"](state, images, labels, None),
                "one fused train step", "profile_one_train_step.txt", top=15)


def upsample_ce_times(torch, kce, rec, launches) -> list:
    """Each loss-tail kernel's time against its plain version at the
    training slice's shape, and its kernels-JSON row."""
    logits, labels, wpx, out_hw, lse = rec["case"]
    rows = []
    pixel_classes = labels.numel() * logits.shape[-1]
    # forward: logits, labels and weights read, preds (int32) and lse written; a
    # (pixel, class) costs 3 lerps, an exp, a max and an add. Backward: the same
    # reads plus lse, the low-resolution gradient written; a (pixel, class) costs
    # the 3 lerps, an exp, the softmax - onehot and 4 multiply-adds of the scatter
    fwd_bound = bound(nbytes(logits, labels, wpx, lse) + 4 * labels.numel(), pixel_classes * 10)
    bwd_bound = bound(nbytes(logits, labels, wpx, lse, logits), pixel_classes * 18)
    for name, fn, plain, err, replaces, (bound_ms, bound_by) in (
        ("upsample_ce_forward", lambda: kce.upsample_ce_forward(logits, labels, wpx, out_hw),
         lambda: kce.upsample_ce_reference(logits, labels, out_hw, sample_weights=wpx),
         rec["fwd_err"], "deeplabv3p_tpu/ops/pallas/upsample_ce.py:242", fwd_bound),
        ("upsample_ce_backward",
         lambda: kce.upsample_ce_backward(logits, labels, wpx, lse, out_hw),
         lambda: kce.upsample_ce_backward_reference(logits, labels, wpx, out_hw),
         rec["bwd_err"], "deeplabv3p_tpu/ops/pallas/upsample_ce.py:267", bwd_bound),
    ):
        ms, plain_ms = ab_ms(fn, plain, iters=20)
        dev_us, dev_launches = device_us(torch, fn, calls=10)
        plain_us, plain_launches = device_us(torch, plain, calls=10)
        print(f"{name}: kernel {ms * 1e3:.2f} us, plain {plain_ms * 1e3:.2f} us a call (CUDA "
              f"events, mean of 2x20 calls each, {tuple(logits.shape)} -> {out_hw}); device "
              f"time a call (profiler): kernel {us_text(dev_us)} in {dev_launches} launch(es), "
              f"plain {us_text(plain_us)} in {plain_launches}")
        rows.append({"name": name, "route": "cuda",
                     "source": "deeplabv3p_torch/ops/kernels/csrc/upsample_ce.cu",
                     "replaces": replaces, "launches": launches[name],
                     "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
                     "bound_ms": bound_ms, "bound_by": bound_by, "library_ms": None,
                     "device_us": dev_us})
    return rows


# -- the confusion and inverted-residual kernels, and the evaluation path --------


def confusion_case(torch, shape, dtype, label_dtype, seed=0):
    """Seeded logits with planted exact ties and NaNs, labels with a 255
    band, values above C-1 and, where the type is signed, negatives."""
    gen = torch.Generator().manual_seed(seed)
    c = shape[-1]
    logits = torch.randn(shape, generator=gen)
    flat = logits.reshape(-1, c)
    n = flat.shape[0]
    tie = torch.arange(0, n, 7)
    flat[tie] = flat[tie].max(dim=1, keepdim=True).values    # every class ties
    pair = torch.arange(3, n, 11)
    flat[pair, c - 1] = flat[pair].max(dim=1).values          # the last class ties the max
    flat[torch.arange(5, n, 13), 0] = float("nan")
    flat[torch.arange(2, n, 17)] = float("nan")                # all-NaN pixels
    labels = torch.randint(0, c + 3, shape[:-1], generator=gen, dtype=torch.int64)
    labels.reshape(-1)[: n // 9] = 255
    if label_dtype != torch.uint8:
        labels.reshape(-1)[n // 2: n // 2 + n // 10] = -1
    return labels.to(label_dtype).cuda(), logits.to(dtype).cuda()


def confusion_check(torch, kconf, shape, dtype_name, label_name) -> dict:
    dtype, label_dtype = getattr(torch, dtype_name), getattr(torch, label_name)
    labels, logits = confusion_case(torch, shape, dtype, label_dtype)
    c = shape[-1]
    got = kconf.confusion_matrix_fused(labels, logits, c)
    torch.cuda.synchronize()
    want = kconf.confusion_matrix_fused_reference(labels, logits, c)
    valid = ((labels.long() >= 0) & (labels.long() < c)).sum().item()
    diff = (got - want).abs().sum().item()
    check(diff == 0 and got.sum().item() == valid and got.dtype == torch.int64,
          f"confusion {shape} {dtype_name} logits, {label_name} labels: sum|kernel - plain| "
          f"{diff} == 0, counts {got.sum().item()} == valid label pixels {valid}")
    return {"max_abs_err": float(diff), "case": (labels, logits, c)}


def argmax_check(torch, kconf, mask_argmax) -> None:
    """jnp.argmax's rule on the card: the first index wins a tie and the
    first NaN wins over numbers. mask_argmax (torch.argmax, the serving and
    --save_result route) and the confusion kernel (the eval route) against
    numpy's argmax on the same planted logits, in f32 and bf16."""
    gen = torch.Generator().manual_seed(5)
    c = 21
    logits = torch.randn((2, 97, 113, c), generator=gen)
    flat = logits.reshape(-1, c)
    flat[0::7] = flat[0::7].max(dim=1, keepdim=True).values      # every class ties
    flat[3::11, c - 1] = flat[3::11].max(dim=1).values           # the last class ties
    flat[5::13, 4] = float("nan")                                 # a NaN among numbers
    flat[6::13, 2] = flat[6::13, 9] = float("nan")               # two: the first wins
    flat[2::17] = float("nan")                                    # all NaN
    labels = torch.randint(0, c + 2, logits.shape[:-1], generator=gen, dtype=torch.int32)
    for dtype in (torch.float32, torch.bfloat16):
        z = logits.to(dtype)
        want = np.argmax(z.float().numpy(), axis=-1)
        got = mask_argmax(z.cuda()).cpu().numpy()
        lab = labels.numpy()
        valid = lab < c
        cm_want = np.bincount(c * lab[valid].astype(np.int64) + want[valid],
                              minlength=c * c).reshape(c, c)
        cm = kconf.confusion_matrix_fused(labels.cuda(), z.cuda(), c).cpu().numpy()
        check(np.array_equal(got, want) and np.array_equal(cm, cm_want),
              f"argmax on the card, {dtype}: mask_argmax equals numpy's argmax on "
              f"{want.size} pixels with planted ties and NaNs ({int((got != want).sum())} "
              f"differ); the confusion kernel's matrix equals numpy's bincount of it "
              f"(sum|diff| {int(np.abs(cm - cm_want).sum())})")


def body_block_shapes(batch: int, hw) -> list[tuple]:
    """(n, h, w, cin, cexp, cout, rate, residual) of every block of the
    MobileNetV2 OS16 body that `fused_mbconv` routes through the kernel, read
    off the model itself."""
    from deeplabv3p_torch.models.factory import build_deeplab_model

    body = build_deeplab_model("mobilenetv2", 21, output_stride=16, device="cpu").backbone
    h, w = (hw[0] + 1) // 2, (hw[1] + 1) // 2  # the stem's stride 2
    shapes = []
    for i in range(17):
        block = getattr(body, f"block_{i}")
        if block.stride == 2:
            h, w = (h + 1) // 2, (w + 1) // 2
        elif block.has_expand:
            cexp, cin = block._sub("expand").weight.shape[:2]
            shapes.append((batch, h, w, cin, cexp, block.out_channels, block.rate,
                           block.skip_connection))
    return shapes


def mbconv_case(torch, shape, dtype, seed=0):
    """Seeded block input and parameters as the JAX package's test draws them."""
    n, h, w, cin, cexp, cout = shape[:6]
    gen = torch.Generator().manual_seed(seed)
    x = torch.randn((n, h, w, cin), generator=gen).cuda().to(dtype)
    we = (torch.randn((cin, cexp), generator=gen) * 0.2).cuda()
    wd = (torch.randn((3, 3, cexp), generator=gen) * 0.2).cuda()
    wp = (torch.randn((cexp, cout), generator=gen) * 0.1).cuda()

    def fold(c):
        return ((torch.rand((c,), generator=gen) + 0.5).cuda(),
                torch.randn((c,), generator=gen).cuda())

    (se, be), (sd, bd), (sp, bp) = fold(cexp), fold(cexp), fold(cout)
    return x, we, se, be, wd, sd, bd, wp, sp, bp


def mbconv_checks(torch, kmb, body_shapes,
                  others=(*MBCONV_TEST_CASES, *MBCONV_EXTRA_CASES)) -> dict:
    """The inverted-residual kernel against its plain version at the body's
    13 shapes and `others` (by default the JAX tests' four, a ragged map and
    OS8's rate 4), bf16 and f32, the weights prepared on the fly as a caller without a module has
    them. Both store e and d as
    bf16, and their f32 sums differ in order, so a sum an ulp apart can round
    to the other bf16 neighbour (2^-8 relative on one of Cexp terms): both x
    types are held to the bf16 bound of `tolerance`."""
    worst = 0.0
    for shape in [*body_shapes, *others]:
        rate, residual = shape[6], shape[7]
        for dtype in (torch.bfloat16, torch.float32):
            args = mbconv_case(torch, shape, dtype)
            got = kmb.fused_inverted_residual(*args, rate=rate, residual=residual)
            torch.cuda.synchronize()
            want = kmb.fused_inverted_residual_reference(*args, rate=rate, residual=residual)
            err, ref = max_err(got, want)
            mean = (got.float() - want.float()).abs().mean().item()
            tol = tolerance(ref, torch.bfloat16)
            check(err <= tol and got.dtype == dtype and bool(torch.isfinite(got).all()),
                  f"mbconv {shape} {dtype}: max|err| {err:.3g} <= {tol:.3g} (mean|err| "
                  f"{mean:.3g}, max|ref| {ref:.3g})")
            if shape in body_shapes and dtype == torch.bfloat16:
                worst = max(worst, err)
            del args, got, want
    torch.cuda.empty_cache()
    return {"max_abs_err": worst, "shapes": body_shapes}


def eval_argv(weights, root, classes_path, out_dir, *extra):
    return ["--model_path", weights, "--model_type", "mobilenetv2", "--model_input_shape",
            f"{INPUT[0]}x{INPUT[1]}", "--output_stride", "16", "--batch_size", str(EVAL_BATCH),
            "--dataset_path", root, "--dataset_file", os.path.join(root, "list.txt"),
            "--classes_path", classes_path, "--out_dir", out_dir, *extra]


def evaluation_path(torch, kernels, classes_path, root):
    """`deeplabv3p_torch.eval.main` in-process, twice (as built by default,
    then `--fused_mbconv`), on the synthetic set and a seeded .npz. Returns
    the two runs' launch counts and what the timing phase reuses."""
    from deeplabv3p_torch import eval as eval_cli
    from deeplabv3p_torch import metrics as metrics_lib
    from deeplabv3p_torch.data.augment import preprocess_eval_batch
    from deeplabv3p_torch.data.pipeline import SegmentationDataset
    from deeplabv3p_torch.models.factory import build_deeplab_model
    from deeplabv3p_torch.models.layers import init_parameters
    from deeplabv3p_torch.train import accumulate_confusion, make_eval_step
    from deeplabv3p_torch.utils.config import get_data_list
    from deeplabv3p_torch.utils.weights import (
        from_jax_variables,
        load_npz,
        save_npz,
        to_jax_variables,
    )

    out_dir = os.path.join(OUT_DIR, "smoke_eval_result")
    weights = os.path.join(OUT_DIR, "smoke_eval_weights.npz")
    seeded = build_deeplab_model("mobilenetv2", 21, device="cpu")
    init_parameters(seeded, torch.Generator().manual_seed(EVAL_SEED))
    save_npz(weights, to_jax_variables(seeded))
    batches = TRAIN_IMAGES // EVAL_BATCH
    print(f"evaluation path: python -m deeplabv3p_torch.eval on {TRAIN_IMAGES} pairs of {INPUT}, "
          f"b{EVAL_BATCH}, seeded weights (seed {EVAL_SEED}) in {weights}")

    runs = []
    for extra in ((), ("--fused_mbconv",)):
        argv = eval_argv(weights, root, classes_path, out_dir, *extra)
        print("  " + " ".join(argv))
        m, wall, launches, text = run_cli(torch, kernels, eval_cli.main,
                                          eval_cli.parse_args(argv))
        summary = [ln for ln in text.splitlines() if "=" in ln and ":" not in ln]
        print(f"  {wall:.2f} s wall (set-up and first-call cuDNN tuning included); "
              f"{' '.join(summary)}; launch counts {launches}")
        check([ln.split("=")[0] for ln in summary[-4:]] == ["mIoU", "FWIoU", "PixelAcc",
                                                            "mClassAcc"],
              f"eval CLI {' '.join(extra) or '(default)'} printed its summary (mIoU= ...)")
        runs.append((m, launches))
    (m_default, l_default), (m_mbconv, l_mbconv) = runs
    check(l_default == {**ZERO_LAUNCHES, "confusion_matrix_fused": batches,
                        "multirate_atrous_depthwise": batches},
          f"eval, default: confusion and ASPP kernels once a batch ({batches}), "
          "inverted-residual, decoder and loss kernels never")
    check(l_mbconv == {**ZERO_LAUNCHES, "confusion_matrix_fused": batches,
                       "multirate_atrous_depthwise": batches,
                       "fused_inverted_residual": 13 * batches},
          f"eval, --fused_mbconv: the inverted-residual kernel 13 times a batch "
          f"({13 * batches}), confusion and ASPP once a batch")

    # -- references from the same weights, on the same batches -------------------
    variables = load_npz(weights)
    ids = get_data_list(os.path.join(root, "list.txt"), shuffle=False)
    ds = SegmentationDataset(root, ids, batch_size=EVAL_BATCH, num_classes=21,
                             input_shape=INPUT, augment=False, shuffle=False,
                             drop_remainder=False)
    host_batches = [(b[0], b[1]) for b in ds.epoch_batches()]
    valid = sum(int((b[1] < 21).sum()) for b in host_batches)

    def model_of(dtype, **flags):
        model = build_deeplab_model("mobilenetv2", 21, dtype=dtype, device="cuda", **flags)
        model.load_state_dict(from_jax_variables(variables, model), strict=True)
        return model

    def library_step(model):
        """The eval step with the library's tail: torch.argmax, then bincount."""
        @torch.no_grad()
        def step(images_u8, labels_u8):
            images, labels = preprocess_eval_batch(images_u8, labels_u8, num_classes=21)
            preds = torch.argmax(model(images.permute(0, 3, 1, 2)), dim=1)
            return metrics_lib.confusion_matrix(labels, preds, 21)
        return step

    class Resident:
        """The decoded batches, as a dataset the shared loop can stream."""

        def epoch_batches(self):
            return iter(host_batches)

    @torch.no_grad()
    def masks_of(model):
        out = []
        for images_u8, labels_u8 in host_batches:
            images, _ = preprocess_eval_batch(torch.from_numpy(images_u8).cuda(),
                                              torch.from_numpy(labels_u8).cuda(), 21)
            out.append(torch.argmax(model(images.permute(0, 3, 1, 2)), dim=1))
        return torch.cat(out)

    bf16, f32 = torch.bfloat16, torch.float32
    served = model_of(bf16, fused_aspp=True)                      # what the CLI builds
    with_mbconv = model_of(bf16, fused_aspp=True, fused_mbconv=True)
    plain = model_of(bf16)                                        # every kernel off
    cm = m_default.confusion
    check(int(cm.sum()) == valid and cm.shape == (21, 21),
          f"eval, default: the (21, 21) matrix counts every valid label pixel "
          f"({int(cm.sum())} == {valid})")
    same_logits = accumulate_confusion(library_step(served), Resident(), 21, "cuda")
    check(np.array_equal(cm, same_logits),
          "eval, default: the matrix EQUALS torch.argmax + bincount on the same model's "
          f"logits (sum|diff| {int(np.abs(cm - same_logits).sum())})")
    # Every kernel off: the plain ASPP branch rounds its depthwise output to
    # bf16 twice where the kernel's route rounds once, so bf16 logits differ
    # by ulps and near-tie pixels flip; each flip moves two cells.
    no_kernels = accumulate_confusion(library_step(plain), Resident(), 21, "cuda")
    flips = int(np.abs(cm - no_kernels).sum()) // 2
    check(int(no_kernels.sum()) == valid and flips <= 0.01 * valid,
          f"eval, default vs every kernel off (bf16, torch.argmax + bincount): {flips} of "
          f"{valid} pixels counted in another cell (<= 1 %; equal: {flips == 0})")
    kern32 = accumulate_confusion(make_eval_step(model_of(f32, fused_aspp=True), 21),
                                  Resident(), 21, "cuda")
    plain32 = accumulate_confusion(library_step(model_of(f32)), Resident(), 21, "cuda")
    flips32 = int(np.abs(kern32 - plain32).sum()) // 2
    check(flips32 <= 1e-4 * valid,
          f"eval in f32, ASPP + confusion kernels vs every kernel off: {flips32} of {valid} "
          f"pixels counted in another cell (<= 0.01 %; equal: {flips32 == 0})")
    masks = {"default": masks_of(served), "--fused_mbconv": masks_of(with_mbconv)}
    agree = (masks["default"] == masks["--fused_mbconv"]).float().mean().item()
    check(agree >= 0.98, f"eval, --fused_mbconv vs default: masks agree on {agree:.5f} of "
                         "pixels (>= 0.98)")
    # for the record: each bf16 route against the f32 model with every kernel off
    # (the kernel keeps the block's weights f32, the standard route rounds them)
    masks32 = masks_of(model_of(f32))
    print("  masks against the f32 model with no kernel: " + ", ".join(
        f"{name} {(m == masks32).float().mean().item():.5f}" for name, m in masks.items()))
    check(abs(m_mbconv.miou - m_default.miou) <= 0.005 and int(m_mbconv.confusion.sum()) == valid,
          f"eval, --fused_mbconv: mIoU {m_mbconv.miou:.5f} within 0.005 of the default's "
          f"{m_default.miou:.5f}, every valid pixel counted")
    logits = served(preprocess_eval_batch(torch.from_numpy(host_batches[0][0]).cuda(),
                                          torch.from_numpy(host_batches[0][1]).cuda(),
                                          21)[0].permute(0, 3, 1, 2))
    check(logits.permute(0, 2, 3, 1).is_contiguous() and logits.dtype == f32,
          "the model's f32 logits are channels_last: the kernel's NHWC view is no copy")
    state = {"ds": ds, "resident": Resident(), "served": served, "with_mbconv": with_mbconv,
             "plain": plain, "library_step": library_step, "batch": host_batches[0]}
    return (l_default, l_mbconv), state


def eval_numbers(torch, state) -> None:
    """Images/s of the eval loop (host clock around the shared accumulation
    loop, which ends in the matrix's copy to the host): as the CLI builds it,
    with `--fused_mbconv`, and with no kernel (plain ASPP, torch.argmax +
    bincount), in turns N D M M D N; through the dataset (JPEG decode
    included) and on the decoded batches. Then the profile of one batch."""
    from deeplabv3p_torch.train import accumulate_confusion, make_eval_step

    steps = {"no kernels": state["library_step"](state["plain"]),
             "default (ASPP + confusion kernels)": make_eval_step(state["served"], 21),
             "--fused_mbconv": make_eval_step(state["with_mbconv"], 21)}
    card = card_line()
    for source, data, rounds in (("through the dataset (decode included)", state["ds"], 1),
                                 ("on decoded batches", state["resident"], 3)):
        for step in steps.values():
            accumulate_confusion(step, data, 21, "cuda")  # warm-up
        times = {name: [] for name in steps}
        for name in [*steps, *reversed(steps)]:
            for _ in range(rounds):
                torch.cuda.synchronize()
                t = time.perf_counter()
                accumulate_confusion(steps[name], data, 21, "cuda")
                times[name].append(time.perf_counter() - t)
        print(f"eval loop, mobilenetv2 OS16 512x512 b{EVAL_BATCH} bf16, {TRAIN_IMAGES} images a "
              f"pass, {source}, in turns N D M M D N  [{card}]:")
        for name, ts in times.items():
            med = statistics.median(ts)
            print(f"  {name}: median {med * 1e3:.2f} ms a pass over {len(ts)} passes "
                  f"(min {min(ts) * 1e3:.2f}, max {max(ts) * 1e3:.2f}), "
                  f"{TRAIN_IMAGES / med:.1f} img/s")
    images = torch.from_numpy(state["batch"][0]).cuda()
    labels = torch.from_numpy(state["batch"][1]).cuda()
    step = steps["default (ASPP + confusion kernels)"]
    profile_one(torch, lambda: step(images, labels), "one eval batch (b8, device-resident)",
                "profile_one_eval_batch.txt", top=14)
    step = steps["--fused_mbconv"]
    profile_one(torch, lambda: step(images, labels), "one eval batch with --fused_mbconv",
                "profile_one_eval_batch_fused_mbconv.txt", top=8)


# -- UNet, Fast-SCNN and the subpixel head ---------------------------------------


def conv_flops(torch, model_type, num_classes, input_hw, batch: int = 1) -> float:
    """Forward operations of the model's convolutions (2 a multiply-add),
    counted from each conv's shapes on the meta device: output pixels x
    output channels x the kernel's taps over its input channels a group; a
    transpose conv's input pixels instead of its output's (each scatters its
    kernel once)."""
    from deeplabv3p_torch.models.factory import build_segmentation_model
    from deeplabv3p_torch.models.layers import Conv, ConvTransposeK

    model = build_segmentation_model(model_type, num_classes, device="meta")
    total = [0]

    def count(m, args, out):
        w = m.weight
        pixels = args[0] if isinstance(m, ConvTransposeK) else out
        total[0] += (2 * pixels.shape[0] * pixels.shape[2] * pixels.shape[3]
                     * w.shape[0] * w.shape[1] * w.shape[2] * w.shape[3])

    for m in model.modules():
        if isinstance(m, Conv):
            m.register_forward_hook(count)
    with torch.no_grad():
        model(torch.zeros(batch, 3, *input_hw, device="meta"))
    return float(total[0])


def family_serving(torch, kernels, runs) -> None:
    """Each (model type, classes file, input (h, w), requests) of `runs`
    served through `DeepLab` as built by default (bf16, b1): no kernel on
    the path (no ASPP, decoder or loss tail), masks of the requests' sizes,
    against the same weights in f32 (>= 0.98 of pixels), latency over two
    turns; for unet_standard one request profiled, its convolutions' device
    time against their bound (`conv_flops` over the dense bf16 rate)."""
    from deeplabv3p_torch.inference import DeepLab
    from deeplabv3p_torch.utils.card import BF16_TENSOR_FLOPS

    card = card_line()
    for model_type, classes, input_hw, reqs in runs:
        common = dict(model_type=model_type, classes_path=classes, model_input_shape=input_hw,
                      device="cuda")
        served = DeepLab(**common)
        plain = DeepLab(dtype=torch.float32, **common)
        for data, hw in reqs[:WARMUP]:
            served.predict(data, hw)
        kernels.reset_launch_counts()                # this path starts here
        masks, times = serve_requests(torch, served, reqs)
        launches = kernels.launch_counts()           # ... and ends here
        check(launches == ZERO_LAUNCHES,
              f"{model_type} serving: no kernel on its path (no ASPP, decoder or loss tail): "
              f"{launches}")
        n_cls = served.num_classes
        ref_masks = [plain.predict(data, hw) for data, hw in reqs]
        agree = min(float((m == r).mean()) for m, r in zip(masks, ref_masks))
        shapes_ok = all(m.shape == hw and m.dtype == np.int32 and m.min() >= 0 and m.max() < n_cls
                        for m, (_, hw) in zip(masks, reqs))
        check(shapes_ok and agree >= 0.98,
              f"{model_type} serving at {input_hw[0]}x{input_hw[1]}, {n_cls} classes, bf16 vs "
              f"f32: masks of the requests' sizes {sorted(set(hw for _, hw in reqs))} agree on "
              f">= 0.98 of pixels (min {agree:.5f})")
        times += serve_requests(torch, served, reqs)[1]
        med = statistics.median(times)
        print(f"  {model_type} latency, {len(times)} requests in two turns (host clock around "
              f"predict, synchronized): median {med:.3f} ms, p90 "
              f"{float(np.percentile(times, 90)):.3f} ms  [{card}]")
        if model_type == "unet_standard":
            flops = conv_flops(torch, model_type, n_cls, input_hw)
            bound_ms = flops / BF16_TENSOR_FLOPS * 1e3
            prof = profile_one(torch, lambda: served.predict(*reqs[0]),
                               "one unet_standard request", "profile_one_request_unet_standard.txt",
                               top=10)
            conv_us = None if prof is None else sum(
                e.device_time_total for e in prof[0] if e.key == "aten::convolution")
            print(f"  unet_standard request: convolutions {flops / 1e9:.1f} GFLOP, bound "
                  f"{bound_ms:.3f} ms at the dense bf16 rate; their device time (aten::convolution) "
                  + ("not measured" if not conv_us else
                     f"{conv_us / 1e3:.3f} ms, {bound_ms * 1e3 / conv_us:.3f} of the bound; "
                     f"device busy {prof[1] / 1e3:.3f} ms") + f"; median request {med:.3f} ms, "
                  f"{bound_ms / med:.3f} of the bound  [{card}]")
        del served, plain
        torch.cuda.empty_cache()


def bn_fed_biases(torch, model_type, num_classes) -> set:
    """Names of the conv biases whose conv output goes straight into a
    BatchNorm, found by hooks on a meta-device forward."""
    from deeplabv3p_torch.models.factory import build_segmentation_model
    from deeplabv3p_torch.models.layers import BatchNorm, Conv

    model = build_segmentation_model(model_type, num_classes, device="meta")
    outputs, fed = {}, set()
    for name, m in model.named_modules():
        if isinstance(m, Conv) and m.bias is not None:
            # the output is kept, so that its id is not reused by another tensor
            m.register_forward_hook(
                lambda m, a, out, name=name: outputs.update({id(out): (name, out)}))
        elif isinstance(m, BatchNorm):
            m.register_forward_pre_hook(
                lambda m, a: fed.add(outputs[id(a[0])][0]) if id(a[0]) in outputs else None)
    with torch.no_grad():
        model(torch.zeros(1, 3, 64, 64, device="meta"))
    return {f"{name}.bias" for name in fed}


def nearest_resize_on_card(torch) -> None:
    """`resize_nearest_nchw` on the card against the CPU's (held to JAX's
    cv2 indices by tests/test_torch_unet.py) at Fast-SCNN's Cityscapes
    shapes: the 4x of the pyramid's 640 channels and the 8x of the logits."""
    from deeplabv3p_torch.ops.resize import resize_nearest_nchw

    gen = torch.Generator().manual_seed(6)
    for shape, k in (((8, 640, 32, 64), 4), ((8, 19, 128, 256), 8), ((2, 5, 37, 29), 3)):
        x = torch.randn(shape, generator=gen).to(torch.bfloat16)
        size = (shape[2] * k, shape[3] * k)
        got = resize_nearest_nchw(x.cuda().contiguous(memory_format=torch.channels_last), size)
        check(torch.equal(got.cpu(), resize_nearest_nchw(x, size)),
              f"nearest resize x{k} of {shape} on the card equals the CPU's")


def half_ulp_toward(torch, value, update):
    """Half the f32 spacing from `value` toward `value - update`: an update
    no larger than it rounds away (to the nearest even at a tie)."""
    toward = torch.where(update > 0, -torch.inf, torch.inf).to(value.dtype)
    return (torch.nextafter(value, toward) - value).abs() / 2


class StageOneUpdates:
    """What the first optimizer stepped inside this scope (a train CLI's
    stage 1) did to each of its parameters, read through torch's global
    optimizer step hook: SGD's update is lr x its momentum buffer. `held`
    maps each parameter of its groups to [some step's update was nonzero,
    every step's update was at most half an f32 ulp of the value it met]; a
    parameter outside its groups has no entry."""

    def __init__(self, torch):
        self.torch = torch
        self.optimizer = None
        self.held: dict = {}

    def __enter__(self):
        from torch.optim.optimizer import register_optimizer_step_post_hook

        self.handle = register_optimizer_step_post_hook(self._after_step)
        return self

    def __exit__(self, *exc):
        self.handle.remove()

    def _after_step(self, optimizer, args, kwargs) -> None:
        if self.optimizer is None:
            self.optimizer = optimizer
        if optimizer is not self.optimizer:
            return
        for group in optimizer.param_groups:
            for p in group["params"]:
                held = self.held.setdefault(p, [False, True])
                buf = optimizer.state.get(p, {}).get("momentum_buffer")
                if buf is None:  # no gradient yet: no update
                    continue
                update = group["lr"] * buf.float()
                value = p.detach().float()
                held[0] = held[0] or bool((update != 0).any())
                held[1] = held[1] and bool(
                    (update.abs() <= half_ulp_toward(self.torch, value, update)).all())


def unmoved_faults(record: StageOneUpdates, params: dict, unmoved) -> list[str]:
    """The parameters of `unmoved` (names of `params` whose values did not
    change) that the optimizer did not update: outside its groups (frozen),
    with no nonzero update (a zero gradient), or with an update above half
    an ulp, which rounding cannot swallow; each as "name: reason"."""
    faults = []
    for name in unmoved:
        held = record.held.get(params[name])
        if held is None:
            faults.append(f"{name}: outside the optimizer's groups")
        elif not held[0]:
            faults.append(f"{name}: no nonzero update")
        elif not held[1]:
            faults.append(f"{name}: an update above half an ulp, yet unmoved")
    return faults


def family_training_path(torch, kernels, train_main, train_args, classes_path, root,
                         model_type, input_hw, images: int = FAMILY_TRAIN_IMAGES) -> None:
    """`python -m deeplabv3p_torch.train --model_type <model_type>` b8 bf16
    at `input_hw`, --no_augment, the CLI's own freeze level (1) and SGD
    1e-2, 1 + 1 epochs on the first `images` pairs of `root`: no kernel on
    the path, finite losses, and stage 1 updated every parameter (no
    parameter is under `backbone`, as JAX's mask has it): each moved from
    the seeded init, or the stage's SGD gave it nonzero updates that were
    each under half an f32 ulp of its value, which rounding swallows
    (`StageOneUpdates`); the peak memory of the run."""
    import shutil

    from deeplabv3p_torch.models.factory import build_segmentation_model, trainable_parameters
    from deeplabv3p_torch.models.layers import init_parameters
    from deeplabv3p_torch.utils.config import get_classes
    from deeplabv3p_torch.utils.weights import from_jax_variables, load_npz

    num_classes = len(get_classes(classes_path))
    list_path = os.path.join(root, f"list{images}.txt")
    with open(list_path, "w") as f:
        f.write("\n".join(f"s{i:03d}" for i in range(images)) + "\n")
    log_dir = os.path.join(OUT_DIR, f"smoke_{model_type}_train_logs")
    shutil.rmtree(log_dir, ignore_errors=True)
    argv = ["--model_type", model_type, "--model_input_shape", f"{input_hw[0]}x{input_hw[1]}",
            "--batch_size", str(MODEL_TRAIN_BATCH), "--no_augment",
            "--transfer_epoch", "1", "--total_epoch", "2", "--seed", str(TRAIN_SEED),
            "--dataset_path", root, "--dataset_file", list_path,
            "--classes_path", classes_path, "--log_dir", log_dir, "--device", "cuda"]
    print("  python -m deeplabv3p_torch.train " + " ".join(argv))
    torch.cuda.reset_peak_memory_stats()
    with StageOneUpdates(torch) as record:
        trainer, wall, launches, _ = run_cli(torch, kernels, train_main, train_args(argv))
    steps = 2 * (images // MODEL_TRAIN_BATCH)
    losses = [r["loss"] for r in trainer.history]
    print(f"  {model_type}: {steps} steps in {wall:.1f} s wall (set-up and first-call cuDNN "
          f"tuning included), peak memory {torch.cuda.max_memory_allocated() / 2**20:.1f} MiB, "
          f"epoch losses {[round(x, 5) for x in losses]}, L2 factor {trainer.l2_factor:g}; "
          f"launch counts {launches}  [{card_line()}]")
    check(launches == ZERO_LAUNCHES, f"{model_type} training: no kernel on its path")
    check(len(losses) == 2 and all(np.isfinite(losses)),
          f"{model_type} training: 2 epochs, finite losses")
    init = build_segmentation_model(model_type, num_classes, device="cpu")
    init_parameters(init, torch.Generator().manual_seed(TRAIN_SEED), bn_identity=True)
    start = {k: p.detach().clone() for k, p in init.named_parameters()}
    stage1 = load_npz(os.path.join(log_dir, next(p for p in sorted(os.listdir(log_dir))
                                                  if p.startswith("ep000-"))))
    init.load_state_dict(from_jax_variables(stage1, init), strict=True)
    unmoved = [k for k, p in init.named_parameters() if torch.equal(p, start[k])]
    # a conv's bias straight into a training-mode BN: the batch mean removes
    # it, so its gradient is zero but for rounding and it may not move; it is
    # held to the optimizer's group at level 1 instead, as every parameter is
    exempt = bn_fed_biases(torch, model_type, num_classes)
    group = {n for n, _ in trainable_parameters(init, 1)}
    check(group == set(start),
          f"{model_type} at the CLI's --freeze_level 1: the optimizer's group holds every "
          f"parameter ({len(group)}/{len(start)}), {len(exempt)} biases straight into a "
          "training-mode BN among them, as JAX's mask trains all with no backbone")
    params = dict(trainer.model.named_parameters())
    still = [k for k in unmoved if k not in exempt]
    faults = unmoved_faults(record, params, still)
    check(isinstance(record.optimizer, torch.optim.SGD) and not faults,
          f"{model_type} stage 1 at the CLI's --freeze_level 1 updated every parameter but "
          f"biases straight into a training-mode BN: {len(start) - len(unmoved)}/{len(start)} "
          f"moved, {len(still) - len(faults)} more took only updates under half an f32 ulp "
          f"({sorted(set(still) - {f.split(':')[0] for f in faults}) or 'none'}); "
          f"not updated: {faults or 'none'}")
    del trainer
    torch.cuda.empty_cache()


def subpixel_head(torch, kernels, requests) -> dict:
    """mobilenetv2 with the subpixel head (scale 4), 512x512 OS16, seeded
    weights: the forward in f32 with the ASPP and decoder kernels against f32
    with none (argmax equal on >= 0.999 of pixels, every full head's rule),
    each kernel once a forward; then bf16 with both kernels, finite. Returns
    the kernel-on run's launch counts."""
    from deeplabv3p_torch.models.factory import build_segmentation_model
    from deeplabv3p_torch.models.layers import init_parameters

    def make(dtype, fused):
        m = build_segmentation_model("mobilenetv2", 21, use_subpixel=True, fused_aspp=fused,
                                     fused_decoder=fused, dtype=dtype, device="cuda")
        init_parameters(m, torch.Generator().manual_seed(0))
        return m

    xs = [torch.from_numpy(data).cuda().permute(0, 3, 1, 2) for data, _ in requests]
    plain, fused, fused16 = make(torch.float32, False), make(torch.float32, True), \
        make(torch.bfloat16, True)
    with torch.inference_mode():
        refs = [plain(x) for x in xs]
        kernels.reset_launch_counts()                # this path starts here
        outs = [fused(x) for x in xs]
        launches = kernels.launch_counts()           # ... and ends here
        outs16 = [fused16(x) for x in xs]
    n = len(xs)
    check(launches == {**ZERO_LAUNCHES, "multirate_atrous_depthwise": n,
                       "fused_decoder_frontend": n},
          f"subpixel head: the ASPP and decoder kernels once a forward each ({n}): {launches}")
    agree = min(float((o.argmax(1) == r.argmax(1)).float().mean()) for o, r in zip(outs, refs))
    err = max(float((o - r).abs().max()) for o, r in zip(outs, refs))
    agree16 = min(float((o.argmax(1) == r.argmax(1)).float().mean()) for o, r in zip(outs16, refs))
    shapes = {tuple(o.shape) for o in outs + outs16}
    check(shapes == {(1, 21, *INPUT)} and all(torch.isfinite(o).all() for o in outs + outs16)
          and agree >= 0.999,
          f"mobilenetv2 subpixel head (scale {fused.subpixel.r}) at {INPUT}: f32 with both "
          f"kernels vs f32 with none, argmax equal on {agree:.5f} >= 0.999 of pixels (max|d| "
          f"{err:.3g}); bf16 with both kernels finite, argmax equal to f32's on {agree16:.5f}  "
          f"[{card_line()}]")
    del plain, fused, fused16
    torch.cuda.empty_cache()
    return launches


# -- the dense CRF (postprocess.py, torch ops: no kernel of its own) ------------


def crf_pair(stem: str, hw) -> tuple:
    """(image (h, w, 3) f32 0..255, labels compacted to 0..n-1 int32) of an
    example/ pair, resized as tests/test_crf_parity.py resizes them."""
    from deeplabv3p_torch.tools.crf_parity_study import compact, load_pair

    image, mask = load_pair(stem, *hw)
    return image, compact(mask)[0]


def crf_mask(k: int, hw, seed: int = 0) -> np.ndarray:
    """A seeded (h, w) int32 mask of k blob-shaped regions, every label present."""
    rng = np.random.default_rng(seed)
    h, w = hw
    fields = [np.kron(rng.uniform(0, 1, (h // 64 + 1, w // 64 + 1)), np.ones((64, 64)))[:h, :w]
              for _ in range(k)]
    mask = np.argmax(np.stack(fields, -1), -1).astype(np.int32)
    mask.flat[:k] = np.arange(k)  # all k present whatever the draw
    return mask


def crf_card_vs_cpu(torch, pp) -> None:
    """`crf_inference` on the card against the same function on the CPU: both
    example pairs at 48x64 (space_step 4) and 512x512 (the defaults), with 21-
    and 2-class unaries; then two calls on the card bit-equal."""
    print("dense CRF (postprocess.crf_inference, torch ops) on the card vs the same on the CPU:")
    for stem in CRF_PAIRS:
        for hw, kw in (((48, 64), {"space_step": 4}), (INPUT, {})):
            image, labels = crf_pair(stem, hw)
            for n, lab in ((21, labels), (2, (labels > 0).astype(np.int32))):
                unary, img = pp.unary_from_labels(torch.from_numpy(lab), n), torch.from_numpy(image)
                q_cpu = pp.crf_inference(unary, img, **kw)
                q_card = pp.crf_inference(unary.cuda(), img.cuda(), **kw)
                d = (q_card.cpu() - q_cpu).abs()
                agree = float((q_card.argmax(-1).cpu() == q_cpu.argmax(-1)).float().mean())
                check(bool(torch.isfinite(q_card).all()) and agree >= 0.999,
                      f"{stem} {hw[0]}x{hw[1]} {kw or 'defaults'}, {n}-class unary: max|dQ| "
                      f"{d.max():.3g}, mean|dQ| {d.mean():.3g}, argmax agreement {agree:.5f} "
                      f">= 0.999")
    image, labels = crf_pair(CRF_PAIRS[1], INPUT)
    img = torch.from_numpy(image).cuda()
    for n, lab in ((21, labels), (2, (labels > 0).astype(np.int32))):
        unary = pp.unary_from_labels(torch.from_numpy(lab).cuda(), n)
        same = torch.equal(pp.crf_inference(unary, img), pp.crf_inference(unary, img))
        check(same, f"two crf_inference calls on the card, 512x512, {n}-class unary: Q bit-equal")


def crf_oracle_on_card(torch, pp) -> None:
    """The grid against `crf_exact_dense` (f64) on the card, with
    tests/test_crf_parity.py's inputs and floors at 48x64; then the full tier
    at 128x170, printed with no floor."""
    def agree(a, b, sel=None):
        return float((a[sel] == b[sel]).float().mean()) if sel is not None else \
            float((a == b).float().mean())

    print("dense CRF: the grid against the exact dense oracle, both on the card:")
    h, w = 40, 56
    labels = torch.from_numpy((np.random.RandomState(0).rand(h, w) > 0.5).astype(np.int32)).cuda()
    image = torch.full((h, w, 3), 127.0, device="cuda")
    unary = pp.unary_from_labels(labels, 2)
    params = dict(compat_bilateral=0.0)
    q_g = pp.crf_inference(unary, image, **params)
    q_ref = pp.crf_exact_dense(unary, image, **params)
    mae, a = float((q_g - q_ref).abs().mean()), agree(q_g.argmax(-1), q_ref.argmax(-1))
    check(mae < 1e-3 and a > 0.995,
          f"spatial-only 40x56: q_mae {mae:.3g} < 1e-3, argmax agreement {a:.5f} > 0.995")
    image = torch.zeros((h, w, 3), device="cuda")
    image[:, w // 2:] = 255.0
    labels = torch.zeros((h, w), dtype=torch.int32, device="cuda")
    labels[:, w // 2 + 2:] = 1
    unary = pp.unary_from_labels(labels, 2)
    params = dict(compat_gaussian=0.0, sxy_bilateral=10.0)
    q_g = pp.crf_inference(unary, image, space_step=4, n_bins=8, color_features="luma", **params)
    q_ref = pp.crf_exact_dense(unary, image, bilateral_features="luma", **params)
    mae, a = float((q_g - q_ref).abs().mean()), agree(q_g.argmax(-1), q_ref.argmax(-1))
    check(a > 0.97 and mae < 0.05,
          f"bilateral-only (luma) 40x56: argmax agreement {a:.5f} > 0.97, q_mae {mae:.3g} < 0.05")
    for hw, steps in (((48, 64), (4,)), ((128, 170), (4, 16))):
        for stem in CRF_PAIRS:
            image, labels = crf_pair(stem, hw)
            image, labels = torch.from_numpy(image).cuda(), torch.from_numpy(labels).cuda()
            unary = pp.unary_from_labels(labels, int(labels.max()) + 1)
            params = dict(sxy_bilateral=80.0 / (500.0 / hw[1]))
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            m_rgb = pp.crf_exact_dense(unary, image, **params).argmax(-1)
            torch.cuda.synchronize()
            t_oracle = time.perf_counter() - t0
            delta = m_rgb != labels
            for step in steps:
                m_g = pp.crf_inference(unary, image, space_step=step, **params).argmax(-1)
                a_all, a_delta = agree(m_g, m_rgb), agree(m_g, m_rgb, delta)
                text = (f"full CRF {stem} {hw[0]}x{hw[1]} (sxy_bilateral "
                        f"{params['sxy_bilateral']:.2f}, space_step {step}; oracle {t_oracle:.2f} "
                        f"s, changed {float(delta.float().mean()):.2%} of pixels): agree_all "
                        f"{a_all:.4f}, agree_delta {a_delta:.4f}")
                if hw == (48, 64):
                    check(bool(delta.any()) and a_all > 0.95 and a_delta > 0.75,
                          text + " (floors 0.95, 0.75)")
                else:
                    print(f"  {text} (no floor)  [{card_line()}]")
    torch.cuda.empty_cache()


def crf_serving(torch, kernels, DeepLab, pp, common, served, requests, city) -> dict:
    """`DeepLab(mobilenetv2, do_crf=True)`, bf16 b1: CRF_REQUESTS requests with
    the counts set to 0 just before and read just after (the ASPP kernel once
    a request, no other kernel), masks of the requests' sizes, one request's
    mask against the CRF run on the CPU on the same pre-resize mask; then in
    turns with the same requests without the CRF (P C C P); then fast_scnn
    at 1024x2048 with 19 classes and the CRF, 2 requests. Returns the counted
    run's launch counts."""
    from deeplabv3p_torch.inference import denormalize_image

    crf = DeepLab(do_crf=True, **common)
    reqs = requests[:CRF_REQUESTS]
    serve_requests(torch, crf, reqs[:WARMUP])
    kernels.reset_launch_counts()                    # the CRF serving path starts here
    masks, times = serve_requests(torch, crf, reqs)
    launches = kernels.launch_counts()               # ... and ends here
    check(launches == {**ZERO_LAUNCHES, "multirate_atrous_depthwise": CRF_REQUESTS},
          f"DeepLab(do_crf=True): launch counts {launches} (ASPP one a request, every other "
          "kernel none)")
    plain_masks, _ = serve_requests(torch, served, reqs)
    moved = [int((m != p).sum()) for m, p in zip(masks, plain_masks)]
    check(all(m.shape == hw and m.dtype == np.int32 and 0 <= m.min() and m.max() < 21
              for m, (_, hw) in zip(masks, reqs)) and sum(moved) > 0,
          f"CRF masks of the requests' sizes, labels in [0, 21); the CRF moved {moved} pixels "
          "a request against the same model without it")
    data, hw = reqs[0]
    with torch.inference_mode():
        x = torch.from_numpy(data).cuda()
        mask = pp.mask_argmax(crf.model(x.permute(0, 3, 1, 2)), dim=1)[0]
        on_cpu = pp.crf_postprocess(denormalize_image(x[0]).cpu(), mask.cpu())
    want = pp.mask_resize(on_cpu, hw).numpy()
    agree = float((masks[0] == want).mean())
    check(agree >= 0.999, f"served CRF mask vs the same pre-resize mask refined on the CPU: "
                          f"{agree:.5f} >= 0.999 of pixels equal")
    pooled = {"no CRF": [], "CRF": []}
    for name in ("no CRF", "CRF", "CRF", "no CRF"):
        pooled[name] += serve_requests(torch, crf if name == "CRF" else served, reqs)[1]
    pooled["CRF"] += times
    print(f"serving mobilenetv2 bf16 b1, {CRF_REQUESTS} requests a turn (P C C P, and the "
          "counted run):")
    for name, ts in pooled.items():
        print(f"  {name}: median {statistics.median(ts):.3f} ms, p90 "
              f"{float(np.percentile(ts, 90)):.3f} ms over {len(ts)} requests  [{card_line()}]")
    fast = DeepLab(model_type="fast_scnn", classes_path=city[0], model_input_shape=CITYSCAPES_HW,
                   device="cuda", do_crf=True)
    serve_requests(torch, fast, city[1][:1])
    kernels.reset_launch_counts()
    fmasks, ftimes = serve_requests(torch, fast, city[1][:2])
    flaunch = kernels.launch_counts()
    n_labels = [len(np.unique(m)) for m in fmasks]
    check(flaunch == ZERO_LAUNCHES and all(m.shape == hw for m, (_, hw) in zip(fmasks, city[1]))
          and all(0 <= m.min() and m.max() < 19 for m in fmasks),
          f"fast_scnn with the CRF at {CITYSCAPES_HW[0]}x{CITYSCAPES_HW[1]}, 19 classes: masks "
          f"of the requests' sizes, no kernel on the path; {n_labels} labels; "
          f"{', '.join(f'{t:.3f}' for t in ftimes)} ms  [{card_line()}]")
    del crf, fast
    torch.cuda.empty_cache()
    return launches


def crf_times(torch, pp) -> None:
    """`crf_postprocess` alone at 512x512 with 2, 5 and 21 labels (CUDA-event
    ms an image, device launches a call by the profiler), and `crf_inference`
    in rgb and luma modes on those unaries; one call profiled."""
    image, _ = crf_pair(CRF_PAIRS[1], INPUT)
    img_u8 = torch.from_numpy(image).cuda().to(torch.uint8)
    img = img_u8.float()
    print(f"dense CRF times at {INPUT[0]}x{INPUT[1]} (CUDA events, mean of 10 calls after 5; "
          "launches: device operations a call by the profiler):")
    for k in CRF_LABEL_COUNTS:
        mask = torch.from_numpy(crf_mask(k, INPUT)).cuda()
        unary = pp.unary_from_labels(mask, k)
        rows = [("crf_postprocess", lambda: pp.crf_postprocess(img_u8, mask))]
        rows += [(f"crf_inference {mode}",
                  lambda mode=mode: pp.crf_inference(unary, img, color_features=mode))
                 for mode in ("rgb", "luma")]
        for name, fn in rows:
            ms = event_ms(fn, 10)
            dev_us, n_ops = device_us(torch, fn, calls=3)
            print(f"  {k:2d} labels, {name}: {ms:.3f} ms an image, device busy "
                  f"{us_text(dev_us, 1)} in {n_ops:.0f} operations a call  [{card_line()}]")
    mask = torch.from_numpy(crf_mask(21, INPUT)).cuda()
    profile_one(torch, lambda: pp.crf_postprocess(img_u8, mask),
                "one crf_postprocess (512x512, 21 labels, rgb)", "profile_one_crf.txt")


def crf_evaluation_path(torch, kernels, classes_path, root) -> dict:
    """`python -m deeplabv3p_torch.eval --do_crf` on the first 16 synthetic
    pairs (2 batches of b8) with evaluation_path's seeded mobilenetv2 .npz:
    the ASPP and confusion kernels once a batch, no other kernel, and the
    matrix EQUAL to the one built image by image from the same model's b8
    logits: argmax -> crf_postprocess -> bincount. Returns the launch
    counts."""
    from deeplabv3p_torch import eval as eval_cli
    from deeplabv3p_torch import metrics as metrics_lib
    from deeplabv3p_torch import postprocess as pp
    from deeplabv3p_torch.data.augment import preprocess_eval_batch
    from deeplabv3p_torch.data.pipeline import SegmentationDataset
    from deeplabv3p_torch.models.factory import build_segmentation_model
    from deeplabv3p_torch.utils.weights import from_jax_variables, load_npz

    weights = os.path.join(OUT_DIR, "smoke_eval_weights.npz")  # evaluation_path's
    with open(os.path.join(root, "list.txt")) as f:
        ids = f.read().split()[:CRF_EVAL_IMAGES]
    list_path = os.path.join(OUT_DIR, "smoke_crf_eval_list.txt")
    with open(list_path, "w") as f:
        f.write("\n".join(ids) + "\n")
    argv = eval_argv(weights, root, classes_path, os.path.join(OUT_DIR, "smoke_crf_eval"),
                     "--do_crf")
    argv[argv.index(os.path.join(root, "list.txt"))] = list_path
    print("  python -m deeplabv3p_torch.eval " + " ".join(argv))
    m, wall, launches, _ = run_cli(torch, kernels, eval_cli.main, eval_cli.parse_args(argv))
    batches = CRF_EVAL_IMAGES // EVAL_BATCH
    print(f"  eval --do_crf: {wall:.2f} s wall for {CRF_EVAL_IMAGES} images (set-up included), "
          f"mIoU {m.miou:.5f} (seeded weights); launch counts {launches}  [{card_line()}]")
    check(launches == {**ZERO_LAUNCHES, "confusion_matrix_fused": batches,
                       "multirate_atrous_depthwise": batches},
          f"eval --do_crf b{EVAL_BATCH}: the ASPP and confusion kernels once a batch ({batches})")
    model = build_segmentation_model("mobilenetv2", 21, fused_aspp=True, dtype=torch.bfloat16,
                                     device="cuda")
    model.load_state_dict(from_jax_variables(load_npz(weights), model), strict=True)
    model.eval()
    ds = SegmentationDataset(root, ids, batch_size=EVAL_BATCH, num_classes=21,
                             input_shape=INPUT, augment=False, shuffle=False,
                             drop_remainder=False)
    want = torch.zeros((21, 21), dtype=torch.int64, device="cuda")
    plain = torch.zeros_like(want)
    with torch.no_grad():
        for images_u8, labels_u8, _ in ds.epoch_batches():
            images_u8 = torch.from_numpy(images_u8).cuda()
            images, labels = preprocess_eval_batch(
                images_u8, torch.from_numpy(labels_u8).cuda(), num_classes=21)
            preds = torch.argmax(model(images.permute(0, 3, 1, 2)), dim=1).to(torch.int32)
            for b in range(preds.shape[0]):
                refined = pp.crf_postprocess(images_u8[b], preds[b])
                want += metrics_lib.confusion_matrix(labels[b], refined, 21)
                plain += metrics_lib.confusion_matrix(labels[b], preds[b], 21)
    want, plain = want.cpu().numpy(), plain.cpu().numpy()
    moved = int(np.abs(want - plain).sum()) // 2
    check(np.array_equal(m.confusion, want) and moved > 0,
          f"eval --do_crf: the matrix EQUALS argmax -> crf_postprocess -> bincount image by "
          f"image (sum|diff| {int(np.abs(m.confusion - want).sum())}); the CRF moved {moved} "
          "counted pixels")
    del model
    torch.cuda.empty_cache()
    return launches


# -- export, the embedded runner and int8 (export/, runtime.py) -----------------


def host_us(torch, fn, calls: int = 1000) -> float:
    """Host time in us a call of fn(): the wall of `calls` back-to-back calls
    before the closing synchronize (the calls only enqueue their kernels,
    which take less than that on the card)."""
    for _ in range(20):
        fn()
    torch.cuda.synchronize()
    t = time.perf_counter()
    for _ in range(calls):
        fn()
    us = (time.perf_counter() - t) / calls * 1e6
    torch.cuda.synchronize()
    return us


def synced_ms(torch, fn, calls: int) -> float:
    """Median ms of `calls` calls of fn(), each on the host clock between two
    synchronizes."""
    times = []
    for _ in range(calls):
        torch.cuda.synchronize()
        t = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t) * 1e3)
    return statistics.median(times)


def op_host_cost(torch, kaspp, kdec, kmb) -> None:
    """Host us a call of each operator's wrapper (the model's path: the
    `deeplabv3p::` operator through the dispatcher) against its CUDA
    implementation called bare (the wrapper before the operators), and for
    the ASPP kernel also through a `torch.library.custom_op` of the same
    implementation, in turns; the serving shapes, bf16."""
    aspp = aspp_case(torch, ASPP_CASES[0][0], ASPP_CASES[0][1], torch.bfloat16, seed=3)
    x, k, r, s, b = aspp

    @torch.library.custom_op("chip_smoke::aspp", mutates_args=(), device_types="cuda",
                             schema="(Tensor x, Tensor kernels, int[] rates, Tensor? scale, "
                                    "Tensor? bias) -> Tensor")
    def as_custom_op(x, kernels, rates, scale, bias):
        return kaspp._launch(x, kernels, rates, scale, bias)

    dec = decoder_case(torch, *DECODER_CASES[0], torch.bfloat16, seed=3)
    shape = body_block_shapes(1, INPUT)[0]
    blk = mbconv_case(torch, shape, torch.bfloat16)
    prep = kmb.prepare_inverted_residual(*blk[1:], rate=shape[6], elem_size=2)
    cfg = prep.config
    cases = {
        "multirate_atrous_depthwise": {
            "bare": lambda: kaspp._launch(x, k, list(r), s, b),
            "op": lambda: kaspp.multirate_atrous_depthwise(x, k, r, s, b),
            "custom_op": lambda: as_custom_op(x, k, list(r), s, b)},
        "fused_decoder_frontend": {
            "bare": lambda: kdec._launch(*dec), "op": lambda: kdec.fused_decoder_frontend(*dec)},
        f"fused_inverted_residual {shape[:6]}": {
            "bare": lambda: kmb._launch(*blk, prep.blob, shape[6], shape[7], cfg.chunk,
                                        cfg.stages, cfg.smem_bytes),
            "op": lambda: kmb.fused_inverted_residual(*blk, rate=shape[6], residual=shape[7],
                                                      prepared=prep)},
    }
    card = card_line()
    for name, fns in cases.items():
        order = [*fns, *reversed(fns)]  # bare, op[, custom_op], ..., op, bare
        us = {v: [] for v in fns}
        for v in order:
            us[v].append(host_us(torch, fns[v]))
        print(f"  {name}: host us a call, in turns {' '.join(order)}: " + ", ".join(
            f"{v} {min(t):.2f}-{max(t):.2f}" for v, t in us.items()) + f"  [{card}]")


def export_phase(torch, kernels, classes_path, requests, kaspp, kdec, kmb) -> dict:
    """`export.pt2` on the card: mobilenetv2 (bf16, 512x512, OS16, 21 classes,
    seeded weights, as `DeepLab` builds it) with the ASPP and decoder
    kernels, and again with the inverted-residual kernel too, exported,
    saved under build/, loaded back and called on EXPORT_REQUESTS requests:
    each kernel one graph node (13 for the inverted residual's blocks), each
    call moving its launch count by as many, the probabilities against the
    eager model's (mask agreement >= 0.9999); `Runner` on the first artifact;
    eager against the artifact in turns; the operators' host cost. Returns
    {path: launch counts} for the kernels line."""
    from collections import Counter

    from deeplabv3p_torch.export.pt2 import Inference, export_model, load_exported, save_exported
    from deeplabv3p_torch.inference import DeepLab
    from deeplabv3p_torch.runtime import Runner

    card = card_line()
    ops = ("multirate_atrous_depthwise", "fused_decoder_frontend", "fused_inverted_residual")
    xs = [torch.from_numpy(data).cuda() for data, _ in requests[:EXPORT_REQUESTS]]
    common = dict(model_type="mobilenetv2", classes_path=classes_path, model_input_shape=INPUT,
                  output_stride=16, device="cuda")
    launches, programs = {}, {}
    print(f"export: mobilenetv2 bf16 {INPUT} OS16 as .pt2 programs, {len(xs)} calls each:")
    for name, flags, per_call in (
            ("mobilenetv2 .pt2", dict(fused_decoder=True), (1, 1, 0)),
            ("mobilenetv2 .pt2 --fused_mbconv", dict(fused_decoder=True, fused_mbconv=True),
             (1, 1, 13))):
        deeplab = DeepLab(**common, **flags)
        t0 = time.perf_counter()
        ep = export_model(deeplab.model, INPUT)
        export_s = time.perf_counter() - t0
        nodes = Counter(str(n.target).split(".")[1] for n in ep.graph.nodes
                        if n.op == "call_function" and str(n.target).startswith("deeplabv3p."))
        path = os.path.join(OUT_DIR, f"smoke_{len(programs)}.pt2")
        save_exported(ep, path)
        t0 = time.perf_counter()
        program = load_exported(path)
        load_s = time.perf_counter() - t0
        check(tuple(nodes[op] for op in ops) == per_call and sum(nodes.values()) == sum(per_call),
              f"{name}: the graph's kernel nodes {dict(nodes)} ({len(ep.graph.nodes)} nodes, "
              f"{sum(str(n.target) == 'aten.clone.default' for n in ep.graph.nodes)} copies); "
              f"exported in {export_s:.2f} s, {os.path.getsize(path) / 2**20:.1f} MiB, loaded "
              f"in {load_s:.2f} s")
        eager = Inference(deeplab.model.eval(), with_softmax=True, with_argmax=False)
        moves, outs = [], []
        kernels.reset_launch_counts()                   # the artifact's path starts here
        with torch.no_grad():
            for x in xs:
                before = kernels.launch_counts()
                outs.append(program(x))
                after = kernels.launch_counts()
                moves.append(tuple(after[op] - before[op] for op in ops))
        torch.cuda.synchronize()
        launches[name] = kernels.launch_counts()        # ... and ends here
        check(all(m == per_call for m in moves),
              f"{name}: each call moves the (ASPP, decoder, inverted residual) launch counts by "
              f"{per_call}: {moves}; counts {launches[name]}")
        with torch.no_grad():
            refs = [eager(x) for x in xs]
        err = max((o - r).abs().max().item() for o, r in zip(outs, refs))
        agree = min((o.argmax(-1) == r.argmax(-1)).float().mean().item()
                    for o, r in zip(outs, refs))
        ok = all(o.shape == (1, *INPUT, 21) and torch.isfinite(o).all() for o in outs)
        check(ok and agree >= 0.9999,
              f"{name} against the eager model: max|dprobs| {err:.3g}, mask agreement min "
              f"{agree:.6f} >= 0.9999")
        with torch.no_grad():
            first = (event_ms(lambda: program(xs[0]), EXPORT_ITERS),
                     synced_ms(torch, lambda: program(xs[0]), EXPORT_ITERS))
        print(f"  {name}: {first[0]:.3f} ms a call right after loading (CUDA events; median of "
              f"calls synchronized one by one {first[1]:.3f} ms)")
        programs[name] = (path, program, eager)

    path, program, eager = programs["mobilenetv2 .pt2"]
    runner = Runner(path, "mobilenetv2", 21, *INPUT)
    raw, h, w, c = runner.run_bytes(requests[0][0].tobytes(), 1, *INPUT)
    probs = np.frombuffer(raw, np.float32).reshape(1, h, w, c)
    with torch.no_grad():
        direct = program(xs[0]).cpu().numpy()
    check((h, w, c) == (*INPUT, 21) and np.abs(probs.sum(-1) - 1).max() <= 1e-5
          and np.array_equal(probs, direct),
          f"Runner(.pt2).run_bytes: ({h}, {w}, {c}), max|sum - 1| "
          f"{np.abs(probs.sum(-1) - 1).max():.3g}, equal to the loaded program's output "
          f"(max|d| {np.abs(probs - direct).max():.3g})")

    print(f"latency, eager forward against the loaded .pt2 (b1, CUDA events, mean of "
          f"{EXPORT_ITERS} calls a turn, in turns P A A P, softmax included):")
    for name, (_, program, eager) in programs.items():
        x = xs[0]
        fns = {"eager": lambda: eager(x), "artifact": lambda: program(x)}
        ms = {k: [] for k in fns}
        med = {k: [] for k in fns}
        with torch.no_grad():
            for k in ("eager", "artifact", "artifact", "eager"):
                ms[k].append(event_ms(fns[k], EXPORT_ITERS))
                med[k].append(synced_ms(torch, fns[k], EXPORT_ITERS))
        print(f"  {name}: eager {ms['eager'][0]:.3f}/{ms['eager'][1]:.3f} ms, artifact "
              f"{ms['artifact'][0]:.3f}/{ms['artifact'][1]:.3f} ms a call; medians of calls "
              f"synchronized one by one: eager {med['eager'][0]:.3f}/{med['eager'][1]:.3f}, "
              f"artifact {med['artifact'][0]:.3f}/{med['artifact'][1]:.3f}  [{card}]")
        tag = name.split()[-1].lstrip("-")
        with torch.no_grad():
            for what, fn in (("eager", fns["eager"]), (".pt2", fns["artifact"])):
                profile_one(torch, fn, f"one call, {name}, {what}",
                            f"profile_one_export_{tag}_{what.lstrip('.')}.txt", top=6)
    print("the operators' host cost:")
    op_host_cost(torch, kaspp, kdec, kmb)
    print("the .pt2 and int8 entry points:")
    export_clis(torch, kernels)
    return launches


def export_clis(torch, kernels) -> None:
    """The `.pt2` and int8 entry points on the card, on the toy set of
    data/toy.py at 512x512 (8 images, 4 classes) and seeded mobilenetv2
    weights: `deeplab --dump_model x.pt2`, then `eval --model_path x.pt2`
    (batch 1, the program's) against `eval` on the same weights as an
    `.npz` (the same matrix); `tools/export_model.py --format pt2|int8|ckpt`
    (int8 calibrated on the toy set), the pt2 one through `Runner`."""
    import shutil

    from deeplabv3p_torch import deeplab as deeplab_cli
    from deeplabv3p_torch import eval as eval_cli
    from deeplabv3p_torch.data.toy import build_overfit_dataset
    from deeplabv3p_torch.runtime import Runner
    from deeplabv3p_torch.tools import export_model as tool
    from deeplabv3p_torch.utils.checkpoint import load_variables

    root = os.path.join(OUT_DIR, "smoke_export_data")
    shutil.rmtree(root, ignore_errors=True)
    list_path = build_overfit_dataset(root, source_dir=os.path.join(REPO, "example"))
    classes = os.path.join(root, "classes.txt")
    common = ["--model_type", "mobilenetv2", "--model_input_shape", str(INPUT[0]),
              "--classes_path", classes, "--device", "cuda"]
    metrics = {}
    for suffix in (".pt2", ".npz"):
        path = os.path.join(root, "dump" + suffix)
        _, dump_s, _, _ = run_cli(torch, kernels, deeplab_cli.main, deeplab_cli.parse_args(
            [*common, "--dump_model", "--output_model_file", path]))
        args = eval_cli.parse_args([*common, "--model_path", path, "--batch_size", "1",
                                    "--dataset_path", root, "--dataset_file", list_path,
                                    "--out_dir", os.path.join(root, "result")])
        m, eval_s, launches, _ = run_cli(torch, kernels, eval_cli.main, args)
        metrics[suffix] = m
        print(f"  deeplab --dump_model {os.path.basename(path)} in {dump_s:.2f} s; eval CLI on it, "
              f"8 images b1: {eval_s:.2f} s, mIoU {m.miou:.5f}, launches {launches}")
    check(np.array_equal(metrics[".pt2"].confusion, metrics[".npz"].confusion),
          f"eval --model_path dump.pt2 gives the matrix of eval on the same weights as an .npz "
          f"(sum|diff| {int(np.abs(metrics['.pt2'].confusion - metrics['.npz'].confusion).sum())})")
    weights = os.path.join(root, "dump.npz")
    base = ["--model_path", weights, "--model_type", "mobilenetv2", "--num_classes", "4",
            "--model_input_shape", str(INPUT[0]), "--device", "cuda"]
    for fmt in ("pt2", "int8", "ckpt"):
        out = os.path.join(root, f"tool.{fmt}")
        extra = ["--dataset_path", root, "--dataset_file", list_path] if fmt == "int8" else []
        _, s, _, _ = run_cli(torch, kernels, tool.main, tool.parse_args(
            [*base, "--format", fmt, "--output", out, *extra]))
        print(f"  tools/export_model.py --format {fmt}: {os.path.getsize(out) / 2**20:.1f} MiB "
              f"in {s:.2f} s")
    payload = load_variables(os.path.join(root, "tool.int8"))
    check(set(payload) == {"quantized_params", "batch_stats", "activation_ranges"},
          f"the int8 payload holds {sorted(payload)}, {len(payload['activation_ranges'])} "
          f"activation ranges")
    data = np.random.default_rng(1).uniform(-1, 1, (1, *INPUT, 3)).astype(np.float32)
    raw, h, w, c = Runner(os.path.join(root, "tool.pt2"), "mobilenetv2", 4, *INPUT).run_bytes(
        data.tobytes(), 1, *INPUT)
    probs = np.frombuffer(raw, np.float32).reshape(h, w, c)
    check((h, w, c) == (*INPUT, 4) and np.abs(probs.sum(-1) - 1).max() <= 1e-5,
          f"Runner on the tool's f32 .pt2: ({h}, {w}, {c}), max|sum - 1| "
          f"{np.abs(probs.sum(-1) - 1).max():.3g}")


def int8_phase(torch, requests, learn=None) -> None:
    """`export.quantize` on the card, as the JAX bench's int8:mobilenetv2_lite_b1
    cell sets it (bench.py:650-680): mobilenetv2_lite bf16 512x512 OS16, 21
    classes, seeded weights, calibrated on 2 seeded uniform batches; every
    eligible conv calibrated, swapped and run through `torch._int_mm` once a
    call; masks against bf16 (printed), a request's time against bf16 in
    turns. With the learning proof's trained mobilenetv2 (`learn`), its int8
    masks on the toy set against bf16's: agreement > 0.98, |dmIoU| < 0.01
    (tests/test_quantize.py's bars)."""
    from deeplabv3p_torch import metrics as metrics_lib
    from deeplabv3p_torch.export import quantize as q
    from deeplabv3p_torch.models.factory import build_segmentation_model
    from deeplabv3p_torch.models.layers import init_parameters
    from deeplabv3p_torch.utils.weights import flax_module_paths

    card = card_line()
    model = build_segmentation_model("mobilenetv2_lite", 21, output_stride=16, fused_aspp=True,
                                     dtype=torch.bfloat16, device="cuda")
    init_parameters(model, torch.Generator().manual_seed(0))
    model.eval()
    gen = torch.Generator().manual_seed(INT8_SEED)
    calib = [(torch.rand((1, 3, *INPUT), generator=gen) * 2 - 1).cuda() for _ in range(2)]
    t0 = time.perf_counter()
    ranges = q.calibrate_conv_inputs(model, calib)
    int8 = q.make_int8_apply(model, ranges)
    prep_s = time.perf_counter() - t0
    eligible = sorted(p for p, n in flax_module_paths(model).items()
                      if q._is_pointwise_conv(model.get_submodule(n)))
    convs = q.int8_convs(int8)
    check(sorted(ranges) == eligible and len(convs) == len(eligible),
          f"int8 mobilenetv2_lite: {len(eligible)} eligible convs, {len(ranges)} calibrated, "
          f"{len(convs)} int8 (calibrated and swapped in {prep_s:.2f} s)")
    xs = [torch.from_numpy(data).cuda().permute(0, 3, 1, 2) for data, _ in requests]
    for conv in convs:
        conv.calls = 0
    with torch.no_grad():
        out_i8 = [int8(x) for x in xs]
        out_bf = [model(x) for x in xs]
    torch.cuda.synchronize()
    check(all(c.calls == len(xs) for c in convs),
          f"int8: every eligible conv ran torch._int_mm once a call ({len(xs)} calls): calls "
          f"{sorted({c.calls for c in convs})}")
    agree = [(a.argmax(1) == b.argmax(1)).float().mean().item() for a, b in zip(out_i8, out_bf)]
    rel = max(((a - b).abs().max() / (b.max() - b.min())).item() for a, b in zip(out_i8, out_bf))
    finite = all(torch.isfinite(o).all() for o in out_i8)
    check(finite, f"int8 logits finite, max|int8 - bf16| {rel:.4f} x the bf16 logits' spread; "
                  f"masks agree with bf16's on {min(agree):.5f}-{max(agree):.5f} of pixels "
                  f"(seeded weights, near-tied logits: printed)")
    x = xs[0]
    fns = {"bf16": lambda: model(x), "int8": lambda: int8(x)}
    ms = {k: [] for k in fns}
    with torch.no_grad():
        for k in ("bf16", "int8", "int8", "bf16"):
            ms[k].append(event_ms(fns[k], EXPORT_ITERS))
    print(f"  int8 mobilenetv2_lite b1 forward: bf16 {ms['bf16'][0]:.3f}/{ms['bf16'][1]:.3f} ms, "
          f"int8 {ms['int8'][0]:.3f}/{ms['int8'][1]:.3f} ms a call (CUDA events, in turns "
          f"P A A P)  [{card}]")
    if learn is None:
        return
    from deeplabv3p_torch.data.augment import preprocess_eval_batch
    from deeplabv3p_torch.data.pipeline import SegmentationDataset
    from deeplabv3p_torch.models.factory import build_deeplab_model
    from deeplabv3p_torch.utils.config import get_data_list
    from deeplabv3p_torch.utils.weights import from_jax_variables, load_npz

    trained = build_deeplab_model("mobilenetv2", 4, fused_aspp=True, dtype=torch.bfloat16,
                                  device="cuda")
    trained.load_state_dict(from_jax_variables(load_npz(learn["weights"]), trained), strict=True)
    trained.eval()
    ds = SegmentationDataset(learn["root"], get_data_list(learn["list"], shuffle=False),
                             batch_size=LEARN_BATCH, num_classes=4,
                             input_shape=(LEARN_HW, LEARN_HW), augment=False, shuffle=False,
                             drop_remainder=False)
    images, labels = [], []
    for images_u8, labels_u8, _ in ds.epoch_batches():
        im, lb = preprocess_eval_batch(torch.from_numpy(images_u8).cuda(),
                                       torch.from_numpy(labels_u8).cuda(), 4)
        images.append(im.permute(0, 3, 1, 2))
        labels.append(lb)
    images, labels = torch.cat(images), torch.cat(labels)
    int8 = q.make_int8_apply(trained, q.calibrate_conv_inputs(trained, images.split(4)))
    with torch.no_grad():
        masks = {k: m(images).argmax(1) for k, m in (("bf16", trained), ("int8", int8))}
    agree = (masks["int8"] == masks["bf16"]).float().mean().item()
    miou = {k: metrics_lib.segment_metrics_from_confusion(
        metrics_lib.confusion_matrix(labels, v, 4).cpu().numpy()).miou for k, v in masks.items()}
    check(agree > 0.98 and abs(miou["int8"] - miou["bf16"]) < 0.01,
          f"int8 on the learning proof's trained mobilenetv2 (toy set, {LEARN_HW} px, "
          f"calibrated on its {len(images)} images): masks agree with bf16's on {agree:.5f} > "
          f"0.98; mIoU {miou['int8']:.5f} against {miou['bf16']:.5f}, |d| < 0.01  [{card}]")


def onnx_phase(torch, kernels, classes_path, requests, learn) -> dict:
    """ONNX on the card: `tools/export_onnx.py --device cuda` on
    mobilenetv2 (f32, 512x512, OS16, 21 classes, seeded weights written as an
    .npz), in process: its node and initializer counts, bytes and seconds, its
    op types inside the native engine's table and no `deeplabv3p` node, the
    ASPP and decoder kernels launched once each by the warm-up forward;
    `export.onnx.interp` on the card against the eager f32 model on the same
    requests (TF32 off for both; mask agreement >= 0.999), timed in turns P A
    A P and profiled once; the eval CLI on the learning proof's trained
    weights (`learn`, the toy set at its 256x256, 4 classes) as an .onnx
    against the .npz (mIoU within 1e-3, the confusion kernel once a batch);
    `tools/validate_deeplab.py` on the .npz, the .onnx and a .pt2 of the same
    weights; unet_standard at 512x512 (ConvTranspose and the nearest Gather)
    exported and run against its eager model. Returns {path: launch counts}
    for the kernels line."""
    from deeplabv3p_torch import eval as eval_cli
    from deeplabv3p_torch.export.onnx import OnnxProgram, load_onnx
    from deeplabv3p_torch.export.onnx.convert import ENGINE_OPS
    from deeplabv3p_torch.export.pt2 import Inference
    from deeplabv3p_torch.models.factory import build_segmentation_model
    from deeplabv3p_torch.models.layers import init_parameters
    from deeplabv3p_torch.tools import export_model as pt2_tool
    from deeplabv3p_torch.tools import export_onnx as tool
    from deeplabv3p_torch.tools import validate_deeplab
    from deeplabv3p_torch.utils.weights import save_npz, to_jax_variables

    card = card_line()
    os.makedirs(OUT_DIR, exist_ok=True)
    xs = [torch.from_numpy(data).cuda() for data, _ in requests[:EXPORT_REQUESTS]]
    launches = {}
    print(f"ONNX: tools/export_onnx.py --device cuda, f32 {INPUT} OS16, seeded weights; "
          f"export.onnx.interp on the card, {len(xs)} requests:")

    def export(model_type, num_classes, classes, hw, seed):
        model = build_segmentation_model(model_type, num_classes, output_stride=16,
                                         fused_aspp=True, fused_decoder=True, device="cuda")
        init_parameters(model, torch.Generator().manual_seed(seed))
        weights = os.path.join(OUT_DIR, f"smoke_onnx_{model_type}.npz")
        save_npz(weights, to_jax_variables(model))
        path = os.path.join(OUT_DIR, f"smoke_{model_type}.onnx")
        _, export_s, counts, _ = run_cli(torch, kernels, tool.main, tool.parse_args(
            ["--model_type", model_type, "--classes_path", classes, "--weights_path", weights,
             "--model_input_shape", f"{hw[0]}x{hw[1]}", "--output_path", path]))
        onnx_model = load_onnx(path)
        ops = {n.op_type for n in onnx_model.graph.node}
        custom = [n.name for n in onnx_model.graph.node
                  if "deeplabv3p" in n.op_type or n.domain]
        check(ops <= ENGINE_OPS and not custom,
              f"{model_type} .onnx: {len(onnx_model.graph.node)} nodes, "
              f"{len(onnx_model.graph.initializer)} initializers, {os.path.getsize(path)} bytes, "
              f"exported in {export_s:.2f} s; op types {sorted(ops)} inside the native "
              f"engine's table (outside: {sorted(ops - ENGINE_OPS)}), custom nodes {custom}  "
              f"[{card}]")
        return model.eval(), weights, path, onnx_model, counts

    def agreement(name, program, eager, inputs):
        (in_name,), (out_name,) = program.inputs, program.outputs
        with torch.no_grad():
            outs = [program({in_name: x})[out_name] for x in inputs]
            refs = [eager(x) for x in inputs]
        err = max((o - r).abs().max().item() for o, r in zip(outs, refs))
        agree = min((o.argmax(-1) == r.argmax(-1)).float().mean().item()
                    for o, r in zip(outs, refs))
        ok = all(o.shape == r.shape and torch.isfinite(o).all() for o, r in zip(outs, refs))
        check(ok and agree >= 0.999,
              f"{name}: the executor on the card against the eager f32 model (TF32 off): "
              f"max|dprob| {err:.3g}, mask agreement min {agree:.6f} >= 0.999")

    model, weights, path, onnx_model, counts = export("mobilenetv2", 21, classes_path, INPUT, 0)
    launches["tools/export_onnx.py mobilenetv2 (warm-up)"] = counts
    check(counts == {**ZERO_LAUNCHES, "multirate_atrous_depthwise": 1,
                     "fused_decoder_frontend": 1},
          f"export_onnx: the warm-up forward launched the ASPP and decoder kernels once each "
          f"and no other: {counts}")
    t0 = time.perf_counter()
    program = OnnxProgram(onnx_model, "cuda")
    print(f"  OnnxProgram on the card in {time.perf_counter() - t0:.2f} s")
    eager = Inference(model, with_softmax=True, with_argmax=False)
    agreement("mobilenetv2", program, eager, xs)
    in_name = program.inputs[0]
    fns = {"eager": lambda: eager(xs[0]), "onnx": lambda: program({in_name: xs[0]})}
    ms = {k: [] for k in fns}
    med = {k: [] for k in fns}
    with torch.no_grad():
        for k in ("eager", "onnx", "onnx", "eager"):
            ms[k].append(event_ms(fns[k], EXPORT_ITERS))
            med[k].append(synced_ms(torch, fns[k], EXPORT_ITERS))
        print(f"  latency b1, the eager f32 model (ASPP and decoder kernels) against the .onnx "
              f"through export.onnx.interp (CUDA events, mean of {EXPORT_ITERS} calls a turn, "
              f"in turns P A A P): eager {ms['eager'][0]:.3f}/{ms['eager'][1]:.3f} ms, onnx "
              f"{ms['onnx'][0]:.3f}/{ms['onnx'][1]:.3f} ms a call; medians of calls "
              f"synchronized one by one: eager {med['eager'][0]:.3f}/{med['eager'][1]:.3f}, "
              f"onnx {med['onnx'][0]:.3f}/{med['onnx'][1]:.3f}  [{card}]")
        for what, fn in fns.items():
            profile_one(torch, fn, f"one call, mobilenetv2 f32, {what}",
                        f"profile_one_onnx_{what}.txt", top=6)

    # the eval CLI on the trained weights, as an .onnx and as the .npz
    root, list_path = learn["root"], learn["list"]
    toy_classes = os.path.join(root, "classes.txt")
    trained = os.path.join(OUT_DIR, "smoke_learn.onnx")
    batch = LEARN_BATCH // 2
    _, s, _, _ = run_cli(torch, kernels, tool.main, tool.parse_args(
        ["--model_type", "mobilenetv2", "--classes_path", toy_classes, "--weights_path",
         learn["weights"], "--model_input_shape", f"{LEARN_HW}x{LEARN_HW}", "--output_path",
         trained, "--batch_size", str(batch)]))
    metrics = {}
    for name in (trained, learn["weights"]):
        args = eval_cli.parse_args(
            ["--model_type", "mobilenetv2", "--model_path", name, "--model_input_shape",
             str(LEARN_HW), "--batch_size", str(batch), "--dataset_path", root,
             "--dataset_file", list_path, "--classes_path", toy_classes,
             "--out_dir", os.path.join(OUT_DIR, "smoke_onnx_eval")])
        m, eval_s, counts, _ = run_cli(torch, kernels, eval_cli.main, args)
        metrics[name] = m
        launches[f"eval --model_path {os.path.basename(name)} b{batch}"] = counts
        print(f"  eval CLI on {os.path.basename(name)} (the toy set, {LEARN_HW}x{LEARN_HW}, "
              f"b{batch}): mIoU {m.miou:.6f} in {eval_s:.2f} s, launches {counts}")
    m_onnx, m_npz = metrics[trained], metrics[learn["weights"]]
    batches = -(-8 // batch)
    onnx_counts = launches[f"eval --model_path {os.path.basename(trained)} b{batch}"]
    check(abs(m_onnx.miou - m_npz.miou) <= 1e-3
          and onnx_counts == {**ZERO_LAUNCHES, "confusion_matrix_fused": batches},
          f"eval --model_path x.onnx (f32, exported in {s:.2f} s): mIoU {m_onnx.miou:.6f} "
          f"against the .npz's {m_npz.miou:.6f} (bf16), |d| {abs(m_onnx.miou - m_npz.miou):.2e} "
          f"<= 1e-3; the confusion kernel once a batch ({batches}): {onnx_counts}")

    # validate_deeplab on the seeded mobilenetv2 as .npz, .onnx and .pt2
    pt2 = os.path.join(OUT_DIR, "smoke_onnx_mobilenetv2.pt2")
    run_cli(torch, kernels, pt2_tool.main, pt2_tool.parse_args(
        ["--model_path", weights, "--model_type", "mobilenetv2", "--num_classes", "21",
         "--model_input_shape", str(INPUT[0]), "--format", "pt2", "--output", pt2]))
    results, _, _, text = run_cli(torch, kernels, validate_deeplab.main,
                                  validate_deeplab.parse_args(
        ["--model_path", f"{weights},{path},{pt2}", "--model_type", "mobilenetv2",
         "--image_file", os.path.join(REPO, "example", "dog.jpg"), "--classes_path",
         classes_path, "--model_input_shape", str(INPUT[0]), "--output_path", OUT_DIR]))
    print("  validate_deeplab --model_path x.npz,x.onnx,x.pt2 on the card:")
    for line in text.strip().splitlines():
        print("    " + line)
    ref = results[weights]
    agree = [float((mask == ref[1]).mean()) for _, mask in results.values()]
    err = max(float(np.abs(probs - ref[0]).max()) for probs, _ in results.values())
    check(len(results) == 3 and min(agree) >= 0.999,
          f"validate_deeplab: .onnx and .pt2 against the .npz, max|dprob| {err:.3g}, mask "
          f"agreement min {min(agree):.6f} >= 0.999")

    # unet_standard: ConvTranspose and the nearest Gather on the card
    model, _, _, onnx_model, counts = export("unet_standard", 21, classes_path, INPUT, 1)
    launches["tools/export_onnx.py unet_standard"] = counts
    agreement("unet_standard", OnnxProgram(onnx_model, "cuda"),
              Inference(model, with_softmax=True, with_argmax=False), xs)
    return launches


def tf_phase(torch, kernels, classes_path, requests, learn) -> dict:
    """The frozen TF graph on the card, with no tensorflow anywhere:
    `tools/export_model.py --format pb --device cuda` on mobilenetv2 (f32,
    512x512, OS16, 21 classes, seeded weights written as an .npz), in
    process: its node count, op types, bytes and seconds, the ASPP and decoder
    kernels launched once each by the export's warm-up forward;
    `FrozenGraphRunner` on the card against the eager f32 model on the same
    requests (TF32 off for both; max |dprob| <= 1e-5, mask agreement >=
    0.999), timed in turns with the eager model, with `export.onnx.interp`
    on the same weights' .onnx and with `TFLiteRunner` on the fp32 and the
    int8 .tflite that `export_tflite` writes from this graph (the int8 one
    calibrated on the export tool's seeded batches), each profiled once; the
    eval CLI on the learning proof's trained weights (`learn`) as a .pb against the
    .npz (mIoU within 1e-3, the confusion kernel once a batch) and against
    `eval_miou` of the f32 model on the same weights (<= 1e-4 of the pixels
    counted elsewhere: the .npz's CLI model is bf16); `validate_deeplab` on
    the .npz and the .pb (max |dprob| <= 1e-5); unet_standard at 512x512
    (Conv2DBackpropInput, MaxPool) and fast_scnn at 1024x2048 with 19 classes
    (AvgPool, the nearest GatherV2) exported by the tool and run against
    their eager models within 1e-5. Returns {path: launch counts} for the
    kernels line."""
    from collections import Counter

    from deeplabv3p_torch import eval as eval_cli
    from deeplabv3p_torch.export.onnx import OnnxProgram, export_onnx
    from deeplabv3p_torch.export.pt2 import Inference
    from deeplabv3p_torch.export.tf_export import FrozenGraphRunner, TFLiteRunner, load_graph
    from types import SimpleNamespace

    from deeplabv3p_torch.export.tflite import lower as tflite_lower
    from deeplabv3p_torch.export.tflite import quantize as int8_quantize
    from deeplabv3p_torch.export.tflite import schema
    from deeplabv3p_torch.inference import preprocess_image
    from deeplabv3p_torch.models.factory import build_segmentation_model
    from deeplabv3p_torch.models.layers import init_parameters
    from deeplabv3p_torch.tools import export_model as tool
    from deeplabv3p_torch.tools import validate_deeplab
    from deeplabv3p_torch.utils.weights import save_npz, to_jax_variables

    card = card_line()
    os.makedirs(OUT_DIR, exist_ok=True)
    t_phase = time.perf_counter()
    launches = {}
    print(f"frozen TF graph: tools/export_model.py --format pb --device cuda, f32 {INPUT} OS16, "
          f"seeded weights; FrozenGraphRunner on the card, {EXPORT_REQUESTS} requests:")

    def export(model_type, num_classes, hw, seed, weights=None, name=None):
        """The tool on the card from seeded weights (or `weights`): the
        eager f32 model of the same weights, the weights' and the .pb's
        paths, the tool's launch counts."""
        model = build_segmentation_model(model_type, num_classes, output_stride=16,
                                         fused_aspp=True, fused_decoder=True, device="cuda")
        init_parameters(model, torch.Generator().manual_seed(seed))
        if weights is None:
            weights = os.path.join(OUT_DIR, f"smoke_pb_{model_type}.npz")
            save_npz(weights, to_jax_variables(model))
        else:
            from deeplabv3p_torch.utils.checkpoint import load_weights

            load_weights(weights, model)
        path = os.path.join(OUT_DIR, f"smoke_{name or model_type}.pb")
        _, s, counts, text = run_cli(torch, kernels, tool.main, tool.parse_args(
            ["--model_path", weights, "--model_type", model_type, "--num_classes",
             str(num_classes), "--model_input_shape", f"{hw[0]}x{hw[1]}", "--format", "pb",
             "--output", path, "--device", "cuda"]))
        graph = load_graph(path)
        ops = Counter(n.op for n in graph.node)
        print(f"  {model_type} .pb: {len(graph.node)} nodes, {os.path.getsize(path)} bytes, "
              f"exported in {s:.2f} s; {text.strip()}; op types {dict(ops.most_common())}  "
              f"[{card}]")
        return model.eval(), weights, path, counts

    def agreement(name, runner, eager, inputs, floor=0.999, bound=1e-5):
        outs = [torch.from_numpy(runner(x.cpu().numpy())).cuda() for x in inputs]
        with torch.no_grad():
            refs = [eager(x) for x in inputs]
        err = max((o - r).abs().max().item() for o, r in zip(outs, refs))
        agree = min((o.argmax(-1) == r.argmax(-1)).float().mean().item()
                    for o, r in zip(outs, refs))
        ok = all(o.shape == r.shape and torch.isfinite(o).all() for o, r in zip(outs, refs))
        check(ok and agree >= floor and err <= bound,
              f"{name}: FrozenGraphRunner on the card against the eager f32 model (TF32 off): "
              f"max|dprob| {err:.3g} <= {bound}, mask agreement min {agree:.6f} >= {floor}  "
              f"[{card}]")

    model, weights, path, counts = export("mobilenetv2", 21, INPUT, 0)
    launches["tools/export_model.py --format pb mobilenetv2 (warm-up)"] = counts
    check(counts == {**ZERO_LAUNCHES, "multirate_atrous_depthwise": 1,
                     "fused_decoder_frontend": 1},
          f"export_model --format pb: the warm-up forward launched the ASPP and decoder kernels "
          f"once each and no other: {counts}")
    t0 = time.perf_counter()
    runner = FrozenGraphRunner(path)  # the card by default
    program = runner.program
    print(f"  FrozenGraphRunner on {program.device} in {time.perf_counter() - t0:.2f} s: "
          f"{len(program.steps)} operations a call, input {program.input_name} "
          f"{program.input_shape}, output {program.output_name}")
    check(program.device.type == "cuda", "FrozenGraphRunner runs on the card by default")
    xs = [torch.from_numpy(data).cuda() for data, _ in requests[:EXPORT_REQUESTS]]
    eager = Inference(model, with_softmax=True, with_argmax=False)
    agreement("mobilenetv2", runner, eager, xs)
    onnx = OnnxProgram(export_onnx(model, INPUT), "cuda")
    # the files export_tflite writes for these weights: this graph, lowered, and
    # its int8 form, calibrated on the export tool's seeded batches (no dataset)
    lowered = tflite_lower.lower(load_graph(path))
    tflite = TFLiteRunner(schema.encode_model(lowered)).program
    t0 = time.perf_counter()
    rep = tool.representative_batches(SimpleNamespace(
        dataset_path=None, dataset_file=None, calib_batches=INT8_CALIB), INPUT)
    int8_bytes = schema.encode_model(int8_quantize.quantize(lowered, rep))
    int8 = TFLiteRunner(int8_bytes).program
    print(f"  int8 .tflite of this graph: quantized in {time.perf_counter() - t0:.2f} s "
          f"(calibrated on the CPU on {INT8_CALIB} seeded batches), {len(int8_bytes)} bytes, "
          f"{len(int8.steps)} operators a call  [{card}]")
    fns = {"eager": lambda: eager(xs[0]), "pb": lambda: program(xs[0]),
           "onnx": lambda: onnx({"input_0": xs[0]}), "tflite": lambda: tflite(xs[0]),
           "int8": lambda: int8(xs[0])}
    ms = {k: [] for k in fns}
    med = {k: [] for k in fns}
    turns = ("eager", "pb", "onnx", "tflite", "int8", "int8", "tflite", "onnx", "pb", "eager")
    with torch.no_grad():
        for k in turns:
            ms[k].append(event_ms(fns[k], EXPORT_ITERS))
            med[k].append(synced_ms(torch, fns[k], EXPORT_ITERS))
        print(f"  latency b1 (CUDA events, mean of {EXPORT_ITERS} calls a turn, in turns "
              f"{' '.join(k[0].upper() for k in turns)}; then medians of calls synchronized one "
              f"by one): "
              + "; ".join(f"{k} {ms[k][0]:.3f}/{ms[k][1]:.3f} ms, median {med[k][0]:.3f}/"
                          f"{med[k][1]:.3f}" for k in fns) + f"  [{card}]")
        for what, fn in fns.items():
            profile_one(torch, fn, f"one call, mobilenetv2 f32, {what}",
                        f"profile_one_tf_{what}.txt", top=6)
    del onnx, tflite, int8

    # the eval CLI on the trained weights, as a .pb and as the .npz
    root, list_path = learn["root"], learn["list"]
    toy_classes = os.path.join(root, "classes.txt")
    _, _, trained, _ = export("mobilenetv2", 4, (LEARN_HW, LEARN_HW), 0, learn["weights"],
                              "learn")
    batch = LEARN_BATCH // 2
    metrics = {}
    for name in (trained, learn["weights"]):
        args = eval_cli.parse_args(
            ["--model_type", "mobilenetv2", "--model_path", name, "--model_input_shape",
             str(LEARN_HW), "--batch_size", str(batch), "--dataset_path", root,
             "--dataset_file", list_path, "--classes_path", toy_classes,
             "--out_dir", os.path.join(OUT_DIR, "smoke_pb_eval")])
        m, eval_s, counts, _ = run_cli(torch, kernels, eval_cli.main, args)
        metrics[name] = m
        launches[f"eval --model_path {os.path.basename(name)} b{batch}"] = counts
        print(f"  eval CLI on {os.path.basename(name)} (the toy set, {LEARN_HW}x{LEARN_HW}, "
              f"b{batch}): mIoU {m.miou:.6f} in {eval_s:.2f} s, launches {counts}")
    m_pb, m_npz = metrics[trained], metrics[learn["weights"]]
    batches = -(-8 // batch)
    pb_counts = launches[f"eval --model_path {os.path.basename(trained)} b{batch}"]
    check(abs(m_pb.miou - m_npz.miou) <= 1e-3
          and pb_counts == {**ZERO_LAUNCHES, "confusion_matrix_fused": batches},
          f"eval --model_path x.pb (f32, graph batch 1 run in chunks): mIoU {m_pb.miou:.6f} "
          f"against the .npz's {m_npz.miou:.6f} (bf16), |d| {abs(m_pb.miou - m_npz.miou):.2e} "
          f"<= 1e-3; the confusion kernel once a batch ({batches}): {pb_counts}")
    # the .npz's CLI model is bf16; the graph computes the f32 model's matrix
    from deeplabv3p_torch.utils.checkpoint import load_weights
    from deeplabv3p_torch.utils.config import get_classes, get_data_list

    f32 = build_segmentation_model("mobilenetv2", 4, output_stride=16, fused_aspp=True,
                                   fused_decoder=True, device="cuda")
    load_weights(learn["weights"], f32)
    ref, _ = quiet(lambda: eval_cli.eval_miou(
        f32.eval(), root, get_data_list(list_path, shuffle=False), get_classes(toy_classes),
        model_input_shape=(LEARN_HW, LEARN_HW), batch_size=batch))
    flips = int(np.abs(m_pb.confusion - ref.confusion).sum()) // 2
    check(flips <= 1e-4 * ref.confusion.sum(),
          f"eval --model_path x.pb against eval_miou of the f32 model on the .npz's weights: "
          f"{flips} of {int(ref.confusion.sum())} pixels counted elsewhere (<= 1e-4 of them), "
          f"mIoU {m_pb.miou:.6f} against {ref.miou:.6f}")

    results, _, _, text = run_cli(torch, kernels, validate_deeplab.main,
                                  validate_deeplab.parse_args(
        ["--model_path", f"{weights},{path}", "--model_type", "mobilenetv2",
         "--image_file", os.path.join(REPO, "example", "dog.jpg"), "--classes_path",
         classes_path, "--model_input_shape", str(INPUT[0]), "--output_path", OUT_DIR]))
    print("  validate_deeplab --model_path x.npz,x.pb on the card:")
    for line in text.strip().splitlines():
        print("    " + line)
    (p_npz, m_npz), (p_pb, m_pb) = results[weights], results[path]
    agree, err = float((m_pb == m_npz).mean()), float(np.abs(p_pb - p_npz).max())
    check(len(results) == 2 and agree >= 0.999 and err <= 1e-5,
          f"validate_deeplab: .pb against the .npz, max|dprob| {err:.3g} <= 1e-5, mask "
          f"agreement {agree:.6f} >= 0.999")

    # unet_standard (Conv2DBackpropInput, MaxPool) and fast_scnn at 1024x2048
    model, _, path, counts = export("unet_standard", 21, INPUT, 1)
    launches["tools/export_model.py --format pb unet_standard"] = counts
    agreement("unet_standard", FrozenGraphRunner(path), Inference(model, True, False), xs[:2])
    city = make_requests(preprocess_image, CITYSCAPES_REQUEST_SHAPES[:2], CITYSCAPES_HW)
    model, _, path, counts = export("fast_scnn", 19, CITYSCAPES_HW, 2)
    launches["tools/export_model.py --format pb fast_scnn"] = counts
    graph_ops = {n.op for n in load_graph(path).node}
    check({"AvgPool", "GatherV2"} <= graph_ops, "fast_scnn .pb holds AvgPool and GatherV2")
    agreement("fast_scnn 1024x2048", FrozenGraphRunner(path), Inference(model, True, False),
              [torch.from_numpy(data).cuda() for data, _ in city])
    leaked = [m for m in ("tensorflow", "google.protobuf") if m in sys.modules]
    check(not leaked, f"no tensorflow or protobuf module imported ({leaked or 'none'})")
    print(f"the TF phase took {time.perf_counter() - t_phase:.1f} s  [{card}]")
    return launches



def tflite_ops(path: str) -> dict:
    """{builtin: count} of a .tflite, most frequent first."""
    from collections import Counter

    from deeplabv3p_torch.export.tflite import schema

    with open(path, "rb") as f:
        model = schema.decode_model(f.read())
    names = [schema.BUILTIN_NAMES.get(schema.builtin_of(model.operator_codes[op.opcode_index]))
             for op in model.subgraphs[0].operators]
    return dict(Counter(names).most_common())


def tflite_buffer_diff(a: bytes, b: bytes) -> str:
    """Which constant buffers of two .tflite files differ, by tensor name and
    max |d| (the files' structure taken as equal)."""
    from deeplabv3p_torch.export.tflite import schema

    ma, mb = schema.decode_model(a), schema.decode_model(b)
    ta, tb = ma.subgraphs[0].tensors, mb.subgraphs[0].tensors
    if len(ta) != len(tb) or [t.shape for t in ta] != [t.shape for t in tb]:
        return f"the structure differs ({len(ta)} against {len(tb)} tensors)"
    diffs = []
    for x, y in zip(ta, tb):
        da, db = ma.buffers[x.buffer].data, mb.buffers[y.buffer].data
        if da is None or db is None or da.tobytes() == db.tobytes():
            continue
        dt = schema.NP_OF_TYPE[x.type]
        d = np.abs(np.frombuffer(da.tobytes(), dt).astype(np.float64)
                   - np.frombuffer(db.tobytes(), dt).astype(np.float64)).max()
        diffs.append(f"{x.name} {list(x.shape)} max|d| {d:.3g}")
    return f"{len(diffs)} buffers differ: " + "; ".join(diffs[:8]) if diffs else \
        "the buffers are equal (only the layout differs)"


def int8_criteria(got: np.ndarray, want: np.ndarray) -> tuple[float, float]:
    """The JAX package's int8 criteria (tests/test_tf_export.py:88-99): the
    centred log-prob correlation and the mean |dprob| of two softmaxes."""
    gl, wl = np.log(np.clip(got, 1e-8, 1.0)), np.log(np.clip(want, 1e-8, 1.0))
    gl, wl = gl - gl.mean(-1, keepdims=True), wl - wl.mean(-1, keepdims=True)
    return float(np.corrcoef(gl.ravel(), wl.ravel())[0, 1]), float(np.abs(got - want).mean())


def tflite_phase(torch, kernels, classes_path, requests, learn) -> dict:
    """`.tflite` (fp32 and float16) and the SavedModel on the card, with no
    tensorflow anywhere: `tools/export_model.py --format tflite --device cuda`
    and `--format tflite_f16` on mobilenetv2 (f32, 512x512, OS16, 21 classes,
    seeded weights written as an .npz), in process: bytes, builtin counts,
    seconds, the ASPP and decoder kernels launched once each by each export's
    warm-up forward; `TFLiteRunner` on the card against the eager f32 model on
    the same requests (TF32 off; fp32 within 1e-5, masks agreeing on >= 0.999
    of pixels; the float16 file held to tests/test_torch_tflite_tf.py's
    bound, 1e-3 and 0.99); the .tflite the CPU writes from the same .npz
    equal to the card's, byte for byte; `--format pb` and `--format
    saved_model` of the same weights, the SavedModel's GraphDef decoded by
    the port's codec and run by `GraphProgram` bit-equal to the .pb's (the
    .tflite executor is timed and profiled in `tf_phase`'s turns); the eval
    CLI on a .tflite of the learning proof's trained weights (`learn`)
    against the .npz (mIoU within 1e-3, the confusion kernel once a batch)
    and against `eval_miou` of the f32 model (<= 1e-4 of the pixels counted
    elsewhere); `validate_deeplab` on the .npz and the .tflite (max |dprob|
    <= 1e-5); unet_standard at 512x512 (TRANSPOSE_CONV, MAX_POOL_2D) and
    fast_scnn at 1024x2048 with 19 classes (AVERAGE_POOL_2D, GATHER)
    exported by the tool and run against their eager models within 1e-5.
    int8: `--format tflite_int8 --device cuda` on the same .npz, calibrated on
    4 images of a synthetic 512x512 set (bytes, builtin counts, under half
    the fp32 file, the conv counts of the fp32 file, no MAXIMUM or MINIMUM),
    byte-equal to the CPU's (the CPU's fp32 export of the same .npz, quantized
    on the same batches); `TFLiteRunner` on the card against the same file
    on the CPU (within 1 LSB of the softmax's 1/256) and against the eager f32
    model (the JAX package's criteria: correlation > 0.9, mean |dprob| <
    0.1); the eval CLI on an int8 .tflite of the trained weights (their fp32
    .tflite quantized, calibrated on the toy set's images; the confusion
    kernel once a batch, |d mIoU| printed), its
    masks agreeing with the f32 model's on >= 0.98 of the toy set's pixels
    (the int8 executor is timed and profiled in `tf_phase`'s turns).
    Returns {path: launch counts} for the kernels line."""
    from types import SimpleNamespace

    from deeplabv3p_torch import eval as eval_cli
    from deeplabv3p_torch.export.pt2 import Inference
    from deeplabv3p_torch.export.tf import saved_model
    from deeplabv3p_torch.export.tf.interp import GraphProgram
    from deeplabv3p_torch.export.tf_export import TFLiteRunner, load_graph
    from deeplabv3p_torch.export.tflite import quantize as int8_quantize
    from deeplabv3p_torch.export.tflite import schema
    from deeplabv3p_torch.inference import preprocess_image
    from deeplabv3p_torch.models.factory import build_segmentation_model
    from deeplabv3p_torch.models.layers import init_parameters
    from deeplabv3p_torch.tools import export_model as tool
    from deeplabv3p_torch.tools import validate_deeplab
    from deeplabv3p_torch.utils.checkpoint import load_weights
    from deeplabv3p_torch.utils.config import get_classes, get_data_list
    from deeplabv3p_torch.utils.weights import save_npz, to_jax_variables

    card = card_line()
    os.makedirs(OUT_DIR, exist_ok=True)
    t_phase = time.perf_counter()
    launches = {}
    print(f".tflite and SavedModel: tools/export_model.py --format tflite / tflite_f16 / pb / "
          f"saved_model --device cuda, f32 {INPUT} OS16, seeded weights; TFLiteRunner on the "
          f"card, {EXPORT_REQUESTS} requests:")

    def model_of(model_type, num_classes, seed, weights=None):
        model = build_segmentation_model(model_type, num_classes, output_stride=16,
                                         fused_aspp=True, fused_decoder=True, device="cuda")
        init_parameters(model, torch.Generator().manual_seed(seed))
        if weights is None:
            weights = os.path.join(OUT_DIR, f"smoke_tflite_{model_type}.npz")
            save_npz(weights, to_jax_variables(model))
        else:
            load_weights(weights, model)
        return model.eval(), weights

    def export(model_type, num_classes, hw, weights, fmt, name, device="cuda", extra=()):
        """The tool on `device`: the output's path, the seconds, the launch
        counts; prints what it wrote."""
        suffix = {"tflite": ".tflite", "tflite_f16": ".tflite", "tflite_int8": ".tflite",
                  "pb": ".pb", "saved_model": ""}[fmt]
        path = os.path.join(OUT_DIR, f"smoke_{name}{suffix}")
        _, s, counts, text = run_cli(torch, kernels, tool.main, tool.parse_args(
            ["--model_path", weights, "--model_type", model_type, "--num_classes",
             str(num_classes), "--model_input_shape", f"{hw[0]}x{hw[1]}", "--format", fmt,
             "--output", path, "--device", device, *extra]))
        what = f"{tflite_ops(path)}" if suffix == ".tflite" else ""
        print(f"  {model_type} --format {fmt} on {device}: exported in {s:.2f} s; "
              f"{text.strip()}; {what}  [{card}]")
        return path, s, counts

    def agreement(name, runner, eager, inputs, floor=0.999, bound=1e-5):
        outs = [torch.from_numpy(runner(x.cpu().numpy())).cuda() for x in inputs]
        with torch.no_grad():
            refs = [eager(x) for x in inputs]
        err = max((o - r).abs().max().item() for o, r in zip(outs, refs))
        agree = min((o.argmax(-1) == r.argmax(-1)).float().mean().item()
                    for o, r in zip(outs, refs))
        ok = all(o.shape == r.shape and torch.isfinite(o).all() for o, r in zip(outs, refs))
        check(ok and agree >= floor and err <= bound,
              f"{name}: TFLiteRunner on the card against the eager f32 model (TF32 off): "
              f"max|dprob| {err:.3g} <= {bound}, mask agreement min {agree:.6f} >= {floor}  "
              f"[{card}]")

    model, weights = model_of("mobilenetv2", 21, 0)
    counts_of = {}
    for fmt in ("tflite", "tflite_f16", "pb", "saved_model"):
        path, _, counts = export("mobilenetv2", 21, INPUT, weights, fmt, f"mobilenetv2_{fmt}")
        counts_of[fmt] = (path, counts)
        launches[f"tools/export_model.py --format {fmt} mobilenetv2 (warm-up, .tflite phase)"] = \
            counts
        check(counts == {**ZERO_LAUNCHES, "multirate_atrous_depthwise": 1,
                         "fused_decoder_frontend": 1},
              f"export_model --format {fmt}: the warm-up forward launched the ASPP and decoder "
              f"kernels once each and no other: {counts}")
    fp32_path, f16_path = counts_of["tflite"][0], counts_of["tflite_f16"][0]
    print(f"  bytes: tflite {os.path.getsize(fp32_path)}, tflite_f16 "
          f"{os.path.getsize(f16_path)}, pb {os.path.getsize(counts_of['pb'][0])}, "
          f"saved_model.pb "
          f"{os.path.getsize(os.path.join(counts_of['saved_model'][0], 'saved_model.pb'))}")

    t0 = time.perf_counter()
    runner = TFLiteRunner(fp32_path)  # the card by default
    program = runner.program
    print(f"  TFLiteRunner on {program.device} in {time.perf_counter() - t0:.2f} s: "
          f"{len(program.steps)} operators a call, input {program.input_name} "
          f"{program.input_shape}, output {program.output_name}")
    check(program.device.type == "cuda", "TFLiteRunner runs on the card by default")
    xs = [torch.from_numpy(data).cuda() for data, _ in requests[:EXPORT_REQUESTS]]
    eager = Inference(model, with_softmax=True, with_argmax=False)
    agreement("mobilenetv2 tflite", runner, eager, xs)
    f16 = TFLiteRunner(f16_path)
    agreement("mobilenetv2 tflite_f16", f16, eager, xs, floor=0.99, bound=1e-3)

    # the CPU's file from the same .npz
    cpu_path, cpu_s, _ = export("mobilenetv2", 21, INPUT, weights, "tflite", "mobilenetv2_cpu",
                                device="cpu")
    with open(fp32_path, "rb") as f:
        card_bytes = f.read()
    with open(cpu_path, "rb") as f:
        cpu_bytes = f.read()
    same = card_bytes == cpu_bytes
    check(same, f"the .tflite written on the card is byte-equal to the CPU's from the same .npz "
                f"({len(card_bytes)} and {len(cpu_bytes)} bytes; the CPU's export "
                f"{cpu_s:.2f} s)"
                + ("" if same else f": {tflite_buffer_diff(card_bytes, cpu_bytes)}"))

    # int8: the tool on the card, calibrated on INT8_CALIB images of a synthetic
    # 512x512 set
    calib_root = os.path.join(OUT_DIR, "smoke_tflite_calib")
    calib = ["--dataset_path", calib_root, "--dataset_file",
             write_train_dataset(calib_root, [INPUT] * INT8_CALIB, 21, TRAIN_SEED),
             "--calib_batches", str(INT8_CALIB)]
    int8_path, _, counts = export("mobilenetv2", 21, INPUT, weights, "tflite_int8",
                                  "mobilenetv2_int8", extra=calib)
    launches["tools/export_model.py --format tflite_int8 mobilenetv2 (warm-up, .tflite phase)"] = \
        counts
    check(counts == {**ZERO_LAUNCHES, "multirate_atrous_depthwise": 1,
                     "fused_decoder_frontend": 1},
          f"export_model --format tflite_int8: the warm-up forward launched the ASPP and "
          f"decoder kernels once each and no other: {counts}")
    ops8, ops32 = tflite_ops(int8_path), tflite_ops(fp32_path)
    size8, size32 = os.path.getsize(int8_path), os.path.getsize(fp32_path)
    convs = ("CONV_2D", "DEPTHWISE_CONV_2D")
    check(size8 < 0.5 * size32 and all(ops8.get(c) == ops32.get(c) for c in convs)
          and not ops8.get("MAXIMUM") and not ops8.get("MINIMUM"),
          f"int8 .tflite: {size8} bytes, {size8 / size32:.4f} of the fp32 file's (< 0.5); "
          f"CONV_2D {ops8.get('CONV_2D')} and DEPTHWISE_CONV_2D {ops8.get('DEPTHWISE_CONV_2D')} "
          f"as the fp32 file's; no MAXIMUM or MINIMUM left  [{card}]")
    # the CPU's: its fp32 export of the same .npz (above; the tool's int8 export is that
    # file, quantized on the CPU), quantized on the same batches
    t0 = time.perf_counter()
    calib_batches = tool.representative_batches(tool.parse_args(
        ["--model_path", weights, "--output", "-", "--num_classes", "21", *calib]), INPUT)
    with open(cpu_path, "rb") as f:
        cpu8_bytes = schema.encode_model(int8_quantize.quantize(schema.decode_model(f.read()),
                                                                calib_batches))
    cpu8_s = time.perf_counter() - t0
    with open(int8_path, "rb") as f:
        card8_bytes = f.read()
    same = card8_bytes == cpu8_bytes
    diff = "" if same else f": {tflite_buffer_diff(card8_bytes, cpu8_bytes)}"
    check(same, f"the int8 .tflite written on the card is byte-equal to the CPU's from the same "
                f".npz (the CPU's fp32 export quantized in {cpu8_s:.2f} s; {len(card8_bytes)} "
                f"and {len(cpu8_bytes)} bytes){diff}")
    card8 = TFLiteRunner(int8_path)  # the card by default
    check(card8.program.device.type == "cuda", "TFLiteRunner runs an int8 file on the card")
    t0 = time.perf_counter()
    on_card = [card8(x.cpu().numpy()) for x in xs]
    t_card = time.perf_counter() - t0
    t0 = time.perf_counter()
    on_cpu = [TFLiteRunner(int8_path, device="cpu")(x.cpu().numpy()) for x in xs]
    t_cpu = time.perf_counter() - t0
    lsb = 1 / 256  # the SOFTMAX's fixed output scale
    d = max(float(np.abs(a - b).max()) for a, b in zip(on_card, on_cpu))
    differ = sum(int((a != b).sum()) for a, b in zip(on_card, on_cpu))
    check(all(np.isfinite(a).all() and a.shape == b.shape for a, b in zip(on_card, on_cpu))
          and d <= lsb * 1.001,
          f"int8 TFLiteRunner on the card against the same file on the CPU, {len(xs)} "
          f"requests: max|d| {d:.3g} ({d / lsb:.2f} LSB of 1/256; the convs' sums are exact, "
          f"the SOFTMAX is f32), {differ} of {sum(a.size for a in on_card)} values differ; "
          f"{t_card:.2f} s on the card, {t_cpu:.2f} s on the CPU  [{card}]")
    with torch.no_grad():
        refs = [eager(x).cpu().numpy() for x in xs]
    corr, mean = int8_criteria(np.stack(on_card), np.stack(refs))
    agree = float(np.mean([(a.argmax(-1) == r.argmax(-1)).mean() for a, r in zip(on_card, refs)]))
    check(corr > INT8_CORRELATION and mean < INT8_MEAN_DPROB,
          f"int8 .tflite on the card against the eager f32 model (tests/test_tf_export.py's "
          f"criteria): centred log-prob correlation {corr:.4f} > {INT8_CORRELATION}, mean "
          f"|dprob| {mean:.4f} < {INT8_MEAN_DPROB} (masks agree on {agree:.4f} of pixels, "
          f"seeded weights)")
    del card8

    # the SavedModel's graph, decoded by the port's codec, against the .pb's
    pb_program = GraphProgram(load_graph(counts_of["pb"][0]), device="cuda")
    sm = saved_model.load(counts_of["saved_model"][0])
    sig = sm.meta_graphs[0].signature_def["serving_default"]
    sm_program = GraphProgram(sm.meta_graphs[0].graph_def, sig.inputs["image_input"].name,
                              sig.outputs["output_0"].name, "cuda")
    with torch.no_grad():
        same_out = all(torch.equal(sm_program(x), pb_program(x)) for x in xs)
    check(same_out and sm.meta_graphs[0].meta_info_def.tags == ["serve"],
          f"saved_model: the port's codec decodes saved_model.pb (tags "
          f"{sm.meta_graphs[0].meta_info_def.tags}, signature {sig.inputs['image_input'].name} "
          f"-> {sig.outputs['output_0'].name}) and its GraphDef runs through GraphProgram "
          f"bit-equal to the .pb's on {len(xs)} requests")
    del sm_program, pb_program

    # the eval CLI on the trained weights, as a .tflite and as the .npz
    root, list_path = learn["root"], learn["list"]
    toy_classes = os.path.join(root, "classes.txt")
    trained, _, _ = export("mobilenetv2", 4, (LEARN_HW, LEARN_HW), learn["weights"], "tflite",
                           "learn")
    batch = LEARN_BATCH // 2
    metrics = {}
    for name in (trained, learn["weights"]):
        args = eval_cli.parse_args(
            ["--model_type", "mobilenetv2", "--model_path", name, "--model_input_shape",
             str(LEARN_HW), "--batch_size", str(batch), "--dataset_path", root,
             "--dataset_file", list_path, "--classes_path", toy_classes,
             "--out_dir", os.path.join(OUT_DIR, "smoke_tflite_eval")])
        m, eval_s, counts, _ = run_cli(torch, kernels, eval_cli.main, args)
        metrics[name] = m
        launches[f"eval --model_path {os.path.basename(name)} b{batch} (.tflite phase)"] = \
            counts
        print(f"  eval CLI on {os.path.basename(name)} (the toy set, {LEARN_HW}x{LEARN_HW}, "
              f"b{batch}): mIoU {m.miou:.6f} in {eval_s:.2f} s, launches {counts}")
    m_tfl, m_npz = metrics[trained], metrics[learn["weights"]]
    batches = -(-8 // batch)
    tfl_counts = launches[f"eval --model_path {os.path.basename(trained)} b{batch} (.tflite phase)"]
    check(abs(m_tfl.miou - m_npz.miou) <= 1e-3
          and tfl_counts == {**ZERO_LAUNCHES, "confusion_matrix_fused": batches},
          f"eval --model_path x.tflite (f32, file batch 1 run in chunks): mIoU {m_tfl.miou:.6f} "
          f"against the .npz's {m_npz.miou:.6f} (bf16), |d| {abs(m_tfl.miou - m_npz.miou):.2e} "
          f"<= 1e-3; the confusion kernel once a batch ({batches}): {tfl_counts}")
    f32 = build_segmentation_model("mobilenetv2", 4, output_stride=16, fused_aspp=True,
                                   fused_decoder=True, device="cuda")
    load_weights(learn["weights"], f32)
    ref, _ = quiet(lambda: eval_cli.eval_miou(
        f32.eval(), root, get_data_list(list_path, shuffle=False), get_classes(toy_classes),
        model_input_shape=(LEARN_HW, LEARN_HW), batch_size=batch))
    flips = int(np.abs(m_tfl.confusion - ref.confusion).sum()) // 2
    check(flips <= 1e-4 * ref.confusion.sum(),
          f"eval --model_path x.tflite against eval_miou of the f32 model on the .npz's "
          f"weights: {flips} of {int(ref.confusion.sum())} pixels counted elsewhere (<= 1e-4 "
          f"of them), mIoU {m_tfl.miou:.6f} against {ref.miou:.6f}")

    # the eval CLI on an int8 .tflite of the trained weights: their fp32 .tflite (above),
    # quantized as the tool's tflite_int8 would, calibrated on the toy set's images (on
    # its first 4 alone, the masks agreed on 0.985 of the f32 model's pixels)
    toy_set = ["--dataset_path", root, "--dataset_file", list_path]
    images = tool.dataset_batches(SimpleNamespace(
        dataset_path=root, dataset_file=list_path, num_classes=4, calib_batches=1 << 20),
        (LEARN_HW, LEARN_HW))
    trained8 = os.path.join(OUT_DIR, "smoke_learn_int8.tflite")
    with open(trained, "rb") as f:
        content = schema.encode_model(int8_quantize.quantize(schema.decode_model(f.read()),
                                                             images))
    with open(trained8, "wb") as f:
        f.write(content)
    args = eval_cli.parse_args(
        ["--model_type", "mobilenetv2", "--model_path", trained8, "--model_input_shape",
         str(LEARN_HW), "--batch_size", str(batch), *toy_set, "--classes_path", toy_classes,
         "--out_dir", os.path.join(OUT_DIR, "smoke_tflite_eval")])
    m8, eval_s, counts, _ = run_cli(torch, kernels, eval_cli.main, args)
    launches[f"eval --model_path {os.path.basename(trained8)} b{batch} (.tflite phase)"] = \
        counts
    runner8, eager32 = TFLiteRunner(trained8), Inference(f32.eval(), True, False)
    with torch.no_grad():
        agree = float(np.mean([
            (runner8(x).argmax(-1) == eager32(torch.from_numpy(x).cuda()).argmax(-1).cpu()
             .numpy()).mean() for x in images]))
    check(counts == {**ZERO_LAUNCHES, "confusion_matrix_fused": batches}
          and agree >= INT8_MASK_FLOOR,
          f"eval --model_path x.tflite (int8, the trained weights, {len(content)} bytes, "
          f"calibrated on the {len(images)} toy images): mIoU {m8.miou:.6f} in {eval_s:.2f} s, |d mIoU| "
          f"{abs(m8.miou - m_npz.miou):.2e} against the .npz's (bf16) and "
          f"{abs(m8.miou - ref.miou):.2e} against the f32 model's; its masks agree with the f32 "
          f"model's on {agree:.6f} of the {len(images)} images' pixels (>= {INT8_MASK_FLOOR}); "
          f"the confusion kernel once a batch ({batches}): {counts}  [{card}]")
    del runner8, eager32

    results, _, _, text = run_cli(torch, kernels, validate_deeplab.main,
                                  validate_deeplab.parse_args(
        ["--model_path", f"{weights},{fp32_path}", "--model_type", "mobilenetv2",
         "--image_file", os.path.join(REPO, "example", "dog.jpg"), "--classes_path",
         classes_path, "--model_input_shape", str(INPUT[0]), "--output_path", OUT_DIR]))
    print("  validate_deeplab --model_path x.npz,x.tflite on the card:")
    for line in text.strip().splitlines():
        print("    " + line)
    (p_npz, m_npz), (p_tfl, m_tfl) = results[weights], results[fp32_path]
    agree, err = float((m_tfl == m_npz).mean()), float(np.abs(p_tfl - p_npz).max())
    check(len(results) == 2 and agree >= 0.999 and err <= 1e-5,
          f"validate_deeplab: .tflite against the .npz, max|dprob| {err:.3g} <= 1e-5, mask "
          f"agreement {agree:.6f} >= 0.999")

    # unet_standard (TRANSPOSE_CONV, MAX_POOL_2D) and fast_scnn at 1024x2048
    model, weights = model_of("unet_standard", 21, 1)
    path, _, counts = export("unet_standard", 21, INPUT, weights, "tflite", "unet_standard")
    launches["tools/export_model.py --format tflite unet_standard"] = counts
    check({"TRANSPOSE_CONV", "MAX_POOL_2D"} <= set(tflite_ops(path)),
          "unet_standard .tflite holds TRANSPOSE_CONV and MAX_POOL_2D")
    agreement("unet_standard", TFLiteRunner(path), Inference(model, True, False), xs[:2])
    city = make_requests(preprocess_image, CITYSCAPES_REQUEST_SHAPES[:2], CITYSCAPES_HW)
    model, weights = model_of("fast_scnn", 19, 2)
    path, _, counts = export("fast_scnn", 19, CITYSCAPES_HW, weights, "tflite", "fast_scnn")
    launches["tools/export_model.py --format tflite fast_scnn"] = counts
    check({"AVERAGE_POOL_2D", "GATHER"} <= set(tflite_ops(path)),
          "fast_scnn .tflite holds AVERAGE_POOL_2D and GATHER")
    agreement("fast_scnn 1024x2048", TFLiteRunner(path), Inference(model, True, False),
              [torch.from_numpy(data).cuda() for data, _ in city])
    leaked = [m for m in ("tensorflow", "google.protobuf", "flatbuffers") if m in sys.modules]
    check(not leaked, f"no tensorflow, protobuf or flatbuffers module imported "
                      f"({leaked or 'none'})")
    print(f"the .tflite phase took {time.perf_counter() - t_phase:.1f} s  [{card}]")
    return launches


def parallel_data():
    """(train images u8 (steps, B, H, W, 3), train labels u8 (steps, B, H,
    W), val images, val labels), made from the seed in every process:
    labels constant on 32x32 tiles, an ignore band on each image's top."""
    rng = np.random.RandomState(PARALLEL_SEEDS[0])
    n = PARALLEL_STEPS * TRAIN_BATCH + PARALLEL_VAL
    images = rng.randint(0, 256, (n, *INPUT, 3)).astype(np.uint8)
    tiles = rng.randint(0, 21, (n, INPUT[0] // 32, INPUT[1] // 32)).astype(np.uint8)
    labels = tiles.repeat(32, axis=1).repeat(32, axis=2)
    labels[:, :16] = 255
    k = PARALLEL_STEPS * TRAIN_BATCH
    shape = (PARALLEL_STEPS, TRAIN_BATCH)
    return (images[:k].reshape(*shape, *INPUT, 3), labels[:k].reshape(*shape, *INPUT),
            images[k:], labels[k:])


class ParallelVal:
    """The eval set in global batches of PARALLEL_VAL_BATCH a rank: this
    rank's rows of each, so that every configuration runs the model on the
    same 8-image batches."""

    def __init__(self, images, labels, mesh):
        self.images, self.labels, self.mesh = images, labels, mesh

    def epoch_batches(self):
        from deeplabv3p_torch.parallel import shard_batch

        b = PARALLEL_VAL_BATCH * self.mesh.size
        for i in range(0, len(self.images), b):
            images, labels = shard_batch(self.mesh, (self.images[i:i + b], self.labels[i:i + b]))
            yield images, labels, np.tile(np.asarray(INPUT, np.float32), (len(images), 1))


def host_copy(t) -> np.ndarray:
    """An f32 numpy copy of a tensor, which later in-place updates leave alone."""
    import torch

    return t.detach().to("cpu", torch.float32, copy=True).numpy()


def parallel_run(mesh, dtype_name: str, profile_as: str = "") -> dict:
    """One configuration of the data-parallel phase in one activation dtype,
    as rank `mesh.rank`: the eval pass on the seeded weights, then
    PARALLEL_STEPS train steps on this rank's rows of the global batches;
    launch counts of each, the global loss and jaccard a step, the
    parameters before the steps and the variables after step 1; then
    PARALLEL_TIMED more steps, timed; with `profile_as`, one step profiled
    (on rank 0; the other ranks take the same steps unprofiled); the
    parameters after the last step."""
    import torch

    from deeplabv3p_torch.data.augment import preprocess_eval_batch
    from deeplabv3p_torch.losses import get_loss_fn
    from deeplabv3p_torch.models.layers import Dropout
    from deeplabv3p_torch.ops import kernels
    from deeplabv3p_torch.parallel import shard_batch
    from deeplabv3p_torch.train import StageConfig, Trainer

    torch.backends.cudnn.allow_tf32 = False  # f32 is f32 in every process
    torch.backends.cuda.matmul.allow_tf32 = False
    train_images, train_labels, val_images, val_labels = parallel_data()
    model = make_train_model(torch, getattr(torch, dtype_name), seed=PARALLEL_SEEDS[1])
    for m in model.modules():
        if isinstance(m, Dropout):
            m.rate = 0.0
    trainer = Trainer(model, 21, get_loss_fn("crossentropy"), device=mesh.device,
                      log_dir=os.path.join(OUT_DIR, f"smoke_parallel_{mesh.size}_{mesh.rank}"),
                      fused_loss=True, mesh=mesh)
    stage = StageConfig(freeze_level=0, optim_type="sgd", learning_rate=1e-2)
    state = trainer.build_stage_state(stage)
    step = trainer.make_train_step(stage)
    kernels.reset_launch_counts()                    # the eval path starts here
    cm = trainer.evaluate(state, ParallelVal(val_images, val_labels, mesh)).confusion
    eval_launches = kernels.launch_counts()          # ... and ends here
    out = {"rank": mesh.rank, "size": mesh.size, "confusion": cm,
           "eval_launches": eval_launches, "loss": [], "jaccard": [], "ms": [],
           "jax_imported": [m for m in ("jax", "flax", "deeplabv3p_tpu") if m in sys.modules]}
    batches = []
    for i in range(PARALLEL_STEPS):
        x, y = shard_batch(mesh, (train_images[i], train_labels[i]))
        batches.append(preprocess_eval_batch(torch.from_numpy(x).to(mesh.device),
                                             torch.from_numpy(y).to(mesh.device),
                                             num_classes=21))
    out["before"] = {k: host_copy(p) for k, p in model.named_parameters()}
    torch.cuda.synchronize()
    kernels.reset_launch_counts()                    # the train path starts here
    for i, (images, labels) in enumerate(batches):
        t = time.perf_counter()
        metrics = step(state, images, labels, None)
        torch.cuda.synchronize()
        out["ms"].append((time.perf_counter() - t) * 1e3)
        out["loss"].append(metrics["loss"].item())
        out["jaccard"].append(metrics["jaccard"].item())
        if i == 0:
            out["after_step1"] = {k: host_copy(v) for k, v in model.state_dict().items()}
    out["train_launches"] = kernels.launch_counts()  # ... and ends here

    def one_step():
        step(state, *batches[state.step % PARALLEL_STEPS], None)

    for _ in range(PARALLEL_TIMED):
        t = time.perf_counter()
        one_step()
        torch.cuda.synchronize()
        out["ms"].append((time.perf_counter() - t) * 1e3)
    if profile_as and mesh.rank == 0:
        profile_one(torch, one_step, f"one {dtype_name} train step, {profile_as}",
                    f"profile_parallel_{profile_as.split()[0]}.txt", top=8)
    elif profile_as:
        for _ in range(PROFILE_CALLS):
            one_step()
    out["params"] = torch.cat([p.detach().reshape(-1) for p in model.parameters()]).cpu().numpy()
    return out


def parallel_both(mesh, profile_as: str) -> dict:
    """`parallel_run` in bf16 (the train CLI's, profiled as `profile_as`) and
    in f32, as rank `mesh.rank`."""
    return {dt: parallel_run(mesh, dt, profile_as if dt == "bfloat16" else "")
            for dt in PARALLEL_DTYPES}


def parallel_gaps(r: dict, a: dict) -> dict:
    """How far run `r` lands from run `a`: |d| of the loss and jaccard at each
    step, max |d| of the parameters and of the BN buffers after step 1 (and
    where), and step 1's parameter update against `a`'s, |d| / |update|."""
    worst = {"parameters": (0.0, ""), "BN buffers": (0.0, "")}
    for k, want in a["after_step1"].items():
        kind = "BN buffers" if "running_" in k else "parameters"
        d = float(np.abs(r["after_step1"][k] - want).max())
        if d >= worst[kind][0]:
            worst[kind] = (d, k)
    num = sum(float(np.sum((r["after_step1"][k] - a["after_step1"][k]) ** 2)) for k in a["before"])
    den = sum(float(np.sum((a["after_step1"][k] - a["before"][k]) ** 2)) for k in a["before"])
    return {"loss": [abs(x - y) for x, y in zip(r["loss"], a["loss"])],
            "jaccard": [abs(x - y) for x, y in zip(r["jaccard"], a["jaccard"])],
            **worst, "update": (num / den) ** 0.5}


def parallel_phase(torch) -> dict:
    """(a) one process at b16, (b) two gloo ranks sharing the card at b8 each,
    (c) a one-rank NCCL group (15c), each in bf16 and in f32; returns each
    rank's bf16 launch counts by path for the kernels' record.

    f32 (TF32 off) holds the code: (b) and (c) within PARALLEL_F32_BOUNDS of
    (a). bf16 holds it within its own rounding: random-init bf16 training's
    step is mostly rounding at the first layers (on the CPU at 64 px, one
    process's bf16 update is 1.2x its own size away from its f64 update, the
    f32 one 0.013x), so each bf16 gap of (b) and (c) from (a) is held to
    PARALLEL_BF16_FACTOR times the same gap between (a) in bf16 and (a) in
    f32, plus PARALLEL_BF16_FLOOR."""
    import datetime
    import tempfile

    import torch.distributed as dist

    from deeplabv3p_torch.parallel import Mesh, make_mesh, spawn

    t0 = time.perf_counter()
    print(f"data parallelism: mobilenetv2 512x512 OS16, 21 classes, --fused_loss, SGD 1e-2, "
          f"dropout off, {PARALLEL_STEPS} steps on global batches of {TRAIN_BATCH}, bf16 and "
          f"f32 (TF32 off); eval pass over {PARALLEL_VAL} images, {PARALLEL_VAL_BATCH} a "
          f"forward")
    timeout = datetime.timedelta(minutes=5)
    a = parallel_both(Mesh(device=torch.device("cuda", 0)), "a one process b16")
    ta = time.perf_counter()
    b = spawn(parallel_both, 2, "b gloo rank 0 of 2, b8", device="cuda", backend="gloo",
              timeout=timeout, join_timeout=600)
    tb = time.perf_counter()
    with tempfile.TemporaryDirectory(prefix="smoke_nccl_") as tmp:
        mesh = make_mesh(1, "cuda", init_method="file://" + os.path.join(tmp, "store"),
                         backend="nccl", timeout=timeout)
        try:
            c = parallel_both(mesh, "c one-rank NCCL group b16")
        finally:
            dist.destroy_process_group()
    tc = time.perf_counter()
    print(f"  wall: (a) {ta - t0:.1f} s in this process, (b) {tb - ta:.1f} s with the two "
          f"ranks' start, (c) {tc - tb:.1f} s")

    train_want = {**ZERO_LAUNCHES, "upsample_ce_forward": PARALLEL_STEPS,
                  "upsample_ce_backward": PARALLEL_STEPS}
    batches_a = PARALLEL_VAL // PARALLEL_VAL_BATCH
    configs = (("(a) one process b16", [a]), ("(b) gloo rank", b),
               ("(c) one-rank NCCL group", [c]))
    for name, runs in configs:
        for both in runs:
            for dt, r in both.items():
                who = f"{name}{' ' + str(r['rank']) if name.startswith('(b)') else ''}, {dt}"
                want_eval = batches_a // r["size"]
                check(r["train_launches"] == train_want,
                      f"{who}: train launches {r['train_launches']} (each loss kernel once a "
                      "step)")
                check(r["eval_launches"] == {**ZERO_LAUNCHES,
                                             "confusion_matrix_fused": want_eval},
                      f"{who}: eval launches {r['eval_launches']} (confusion once a batch "
                      f"of {PARALLEL_VAL_BATCH})")
                check(not r["jax_imported"],
                      f"{who}: no JAX module imported ({r['jax_imported'] or 'none'})")
                check(np.array_equal(r["confusion"], a[dt]["confusion"]),
                      f"{who}: the summed eval matrix equals (a)'s "
                      f"({int(r['confusion'].sum())} pixels counted)")
    for dt in PARALLEL_DTYPES:
        b0, b1 = b[0][dt], b[1][dt]
        check(b0["loss"] == b1["loss"] and b0["jaccard"] == b1["jaccard"],
              f"(b) {dt}: both ranks log the same global loss and jaccard at every step")
        check(np.array_equal(b0["params"], b1["params"]),
              f"(b) {dt}: the ranks' {b0['params'].size} parameters bit-equal after "
              f"{PARALLEL_STEPS + PARALLEL_TIMED + PROFILE_CALLS * (dt == 'bfloat16')} steps")
    floor = parallel_gaps(a["bfloat16"], a["float32"])  # bf16's own rounding, one process
    print(f"  (a) bf16 against (a) f32, the bf16 yardstick: loss |d| "
          f"{[f'{x:.3g}' for x in floor['loss']]}, jaccard |d| "
          f"{[f'{x:.3g}' for x in floor['jaccard']]}, parameters max |d| "
          f"{floor['parameters'][0]:.3g} ({floor['parameters'][1]}), BN buffers max |d| "
          f"{floor['BN buffers'][0]:.3g}, |d| / |update| {floor['update']:.3g}")
    for name, r in (("(b) two gloo ranks", b[0]), ("(c) one-rank NCCL group", c)):
        for dt in PARALLEL_DTYPES:
            g = parallel_gaps(r[dt], a[dt])
            f32 = dt == "float32"
            if f32:
                bounds = dict(PARALLEL_F32_BOUNDS)
            else:
                bounds = {k: PARALLEL_BF16_FACTOR * (floor[k] if k == "update" else floor[k][0])
                          + PARALLEL_BF16_FLOOR[k] for k in ("parameters", "BN buffers", "update")}
            for i in range(PARALLEL_STEPS):
                loss_a = abs(a[dt]["loss"][i])
                loss_bound = (PARALLEL_F32_BOUNDS["loss"][min(i, 1)] * loss_a if f32 else
                              PARALLEL_BF16_FACTOR * floor["loss"][i]
                              + PARALLEL_BF16_FLOOR["loss"] * loss_a)
                jaccard_bound = (PARALLEL_F32_BOUNDS["jaccard"] if f32 else
                                 PARALLEL_BF16_FACTOR * floor["jaccard"][i]
                                 + PARALLEL_BF16_FLOOR["jaccard"])
                check(g["loss"][i] <= loss_bound and g["jaccard"][i] <= jaccard_bound,
                      f"{name} {dt} step {i + 1}: loss {r[dt]['loss'][i]:.6f} vs (a) "
                      f"{a[dt]['loss'][i]:.6f} (|d| {g['loss'][i]:.3g} <= {loss_bound:.3g}), "
                      f"jaccard {r[dt]['jaccard'][i]:.5f} vs {a[dt]['jaccard'][i]:.5f} "
                      f"(|d| {g['jaccard'][i]:.3g} <= {jaccard_bound:.3g})")
            for kind in ("parameters", "BN buffers"):
                d, k = g[kind]
                check(d <= bounds[kind], f"{name} {dt}: {kind} after step 1 against (a), "
                                         f"max |d| {d:.3g} at {k} (<= {bounds[kind]:.3g})")
            check(g["update"] <= bounds["update"],
                  f"{name} {dt}: step 1's parameter update against (a)'s, |d| / |update| "
                  f"{g['update']:.3g} (<= {bounds['update']:.3g})")
    card = card_line()
    for name, runs in (("(a) one process, b16", [a]),
                       ("(b) two gloo ranks sharing the card, b8 each", b),
                       ("(c) one-rank NCCL group, b16", [c])):
        for both in runs:
            for dt, r in both.items():
                warm = r["ms"][1:]
                print(f"  step times {name}, rank {r['rank']}, {dt}: median "
                      f"{statistics.median(warm):.1f} ms of steps 2-{len(r['ms'])} "
                      f"({', '.join(f'{t:.1f}' for t in r['ms'])} ms; host clock, "
                      f"synchronized; step 1 includes the warm-up)  [{card}]")
    print(f"the data-parallel phase took {time.perf_counter() - t0:.1f} s")
    launches = {}
    for both in b:
        r = both["bfloat16"]
        launches[f"data-parallel train, gloo rank {r['rank']} of 2, b8"] = r["train_launches"]
        launches[f"data-parallel eval, gloo rank {r['rank']} of 2, b8"] = r["eval_launches"]
    launches["data-parallel train, one-rank NCCL group, b16"] = c["bfloat16"]["train_launches"]
    return launches


# -- 15d. spatial partitioning ------------------------------------------------


def spatial_submeshes(world):
    """From a world of 4 gloo ranks (`world`, a (1, 4) mesh): this rank's
    (1, 2) mesh, whose world is its pair {0, 1} or {2, 3} (two replicas),
    and the (2, 2) mesh (spatial groups the pairs, data groups {0, 2} and
    {1, 3}). Every rank makes every group, in one order."""
    import dataclasses

    import torch.distributed as dist

    pairs = [dist.new_group([0, 1]), dist.new_group([2, 3])]
    columns = [dist.new_group([0, 2]), dist.new_group([1, 3])]
    pair = pairs[world.rank // 2]
    one_by_two = dataclasses.replace(world, rank=world.rank % 2, size=2, group=pair,
                                     spatial=2, spatial_group=pair, data_group=None)
    two_by_two = dataclasses.replace(world, spatial=2, spatial_group=pair,
                                     data_group=columns[world.rank % 2])
    return one_by_two, two_by_two


def spatial_image(hw, seed: int) -> np.ndarray:
    """A (1, H, W, 3) request in [-1, 1], as `preprocess_image` gives one."""
    return np.random.RandomState(seed).uniform(-1, 1, (1, *hw, 3)).astype(np.float32)


def spatial_serving_run(torch, mesh, hw, num_classes: int,
                        model_type: str = "mobilenetv2") -> dict:
    """`DeepLab(mesh=...)` (mobilenetv2, OS16, seeded weights, the ASPP and
    decoder kernels on; or `model_type`, which may have no kernel) on one
    request: the f32 logits (TF32 off) of the rows, gathered at their own
    global height, and the bf16 mask; the bf16 launch counts of the
    requests, then SPATIAL_REQUESTS timed requests. `mesh` None: one
    process."""
    from deeplabv3p_torch.inference import DeepLab
    from deeplabv3p_torch.ops import kernels
    from deeplabv3p_torch.parallel.spatial import gather_rows, height_of, own_rows, partitioned

    names = [f"c{i}" for i in range(num_classes)]
    image = spatial_image(hw, SPATIAL_SEEDS[0])
    out = {}
    f32 = DeepLab(device="cuda", dtype=torch.float32, model_type=model_type,
                  class_names=names, model_input_shape=hw, fused_decoder=True, mesh=mesh)
    x = torch.from_numpy(image).to(f32.device)
    with torch.inference_mode():
        if mesh is None:
            logits = f32.model(x.permute(0, 3, 1, 2))
        else:
            with partitioned(mesh, hw) as part:
                rows = f32.model(own_rows(x, mesh).permute(0, 3, 1, 2))
                h = height_of(rows)
            logits = gather_rows(rows.contiguous(), h, part, dim=2)
    out["logits"] = host_copy(logits)
    out["mask_f32"] = f32.predict(image, hw)
    del f32, logits
    bf16 = DeepLab(device="cuda", dtype=torch.bfloat16, model_type=model_type,
                   class_names=names, model_input_shape=hw, fused_decoder=True, mesh=mesh)
    if mesh is None:  # the share of pixels whose top two bf16 logits tie
        with torch.inference_mode():
            top2 = bf16.model(x.permute(0, 3, 1, 2)).float().topk(2, dim=1).values
        out["ties"] = float((top2[:, 0] == top2[:, 1]).float().mean())
        del top2
    bf16.predict(image, hw)  # warm-up
    torch.cuda.synchronize()
    kernels.reset_launch_counts()                    # the serving path starts here
    masks, ms = serve_requests(torch, bf16, [(image, hw)] * SPATIAL_REQUESTS)
    out["launches"] = kernels.launch_counts()        # ... and ends here
    out["mask"], out["ms"] = masks[0], ms
    return out


class SpatialVal:
    """The eval set in batches of SPATIAL_EVAL_BATCH, whole samples: each
    rank of the spatial group runs its rows (`make_eval_step`)."""

    def __init__(self, images, labels):
        self.images, self.labels = images, labels

    def epoch_batches(self):
        for i in range(0, len(self.images), SPATIAL_EVAL_BATCH):
            images = self.images[i:i + SPATIAL_EVAL_BATCH]
            yield (images, self.labels[i:i + SPATIAL_EVAL_BATCH],
                   np.tile(np.asarray(INPUT, np.float32), (len(images), 1)))


def spatial_eval_run(torch, mesh) -> dict:
    """`make_eval_step` + `accumulate_confusion` (mobilenetv2 bf16 as the
    eval CLI builds it, --fused_mbconv on) over SPATIAL_EVAL_IMAGES seeded
    pairs at 512x512; the launch counts of the pass and the matrix."""
    from deeplabv3p_torch.models.factory import build_deeplab_model
    from deeplabv3p_torch.models.layers import init_parameters
    from deeplabv3p_torch.ops import kernels
    from deeplabv3p_torch.train import accumulate_confusion, make_eval_step

    _, _, val_images, val_labels = parallel_data()
    model = build_deeplab_model("mobilenetv2", 21, fused_aspp=True, fused_mbconv=True,
                                dtype=torch.bfloat16, device="cuda")
    init_parameters(model, torch.Generator().manual_seed(SPATIAL_SEEDS[1]))
    step = make_eval_step(model.eval(), 21, mesh)
    data = SpatialVal(val_images[:SPATIAL_EVAL_IMAGES], val_labels[:SPATIAL_EVAL_IMAGES])
    accumulate_confusion(step, data, 21, model.conv_upsample.weight.device,
                         None if mesh is None else mesh.group)  # warm-up
    torch.cuda.synchronize()
    kernels.reset_launch_counts()                    # the eval path starts here
    cm = accumulate_confusion(step, data, 21, model.conv_upsample.weight.device,
                              None if mesh is None else mesh.group)
    launches = kernels.launch_counts()               # ... and ends here
    return {"confusion": cm, "launches": launches, **eval_library_pass(torch, model, data, mesh)}


def eval_library_pass(torch, model, data, mesh, c: int = 21) -> dict:
    """The eval pass once more, each batch's logits (this rank's rows) counted
    by the confusion kernel and by torch.argmax + torch.bincount, each summed
    over the mesh: {'kernel': ..., 'library': ...} (C, C) int64."""
    import torch.distributed as dist

    from deeplabv3p_torch.data.augment import preprocess_eval_batch
    from deeplabv3p_torch.ops.kernels.confusion import confusion_matrix_fused
    from deeplabv3p_torch.parallel.spatial import own_rows, partitioned

    sums = torch.zeros((2, c, c), dtype=torch.int64, device="cuda")
    with torch.no_grad():
        for images, labels, _ in data.epoch_batches():
            images, labels = preprocess_eval_batch(torch.from_numpy(images).cuda(),
                                                   torch.from_numpy(labels).cuda(), c)
            hw = tuple(labels.shape[1:3])
            if mesh is not None:
                images, labels = own_rows(images, mesh), own_rows(labels, mesh)
            with partitioned(mesh, hw):
                logits = model(images.permute(0, 3, 1, 2)).permute(0, 2, 3, 1).contiguous()
            sums[0] += confusion_matrix_fused(labels.contiguous(), logits, c)
            sums[1] += argmax_bincount(torch, labels, logits, c)
    if mesh is not None:
        dist.all_reduce(sums, group=mesh.group)
    kern, lib = sums.cpu().numpy()
    return {"kernel": kern, "library": lib}


def argmax_bincount(torch, labels, logits, c: int):
    """The (C, C) int64 confusion matrix by torch.argmax + torch.bincount,
    labels outside [0, C) dropped."""
    gt = labels.reshape(-1).long()
    idx = torch.where((gt >= 0) & (gt < c), c * gt + torch.argmax(logits, dim=-1).reshape(-1),
                      torch.full_like(gt, c * c))
    return torch.bincount(idx, minlength=c * c + 1)[:c * c].reshape(c, c)


def spatial_trainer(torch, mesh, dtype_name: str, batch: int) -> tuple:
    """(model, step, state, batches): mobilenetv2 512x512 seeded, the plain
    CE, SGD 1e-2, dropout off, and SPATIAL_STEPS global batches of `batch`
    of the data-parallel phase's set; on a spatial `mesh` each batch is the
    data group's whole samples."""
    from deeplabv3p_torch.data.augment import preprocess_eval_batch
    from deeplabv3p_torch.losses import get_loss_fn
    from deeplabv3p_torch.models.layers import Dropout
    from deeplabv3p_torch.train import StageConfig, Trainer

    train_images, train_labels, _, _ = parallel_data()
    model = make_train_model(torch, getattr(torch, dtype_name), seed=PARALLEL_SEEDS[1])
    for m in model.modules():
        if isinstance(m, Dropout):
            m.rate = 0.0
    rank = 0 if mesh is None else mesh.rank
    trainer = Trainer(model, 21, get_loss_fn("crossentropy"), device=torch.device("cuda"),
                      log_dir=os.path.join(OUT_DIR, f"smoke_spatial_{batch}_{rank}"), mesh=mesh)
    stage = StageConfig(freeze_level=0, optim_type="sgd", learning_rate=1e-2)
    state = trainer.build_stage_state(stage)
    d, nd = (0, 1) if mesh is None else (mesh.data_index, mesh.data_size)
    b = batch // nd
    batches = [preprocess_eval_batch(
        torch.from_numpy(train_images[i][d * b:(d + 1) * b]).cuda(),
        torch.from_numpy(train_labels[i][d * b:(d + 1) * b]).cuda(), num_classes=21)
        for i in range(SPATIAL_STEPS)]
    return model, trainer.make_train_step(stage), state, batches


def spatial_train_run(torch, mesh, dtype_name: str, batch: int) -> dict:
    """SPATIAL_STEPS train steps of `spatial_trainer`, recorded as
    `parallel_run` records them; then SPATIAL_TIMED more, timed."""
    from deeplabv3p_torch.ops import kernels

    model, step, state, batches = spatial_trainer(torch, mesh, dtype_name, batch)
    out = {"loss": [], "jaccard": [], "ms": [],
           "before": {k: host_copy(p) for k, p in model.named_parameters()}}
    torch.cuda.synchronize()
    kernels.reset_launch_counts()                    # the train path starts here
    for i, (images, labels) in enumerate(batches):
        t = time.perf_counter()
        metrics = step(state, images, labels, None)
        torch.cuda.synchronize()
        out["ms"].append((time.perf_counter() - t) * 1e3)
        out["loss"].append(metrics["loss"].item())
        out["jaccard"].append(metrics["jaccard"].item())
        if i == 0:
            out["after_step1"] = {k: host_copy(v) for k, v in model.state_dict().items()}
    out["launches"] = kernels.launch_counts()        # ... and ends here
    for i in range(SPATIAL_TIMED):
        t = time.perf_counter()
        step(state, *batches[i % SPATIAL_STEPS], None)
        torch.cuda.synchronize()
        out["ms"].append((time.perf_counter() - t) * 1e3)
    out["params"] = torch.cat([p.detach().reshape(-1) for p in model.parameters()]).cpu().numpy()
    return out


def step2_at(torch, variables: dict, dtype_name: str, batch: int) -> tuple[float, float]:
    """One process's (loss, jaccard) of step 2's global batch of
    `spatial_trainer` (its train-mode forward, before the update) with the
    model's parameters and buffers set to `variables`, a host state dict."""
    model, step, state, batches = spatial_trainer(torch, None, dtype_name, batch)
    model.load_state_dict({k: torch.from_numpy(v) for k, v in variables.items()})
    metrics = step(state, *batches[1], None)
    return metrics["loss"].item(), metrics["jaccard"].item()


def spatial_runs(mesh4=None) -> dict:
    """Every run of the phase, as one process (`mesh4` None) or as rank
    `mesh4.rank` of four gloo ranks sharing the card: serving on (1, 2) at
    1024x2048 and on (1, 4) at 512x512, eval on (1, 2), training on (1, 2)
    at b2 and on (2, 2) at b4, in bf16 and f32."""
    import torch

    torch.backends.cudnn.allow_tf32 = False  # f32 is f32 in every process
    torch.backends.cuda.matmul.allow_tf32 = False
    m12, m22 = (None, None) if mesh4 is None else spatial_submeshes(mesh4)
    meshes = {(1, 2): m12, (1, 4): mesh4, (2, 2): m22}
    out = {"rank": 0 if mesh4 is None else mesh4.rank,
           "jax_imported": [m for m in ("jax", "flax", "deeplabv3p_tpu") if m in sys.modules]}
    for shape, hw, c in SPATIAL_SERVING:
        out[("serve", shape)] = spatial_serving_run(torch, meshes[shape], hw, c)
    shape, hw, c = SPATIAL_UNET
    out[("serve", "unet_simple")] = spatial_serving_run(torch, meshes[shape], hw, c,
                                                        "unet_simple")
    out["eval"] = spatial_eval_run(torch, m12)
    for shape, batch in SPATIAL_TRAINING:
        for dt in PARALLEL_DTYPES:
            out[("train", shape, dt)] = spatial_train_run(torch, meshes[shape], dt, batch)
    return out


def spatial_slabs(h: int, size: int, halo: int, decoder_of: int = 0) -> list[tuple]:
    """(rank, block [lo, hi), slab [a, b)) of every non-empty block of a map
    of height h over `size` spatial ranks, as the spatial path computes
    them (`slab_needs` clipped to the map: `layers._on_slab`, whose kernel
    pads past the edges itself). With `decoder_of` = the encoder map's
    height, the decoder's: the skip slab and the encoder rows it samples,
    (rank, lo, hi, s0, s1, e0, e1) (`Decoder._fused_frontend_rows`)."""
    from deeplabv3p_torch.ops.resize import source_rows
    from deeplabv3p_torch.parallel.spatial import Partition, clip, slab_needs

    part = Partition(size, 0, None, {})
    out = []
    for r, ((lo, hi), (a, b)) in enumerate(zip(part.blocks(h), slab_needs(h, part, halo))):
        if lo < hi:
            a, b = clip(a, b, h)
            out.append((r, lo, hi, a, b, *(source_rows(a, b, decoder_of, h)
                                           if decoder_of else ())))
    return out


def spatial_kernel_checks(torch, kaspp, kdec, kmb, kconf) -> None:
    """The kernels on every slab the spatial phase's ranks hand them: ASPP's
    serving blocks on (1, 2) at 1024x2048 and on (1, 4) at 512x512 and its
    eval blocks on (1, 2) b4 (each block + 18 rows a side inside the map),
    the decoder's serving blocks (+ 1 skip row a side, with their global row
    offsets), the inverted residual's slabs in the eval pass (the 8
    distinct shapes of its 13 blocks, each block + its rate a side), and the
    confusion kernel on an eval rank's block of logits. Each slab against the kernel's plain version on the same slab,
    and cropped to its block against the whole map's call on those rows (at
    `tolerance`, TF32 off; whether the crop is bit-equal is printed); the
    confusion matrix equal to its plain version and to torch.argmax +
    torch.bincount."""
    print("kernels on the spatial path's row slabs, against the plain version and the whole "
          "map:")
    g = torch.Generator(device="cuda").manual_seed(SPATIAL_SEEDS[2])

    def rand(*shape, scale=1.0, dtype=torch.float32):
        return (torch.randn(*shape, generator=g, device="cuda") * scale).to(dtype)

    out_stride = 16  # the phase's mobilenetv2
    aspp_cases = [(f"serving {m} {hw[0]}x{hw[1]}", m[1], 1, hw) for m, hw, _ in SPATIAL_SERVING]
    aspp_cases.append((f"eval (1, 2) b{SPATIAL_EVAL_BATCH}", 2, SPATIAL_EVAL_BATCH, INPUT))
    rates = (6, 12, 18)
    for dtype in (torch.float32, torch.bfloat16):
        for who, size, n, hw in aspp_cases:
            h, w = -(-hw[0] // out_stride), -(-hw[1] // out_stride)
            x = rand(n, h, w, 320, dtype=dtype)
            kern, sc, bi = rand(3, 3, 3, 320, scale=0.2), rand(3, 320).abs() + 0.5, rand(
                3, 320, scale=0.1)
            whole = kaspp.multirate_atrous_depthwise(x, kern, rates, sc, bi)
            for r, lo, hi, a, b in spatial_slabs(h, size, max(rates)):
                slab = kaspp.multirate_atrous_depthwise(x[:, a:b].contiguous(), kern, rates, sc,
                                                        bi)
                err, ref = max_err(slab, kaspp.multirate_atrous_depthwise_reference(
                    x[:, a:b], kern, rates, sc, bi))
                crop, rows = max_err([o[:, lo - a:hi - a] for o in slab],
                                     [o[:, lo:hi] for o in whole])
                tol = tolerance(ref, dtype)
                check(err <= tol and crop <= tol,
                      f"ASPP {who} rank {r} {dtype}: slab {tuple(x[:, a:b].shape)} (rows "
                      f"[{a}, {b}) of {h} for block [{lo}, {hi})): max|err| against plain "
                      f"{err:.3g}, cropped against the whole map's rows {crop:.3g} (<= "
                      f"{tol:.3g}; bit-equal {crop == 0.0})")
        for m, hw, _ in SPATIAL_SERVING:
            he, we, hs, ws = hw[0] // 16, hw[1] // 16, hw[0] // 4, hw[1] // 4
            enc, skip = rand(1, he, we, 256, dtype=dtype), rand(1, hs, ws, 48, dtype=dtype)
            k, sc, bi = rand(3, 3, 304, scale=0.2), rand(304).abs() + 0.5, rand(304, scale=0.1)
            whole = kdec.fused_decoder_frontend(enc, skip, k, sc, bi)
            for r, lo, hi, s0, s1, e0, e1 in spatial_slabs(hs, m[1], 1, decoder_of=he):
                args = (enc[:, e0:e1].contiguous(), skip[:, s0:s1].contiguous(), k, sc, bi,
                        s0, hs, e0, he)
                got = kdec.fused_decoder_frontend(*args)
                err, ref = max_err(got, kdec.fused_decoder_reference(*args))
                crop, _ = max_err(got[:, lo - s0:hi - s0], whole[:, lo:hi])
                tol = tolerance(ref, dtype)
                check(err <= tol and crop <= tol,
                      f"decoder serving {m} {hw[0]}x{hw[1]} rank {r} {dtype}: skip rows [{s0}, "
                      f"{s1}) of {hs} with encoder rows [{e0}, {e1}) of {he} (global row "
                      f"offsets) for block [{lo}, {hi}): max|err| against plain {err:.3g}, "
                      f"cropped against the whole map's rows {crop:.3g} (<= {tol:.3g}; "
                      f"bit-equal {crop == 0.0})")
        for shape in dict.fromkeys(body_block_shapes(SPATIAL_EVAL_BATCH, INPUT)):  # 8 of 13
            rate, residual = shape[6], shape[7]
            xb, *params = mbconv_case(torch, shape, dtype, SPATIAL_SEEDS[2])
            whole = kmb.fused_inverted_residual(xb, *params, rate=rate, residual=residual)
            for r, lo, hi, a, b in spatial_slabs(shape[1], 2, rate):
                slab = xb[:, a:b].contiguous()
                got = kmb.fused_inverted_residual(slab, *params, rate=rate, residual=residual)
                err, ref = max_err(got, kmb.fused_inverted_residual_reference(
                    slab, *params, rate=rate, residual=residual))
                crop, _ = max_err(got[:, lo - a:hi - a], whole[:, lo:hi])
                tol = tolerance(ref, torch.bfloat16)  # its two bf16 roundings (mbconv_checks)
                check(err <= tol and crop <= tol,
                      f"inverted residual {shape} eval (1, 2) rank {r} {dtype}: rows [{a}, {b}) "
                      f"for block [{lo}, {hi}): max|err| against plain {err:.3g}, cropped "
                      f"against the whole map's rows {crop:.3g} (<= {tol:.3g}; bit-equal "
                      f"{crop == 0.0})")
            del xb, params, whole
    # the confusion kernel on an eval rank's block: (1, 2) at 512x512, b4
    n, (h, w), c = SPATIAL_EVAL_BATCH, INPUT, 21
    lo, hi = spatial_slabs(h, 2, 0)[1][1:3]
    for dtype in (torch.float32, torch.bfloat16):  # the eval path's logits are f32
        logits = rand(n, hi - lo, w, c, dtype=dtype)
        labels = torch.randint(0, c + 3, (n, hi - lo, w), generator=g, device="cuda",
                               dtype=torch.int32)
        labels[labels >= c] = 255  # the eval batch's ignore label
        got = kconf.confusion_matrix_fused(labels, logits, c)
        plain = kconf.confusion_matrix_fused_reference(labels, logits, c)
        lib = argmax_bincount(torch, labels, logits, c)
        check(torch.equal(got, plain) and torch.equal(got, lib),
              f"confusion eval (1, 2) rank 1 block {tuple(logits.shape)} {dtype}: equal to the "
              f"plain version {torch.equal(got, plain)}, to torch.argmax + torch.bincount "
              f"{torch.equal(got, lib)} ({int(got.sum())} pixels counted)")
    torch.cuda.empty_cache()


def spatial_phase(torch, kaspp, kdec, kmb, kconf) -> dict:
    """(15d) spatial partitioning on the card: the kernels on row slabs, then
    every run of `spatial_runs` in this process and as four gloo ranks
    sharing the card, held to each other; returns each rank's bf16 launch
    counts by path for the kernels' record. Every multi-rank time here is a
    correctness run of gloo on one card, not a scaling number."""
    import datetime

    from deeplabv3p_torch.parallel import spawn

    t0 = time.perf_counter()
    spatial_kernel_checks(torch, kaspp, kdec, kmb, kconf)
    print(f"spatial partitioning: mobilenetv2 OS16 seeded, serving {SPATIAL_SERVING} "
          f"((mesh, H x W, classes)) and unet_simple {SPATIAL_UNET}, eval b{SPATIAL_EVAL_BATCH} x "
          f"{SPATIAL_EVAL_IMAGES // SPATIAL_EVAL_BATCH} with --fused_mbconv on (1, 2), training "
          f"{SPATIAL_TRAINING} ((mesh, global batch)) at 512x512, {SPATIAL_STEPS} steps, bf16 "
          f"and f32 (TF32 off); four gloo ranks on the one card")
    a = spatial_runs()
    ta = time.perf_counter()
    ranks = spawn(spatial_runs, 4, device="cuda", backend="gloo",
                  timeout=datetime.timedelta(minutes=5), join_timeout=600,
                  axis_names=("data", "spatial"), mesh_shape=(1, 4))
    tb = time.perf_counter()
    print(f"  wall: one process {ta - t0:.1f} s, four ranks {tb - ta:.1f} s with their start")
    card = card_line()
    launches = {}
    for r in ranks:
        check(not r["jax_imported"], f"rank {r['rank']}: no JAX module imported "
                                     f"({r['jax_imported'] or 'none'})")
    served = [(("serve", shape), shape, hw, "mobilenetv2", {
        "multirate_atrous_depthwise": SPATIAL_REQUESTS,
        "fused_decoder_frontend": SPATIAL_REQUESTS}) for shape, hw, _ in SPATIAL_SERVING]
    served.append((("serve", "unet_simple"), SPATIAL_UNET[0], SPATIAL_UNET[1], "unet_simple", {}))
    for key, shape, hw, model_type, kernel_launches in served:
        want = a[key]
        scale = float(np.abs(want["logits"]).max())
        one_vs_f32 = float((want["mask"] == want["mask_f32"]).mean())
        print(f"  one process {model_type} {hw[0]}x{hw[1]}: bf16 mask agrees with its f32 mask "
              f"on {one_vs_f32:.6f} of pixels; top two bf16 logits tie on {want['ties']:.6f}")
        for r in ranks:
            got = r[key]
            who = f"serving {model_type} {shape} {hw[0]}x{hw[1]}, rank {r['rank']}"
            same_shape = got["logits"].shape == want["logits"].shape
            check(same_shape, f"{who}: logits gathered {got['logits'].shape}, one process's "
                              f"{want['logits'].shape}")
            d = (float(np.abs(got["logits"] - want["logits"]).max()) if same_shape
                 else float("inf"))
            check(d <= SPATIAL_F32_LOGITS * scale,
                  f"{who}: f32 logits gathered against one process's, max|d| {d:.3g} "
                  f"({d / scale:.3g} of max|logits| {scale:.3g}; <= {SPATIAL_F32_LOGITS})")
            agree = float((got["mask"] == want["mask"]).mean())
            vs_f32 = float((got["mask"] == want["mask_f32"]).mean())
            f32_agree = float((got["mask_f32"] == want["mask_f32"]).mean())
            check(f32_agree >= SPATIAL_MASK_FLOOR,
                  f"{who}: f32 mask agrees with one process's on {f32_agree:.6f} of pixels "
                  f"(>= {SPATIAL_MASK_FLOOR})")
            if model_type == "unet_simple":
                check(vs_f32 >= one_vs_f32 - SPATIAL_BF16_VS_F32,
                      f"{who}: bf16 mask agrees with one process's f32 mask on {vs_f32:.6f} of "
                      f"pixels, one process's bf16 mask on {one_vs_f32:.6f} (>= that - "
                      f"{SPATIAL_BF16_VS_F32}); with one process's bf16 mask {agree:.6f} "
                      f"(not held: bf16 ties)")
            else:
                check(agree >= SPATIAL_MASK_FLOOR,
                      f"{who}: bf16 mask agrees with one process's on {agree:.6f} of pixels "
                      f"(>= {SPATIAL_MASK_FLOOR}); with its f32 mask {vs_f32:.6f}")
            want_l = {**ZERO_LAUNCHES, **kernel_launches}
            check(got["launches"] == want_l,
                  f"{who}: launches {got['launches']} "
                  f"({'ASPP and decoder once a request' if kernel_launches else 'no kernel'})")
            if kernel_launches:
                launches[f"spatial serving {shape} {hw[0]}x{hw[1]} bf16, gloo rank {r['rank']}, "
                         f"{SPATIAL_REQUESTS} requests"] = got["launches"]
            warm = got["ms"][1:]
            print(f"  request latency, {who}, bf16: median {statistics.median(warm):.2f} ms of "
                  f"requests 2-{len(got['ms'])} ({', '.join(f'{t:.2f}' for t in got['ms'])} ms; "
                  f"host clock, synchronized)  [{card}]")
        warm = want["ms"][1:]
        print(f"  request latency, one process {model_type} {hw[0]}x{hw[1]}, bf16: median "
              f"{statistics.median(warm):.2f} ms  [{card}]")
    batches = SPATIAL_EVAL_IMAGES // SPATIAL_EVAL_BATCH
    want_cm = a["eval"]["confusion"]
    for who, got in [("eval, one process", a["eval"]),
                     *((f"eval (1, 2), rank {r['rank']}", r["eval"]) for r in ranks)]:
        check(np.array_equal(got["kernel"], got["library"]),
              f"{who}: the summed matrix of the kernel on the blocks' logits equals torch.argmax "
              f"+ torch.bincount of the same logits, summed ({int(got['library'].sum())} "
              f"pixels); the eval path's matrix equals this second pass's: "
              f"{np.array_equal(got['kernel'], got['confusion'])}")
    for r in ranks:
        got = r["eval"]
        who = f"eval (1, 2), rank {r['rank']}"
        diff = int(np.abs(got["confusion"] - want_cm).sum()) // 2
        check(got["confusion"].sum() == want_cm.sum()
              and diff <= SPATIAL_EVAL_DISAGREE * want_cm.sum(),
              f"{who}: the summed matrix against one process's: equal {diff == 0}, "
              f"{diff} of {int(want_cm.sum())} pixels elsewhere (<= {SPATIAL_EVAL_DISAGREE})")
        want_l = {**ZERO_LAUNCHES, "multirate_atrous_depthwise": batches,
                  "confusion_matrix_fused": batches, "fused_inverted_residual": 13 * batches}
        check(got["launches"] == want_l,
              f"{who}: launches {got['launches']} (ASPP and confusion once a batch, the "
              f"inverted residual 13 times)")
        launches[f"spatial eval (1, 2) b{SPATIAL_EVAL_BATCH} --fused_mbconv, gloo rank "
                 f"{r['rank']}"] = got["launches"]
    for shape, batch in SPATIAL_TRAINING:
        one = {dt: a[("train", shape, dt)] for dt in PARALLEL_DTYPES}
        # bf16's yardstick: one process's own bf16-vs-f32 gap, at the same
        # parameters: the seeded ones for step 1 and after it; for step 2 the
        # ranks' parameters after step 1 (bit-equal over the ranks), because a
        # bf16 step 1's update is mostly rounding, so one process's bf16 run
        # reaches other parameters (and step-2 losses up to 0.02 apart from
        # run to run; PERF.md)
        yard = parallel_gaps(one["bfloat16"], one["float32"])
        at = {dt: step2_at(torch, ranks[0][("train", shape, "bfloat16")]["after_step1"], dt,
                           batch) for dt in PARALLEL_DTYPES}
        refs = [{dt: (one[dt]["loss"][0], one[dt]["jaccard"][0]) for dt in PARALLEL_DTYPES}, at]
        groups = [[0, 1], [2, 3]] if shape == (1, 2) else [[0, 1, 2, 3]]
        for dt in PARALLEL_DTYPES:
            want = one[dt]
            for g in groups:
                first = ranks[g[0]][("train", shape, dt)]
                same = all(np.array_equal(ranks[i][("train", shape, dt)]["params"],
                                          first["params"])
                           and ranks[i][("train", shape, dt)]["loss"] == first["loss"]
                           for i in g)
                check(same, f"train {shape} b{batch} {dt}: ranks {g} log the same loss and "
                            f"hold bit-equal parameters after {SPATIAL_STEPS + SPATIAL_TIMED} "
                            f"steps")
            f32 = dt == "float32"
            if f32:
                bounds = dict(PARALLEL_F32_BOUNDS)
            else:
                bounds = {k: PARALLEL_BF16_FACTOR * (yard[k] if k == "update" else yard[k][0])
                          + PARALLEL_BF16_FLOOR[k] for k in ("parameters", "BN buffers",
                                                             "update")}
            for r in ranks:
                got = r[("train", shape, dt)]
                who = f"train {shape} b{batch} {dt}, rank {r['rank']}"
                check(got["launches"] == ZERO_LAUNCHES,
                      f"{who}: launches {got['launches']} (no kernel: the inference kernels "
                      f"carry no gradient, the fused loss is refused)")
                gap = parallel_gaps(got, want)
                for i in range(SPATIAL_STEPS):
                    if f32:
                        ref, jref = want["loss"][i], want["jaccard"][i]
                        lb = PARALLEL_F32_BOUNDS["loss"][min(i, 1)] * abs(ref)
                        jb = PARALLEL_F32_BOUNDS["jaccard"]
                        what = "one process"
                    else:
                        (ref, jref), (ref32, jref32) = refs[i]["bfloat16"], refs[i]["float32"]
                        lb = (PARALLEL_BF16_FACTOR * abs(ref - ref32)
                              + PARALLEL_BF16_FLOOR["loss"] * abs(ref32))
                        jb = (PARALLEL_BF16_FACTOR * abs(jref - jref32)
                              + PARALLEL_BF16_FLOOR["jaccard"])
                        what = ("one process" if i == 0 else
                                "one process at the ranks' parameters after step 1")
                    dl, dj = abs(got["loss"][i] - ref), abs(got["jaccard"][i] - jref)
                    check(dl <= lb and dj <= jb,
                          f"{who} step {i + 1}: loss {got['loss'][i]:.6f} vs {what} {ref:.6f} "
                          f"(|d| {dl:.3g} <= {lb:.3g}), jaccard |d| {dj:.3g} (<= {jb:.3g})")
                if not f32:  # the trajectories, printed: step 2 from other parameters
                    print(f"  {who} step 2 against one process's own bf16 run "
                          f"{want['loss'][1]:.6f} and f32 run {one['float32']['loss'][1]:.6f}: "
                          f"|d| {gap['loss'][1]:.3g} and "
                          f"{abs(got['loss'][1] - one['float32']['loss'][1]):.3g} (not held)")
                for kind in ("parameters", "BN buffers"):
                    d, k = gap[kind]
                    check(d <= bounds[kind], f"{who}: {kind} after step 1, max |d| {d:.3g} at "
                                             f"{k} (<= {bounds[kind]:.3g})")
                check(gap["update"] <= bounds["update"],
                      f"{who}: step 1's update against one process's, |d| / |update| "
                      f"{gap['update']:.3g} (<= {bounds['update']:.3g})")
                warm = got["ms"][1:]
                print(f"  step time, {who}: median {statistics.median(warm):.1f} ms of steps "
                      f"2-{len(got['ms'])} ({', '.join(f'{t:.1f}' for t in got['ms'])} ms; "
                      f"host clock, synchronized)  [{card}]")
            print(f"  step time, one process b{batch} {dt}: median "
                  f"{statistics.median(want['ms'][1:]):.1f} ms  [{card}]")
        print(f"  one process b{batch} at the ranks' parameters after step 1, step 2: loss "
              f"bf16 {at['bfloat16'][0]:.6f}, f32 {at['float32'][0]:.6f}; jaccard bf16 "
              f"{at['bfloat16'][1]:.6f}, f32 {at['float32'][1]:.6f}")
    print(f"the spatial phase took {time.perf_counter() - t0:.1f} s")
    return launches


def quiet(fn, *args):
    """(fn(*args), what it printed)."""
    import contextlib
    import io

    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        out = fn(*args)
    return out, buf.getvalue()


def nearest_np(a: np.ndarray, hw) -> np.ndarray:
    """`ops.resize.resize_nearest(convention="cv2")` in numpy: source index
    floor(dst * (in / out)) in f32, clipped."""
    def index(out, n):
        src = np.floor(np.arange(out, dtype=np.float32) * np.float32(n / out)).astype(np.int64)
        return np.clip(src, 0, n - 1)

    return a[index(hw[0], a.shape[0])][:, index(hw[1], a.shape[1])]


def tools_phase(torch, kernels, train_main, train_args) -> dict:
    """(15e) the dataset and evaluation tools on the card machine, which has
    no JAX: the toy set of data/toy.py from example/, packed at 512x512 by
    the port's `pack_dataset` (the shards held equal to the dataset's own
    decode), mobilenetv2 b4 trained TOOLS_STEPS steps on the card from the
    packed path through the train CLI, `label_statistics` and
    `dataset_visualize` on the toy set, the trained model's masks of the toy
    images (`DeepLab`, bf16, the ASPP kernel once a request) written as gray
    PNGs and run through `onboard_png_convert` and `onboard_segment_eval`
    on the card (its matrix held equal to np.bincount over the same PNGs),
    `model_statistics` of mobilenetv2 at 512 on the card (FLOPs >=
    `conv_flops`), and every dataset tool's --help in one subprocess.
    Returns the serving run's launch counts for the kernels' record."""
    import shutil

    from PIL import Image

    from deeplabv3p_torch.data import toy
    from deeplabv3p_torch.data.pipeline import SegmentationDataset
    from deeplabv3p_torch.inference import DeepLab, preprocess_image
    from deeplabv3p_torch.tools import model_statistics, onboard_png_convert, onboard_segment_eval
    from deeplabv3p_torch.tools.dataset_converter import (
        dataset_visualize,
        label_statistics,
        pack_dataset,
    )
    from deeplabv3p_torch.utils.config import get_classes, get_data_list

    t0 = time.perf_counter()
    card = card_line()
    root = os.path.join(OUT_DIR, "tools")
    shutil.rmtree(root, ignore_errors=True)
    data = os.path.join(root, "toy")
    list_path = toy.build_overfit_dataset(data, source_dir=os.path.join(REPO, "example"))
    classes_path = os.path.join(data, "classes.txt")
    names = get_classes(classes_path)
    ids = get_data_list(list_path, shuffle=False)
    print(f"dataset and evaluation tools: the toy set ({len(ids)} pairs, {len(names)} classes) "
          f"from example/")

    # pack at 512x512, the shards against the dataset's own decode
    packed = os.path.join(root, "packed")
    t = time.perf_counter()
    _, text = quiet(pack_dataset.main, ["--dataset_path", data, "--dataset_file", list_path,
                                        "--model_input_shape", f"{TOOLS_HW[0]}",
                                        "--output", packed, "--shard_size", f"{TOOLS_SHARD}"])
    pack_s = time.perf_counter() - t
    print(f"  pack_dataset: {text.strip()}; {pack_s:.3f} s with the tool's start, "
          f"{len(ids) / pack_s:.1f} img/s  [{card}]")
    with open(os.path.join(packed, "meta.json")) as f:
        meta = json.load(f)
    images = np.concatenate([np.load(os.path.join(packed, f"shard_{k}_images.npy"))
                             for k in range(len(meta["shard_sizes"]))])
    labels = np.concatenate([np.load(os.path.join(packed, f"shard_{k}_labels.npy"))
                             for k in range(len(meta["shard_sizes"]))])
    ds = SegmentationDataset(data, meta["ids"], batch_size=1, input_shape=TOOLS_HW,
                             augment=False, shuffle=False)
    same = all(np.array_equal(images[i], ds._load_sample(i)[0])
               and np.array_equal(labels[i], ds._load_sample(i)[1]) for i in range(len(ids)))
    check(same and images.shape == (len(ids), *TOOLS_HW, 3) and sorted(meta["ids"]) == sorted(ids),
          f"pack_dataset: shards {images.shape} uint8 images and {labels.shape} labels in "
          f"{meta['shard_sizes']}, equal to SegmentationDataset's decode of the same ids")

    # mobilenetv2 b4 on the card from the packed path
    log_dir = os.path.join(root, "logs")
    argv = ["--model_type", "mobilenetv2", "--model_input_shape", f"{TOOLS_HW[0]}",
            "--batch_size", f"{TOOLS_BATCH}", "--no_augment", "--transfer_epoch", "0",
            "--total_epoch", f"{TOOLS_STEPS * TOOLS_BATCH // len(ids)}",
            "--dataset_path", packed, "--dataset_file", list_path,
            "--classes_path", classes_path, "--log_dir", log_dir]
    _, wall, counts, _ = run_cli(torch, kernels, train_main, train_args(argv))
    with open(os.path.join(log_dir, "history.jsonl")) as f:
        records = [json.loads(line) for line in f]
    steps = sum(r["steps"] for r in records)
    check(steps == TOOLS_STEPS and all(np.isfinite(r["loss"]) for r in records)
          and os.path.exists(os.path.join(log_dir, "trained_final.npz")),
          f"train CLI on the packed set (mobilenetv2 b{TOOLS_BATCH} bf16, 512x512): {steps} "
          f"steps, losses {[round(r['loss'], 4) for r in records]}, {wall:.1f} s with its "
          f"start; launches {counts}  [{card}]")

    # the label tools on the toy set
    _, text = quiet(label_statistics.main, ["--label_path", os.path.join(data, "labels"),
                                            "--dataset_file", list_path,
                                            "--classes_path", classes_path])
    lines = text.strip().splitlines()
    check(len(lines) == len(names) + 3 and lines[-1].startswith(f"total images: {len(ids)},"),
          f"label_statistics: {lines[-1]}")
    dump = os.path.join(root, "visualize")
    quiet(dataset_visualize.main, ["--dataset_path", data, "--dataset_file", list_path,
                                   "--classes_path", classes_path, "--dump", dump])
    shapes = [Image.open(os.path.join(dump, f"{i}.jpg")).size for i in ids]
    try:  # with matplotlib a 1000x1000 figure with the legend, else the blend alone
        import matplotlib  # noqa: F401
        want = [(1000, 1000)] * len(ids)
    except ImportError:
        want = [Image.open(os.path.join(data, "images", f"{i}.jpg")).size for i in ids]
    check(shapes == want, f"dataset_visualize: {len(shapes)} overlays of sizes "
                          f"{sorted(set(shapes))}, as expected {shapes == want}")

    # the trained model's masks as gray PNGs, then the PNG tools on the card
    served = DeepLab(device="cuda", model_type="mobilenetv2", classes_path=classes_path,
                     model_input_shape=TOOLS_HW,
                     weights_path=os.path.join(log_dir, "trained_final.npz"))
    pred_dir = os.path.join(root, "pred")
    os.makedirs(pred_dir)
    kernels.reset_launch_counts()                    # the serving path starts here
    for i in ids:
        image = Image.open(os.path.join(data, "images", f"{i}.jpg")).convert("RGB")
        mask = served.predict(preprocess_image(image, TOOLS_HW), (image.size[1], image.size[0]))
        Image.fromarray(mask.astype(np.uint8)).save(os.path.join(pred_dir, f"{i}.png"))
    serve_counts = kernels.launch_counts()           # ... and ends here
    check(serve_counts == {**ZERO_LAUNCHES, "multirate_atrous_depthwise": len(ids)},
          f"the toy masks served: launches {serve_counts} (ASPP once a request)")
    palette = os.path.join(root, "palette")
    n, text = quiet(onboard_png_convert.main, ["--input_label_path", pred_dir,
                                               "--output_label_path", palette,
                                               "--classes_path", classes_path])
    same = all(np.array_equal(np.array(Image.open(os.path.join(palette, f"{i}.png"))),
                              np.array(Image.open(os.path.join(pred_dir, f"{i}.png"))))
               and Image.open(os.path.join(palette, f"{i}.png")).mode == "P" for i in ids)
    check(same, f"onboard_png_convert: {len(ids)} palette PNGs holding the gray masks' indices; "
                f"{text.strip().splitlines()[0]}")
    t = time.perf_counter()
    m, text = quiet(onboard_segment_eval.main, [
        "--dataset_file", list_path, "--gt_label_path", os.path.join(data, "labels"),
        "--pred_label_path", pred_dir, "--classes_path", classes_path,
        "--model_output_shape", f"{TOOLS_HW[0]}x{TOOLS_HW[1]}"])
    eval_s = time.perf_counter() - t
    c = len(names)
    want = np.zeros((c, c), np.int64)
    for i in ids:
        gt = nearest_np(np.array(Image.open(os.path.join(data, "labels", f"{i}.png"))).astype(
            np.int64), TOOLS_HW)
        gt[gt > c - 1] = 255
        pred = nearest_np(np.array(Image.open(os.path.join(pred_dir, f"{i}.png"))).astype(
            np.int64), gt.shape)
        ok = gt < c
        want += np.bincount(c * gt[ok] + pred[ok], minlength=c * c).reshape(c, c)
    check(np.array_equal(m.confusion, want),
          f"onboard_segment_eval on the card: its matrix ({int(want.sum())} pixels) equals "
          f"np.bincount over the same PNGs resized; "
          f"{' '.join(text.strip().splitlines()[-4:])}; {eval_s:.3f} s")

    # model statistics on the card
    (n_params, flops), _ = quiet(model_statistics.main, ["--model_type", "mobilenetv2",
                                                         "--model_input_shape",
                                                         f"{TOOLS_HW[0]}"])
    conv = conv_flops(torch, "mobilenetv2", 21, TOOLS_HW)
    check(flops >= conv, f"model_statistics mobilenetv2 512x512 on the card: {n_params} "
                         f"parameters, {flops / 1e9:.3f} GFLOPs (>= the convolutions' "
                         f"{conv / 1e9:.3f})  [{card}]")

    # every dataset tool's --help, one process
    env = dict(os.environ, PYTHONPATH=REPO)
    r = subprocess.run([sys.executable, "-c", TOOLS_HELP, *EVAL_TOOLS], env=env, cwd=root,
                       capture_output=True, text=True, timeout=300)
    check(r.returncode == 0, f"every dataset and evaluation tool's --help in one process: "
                             f"{r.stdout.splitlines()[0] if r.stdout else r.stderr[-500:]}")
    print(f"the tools phase took {time.perf_counter() - t0:.1f} s")
    return {f"tools: the toy set's masks served, {len(ids)} requests": serve_counts}


def phase_profile_checks(record: dict, card: str) -> None:
    """A train_phase_profile record on the card: every phase, in the JAX
    tool's order, a positive time, the step no faster than its gradient, and
    shares of the card's peaks in (0, 100] (FlopCounterMode counts no
    element-wise work, so loss_only has no FLOPs and no MFU)."""
    rows = {r["phase"]: r for r in record["phases"]}
    name = f"{record['model_type']} b{record['batch']} {record['input']}px"
    check([r["phase"] for r in record["phases"]] == DIAG_PHASES,
          f"train_phase_profile {name}: the six phases {list(rows)}")
    check(all(r["ms"] > 0 for r in rows.values())
          and rows["train_step"]["ms"] >= rows["grad (fwd+bwd)"]["ms"],
          f"train_phase_profile {name}: every ms > 0, train_step "
          f"{rows['train_step']['ms']} >= grad {rows['grad (fwd+bwd)']['ms']}  [{card}]")
    shares = [(r["phase"], r["mfu_pct"], r["hbm_pct"]) for r in rows.values()]
    check(all(h is not None and 0 < h <= 100 for _, _, h in shares)
          and all(m is not None and 0 < m <= 100 for p, m, _ in shares if p != "loss_only")
          and rows["loss_only"]["mfu_pct"] == 0,
          f"train_phase_profile {name}: mfu_pct and hbm_pct in (0, 100] (loss_only's MFU 0): "
          f"{shares}")


def diagnostics_phase(torch, kernels, classes_path) -> dict:
    """(15f) the profiler and the diagnostics tools on the card: the phase
    profiler (train_phase_profile) on mobilenetv2_lite and mobilenetv2 b16 at
    512x512, its two JSON records printed, and one train_step of the second
    traced (busy share, top kernels, the host's waits); `utils.profiler.trace` and
    `annotate` around DIAG_TRACED_REQUESTS served mobilenetv2 requests (bf16,
    the ASPP and decoder kernels), the trace holding the annotation and both
    kernels; featuremap_check of mobilenetv2 at 512 on an example/ image on
    the card and on the CPU (seeded weights, the same on both): the same
    files, every map within DIAG_MAP_RTOL of max|map|; convkernel_check
    (--layer Conv, 4 filters, 128 px, 5 steps) on the card and on the CPU:
    the same layer, the PNG; augment_test, 4 samples at 512: 4 JPEGs whose
    labels are drawn in the colour map's colours; export_native_bench_model
    (mobilenetv2_lite, 512) on the card and on the CPU: the files byte-equal,
    the port's executor on the card within DIAG_ONNX_ATOL of the eager f32
    model; and the five tools' --help in the no-JAX process. Returns the
    traced requests' launch counts for the kernels' record."""
    import contextlib
    import glob
    import io
    import shutil

    from deeplabv3p_torch.export.onnx import OnnxProgram, load_onnx
    from deeplabv3p_torch.inference import DeepLab, preprocess_image
    from deeplabv3p_torch.losses import get_loss_fn
    from deeplabv3p_torch.tools import (
        augment_test,
        convkernel_check,
        export_native_bench_model,
        featuremap_check,
        train_phase_profile,
    )
    from deeplabv3p_torch.utils.profiler import annotate, trace
    from deeplabv3p_torch.utils.visualize import create_pascal_label_colormap

    t0 = time.perf_counter()
    card = card_line()
    root = os.path.join(OUT_DIR, "diagnostics")
    shutil.rmtree(root, ignore_errors=True)
    os.makedirs(root)
    image_file = os.path.join(REPO, "example", "2007_000039.jpg")
    label_file = os.path.join(REPO, "example", "2007_000039.png")

    # the phase profiler at its defaults, b16
    for model_type, batch in DIAG_PROFILED:
        out, err = io.StringIO(), io.StringIO()
        t = time.perf_counter()
        with contextlib.redirect_stdout(out), contextlib.redirect_stderr(err):
            rc = train_phase_profile.main(["--model_type", model_type, "--batch", f"{batch}"])
        print(f"train_phase_profile --model_type {model_type} --batch {batch} (512x512, 21 "
              f"classes, bf16; {time.perf_counter() - t:.1f} s with its counts)  [{card}]:")
        for line in err.getvalue().splitlines():
            print(f"  {line}")
        last = out.getvalue().strip().splitlines()[-1]
        print(last)
        check(rc == 0, f"train_phase_profile {model_type}: exit code {rc}")
        if rc == 0:
            phase_profile_checks(json.loads(last), card)

    # one traced train_step of the last profiled model: the card's busy share
    # and the host's waits on the card inside the step
    model_type, batch = DIAG_PROFILED[-1]
    dev = torch.device("cuda")
    model = train_phase_profile.build_phase_model(model_type, 21, dev)
    x, labels, weights = train_phase_profile.phase_batch(batch, INPUT[0], 21, dev)
    state, step = train_phase_profile.phase_train_step(
        model, 21, get_loss_fn("crossentropy"), dev, os.path.join(root, "phase_train_step"))
    prof = profile_one(torch, lambda: step(state, x, labels, weights, 1.0),
                       f"one train_phase_profile train_step ({model_type} b{batch})",
                       "profile_phase_train_step.txt")
    if prof is not None:
        waits = {e.key: e.count for e in prof[0] if e.key in DIAG_HOST_WAITS}
        print(f"  the host's waits in that step: {waits}  [{card}]")
    del model, state, step

    # trace + annotate around served requests with both kernels
    served = DeepLab(model_type="mobilenetv2", classes_path=classes_path, model_input_shape=INPUT,
                     fused_decoder=True, device="cuda")
    requests = make_requests(preprocess_image)[:DIAG_TRACED_REQUESTS]
    served.predict(*requests[0])
    log_dir = os.path.join(root, "trace")
    kernels.reset_launch_counts()                    # the traced requests start here
    with trace(log_dir):
        with annotate(DIAG_ANNOTATION):
            for data, hw in requests:
                served.predict(data, hw)
        torch.cuda.synchronize()
    counts = kernels.launch_counts()                 # ... and end here
    files = glob.glob(os.path.join(log_dir, "*.pt.trace.json"))
    text = ""
    if files:
        with open(files[0]) as f:
            text = f.read()
    found = {n: n in text for n in (DIAG_ANNOTATION, *DIAG_KERNEL_NAMES)}
    check(len(files) == 1 and all(found.values())
          and counts == {**ZERO_LAUNCHES, "multirate_atrous_depthwise": DIAG_TRACED_REQUESTS,
                         "fused_decoder_frontend": DIAG_TRACED_REQUESTS},
          f"trace + annotate: {len(files)} trace file(s) of {len(text)} bytes, found {found}; "
          f"launches {counts}")

    # featuremap_check on the card and on the CPU, seeded weights
    dirs = {}
    for device in ("cuda", "cpu"):
        dirs[device] = os.path.join(root, f"featuremaps_{device}")
        t = time.perf_counter()
        names, _ = quiet(featuremap_check.main, ["--model_type", "mobilenetv2", "--image_file",
                                                 image_file, "--output_path", dirs[device],
                                                 "--device", device])
        print(f"  featuremap_check mobilenetv2 512x512 --device {device}: {len(names)} maps, "
              f"{time.perf_counter() - t:.1f} s")
    files = {d: sorted(os.listdir(dirs[d])) for d in dirs}
    worst, bad = 0.0, []
    for n in files["cpu"]:
        if n.endswith(".npy") and n in files["cuda"]:
            got, want = (np.load(os.path.join(dirs[d], n)) for d in ("cuda", "cpu"))
            err = float(np.abs(got - want).max()) / max(float(np.abs(want).max()), 1e-30)
            worst = max(worst, err)
            if got.shape != want.shape or not err <= DIAG_MAP_RTOL:
                bad.append(n)
    check(files["cuda"] == files["cpu"] and not bad,
          f"featuremap_check on the card against the CPU: {len(files['cuda'])} files each, the "
          f"same names {files['cuda'] == files['cpu']}; worst max|d| / max|map| {worst:.3g} <= "
          f"{DIAG_MAP_RTOL} (TF32 off); over it: {bad[:5]}")

    # convkernel_check on the card and on the CPU
    chosen = {}
    for device in ("cuda", "cpu"):
        png = os.path.join(root, f"kernel_viz_{device}.png")
        t = time.perf_counter()
        (layer, _), _ = quiet(convkernel_check.main, [*DIAG_KERNEL_ARGS, "--output", png,
                                                      "--device", device])
        chosen[device] = (layer, os.path.getsize(png) if os.path.exists(png) else 0)
        print(f"  convkernel_check --device {device}: {time.perf_counter() - t:.1f} s")
    check(chosen["cuda"][0] == chosen["cpu"][0] and chosen["cuda"][1] > 0,
          f"convkernel_check {' '.join(DIAG_KERNEL_ARGS)}: layer {chosen['cuda'][0]!r} on the "
          f"card, {chosen['cpu'][0]!r} on the CPU; PNG of {chosen['cuda'][1]} bytes")

    # augment_test on the card
    aug_dir = os.path.join(root, "augment")
    t = time.perf_counter()
    sides, _ = quiet(augment_test.main, ["--image_file", image_file, "--label_file", label_file,
                                         "--output_path", aug_dir, "--count",
                                         f"{DIAG_AUGMENT_COUNT}"])
    aug_s = time.perf_counter() - t
    colours = {tuple(v) for v in create_pascal_label_colormap()[:22]}
    drawn = set().union(*({tuple(v) for v in s[:, INPUT[1]:].reshape(-1, 3)} for s in sides))
    jpgs = sorted(os.listdir(aug_dir))
    check(jpgs == [f"augment_{i}.jpg" for i in range(DIAG_AUGMENT_COUNT)] and drawn <= colours,
          f"augment_test on the card: {jpgs} in {aug_s:.1f} s, the labels in {len(drawn)} of "
          f"the colour map's colours")

    # export_native_bench_model on the card and on the CPU
    onnx_files = {d: os.path.join(root, f"native_bench_{d}.onnx") for d in ("cuda", "cpu")}
    for device, path in onnx_files.items():
        t = time.perf_counter()
        quiet(export_native_bench_model.main, [path, "--device", device])
        print(f"  export_native_bench_model --device {device}: {time.perf_counter() - t:.1f} s")
    with open(onnx_files["cuda"], "rb") as f, open(onnx_files["cpu"], "rb") as g:
        same = f.read() == g.read()
    program = OnnxProgram(load_onnx(onnx_files["cuda"]), "cuda")
    model = export_native_bench_model.build_model("mobilenetv2_lite", torch.device("cuda"))
    x = torch.from_numpy(requests[0][0]).cuda()
    with torch.inference_mode():
        want = torch.softmax(model(x.permute(0, 3, 1, 2)), dim=1).permute(0, 2, 3, 1)
        got = program({program.inputs[0]: x})[program.outputs[0]]
    err = (got - want).abs().max().item()
    check(same and err <= DIAG_ONNX_ATOL,
          f"export_native_bench_model mobilenetv2_lite 512: the card's file byte-equal to the "
          f"CPU's {same} ({os.path.getsize(onnx_files['cuda'])} bytes, IO {program.inputs} -> "
          f"{program.outputs}); the executor on the card against the eager f32 model: max|d| "
          f"{err:.3g} <= {DIAG_ONNX_ATOL}")

    # the five tools' --help with no JAX
    env = dict(os.environ, PYTHONPATH=REPO)
    r = subprocess.run([sys.executable, "-c", TOOLS_HELP, *DIAGNOSTICS_TOOLS], env=env, cwd=root,
                       capture_output=True, text=True, timeout=300)
    ran = r.stdout.splitlines()[-1].split() if r.returncode == 0 and r.stdout else []
    check(r.returncode == 0 and {f"deeplabv3p_torch.tools.{n}" for n in DIAGNOSTICS_TOOLS}
          <= set(ran), f"the diagnostics tools' --help with no JAX: "
                       f"{r.stdout.splitlines()[0] if r.stdout else r.stderr[-500:]}")
    print(f"the diagnostics phase took {time.perf_counter() - t0:.1f} s")
    return {f"diagnostics: mobilenetv2 served under trace + annotate, {DIAG_TRACED_REQUESTS} "
            "requests": counts}


def card_line() -> str:
    from deeplabv3p_torch.utils.card import card_text

    return card_text(0)


def confusion_times(torch, kconf, rec, launches) -> dict:
    """The confusion kernel's time against its plain version at the eval
    slice's shape, and beside it the library's two calls: torch.argmax to an
    int64 map, then torch.bincount of the joint index (the index arithmetic
    between them is not timed)."""
    labels, logits, c = rec["case"]
    ms, plain_ms = ab_ms(lambda: kconf.confusion_matrix_fused(labels, logits, c),
                         lambda: kconf.confusion_matrix_fused_reference(labels, logits, c),
                         iters=20)
    preds = torch.argmax(logits, dim=-1)
    gt = labels.reshape(-1).long()
    idx = torch.where((gt >= 0) & (gt < c), c * gt + preds.reshape(-1),
                      torch.full_like(gt, c * c))
    argmax_ms = event_ms(lambda: torch.argmax(logits, dim=-1), 20)
    bincount_ms = event_ms(lambda: torch.bincount(idx, minlength=c * c + 1), 20)
    # each logit and label read once, the (C, C) int64 matrix written once; one
    # compare a logit
    bound_ms, bound_by = bound(nbytes(labels, logits) + 8 * c * c, logits.numel())
    print(f"confusion_matrix_fused: kernel {ms * 1e3:.2f} us, plain {plain_ms * 1e3:.2f} us a "
          f"call (CUDA events, mean of 2x20 calls each, {tuple(logits.shape)} {logits.dtype} "
          f"logits, {labels.dtype} labels); the library's two calls: torch.argmax "
          f"{argmax_ms * 1e3:.2f} us + torch.bincount {bincount_ms * 1e3:.2f} us  [{card_line()}]")
    return {"name": "confusion_matrix_fused", "route": "cuda",
            "source": "deeplabv3p_torch/ops/kernels/csrc/confusion.cu",
            "replaces": "deeplabv3p_tpu/ops/pallas/confusion.py:67",
            "launches": launches["confusion_matrix_fused"], "max_abs_err": rec["max_abs_err"],
            "ms": ms, "plain_ms": plain_ms, "bound_ms": bound_ms, "bound_by": bound_by,
            "library_ms": argmax_ms + bincount_ms,
            "library_calls": {"torch.argmax": argmax_ms, "torch.bincount": bincount_ms}}


def mbconv_bound(shape, n_bytes: float) -> tuple[float, str]:
    """(least ms, which limit): the two 1x1 products, counted once (not per
    weight part, not per halo recompute), at the tensor cores' dense bf16
    rate plus the 3x3 depthwise stencil at the f32 FMA rate, or the bytes
    over the memory rate, whichever is larger. The inverted residual's two
    products are the only bf16 tensor-core work of the six kernels; every
    other kernel multiplies by f32 weights in f32."""
    from deeplabv3p_torch.utils.card import BF16_TENSOR_FLOPS, F32_FLOPS, HBM_BYTES_PER_S

    n, h, w, cin, cexp, cout = shape[:6]
    by_ops = (2 * n * h * w * (cin * cexp + cexp * cout) / BF16_TENSOR_FLOPS
              + 2 * 9 * n * h * w * cexp / F32_FLOPS) * 1e3
    by_bytes = n_bytes / HBM_BYTES_PER_S * 1e3
    return (by_bytes, "bytes") if by_bytes >= by_ops else (by_ops, "operations")


def mbconv_times(torch, kmb, rec, launches, state) -> dict:
    """The inverted-residual kernel at each of the body's 13 shapes (bf16,
    batch 8) against its plain version and its bound, and each block of the
    body as a module, fused against its standard route (bf16 convolutions,
    f32 BatchNorm, relu6). The kernel is timed as the module calls it, with
    its weights prepared once; the time of a call that prepares them on the
    fly is printed beside it. The JSON row's times are sums over the 13
    shapes: one forward's worth of calls."""
    from deeplabv3p_torch.ops.kernels._build import load_library

    rows = []
    card = card_line()
    body = state["with_mbconv"].backbone
    blocks = [b for b in (getattr(body, f"block_{i}") for i in range(17))
              if b.has_expand and b.stride == 1]
    print(f"fused_inverted_residual at the body's 13 shapes, bf16 (CUDA events, mean of 2x20 "
          f"calls each; device = the profiler's kernel time; module = the block as the model "
          f"calls it)  [{card}]:")
    for shape, block in zip(rec["shapes"], blocks):
        n, h, w, cin, cexp, cout, rate, residual = shape
        args = mbconv_case(torch, shape, torch.bfloat16)
        prepared = kmb.prepare_inverted_residual(*args[1:], rate=rate, elem_size=2)
        cfg = prepared.config
        ms, plain_ms = ab_ms(
            lambda: kmb.fused_inverted_residual(*args, rate=rate, residual=residual,
                                                prepared=prepared),
            lambda: kmb.fused_inverted_residual_reference(*args, rate=rate, residual=residual),
            iters=20)
        unprepared_ms = event_ms(
            lambda: kmb.fused_inverted_residual(*args, rate=rate, residual=residual), 20)
        dev_us, _ = device_us(torch, lambda: kmb.fused_inverted_residual(
            *args, rate=rate, residual=residual, prepared=prepared), calls=20)
        per_sm = load_library().fused_inverted_residual_blocks_per_sm(1, cout, cfg.smem_bytes)
        weights = nbytes(*args[1:])
        flops = 2 * n * h * w * (cin * cexp + 9 * cexp + cexp * cout)
        bound_ms, bound_by = mbconv_bound(
            shape, nbytes(args[0]) + n * h * w * cout * 2 + weights)
        x = args[0].permute(0, 3, 1, 2)

        def run(fused):
            block.fused_inference = fused
            with torch.inference_mode():
                return block(x)

        mod_fused, mod_plain = ab_ms(lambda: run(True), lambda: run(False), iters=20)
        block.fused_inference = True
        rate_text = ("rate not measured" if dev_us is None
                     else f"{flops / (dev_us * 1e-6) / 1e12:.2f} TFLOP/s")
        print(f"  {shape}: kernel {ms * 1e3:.1f} us (device {us_text(dev_us, 1)}, "
              f"{rate_text}; {cfg.smem_bytes} B shared, "
              f"{per_sm} block(s) an SM, chunk {cfg.chunk} x {cfg.stages} buffers), bound "
              f"{bound_ms * 1e3:.1f} us by {bound_by}, plain {plain_ms * 1e3:.1f} us, preparing "
              f"on the fly {unprepared_ms * 1e3:.1f} us; module fused {mod_fused * 1e3:.1f} us, "
              f"standard {mod_plain * 1e3:.1f} us")
        rows.append({"shape": list(shape), "ms": ms,
                     "device_ms": None if dev_us is None else dev_us * 1e-3,
                     "plain_ms": plain_ms, "bound_ms": bound_ms, "bound_by": bound_by,
                     "unprepared_ms": unprepared_ms, "blocks_per_sm": per_sm,
                     "module_fused_ms": mod_fused, "module_standard_ms": mod_plain})
        del args, x
    total = {k: sum(r[k] for r in rows) for k in ("ms", "plain_ms", "bound_ms",
                                                  "unprepared_ms", "module_fused_ms",
                                                  "module_standard_ms")}
    # the device total only where every shape's trace gave a time
    total["device_ms"] = (None if any(r["device_ms"] is None for r in rows)
                          else sum(r["device_ms"] for r in rows))
    device_total = None if total["device_ms"] is None else total["device_ms"] * 1e3
    print(f"  the 13 calls: kernel {total['ms'] * 1e3:.1f} us (device "
          f"{us_text(device_total, 1)}), bound {total['bound_ms'] * 1e3:.1f} us, plain "
          f"{total['plain_ms'] * 1e3:.1f} us, preparing on the fly "
          f"{total['unprepared_ms'] * 1e3:.1f} us; modules fused "
          f"{total['module_fused_ms'] * 1e3:.1f} us, standard "
          f"{total['module_standard_ms'] * 1e3:.1f} us")
    by = {r["bound_by"] for r in rows}
    return {"name": "fused_inverted_residual", "route": "cuda",
            "source": "deeplabv3p_torch/ops/kernels/csrc/mbconv.cu",
            "replaces": "deeplabv3p_tpu/ops/pallas/mbconv.py:136",
            "launches": launches["fused_inverted_residual"],
            "max_abs_err": rec["max_abs_err"], "ms": total["ms"],
            "plain_ms": total["plain_ms"], "bound_ms": total["bound_ms"],
            "bound_by": by.pop() if len(by) == 1 else "operations", "library_ms": None,
            "device_ms": total["device_ms"], "unprepared_ms": total["unprepared_ms"],
            "module_fused_ms": total["module_fused_ms"],
            "module_standard_ms": total["module_standard_ms"], "per_shape": rows}


if __name__ == "__main__":
    main()
