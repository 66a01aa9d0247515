#!/usr/bin/env python3
"""Smoke run of the PyTorch/H100 port (``iclr_17_compression_tpu_torch``) on one GPU.

Run from the root of a checkout, on a machine with one NVIDIA H100:

    python3 chip_smoke.py

Phases, one JSON line each:
  device  the card (torch and nvidia-smi); exits non-zero without CUDA
  build   nvcc of the CUDA kernels and g++ of the rANS coder, with seconds
          (under 60 s from clean), and each kernel's registers, shared memory
          and spills as ptxas reports them
  k1/k2/k3  each kernel against its plain PyTorch version on the card at the
          shapes of the main path (one 768×512 image, N=128): error against
          the stated tolerance (max abs and rel error), the wrapper's launch
          counter so far, kernel, plain and library device times (CUDA
          events around a batch of calls queued behind a sleep kernel, median
          of 20 after 3 warm-ups), the kernel's time for one call from an idle
          queue (wrapper included), and the bound from the shapes (for K3
          also an empty kernel's launch in the same harness, the floor under
          its time: launch_floor_ms); K1 and K2
          also give the same bits on a second call, and hold at the widths
          off the main path (K1 at C=192 and 256, K2 at Cout=192)
  main    the Ballé-17 file codec at N=128 with the archived lam2048 weights
          on 4 synthetic 768×512 images: encode → bytes → decode, with the
          launch counters reset just before and read just after; then the
          checks (symbols round-trip exactly, recon finite in [0, 1], rANS
          bpp within 3% of the model's estimate, 3/1/2 launches of K2/K3/K1
          per image, GPU decode equal to the CPU decode of the same file)
  profile one encode + decode under torch.profiler: device busy time by
          kernel against the wall time, and the host coder stages' times
  train   the Ballé-17 training path at full width (N=128, batch 4, 256×256
          crops, λ 8192, the config of examples/balle17.json) on 16
          synthetic 512×512 PPM training images and 2 768×512 test images
          written under build/: the training CLI's main (train_single_image)
          for 100 steps, then --resume to 120, with the launch counters reset just before and
          read just after (K2 3 and K1 2 launches a step, the eval's
          launches excluded); checks: every rd_loss finite and the last 10
          steps' mean below the first 10's; the gradient of every parameter
          through the kernels' autograd Functions against the plain path on
          the card (GRAD_TOL); K2 at the three training stages and K1 at the
          two training IGDN shapes against their plain versions, with split
          counts and times; the resume starts at step 100 from parameters
          and Adam moments read back bit-equal, on the batch the
          uninterrupted loop would draw; the last iter_<step>.ckpt loads
          through load_balle17 and codes a test image with exact symbols; a
          model moved to the card by hand with TF32 on trains in fp32.
          Numbers: median step ms over steps 20-100 and images/s, peak
          memory, the step's phases (CUDA events), a 5-step profile (device
          busy, idle share, K1/K2 backward recompute, top kernels), the
          eval's bpp, PSNR and MS-SSIM
  dsc     the flagship DSC stereo codec (temp_0031bpp, n = 128, full width)
          on the port's seeded init, 4 synthetic stereo pairs at 320×1216:
          encode_image → bytes → decode_image with the right image as side
          information, with the launch counters reset just before and read
          just after (K2 4 + 7 and K3 1 per image); checks: the symbols and
          K3's dequantized code round-trip exactly, the recon is finite in
          [0, 1], GPU decode equals the CPU decode of one file, GPU symbols
          equal the CPU ones up to rounding flips; the files' codes use all
          17 symbols and hold the clamp at ±128; a two-stage file (a second
          model as the reg_0_0625 stage) round-trips. Every GDN and IGDN is
          moved off its identity init (a full γ, not symmetric), g_a22's
          last conv is scaled so that the code spreads past the clip, and
          g_s22's first conv takes it in steps. Numbers: batch-4 serving ms and Mpix/s, one image's
          profile (device busy, idle share, host coder stages), K2 at each
          DSC shape (splits, times, cuDNN + plain GDN, cuDNN + K1), K1 at
          C = 64, K3 at step 16
  dsc_train  DSC training at full width: temp_0031bpp (n = 128) through the
          training CLI on examples/dsc_0031bpp.json (batch 2, MS-SSIM), on
          12 synthetic stereo pairs of KITTI's 375×1242 written as a KITTI
          layout of PNGs under build/ (crops 315×1215 floored to 288×1184)
          and a 2-frame test root: 48 steps, then --resume for 12 more, with
          the launch counters reset just before and read just after; checks:
          K2 17 launches a step and a validation frame, K3 0 a step and 1 a
          validation frame, K1 none (DSC's GDNs run fused in K2); every
          loss finite and the last 10 steps' mean below the first 10's; the gradient of every parameter through K2's
          Function against the plain path on the card within 4× a floor
          measured in the same run (the plain path against itself with K2's
          outputs moved by K2's own error; DSC_GRAD_TOL), on the largest
          and on the median tensor's gap, and a control at TF32's error
          (1e-3 relative) beyond one of the two gates; K2 at the training
          sites (five shapes) and K3 at the validation code against plain;
          the resume's parameters, Adam moments, LR and plateau state read
          back bit-equal and its first batch the uninterrupted loop's;
          best_train.ckpt through load_dsc and the codec CLI with exact
          symbols; reg_stage for 4 steps over the trained model written as
          JAX-layout params (K2 28, K3 1 and K1 0 a step, the frozen base
          bit-unchanged, finite losses); a model moved to the card by hand
          with TF32 on trains in fp32. Numbers: median step ms and pairs/s,
          peak memory, a 5-step profile (device busy, idle share, K2
          forward, K2's backward recompute, cuDNN's convolutions, top
          kernels), validation ms a frame, K2 at each training shape with
          cuDNN + plain GDN and cuDNN + K1 and its bound, K3 against its
          launch floor
  hyper   the scale-hyperprior (both quantizers) and joint-AR codecs at
          N = 192, M = 320 (the codec CLI's defaults) on the port's seeded
          init, every GDN off the identity and the analysis and
          hyper-analysis outputs spread over many symbols, on 2 synthetic
          768×512 images: encode_image → bytes → decode_image, with the launch
          counters reset just before and read just after (per image: the
          hyperprior encode K2 3, decode K1 3; joint encode K2 3, decode K2 3;
          K1 0 on joint); checks: ŷ and ẑ round-trip exactly (joint: the
          decoder's ŷ bit-equal to the encoder's), each file equal to a second
          encode, the hyperprior's decoded recon within 1e-4 of its eval
          forward's, recon finite in [0, 1], the eval forwards' launches (K2
          3 + K1 3, K2 6), cuDNN not benchmarking; σ's scale-index flips
          between the card and the CPU for the same ẑ, and the CPU decode of
          the card's file of a crop where they are 0; the native host AR
          against numpy front by front and a numpy-backend file round trip.
          Numbers: encode / decode ms, rANS bpp against the estimate, the
          symbols' spread, host AR ms (native, numpy), one joint encode +
          decode profiled, peak memory, K2 at the six C = 192 shapes (5×5 s2
          and 3×3 s1 GDN / IGDN; S, partial bytes, cuDNN + plain GDN, cuDNN +
          K1) and K1 at the three IGDN shapes against plain
  hyper_train  hyperprior and joint-AR training at N = 192, M = 320 (the
          training settings of examples/balle17.json: batch 4, 256×256 crops,
          λ 8192, lr 1e-4) through the training CLI on 8 synthetic 512×512
          PPMs and a 768×512 test image: 30 steps of each, then --resume to
          40, and 4 steps of the sigma-norm quantizer, with the launch
          counters reset just before and read just after (hyperprior K2 3 +
          K1 3 a step, joint K2 6; the eval's apart); checks: the resume's
          parameters and Adam moments read back bit-equal and its first batch
          the uninterrupted loop's, every rd_loss finite and the last 10
          steps' mean below the first 10's, the gradient of every parameter
          through K2's and K1's Functions against the plain path within 4× a
          floor measured in the same run, for the largest tensor's gap and
          for the median tensor's, with a TF32-size control beyond that gate,
          the trained checkpoints (the JAX-layout iter file and the
          train-state file) through the codec CLI (kinds 5 and 6) with the
          same file from both and exact symbols. Numbers: median step ms and
          images/s (the joint's loop under cuDNN autotuning), a step under
          cuDNN's defaults and autotuned, a 5-step profile of each model
          (device busy, idle share), peak memory, K2 at the six and K1 at
          the three C = 192 training shapes against plain and cuDNN (S,
          partial bytes)
  dsc_fusion  the four DSC fusion presets (att_0031bpp, bottleneck_att_1bpp
          with its 32-channel code, fif_0031bpp, pam_0031bpp) at n = 128 on
          the dsc phase's seeded weights, one synthetic 320×1216 pair each
          through the file codec, the counters around it only (K2 4 + 7 and
          K3 1 an image); checks: the symbols and K3's code round-trip
          exactly, the recon finite in [0, 1], the CPU decode of the same
          file within 1e-4, K3 bit-exact; then train_dsc (batch 2, 288×1184
          crops) of att_0031bpp, bottleneck_att_1bpp and pam_0031bpp for 4
          steps each on synthetic KITTI frames: every loss finite, K2 17 a
          step. Numbers: encode / decode ms, serving ms and device busy ms
          an image (one profiled), K2
          at the bottleneck preset's sites and K3 on each preset's code
          against plain, step ms
  aux     the six auxiliary trainers through the training CLI's main at the
          JAX TrainConfig's defaults (batch 4, image_size 256, lr 1e-4,
          KITTI layout) for 20 steps each: two_steps and decoder_only over
          the archived Ballé-17 (frozen), att_exp, att_block over a seeded
          temp_1bpp (frozen, written as a JAX params file), passr on the
          dsc_train phase's KITTI frames, fif_enhance on 4 triplets of
          KITTI's size written under build/; the counters reset before and
          read after each step (K2 6 a step for two_steps, K2 6 + K1 4 for
          decoder_only, K2 17 + K3 1 for att_block, none for the others);
          checks: every loss finite and the last 5 steps' mean below the
          first 5's, the frozen models bit-unchanged, each best_train.ckpt
          back through _load_frozen and load_params_partial, decoder_only's
          gradients through K1's Function against the plain path (GRAD_TOL),
          and K1 at C = 128 at its two IGDN shapes against plain, with its
          times and bound; then K1 at C = 512 at AnalysisSmall's GDNs and SynthesisSmall's
          IGDNs (batch 4 of 16×16) against plain, with the same bits on a
          second call, its times and bound, and one AnalysisSmall →
          SynthesisSmall forward on the card (K1 6) within 1e-4 of its
          largest |value| of the CPU's. Numbers: median step ms, peak memory
          and seconds of each trainer
  eval    the evaluation and analysis tools with the archived weights at full
          width, each step's launches counted on its own (K2 3 + K1 2 a
          Ballé-17 forward, K2 17 + K3 1 a flagship forward, K2 3 + K1 2 +
          K3 1 a Ballé file): the four Ballé-17 checkpoints (N = 128) through
          eval_kodak with rANS on 4 synthetic 768×512 images (finite, rANS
          bpp within 3% of the estimate; one image against the CPU with the
          card's tables: PSNR within 1e-3 dB, bpp 0.1%), code_distribution,
          eval_single_image and average_two_models(A, A) (equal, under
          deterministic cuDNN), mix_encoder_decoder(lam128, lam2048), and
          create_diff_folder read back by the port's PNG reader; the flagship
          DSC (temp_0031bpp, n = 128) on 2 synthetic 320×1216 pairs:
          si_only_recon, code_only_recon (the caller's model unchanged),
          two_level_recon with the lam2048 file codec as the diff codec,
          greedy_channel_mask_search for 2 channels, the first greedy step's
          masked MSEs against the CPU's (rtol 1e-4): all 8 on a 128×256
          crop, and on the whole first pair for the channel chosen first,
          encoder_similarity (with the channel dump) and encoder_distances,
          save_both_direction_recons read back; reference .pth files of
          lam2048 and the flagship loaded on the card with bit-equal
          outputs; NLBlock in its four modes at C = 128 on the 20×76 latent
          grid against the CPU (1e-4 of its largest |value|)
Then the script's seconds, the card's name and power limit, one line with
every kernel's numbers, and last the line {"ok": true, "device": {...}}.
Any failed check exits non-zero. Imports nothing of JAX.
"""

import contextlib
import copy
import dataclasses
import json
import os
import re
import shutil
import statistics
import subprocess
import sys
import time
import types

import numpy as np

ROOT = os.path.dirname(os.path.abspath(__file__))
CKPT = os.path.join(ROOT, "results", "ckpts", "lam2048_iter_19000.ckpt")
N_IMAGES, IMG_H, IMG_W, N_CH = 4, 512, 768, 128

# Peak rates of one H100 SXM (NVIDIA data sheet, at the 700 W limit): fp32
# outside the tensor cores, TF32 on the tensor cores (dense), and HBM3
# bandwidth. K1 and K2 compute their products in 3xTF32 on the tensor cores
# (three TF32 products each), the rest in fp32; K3 is fp32 elementwise.
PEAK_FP32_FLOPS = 67e12
PEAK_TF32_FLOPS = 495e12
PEAK_HBM_BYTES = 3.35e12
# The kernels' symbols in the library: K2's conv and its split-K reduction,
# K1, K3.
KERNEL_SYMBOLS = ("conv_gdn_kernel", "conv_gdn_reduce_kernel", "gdn_rows_kernel",
                  "quant_pack_kernel")
# The whole port build (nvcc of the kernels and g++ of the coder) from clean.
BUILD_LIMIT_S = 60.0

# Kernel vs plain version on the card, both fp32 with TF32 off. The sums run
# in another order and rsqrtf has about 2 ulp of error, so K1 and K2 agree to
# rtol 1e-4 (atol 1e-5 for outputs near zero, fp32 rounding of sums of
# terms of order 1). K3 is rounding and clamping only: bit-exact.
RTOL, ATOL = 1e-4, 1e-5
# rANS rate against the BitEstimator's estimate of the same latent (the
# archive has 0.7513 vs 0.7479 bpp on eval24).
BPP_REL_TOL = 0.03
# GPU vs CPU decode of the same file (same latent, same tables): fp32 convs
# in another order.
DECODE_ATOL = 1e-4
# GPU vs CPU latent: round() may flip where the encoder output sits within
# float error of k+0.5; at most 0.1% of elements, by 1.
LATENT_FLIP_FRAC = 1e-3

# DSC phase: the flagship preset at full width (n = 128) on the port's
# seeded init, 4 stereo pairs at 320×1216 (a KITTI frame floored to ×32, the
# JAX package's DSC serving shape); each channel of g_a22's last 3×3 conv
# centred and scaled to a std of 4 steps (64) on the first left image, so
# that the code (that conv and an attention block) spans every symbol and
# passes the clip at ±128, and g_s22's first 3×3 conv divided by the step.
DSC_PRESET, DSC_SEED = "temp_0031bpp", 1234
N_PAIRS, DSC_H, DSC_W = 4, 320, 1216
CODE_SPREAD = 64.0

# Training phase: the run's length, its resume, and the profiled window.
TRAIN_STEPS, RESUME_STEPS = 100, 120
N_TRAIN_IMAGES, TRAIN_IMG = 16, 512
PROFILE_START, PROFILE_STEPS = 40, 5
# Gradients through the kernels' Functions vs the plain path on the card,
# per parameter tensor, as a fraction of its largest |gradient|. The
# backward is the same plain recompute on both sides; only the forward
# differs, by K1's and K2's 3xTF32 error (rtol 1e-4 at most), which the
# loss's λ = 8192 and the decoder carry into every gradient. 1e-3 leaves a
# factor of 10 over that; a TF32 path misses it by the decoder's 1e-3.
GRAD_TOL = 1e-3

# DSC training phase: the flagship (temp_0031bpp, n = 128) trained by the
# CLI on examples/dsc_0031bpp.json at batch 2 on synthetic KITTI-layout
# stereo PNGs of KITTI's 375×1242 (crops 315×1215 floored to 288×1184):
# DSC_TRAIN_FRAMES frames × (_10, _11) = 12 pairs, 6 steps an epoch, 8
# epochs (48 steps), then --resume for 2 more; a 2-frame test root for the
# validation pass; REG_STEPS steps of the reg_stage trainer.
KITTI_H, KITTI_W = 375, 1242
KITTI_TRAIN_DIR = os.path.join(ROOT, "build", "chip_smoke_dsc_train", "kitti_train")
DSC_TRAIN_FRAMES, DSC_TRAIN_EPOCHS, DSC_RESUME_EPOCHS, REG_STEPS = 6, 8, 2, 4
# Gradients through K2's Function vs the plain path on the card, per
# parameter tensor, as a fraction of its largest |gradient|. The backward
# is the same plain recompute on both sides; the forwards differ by K2's
# 3xTF32 error (1.3e-5 relative at most at these shapes). Through MS-SSIM's
# ratios and the leaky ReLUs that error does not stay small: a conv output
# within it of 0 falls on the other side of its kink in one path, and the
# gradient of every weight upstream of it moves by up to 0.99 of that
# element's share; in the small tensors of g_s22 (666 pixels a channel)
# that is 5e-3 of the largest. So the gate is measured in the same run:
# the plain path against itself with each K2 output moved by
# DSC_K2_PERTURB·N(0, 1) relative (K2's error), and the kernel path may
# stand at most DSC_FLOOR_FACTOR times that floor from plain (never held
# tighter than DSC_GRAD_TOL). A control shows that the gate separates: the
# same plain path with each K2 output moved by DSC_CONTROL_PERTURB relative
# (TF32's error, 100× K2's) must stand beyond the gate, or the phase fails.
# Both are held on two statistics, as in the hyper_train phase: the largest
# tensor's gap and the median tensor's. The kernel must pass both gates;
# the control must miss one. The largest gap alone did not separate on an
# H100 (a trained model with a floor of 8.1e-3 gave a gate of 3.25e-2 and
# a control of 3.06e-2; runs before gave controls of 5.5e-2 and 1.3e-1):
# the kinks flip under any perturbation in the small tensors, while the
# median tensor's gap scales with the perturbation.
DSC_GRAD_TOL = 1e-3
DSC_K2_PERTURB = 1e-5
DSC_FLOOR_FACTOR = 4.0
DSC_CONTROL_PERTURB = 1e-3

# Hyperprior / joint-AR phase: hyperprior, hyperprior-sigma and joint at
# N = 192, M = 320 (the codec CLI's defaults) on the port's seeded init, two
# synthetic 768×512 images; every GDN and IGDN moved off the identity (the
# dsc phase's law), each channel of the analysis transform's last conv
# centred and scaled to a std of HYPER_Y_STD, and of the hyper-analysis'
# last conv to HYPER_Z_STD, on the first image, so that y and z spread over
# many symbols. The card's file of a 128×192 crop is decoded on the CPU
# where no σ changes its scale index between the devices.
HYPER_SEED, N_HYPER_IMAGES, HYPER_N, HYPER_M = 4321, 2, 192, 320
HYPER_Y_STD, HYPER_Z_STD = 3.0, 2.0
HYPER_CROP = (128, 192)
# ŷ of the card's file decoded on the CPU: the symbols are equal and the
# CPU's σ (σ-normalized) or μ (joint) differs in the last bits.
Y_HAT_TOL = 1e-5
# The native AR library against the numpy path, front by front (the JAX
# package's test tolerance, rtol = atol).
AR_TOL = 2e-4

# Hyperprior / joint-AR training phase: both models through the training
# CLI at the JAX TrainConfig's training settings (examples/balle17.json:
# batch 4, 256×256 crops, λ 8192, lr 1e-4) at N = 192, M = 320, on
# N_HT_IMAGES synthetic 512×512 PPMs and one 768×512 test image; HT_STEPS
# steps, then --resume to HT_RESUME_STEPS; HT_SIGMA_STEPS steps of the
# sigma-norm quantizer; HT_CUDNN_STEPS steps under each cuDNN setting. The
# gradient gate is the dsc_train phase's (a floor measured in the same run,
# DSC_FLOOR_FACTOR, DSC_K2_PERTURB, the DSC_CONTROL_PERTURB control), with
# K1's outputs moved as K2's, on two statistics: the largest tensor's gap
# and the median tensor's. The first alone cannot tell a TF32-size error
# from K2's own in the hyperprior (on an H100: floor 1.26e-2, control
# 2.95e-2, in h_s), where the ReLU kinks of the hyper transforms' small
# tensors flip under any perturbation; the median scales with it.
HT_STEPS, HT_RESUME_STEPS, HT_SIGMA_STEPS, HT_CUDNN_STEPS = 30, 40, 4, 3
N_HT_IMAGES, HT_IMG = 8, 512

# DSC fusion phase: the four fusion presets at n = 128 on the dsc phase's
# seeded weights (GDNs off the identity, the code spread to CODE_SPREAD,
# the receiver taking it in steps), one 320×1216 pair each through the file
# codec; then FUSION_TRAIN_EPOCHS epochs of train_dsc (batch 2, 288×1184
# crops) of each trainable preset on FUSION_FRAMES synthetic KITTI frames.
FUSION_PRESETS = ("att_0031bpp", "bottleneck_att_1bpp", "fif_0031bpp", "pam_0031bpp")
FUSION_TRAINABLE = ("att_0031bpp", "bottleneck_att_1bpp", "pam_0031bpp")
FUSION_SEED, FUSION_FRAMES, FUSION_TRAIN_EPOCHS = 2468, 2, 2


# Auxiliary trainers' phase: the six trainers through the training CLI at
# the JAX TrainConfig's defaults (batch 4, image_size 256, lr 1e-4, KITTI
# layout; the KITTI loader's 315×1215 crops floored to ×16 or ×32) on the
# dsc_train phase's KITTI frames and AUX_TRIPLETS enhancement triplets of
# KITTI's size, AUX_STEPS steps each; two_steps and decoder_only freeze the
# archived Ballé-17, att_block a seeded temp_1bpp. K2 / K1 / K3 launches a
# step: att_block's are its base's eval forward (17 K2 sites, one code).
# Then K1 at C = 512 at AnalysisSmall's and SynthesisSmall's shapes (batch
# C512_BATCH of 16×16, their GDNs and IGDNs).
AUX_TRAINERS = ("two_steps", "decoder_only", "att_exp", "att_block", "passr", "fif_enhance")
AUX_LAUNCHES = {"two_steps": (6, 0, 0), "decoder_only": (6, 4, 0), "att_exp": (0, 0, 0),
                "att_block": (17, 0, 1), "passr": (0, 0, 0), "fif_enhance": (0, 0, 0)}
AUX_STEPS, AUX_TRIPLETS, AUX_SEED, C512_BATCH = 20, 4, 97, 4

# Evaluation phase: the four archived Ballé-17 checkpoints through eval_kodak
# (rANS) on EVAL_IMAGES synthetic 768×512 images, and the mixing, code
# statistics and diff-folder tools over them; the archived flagship DSC
# (temp_0031bpp) through the ablations, the greedy channel-mask search for
# EVAL_MASKS channels, the similarity analyses and the both-direction dump
# on EVAL_PAIRS synthetic 320×1216 pairs; reference .pth files of both
# models; NLBlock in its four modes at C = 128 on the flagship's 20×76
# latent grid. A forward of the Ballé-17 model launches K2 3 and K1 2, of
# the flagship K2 17 (base branch included) and K3 1; the Ballé file codec
# (encode + decode) K2 3, K1 2 and K3 1. The first greedy step's masked
# MSEs are held against the CPU's: all of them on an EVAL_CROP crop of the
# first pair, and the one of the channel chosen first on the whole pair (a
# forward there takes about 4 s on 8 CPU cores, so not all 8).
BALLE_CKPTS = ("lam128_iter_10000", "lam2048_iter_19000", "lam8192_iter_20000",
               "msssim48_iter_12000")
FLAGSHIP = os.path.join(ROOT, "results", "ckpts", "dsc_flagship_params.msgpack")
EVAL_SEED, EVAL_IMAGES, EVAL_PAIRS, EVAL_MASKS, EVAL_CROP = 4242, 4, 2, 2, (128, 256)
BALLE_FWD, DSC_FWD, BALLE_CODEC = (3, 2, 0), (17, 0, 1), (3, 2, 1)
# Card vs CPU on the same inputs: PSNR 1e-3 dB and bpp 0.1% (the rule of
# the R-D row of PERF.md §2), the masked MSEs rtol 1e-4, NLBlock's output
# 1e-4 of its largest |value| (cuBLAS and the CPU's fp32 sums).
EVAL_PSNR_DB, EVAL_BPP_REL, EVAL_MSE_RTOL, NL_TOL = 1e-3, 1e-3, 1e-4, 1e-4


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


class SmokeFailure(Exception):
    pass


def check(cond: bool, what: str) -> None:
    if not cond:
        raise SmokeFailure(what)


def bound_ms(flops: float, nbytes: float):
    """The least time of an fp32 route on the CUDA cores."""
    t_ops, t_bytes = flops / PEAK_FP32_FLOPS, nbytes / PEAK_HBM_BYTES
    return 1e3 * max(t_ops, t_bytes), ("operations" if t_ops >= t_bytes else "bytes")


def bound_3xtf32_ms(mma_flops: float, elementwise_flops: float, nbytes: float):
    """The least time of the kernels' route: the products as three TF32
    products on the tensor cores, the elementwise work in fp32."""
    t_ops = 3.0 * mma_flops / PEAK_TF32_FLOPS + elementwise_flops / PEAK_FP32_FLOPS
    t_bytes = nbytes / PEAK_HBM_BYTES
    return 1e3 * max(t_ops, t_bytes), ("operations" if t_ops >= t_bytes else "bytes")


def ptxas_report(log: str) -> dict:
    """Registers, static shared memory and spills of each kernel, from the
    ``nvcc -Xptxas -v`` output the build keeps."""
    out, name = {}, None
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '(\w+)'", line)
        if m:
            name = next((k for k in KERNEL_SYMBOLS if k in m.group(1)), m.group(1))
            out[name] = {}
            continue
        if name is None:
            continue
        m = re.search(r"(\d+) bytes stack frame, (\d+) bytes spill stores, (\d+) bytes spill loads",
                      line)
        if m:
            out[name].update(stack_bytes=int(m.group(1)), spill_store_bytes=int(m.group(2)),
                             spill_load_bytes=int(m.group(3)))
        m = re.search(r"Used (\d+) registers", line)
        if m:
            out[name]["registers"] = int(m.group(1))
            sm = re.search(r"(\d+) bytes smem", line)
            out[name]["static_smem_bytes"] = int(sm.group(1)) if sm else 0
    return out


def smooth_image(rng: np.random.Generator, h: int = IMG_H, w: int = IMG_W) -> np.ndarray:
    """A natural-looking synthetic HWC image in [0, 1]: a few low-frequency
    colour waves, edges from a random step pattern, and fine texture."""
    yy, xx = np.mgrid[0:h, 0:w].astype(np.float32)
    img = np.zeros((h, w, 3), np.float32) + rng.uniform(0.3, 0.7, 3).astype(np.float32)
    for _ in range(6):
        fy, fx = rng.uniform(-6, 6, 2) / np.array([h, w])
        phase = rng.uniform(0, 2 * np.pi)
        amp = rng.uniform(0.03, 0.12, 3).astype(np.float32)
        img += amp * np.cos(2 * np.pi * (fy * yy + fx * xx) + phase)[..., None]
    blocks = rng.uniform(-0.15, 0.15, (h // 64, w // 64, 3)).astype(np.float32)
    img += np.repeat(np.repeat(blocks, 64, axis=0), 64, axis=1)
    img += 0.03 * rng.standard_normal((h, w, 3)).astype(np.float32)
    return np.clip(img, 0.0, 1.0)


def shift_pair(a: np.ndarray, rng: np.random.Generator) -> np.ndarray:
    """The right eye of a synthetic stereo pair: each row of ``a`` shifted by
    a smooth disparity of 6-20 px, with a gain of 0.92-1.08 and an offset of
    ±0.03 (the warp of the eval pairs of tools/make_offline_data.py)."""
    h, w = a.shape[:2]
    base = rng.integers(6, 20)
    yy = np.linspace(0, 2 * np.pi * rng.uniform(0.5, 2.0), h)
    disp = (base + 4 * np.sin(yy + rng.uniform(0, 6)))[:, None]
    cols = np.clip(np.arange(w)[None, :] + disp, 0, w - 1).astype(int)
    b = a[np.arange(h)[:, None], cols]
    return np.clip(b * rng.uniform(0.92, 1.08) + rng.uniform(-0.03, 0.03), 0, 1).astype(np.float32)


def k2_work(args, out):
    """(product flops, elementwise flops, bytes) of one K2 call."""
    x, w, b, gamma_t, beta = args[:5]
    _, h, wd, cin = x.shape
    _, ho, wo, cout = out.shape
    kk = w.shape[0]
    p = out.shape[0] * ho * wo
    mma = 2.0 * p * kk * kk * cin * cout
    elementwise = p * cout if b is not None else 0.0
    nbytes = 4.0 * (x.numel() + w.numel() + out.numel() + (cout if b is not None else 0))
    if gamma_t is not None:
        mma += 2.0 * p * cout * cout
        elementwise += 4.0 * p * cout
        nbytes += 4.0 * (cout * cout + cout)
    return mma, elementwise, nbytes


def k1_work(x):
    """(product flops, elementwise flops, bytes) of one K1 call."""
    c = x.shape[-1]
    p = x.numel() // c
    return 2.0 * p * c * c, 4.0 * p * c, 4.0 * (2 * x.numel() + c * c + c)


def to_u8(img: np.ndarray) -> np.ndarray:
    """An image in [0, 1] as 8-bit values, rounded."""
    return np.clip(np.rint(np.asarray(img, np.float64) * 255.0), 0, 255).astype(np.uint8)


def write_kitti(root: str, frames: int, rng: np.random.Generator, h: int = KITTI_H,
                w: int = KITTI_W) -> None:
    """A KITTI-layout root: ``image_2`` / ``image_3`` stereo pairs
    ``0000NN_10.png`` and ``_11.png`` of ``frames`` frames, h×w."""
    from iclr_17_compression_tpu_torch.data.datasets import write_png

    for side in ("image_2", "image_3"):
        os.makedirs(os.path.join(root, side), exist_ok=True)
    for i in range(frames):
        for t in (10, 11):
            a = smooth_image(rng, -(-h // 64) * 64, -(-w // 64) * 64)[:h, :w]
            write_png(os.path.join(root, "image_2", f"{i:06d}_{t}.png"), to_u8(a))
            write_png(os.path.join(root, "image_3", f"{i:06d}_{t}.png"),
                      to_u8(shift_pair(a, rng)))


def gdn_off_identity_(torch, model, gen):
    """Every GDN and IGDN of ``model`` off its identity init, drawn from
    ``gen``: β in 0.7-1.3, γ = 0.3·I + 0.1·U (full, neither diagonal nor
    symmetric)."""
    from iclr_17_compression_tpu_torch.nn.layers import GDN

    with torch.no_grad():
        for mod in model.modules():
            if isinstance(mod, GDN):
                c = mod.beta.shape[0]
                mod.beta.copy_(0.7 + 0.6 * torch.rand(c, generator=gen))
                mod.gamma.copy_(0.3 * torch.eye(c) + 0.1 * torch.rand((c, c), generator=gen))
    return model


def device_ms_by_kernel(torch, prof) -> dict:
    """Device milliseconds by kernel name (the first 60 characters) of a
    ``torch.profiler`` run, the ranges' own device spans left out."""
    by_kernel = {}
    for evt in prof.events():
        if evt.device_type == torch.autograd.DeviceType.CUDA and not getattr(
                evt, "is_user_annotation", False):
            key = evt.name.split("(")[0][:60]
            by_kernel[key] = by_kernel.get(key, 0.0) + evt.time_range.elapsed_us() / 1e3
    return by_kernel


def block_k2_args(block, xin) -> tuple:
    """The K2 call of a ResidualBlockWithStride (conv2 + GDN) or a
    ResidualBlockUpsample (conv + IGDN) on the block's input ``xin``:
    (x, w HWIO, b, γᵀ, β, stride 1, pad 1, inverse)."""
    from iclr_17_compression_tpu_torch.ops.gdn import gdn_reparam

    if hasattr(block, "gdn"):
        y, conv, gdn = block.act(block.conv1(xin)), block.conv2, block.gdn
    else:
        y, conv, gdn = block.act(block.subpel_conv(xin)), block.conv, block.igdn
    beta, gamma = gdn_reparam(gdn.params())
    return (y.contiguous(), conv.weight.permute(2, 3, 1, 0).contiguous(), conv.bias,
            gamma.t().contiguous(), beta.contiguous(), 1, 1, gdn.inverse)


def add_pixels_and_partials(row: dict) -> None:
    """Each K2 shape's output pixels and its split-K partials' bytes
    (S × P × Cout × 4, 0 unsplit)."""
    for shape in row["shapes"]:
        nb, hh, ww, _ = shape["x"]
        shape["pixels"] = nb * (hh // shape["stride"]) * (ww // shape["stride"])
        shape["partial_bytes"] = (4 * shape["splits"] * shape["pixels"] * shape["w"][3]
                                  if shape["splits"] > 1 else 0)


def spread_channels_(torch, conv, run, std, mean=0.0) -> None:
    """Set each output channel of ``conv`` to the mean ``mean`` and the std
    ``std`` (scalars or one a channel) on what ``run()`` feeds it."""
    seen = {}
    hook = conv.register_forward_hook(lambda mod, a, out: seen.setdefault("y", out))
    with torch.no_grad():
        run()
        hook.remove()
        y = seen["y"].flatten(0, 2)
        scale = torch.as_tensor(std, device=y.device) / y.std(dim=0)
        deconv = isinstance(conv, torch.nn.ConvTranspose2d)  # weight (Cin, Cout, k, k)
        conv.weight.mul_(scale.view((1, -1, 1, 1) if deconv else (-1, 1, 1, 1)))
        conv.bias.copy_(scale * (conv.bias - y.mean(dim=0)) + mean)


def dsc_train_phase(torch, dev, tools, h: int = KITTI_H, w: int = KITTI_W,
                    train_frames: int = DSC_TRAIN_FRAMES, epochs: int = DSC_TRAIN_EPOCHS,
                    reg_steps: int = REG_STEPS) -> dict:
    """DSC training on the card (see the module docstring). ``tools`` holds
    the harness of ``main``: check, emit, time_ms, call_ms, measure_k2,
    new_row, bound_ms, floor_ms. Returns the K2 and K3 rows and launches."""
    from torch.profiler import ProfilerActivity, profile

    from iclr_17_compression_tpu_torch.coding import codec_cli
    from iclr_17_compression_tpu_torch.data.datasets import StereoKittiDataset, batch_iterator
    from iclr_17_compression_tpu_torch.models.dsc import (DSC_PRESETS, DSCStereoModel,
                                                          quantize_code)
    from iclr_17_compression_tpu_torch.ops.kernels import conv_gdn_kernel as k2
    from iclr_17_compression_tpu_torch.ops.kernels import gdn_kernel as k1
    from iclr_17_compression_tpu_torch.ops.kernels import quant_pack_kernel as k3
    from iclr_17_compression_tpu_torch.train import cli as train_cli
    from iclr_17_compression_tpu_torch.train import trainers
    from iclr_17_compression_tpu_torch.train.checkpoint import load_train_state
    from iclr_17_compression_tpu_torch.train.config import TrainConfig
    from iclr_17_compression_tpu_torch.train.schedules import ReduceLROnPlateau
    from iclr_17_compression_tpu_torch.train.state import (build_model, create_train_state,
                                                           make_dsc_train_step, step_generator)
    from iclr_17_compression_tpu_torch.train.weights import (dsc_params_to_jax, load_dsc,
                                                             msgpack_dumps)

    check, emit = tools.check, tools.emit
    t_phase = time.perf_counter()
    work = os.path.join(ROOT, "build", "chip_smoke_dsc_train")
    shutil.rmtree(work, ignore_errors=True)
    train_dir, test_dir = KITTI_TRAIN_DIR, os.path.join(work, "kitti_test")
    rng = np.random.default_rng(3)
    write_kitti(train_dir, train_frames, rng, h, w)
    write_kitti(test_dir, 2, rng, h, w)
    cfg = dataclasses.replace(
        TrainConfig.from_json(os.path.join(ROOT, "examples", "dsc_0031bpp.json")),
        tot_epoch=epochs, print_freq=2 * train_frames, tensorboard=False,
        train_dir=train_dir, test_dir=test_dir, save_root=work)
    check((cfg.model, cfg.batch_size, cfg.lr_base) == ("dsc:temp_0031bpp", 2, 1e-4),
          "examples/dsc_0031bpp.json is not the temp_0031bpp, batch 2, lr 1e-4 config")
    preset = DSC_PRESETS["temp_0031bpp"]
    per_epoch = 2 * train_frames // cfg.batch_size
    cfg_path, resume_path = (os.path.join(work, f) for f in ("dsc.json", "resume.json"))
    with open(cfg_path, "w") as f:
        f.write(cfg.to_json())
    with open(resume_path, "w") as f:
        f.write(dataclasses.replace(cfg, tot_epoch=epochs + DSC_RESUME_EPOCHS).to_json())

    # the loop's own step, timed (host clock around work that ends in a
    # synchronize) and its K2/K3/K1 launches counted; the rest of each run's
    # launches are the validation pass's
    steps, first = [], {}
    real_make_step = train_cli.make_dsc_train_step

    def counts():
        return (k2.conv_gdn.launches, k3.quantize_pack.launches, k1.gdn_fused.launches)

    def timed_make_step(*args, **kw):
        step_fn = real_make_step(*args, **kw)

        def timed_step(state, im1, im2, generator):
            first.setdefault("step", state.step)
            first.setdefault("lr", state.schedule(state.step))
            first.setdefault("batch", (im1.detach().clone(), im2.detach().clone()))
            before = counts()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            metrics = step_fn(state, im1, im2, generator)
            torch.cuda.synchronize()
            t1 = time.perf_counter()
            steps.append((state.step, t0, t1, float(metrics["loss"]),
                          *(a - b for a, b in zip(counts(), before))))
            return metrics

        return timed_step

    def reset_launches():
        k2.conv_gdn.launches = k3.quantize_pack.launches = k1.gdn_fused.launches = 0

    def read_launches():
        return dict(zip(("conv_gdn", "quantize_pack", "gdn"), counts()))

    train_cli.make_dsc_train_step = timed_make_step
    try:
        # run A: epochs 0..epochs-1, the counters around it only
        torch.cuda.reset_peak_memory_stats()
        reset_launches()
        t0 = time.perf_counter()
        state_a = train_cli.main(["--config", cfg_path, "-n", "dsc1"])
        run_a_s = time.perf_counter() - t0
        launches_a = read_launches()
        peak_bytes = torch.cuda.max_memory_allocated()
        steps_a = list(steps)
        first.clear()

        # what run A saved, read back into a fresh state, equals what it held
        run_dir = os.path.join(work, "dsc1")
        fresh = create_train_state(DSCStereoModel(preset).to(dev), lr=cfg.lr_base)
        fresh, meta = load_train_state(fresh, os.path.join(run_dir, "latest.ckpt"))
        saved_opt = state_a.optimizer.state_dict()["state"]
        read_opt = fresh.optimizer.state_dict()["state"]
        check(fresh.step == epochs * per_epoch == meta["step"] and meta["next_epoch"] == epochs,
              f"saved step {fresh.step}, {meta}")
        check(all(torch.equal(a, b) for a, b in zip(state_a.model.state_dict().values(),
                                                    fresh.model.state_dict().values())),
              "resume: parameters read back differ from the saved ones")
        check(len(saved_opt) == len(read_opt) and all(
            torch.equal(saved_opt[i][k], read_opt[i][k])
            for i in saved_opt for k in ("exp_avg", "exp_avg_sq", "step")),
            "resume: Adam moments read back differ from the saved ones")
        # the plateau state the sidecar holds is the one run A's epoch losses give
        plateau = ReduceLROnPlateau(base_lr=cfg.lr_base, patience=cfg.plateau_patience)
        for e in range(epochs):
            plateau.step(float(np.mean([s[3] for s in steps_a[e * per_epoch:(e + 1) * per_epoch]])))
        check((meta["lr"], meta["plateau_best"], meta["plateau_bad"])
              == (plateau.lr, plateau.best, plateau.bad_epochs) == (
                  state_a.schedule(state_a.step), plateau.best, plateau.bad_epochs),
              f"sidecar {meta}: the plateau gives {plateau.lr}, {plateau.best}, "
              f"{plateau.bad_epochs}")

        # run B: --resume for DSC_RESUME_EPOCHS more epochs
        reset_launches()
        state_b = train_cli.main(["--config", resume_path, "-n", "dsc1", "--resume", run_dir])
        launches_b = read_launches()
        steps_b = steps[len(steps_a):]
    finally:
        train_cli.make_dsc_train_step = real_make_step

    n_a, n_b = len(steps_a), len(steps_b)
    check(n_a == epochs * per_epoch and n_b == DSC_RESUME_EPOCHS * per_epoch,
          f"steps run {n_a}, {n_b}")
    check(first["step"] == epochs * per_epoch and state_b.step == n_a + n_b,
          f"resume ran steps {first['step']}..{state_b.step}")
    check(first["lr"] == meta["lr"], f"resume: LR {first['lr']}, saved {meta['lr']}")
    expected = next(batch_iterator(StereoKittiDataset([train_dir], train=True, seed=cfg.seed),
                                   cfg.batch_size, seed=cfg.seed, epoch=epochs))
    check(all(torch.equal(t.cpu(), torch.from_numpy(e)) for t, e in zip(first["batch"], expected)),
          "resume: the first batch is not the one the uninterrupted loop draws")
    step_k2 = {s[4] for s in steps_a + steps_b}
    step_k3 = {s[5] for s in steps_a + steps_b}
    step_k1 = {s[6] for s in steps_a + steps_b}
    val_frames = 2 * (epochs + DSC_RESUME_EPOCHS)  # the two *_10 test frames an epoch
    val_k2 = launches_a["conv_gdn"] + launches_b["conv_gdn"] - 17 * (n_a + n_b)
    val_k3 = launches_a["quantize_pack"] + launches_b["quantize_pack"]
    check(step_k2 == {17} and step_k3 == {0} and step_k1 == {0},
          f"K2/K3/K1 launches a step {step_k2}/{step_k3}/{step_k1}, expected 17/0/0")
    # DSC's GDNs all run fused in K2: no standalone K1, in the steps or in
    # the validation frames
    check(launches_a["gdn"] == launches_b["gdn"] == 0,
          f"standalone K1 launches in DSC training {launches_a['gdn']}, {launches_b['gdn']}")
    check(val_k2 == 17 * val_frames and val_k3 == val_frames,
          f"validation launches K2 {val_k2}, K3 {val_k3} over {val_frames} frames, "
          "expected 17 and 1 a frame")
    losses = [s[3] for s in steps_a + steps_b]
    check(all(np.isfinite(losses)), "a DSC training loss is not finite")
    first10, last10 = float(np.mean(losses[:10])), float(np.mean(losses[-10:]))
    check(last10 < first10, f"DSC loss did not fall: first 10 {first10:.4f}, last 10 {last10:.4f}")
    step_ms = [1e3 * (t1 - t0) for _, t0, t1, *_ in steps_a[2:]]  # after 2 warm-up steps
    iter_ms = [1e3 * (b[1] - a[1]) for a, b in zip(steps_a[2:], steps_a[3:])]
    med_step, med_iter = statistics.median(step_ms), statistics.median(iter_ms)
    best_meta = json.load(open(os.path.join(run_dir, "best_train.ckpt.json")))
    val_meta = json.load(open(os.path.join(run_dir, "best_val.ckpt.json")))

    # validation: the eval forward of one 352×1216 test frame (K2 17, K3 1)
    val_set = StereoKittiDataset([test_dir], train=False, seed=cfg.seed)
    model = state_b.model
    v1, v2 = (torch.from_numpy(x[None]).to(dev) for x in val_set[0])
    val_ms = []
    with torch.no_grad():
        for i in range(8):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            float(model(v1, v2)["loss_full"])
            if i >= 3:
                val_ms.append(1e3 * (time.perf_counter() - t0))

    # a profile of PROFILE_STEPS steps of the train step on run B's first batch
    im1, im2 = (torch.from_numpy(b).to(dev) for b in expected)
    prof_state = create_train_state(
        build_model(cfg.model, device=dev, seed=cfg.seed), lr=cfg.lr_base)
    step_fn = make_dsc_train_step()
    for i in range(2):
        step_fn(prof_state, im1, im2, step_generator(cfg.seed, i, dev))
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for i in range(PROFILE_STEPS):
            step_fn(prof_state, im1, im2, step_generator(cfg.seed, i, dev))
        torch.cuda.synchronize()
        window_ms = 1e3 * (time.perf_counter() - t0)
    by_kernel, ranges, top_backward = {}, {}, 0.0
    for evt in prof.events():
        if evt.device_type == torch.autograd.DeviceType.CUDA:
            if getattr(evt, "is_user_annotation", False):
                continue  # a range's span on the device timeline, not a kernel
            name = evt.name.split("(")[0][:60]
            by_kernel[name] = by_kernel.get(name, 0.0) + evt.time_range.elapsed_us() / 1e3
            continue
        if evt.name.startswith(("train_step/", "iclr17c::conv_gdn_backward")):
            ranges[evt.name] = ranges.get(evt.name, 0.0) + evt.device_time_total / 1e3
        if evt.name.startswith("autograd::engine::evaluate_function"):
            # the backward runs on autograd's thread, outside the step's range
            parent = evt.cpu_parent
            while parent is not None and not parent.name.startswith("autograd::engine"):
                parent = parent.cpu_parent
            if parent is None:
                top_backward += evt.device_time_total / 1e3
    busy = sum(by_kernel.values())
    k2_forward = sum(v for k, v in by_kernel.items() if "conv_gdn" in k)
    convs = sum(v for k, v in by_kernel.items() if "conv_gdn" not in k and any(
        t in k.lower() for t in ("conv", "xmma", "gemm", "cudnn", "winograd", "fft",
                                 "grad_engine", "wgrad")))

    # gradients on the card: K2's Function against the plain path (the
    # wrapper swapped for conv_gdn_plain), the same weights, batch and noise;
    # the floor: the plain path against itself with every K2 output moved by
    # K2's own relative error (DSC_K2_PERTURB, seeded); and the control: the
    # same at TF32's relative error (DSC_CONTROL_PERTURB), which must miss
    # the gate
    def grads(m, path: str, rel: float = 0.0):
        real = k2.conv_gdn
        gen_p = torch.Generator(device=dev).manual_seed(11)

        def perturbed(*args):
            y = k2.conv_gdn_plain(*args)
            return y * (1.0 + rel * torch.randn(y.shape, generator=gen_p, device=y.device))

        k2.conv_gdn = {"kernel": real, "plain": k2.conv_gdn_plain, "perturbed": perturbed}[path]
        try:
            m.zero_grad(set_to_none=True)
            out = m(im1, im2, train=True, generator=step_generator(cfg.seed, 7, dev))
            loss = out["loss_full"] + out["loss"]
            loss.backward()
        finally:
            k2.conv_gdn = real
        return float(loss.detach()), {k: p.grad.clone() for k, p in m.named_parameters()}

    def gaps(ga, gb):
        return {k: float((ga[k] - gb[k]).abs().max() / gb[k].abs().max().clamp(min=1e-30))
                for k in gb}

    def stats(g, g_plain):
        """(the largest tensor's gap, the median tensor's gap)."""
        gap = list(gaps(g, g_plain).values())
        return max(gap), statistics.median(gap)

    def parity_of(m, control: bool = False):
        """(the kernel's (largest, median) gap against plain, the floor's,
        the gate on each, the five worst tensors, the control's gaps or
        None) of model ``m``: the hyper_train phase's two statistics."""
        before = k2.conv_gdn.launches
        _, g_kernel = grads(m, "kernel")
        check(k2.conv_gdn.launches - before == 17, "gradient parity: the kernel path ran no K2")
        _, g_plain = grads(m, "plain")
        floor = stats(grads(m, "perturbed", DSC_K2_PERTURB)[1], g_plain)
        kp = gaps(g_kernel, g_plain)
        worst = sorted(((v, k) for k, v in kp.items()), reverse=True)[:5]
        missed = (stats(grads(m, "perturbed", DSC_CONTROL_PERTURB)[1], g_plain)
                  if control else None)
        gate = (max(DSC_GRAD_TOL, DSC_FLOOR_FACTOR * floor[0]), DSC_FLOOR_FACTOR * floor[1])
        return (max(kp.values()), statistics.median(kp.values())), floor, gate, worst, missed

    parity = build_model(cfg.model, device=dev, seed=cfg.seed)
    parity.load_state_dict(model.state_dict())  # the trained weights
    gap, floor, gate, worst, control_gap = parity_of(parity, control=True)
    del parity

    # TF32 on (PyTorch's defaults), a model moved to the card by hand: its
    # forward turns TF32 off, so it trains in fp32 and matches the plain path
    torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = True
    tf32_model = DSCStereoModel(preset).cuda()
    tf32_model.load_state_dict(model.state_dict())
    flags_before = (torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32)
    tf32_gap, tf32_floor, tf32_gate, _, _ = parity_of(tf32_model)
    flags = (torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32)
    del tf32_model

    # K2 at the training shapes: the blocks' own inputs in one train forward
    sites = [(f"{stack} l{i}", getattr(model, stack)[i])
             for stack, specs in (("g_a", preset.ga), ("g_a22", preset.ga22),
                                  ("g_s22", preset.gs22), ("g_s", preset.gs))
             for i, spec in enumerate(specs) if spec[0] in ("rbs", "rbu")]
    inputs = {}
    hooks = [block.register_forward_pre_hook(
        lambda mod, args, where=where: inputs.setdefault(where, args[0].detach()))
        for where, block in sites]
    with torch.no_grad():
        model(im1, im2, train=True, generator=step_generator(cfg.seed, 9, dev))
    for hk in hooks:
        hk.remove()
    k2_rows = tools.new_row(library=True)
    with torch.no_grad():
        for where, block in sites:
            tools.measure_k2(block_k2_args(block, inputs[where]), k2_rows,
                             f"K2 DSC training {where}", cudnn_k1=True)
            k2_rows["shapes"][-1]["where"] = where

        # K3 on the validation frame's code (1×11×38×8, step 16, clip 128)
        code_pre = model.encode(v1).contiguous()
        syms, code = quantize_code(code_pre, preset)
        rsyms, rcode = k3.quantize_pack_plain(code_pre, preset.coarse_step, preset.code_clip)
        check(torch.equal(syms, rsyms) and torch.equal(code, rcode),
              "K3 on the validation code: not bit-exact")
        n3 = code_pre.numel()
        k3_b_ms, k3_b_by = tools.bound_ms(5.0 * n3, 9.0 * n3)
        k3_val = {"x": list(code_pre.shape), "step": preset.coarse_step, "bits": 8,
                  "ms": tools.time_ms(lambda: quantize_code(code_pre, preset)),
                  "call_ms": tools.call_ms(lambda: quantize_code(code_pre, preset)),
                  "plain_ms": tools.time_ms(lambda: k3.quantize_pack_plain(
                      code_pre, preset.coarse_step, preset.code_clip)),
                  "bound_ms": k3_b_ms, "bound_by": k3_b_by, "launch_floor_ms": tools.floor_ms,
                  "library_ms": None, "max_abs_err": 0.0}

    # train → codec: best_train.ckpt through load_dsc and the codec CLI
    best = os.path.join(run_dir, "best_train.ckpt")
    trained = load_dsc(best, "temp_0031bpp", device="cuda")
    left = os.path.join(test_dir, "image_2", "000000_10.png")
    right = os.path.join(test_dir, "image_3", "000000_10.png")
    icz, rec_path = os.path.join(work, "pair.icz"), os.path.join(work, "pair.ppm")
    codec_cli.main(["encode", left, icz, "--model", "temp_0031bpp", "--ckpt", best])
    codec_cli.main(["decode", icz, rec_path, "--ckpt", best, "--si", right])
    data = open(icz, "rb").read()
    decoded, name, h0, w0 = codec_cli.read_dsc_code(data)
    from iclr_17_compression_tpu_torch.data.datasets import _load

    img = _load(left)
    x = torch.from_numpy(codec_cli.pad_to_multiple(img, preset.code_div)[None]).to(dev)
    sent, _ = codec_cli.dsc_symbols(x, trained)
    check(name == "temp_0031bpp" and (h0, w0) == img.shape[:2]
          and np.array_equal(decoded[0] / preset.coarse_step, sent),
          "best_train.ckpt through the codec CLI: decoded symbols differ from the encoder's")
    rec = _load(rec_path)
    check(rec.shape == img.shape and np.isfinite(rec).all(), "best_train.ckpt: bad recon")

    # reg_stage: a few steps over a frozen base written as JAX-layout params
    base_path = os.path.join(work, "base_params.msgpack")
    with open(base_path, "wb") as f:
        f.write(msgpack_dumps(dsc_params_to_jax(trained.state_dict(), preset)))
    reg_steps_seen, frozen = [], {}
    real_reg_step = trainers.make_reg_stage_step

    def counted_reg_step(base):
        frozen["base"] = base
        step_fn = real_reg_step(base)

        def step(state, batch, generator):
            before = counts()
            metrics = step_fn(state, batch, generator)
            reg_steps_seen.append((float(metrics["loss"]),
                                   *(a - b for a, b in zip(counts(), before))))
            return metrics

        return step

    trainers.make_reg_stage_step = counted_reg_step
    try:
        reg_cfg = dataclasses.replace(cfg, model="reg_stage", tot_epoch=1, tot_step=reg_steps)
        trainers.train_reg_stage(reg_cfg, "reg1", pretrain=base_path)
    finally:
        trainers.make_reg_stage_step = real_reg_step
    check(len(reg_steps_seen) == reg_steps, f"reg_stage ran {len(reg_steps_seen)} steps")
    check({s[1:] for s in reg_steps_seen} == {(28, 1, 0)},
          f"reg_stage launches a step {[s[1:] for s in reg_steps_seen]}, "
          "expected K2 17 + 11, K3 1 and K1 0")
    check(all(np.isfinite(s[0]) for s in reg_steps_seen), "a reg_stage loss is not finite")
    saved_base = load_dsc(base_path, "temp_0031bpp", device="cuda").state_dict()
    check(all(torch.equal(v, saved_base[k]) for k, v in frozen["base"].state_dict().items()),
          "reg_stage: the frozen base's parameters moved")
    check(all(not p.requires_grad for p in frozen["base"].parameters()),
          "reg_stage: the frozen base requires gradients")

    result = {"phase": "dsc_train", "ok": True, "preset": "temp_0031bpp", "n": preset.n,
              "batch": cfg.batch_size, "crop": [288, 1184], "frames": [h, w],
              "train_pairs": 2 * train_frames, "epochs": [epochs, epochs + DSC_RESUME_EPOCHS],
              "steps": [n_a, n_a + n_b],
              "launches": {k: launches_a[k] + launches_b[k] for k in launches_a},
              "launches_per_step": {"conv_gdn": 17, "quantize_pack": 0, "gdn": 0},
              "validation_launches_per_frame": {"conv_gdn": val_k2 / val_frames,
                                                "quantize_pack": val_k3 / val_frames},
              "reg_stage_launches_per_step": {"conv_gdn": 28, "quantize_pack": 1, "gdn": 0},
              "loss_first10": first10, "loss_last10": last10, "loss_every6": losses[::6],
              "median_step_ms": med_step, "pairs_per_s": cfg.batch_size * 1e3 / med_step,
              "median_iteration_ms": med_iter, "run_a_s": run_a_s,
              "peak_memory_gib": peak_bytes / 2 ** 30,
              "validation_ms_per_frame": statistics.median(val_ms),
              "best_train": best_meta, "best_val": val_meta,
              "profile": {"steps": PROFILE_STEPS, "window_ms": window_ms,
                          "device_idle_share": 1.0 - busy / window_ms,
                          "per_step_ms": {
                              "wall": window_ms / PROFILE_STEPS,
                              "device_busy": busy / PROFILE_STEPS,
                              "k2_forward_kernels": k2_forward / PROFILE_STEPS,
                              "k2_backward_recompute": ranges.get(
                                  "iclr17c::conv_gdn_backward", 0.0) / PROFILE_STEPS,
                              "cudnn_convolutions": convs / PROFILE_STEPS,
                              "forward": ranges.get("train_step/forward", 0.0) / PROFILE_STEPS,
                              "backward": top_backward / PROFILE_STEPS,
                              "optimizer": ranges.get("train_step/optimizer", 0.0)
                              / PROFILE_STEPS},
                          "window_ms_by_kernel": dict(sorted(by_kernel.items(),
                                                             key=lambda kv: -kv[1])[:15])},
              "grad_parity": {"tol": DSC_GRAD_TOL, "floor_factor": DSC_FLOOR_FACTOR,
                              "perturb": DSC_K2_PERTURB, "max_gap": gap[0],
                              "median_gap": gap[1], "floor": floor, "gate": gate,
                              "worst": worst,
                              "control_perturb": DSC_CONTROL_PERTURB,
                              "control_gap": control_gap},
              "tf32_check": {"flags_before": flags_before, "flags_after_forward": flags,
                             "grad_gap": tf32_gap, "floor": tf32_floor, "gate": tf32_gate},
              "reg_stage": {"steps": len(reg_steps_seen),
                            "losses": [s[0] for s in reg_steps_seen]},
              "k2_training": k2_rows, "k3_validation": k3_val,
              "seconds": time.perf_counter() - t_phase}
    emit(result)
    # the gradient checks come after the numbers, so that a miss shows them
    check(gap[0] <= gate[0] and gap[1] <= gate[1],
          f"DSC gradients through K2 vs plain: largest tensor {gap[0]:.2e} (gate "
          f"{gate[0]:.2e}), median {gap[1]:.2e} (gate {gate[1]:.2e})")
    check(control_gap[0] > gate[0] or control_gap[1] > gate[1],
          f"the gradient gate does not catch a TF32-size error: control {control_gap} "
          f"within the gate {gate}")
    check(flags_before == (True, True) and flags == (False, False)
          and tf32_gap[0] <= tf32_gate[0] and tf32_gap[1] <= tf32_gate[1],
          f"DSC model moved by hand with TF32 on: flags {flags}, grads {tf32_gap} beyond "
          f"{tf32_gate}")
    print(f"dsc_train phase seconds: {result['seconds']:.1f}", flush=True)
    return result


def hyper_phase(torch, dev, tools, h: int = IMG_H, w: int = IMG_W,
                n_images: int = N_HYPER_IMAGES, crop=HYPER_CROP, n: int = HYPER_N,
                m: int = HYPER_M) -> dict:
    """The hyperprior and joint-AR codecs on the card (see the module
    docstring). ``tools`` holds the harness of ``main``: check, emit,
    time_ms, measure_k2, measure_k1, new_row. Returns the K2 and K1 rows and
    the launches of the main path."""
    from torch.profiler import ProfilerActivity, profile

    from iclr_17_compression_tpu_torch.coding import codec_cli
    from iclr_17_compression_tpu_torch.coding.api import decode_latent
    from iclr_17_compression_tpu_torch.coding.gaussian import default_scale_table, scale_indices
    from iclr_17_compression_tpu_torch.models import cheng2020, hyperprior
    from iclr_17_compression_tpu_torch.models.cheng2020 import JointAutoregressive
    from iclr_17_compression_tpu_torch.models.hyperprior import ScaleHyperprior
    from iclr_17_compression_tpu_torch.ops.gdn import gdn_reparam
    from iclr_17_compression_tpu_torch.ops.kernels import conv_gdn_kernel as k2
    from iclr_17_compression_tpu_torch.ops.kernels import gdn_kernel as k1
    from iclr_17_compression_tpu_torch.ops.kernels import quant_pack_kernel as k3

    check, emit = tools.check, tools.emit
    t_phase = time.perf_counter()
    laps, t_lap = {}, [t_phase]

    def lap(name):
        now = time.perf_counter()
        laps[name] = now - t_lap[0]
        t_lap[0] = now

    device = str(dev)
    # the encoder and the decoder compute σ from the same ẑ with the same
    # cuDNN algorithms only if cuDNN does not pick them by timing
    check(not torch.backends.cudnn.benchmark, "cudnn.benchmark is on")
    torch.cuda.reset_peak_memory_stats()
    rng = np.random.default_rng(5)
    images = [smooth_image(rng, h, w) for _ in range(n_images)]
    gen = torch.Generator().manual_seed(HYPER_SEED)
    table = default_scale_table()

    def tensor(img):
        return torch.from_numpy(codec_cli.pad_to_multiple(img, 64)[None]).to(dev)

    def off_identity(model):
        return gdn_off_identity_(torch, model, gen)


    # the spread of y and z, σ in a trained model's range (hyperprior
    # σ = exp(N(log 2, 0.5²)), joint σ ≈ N(2, 0.5²), μ ≈ N(0, 0.5²)), and
    # each decoder stage at a unit scale with the recon near [0, 1] (the
    # random IGDNs square their input, so a raw 5×5 decoder reaches 1e6)
    x0 = tensor(images[0])
    hp = off_identity(ScaleHyperprior(n, m).init_(gen)).to(dev).eval()
    spread_channels_(torch, hp.Encoder.conv4, lambda: hp.Encoder(x0), HYPER_Y_STD)
    spread_channels_(torch, hp.priorEncoder.conv3, lambda: hp.priorEncoder(hp.Encoder(x0)),
                     HYPER_Z_STD)
    spread_channels_(torch, hp.priorDecoder.deconv3, lambda: hp.priorDecoder(
        torch.round(hp.priorEncoder(hp.Encoder(x0)))), 0.5, float(np.log(2.0)))
    for i, deconv in enumerate((hp.Decoder.deconv1, hp.Decoder.deconv2, hp.Decoder.deconv3,
                                hp.Decoder.deconv4)):
        spread_channels_(torch, deconv, lambda: hp.Decoder(torch.round(hp.Encoder(x0))),
                         *((0.2, 0.5) if i == 3 else (1.0,)))
    hps = ScaleHyperprior(n, m, quant="sigma-norm").to(dev).eval()
    hps.load_state_dict(hp.state_dict())
    jm = off_identity(JointAutoregressive(n).init_(gen)).to(dev).eval()
    spread_channels_(torch, jm.g_a[6], lambda: jm.g_a(x0), HYPER_Y_STD)
    spread_channels_(torch, jm.h_a[8], lambda: jm.h_a(jm.g_a(x0)), HYPER_Z_STD)
    ep_mean = torch.cat([torch.full((n,), 2.0), torch.zeros(n)]).to(dev)
    spread_channels_(torch, jm.entropy_parameters[4], lambda: jm(x0), 0.5, ep_mean)
    spread_channels_(torch, jm.g_s[7][0], lambda: jm.g_s(torch.round(jm.g_a(x0))), 0.2, 0.5)
    models = {"hyperprior": hp, "hyperprior-sigma": hps, "joint": jm}

    def counts():
        return {"conv_gdn": k2.conv_gdn.launches, "gdn": k1.gdn_fused.launches,
                "quantize_pack": k3.quantize_pack.launches}

    def reset():
        k2.conv_gdn.launches = k1.gdn_fused.launches = k3.quantize_pack.launches = 0

    def add(total, before):
        for k, v in counts().items():
            total[k] += v - before[k]

    # the codecs' σ and hyper paths give the same bits call after call (the
    # hyperprior's σ under deterministic cuDNN, the joint's forward convs)
    with torch.no_grad():
        z_hp = np.round(hp.priorEncoder(hp.Encoder(x0))[0].cpu().numpy())
        z_jm = np.round(jm.h_a(jm.g_a(x0))[0].cpu().numpy())
    for what, fn in (("hyperprior σ", lambda: hyperprior.sigma_of(hp, z_hp)),
                     ("joint hyper", lambda: cheng2020._hyper(jm, z_jm, dev))):
        first = fn()
        check(all(np.array_equal(first, fn()) for _ in range(3)),
              f"{what}: not the same bits on a second call")

    lap("set_up")

    # ---- the main path: each model's file codec on the images, the
    # counters set to 0 just before and read just after
    expected = {"hyperprior": ({"conv_gdn": 3, "gdn": 0}, {"conv_gdn": 0, "gdn": 3}),
                "hyperprior-sigma": ({"conv_gdn": 3, "gdn": 0}, {"conv_gdn": 0, "gdn": 3}),
                "joint": ({"conv_gdn": 3, "gdn": 0}, {"conv_gdn": 3, "gdn": 0})}
    launches, per_model, files = {}, {}, {}
    for name, model in models.items():
        reset()
        enc_l = dict.fromkeys(counts(), 0)
        dec_l = dict.fromkeys(counts(), 0)
        enc_ms, dec_ms, recons = [], [], []
        for img in images:
            torch.cuda.synchronize()
            before = counts()
            t0 = time.perf_counter()
            data = codec_cli.encode_image(img, model, device=device)
            t1 = time.perf_counter()
            add(enc_l, before)
            before = counts()
            t2 = time.perf_counter()
            rec = codec_cli.decode_image(data, model, device=device)
            torch.cuda.synchronize()
            t3 = time.perf_counter()
            add(dec_l, before)
            files.setdefault(name, []).append(data)
            recons.append(rec)
            enc_ms.append(1e3 * (t1 - t0))
            dec_ms.append(1e3 * (t3 - t2))
        launches[name] = {"encode": enc_l, "decode": dec_l}
        for direction, got, want in (("encode", enc_l, expected[name][0]),
                                     ("decode", dec_l, expected[name][1])):
            want = {**want, "quantize_pack": 0}
            check(got == {k: v * n_images for k, v in want.items()},
                  f"{name} {direction} launches {got}, expected {want} an image")
        per_model[name] = {"encode_ms": enc_ms, "decode_ms": dec_ms, "recons": recons}
    path_launches = {k: sum(launches[nm][d][k] for nm in launches for d in ("encode", "decode"))
                     for k in counts()}

    lap("main_path")

    # ---- checks on the files, outside the counted run
    results = {}
    for name, model in models.items():
        per_image = []
        for i, (img, data) in enumerate(zip(images, files[name])):
            x = tensor(img)
            rec = per_model[name]["recons"][i]
            check(rec.shape == img.shape and np.isfinite(rec).all() and rec.min() >= 0.0
                  and rec.max() <= 1.0, f"{name} image {i}: recon not finite in [0, 1]")
            if name == "joint":
                comp, y_enc = cheng2020.compress(model, x, return_y_hat=True)
                file_comp = codec_cli.read_joint(data)[0]
                _, y_dec = cheng2020.decompress(model, file_comp, return_y_hat=True)
                reset()
                with torch.no_grad():
                    out = model(x)
                fwd = counts()
                check(fwd["conv_gdn"] == 6 and fwd["gdn"] == 0,
                      f"joint eval forward launches {fwd}, expected K2 6")
            else:
                comp, y_enc = hyperprior.compress(model, x, return_y_hat=True)
                file_comp = codec_cli.read_hyperprior(data)[0]
                _, y_dec = hyperprior.decompress(model, file_comp, return_y_hat=True)
                reset()
                with torch.no_grad():
                    out = model(x)
                fwd = counts()
                check(fwd["conv_gdn"] == 3 and fwd["gdn"] == 3,
                      f"{name} eval forward launches {fwd}, expected K2 3 + K1 3")
                check(np.array_equal(out["latent"][0].cpu().numpy(), y_enc),
                      f"{name} image {i}: the codec's ŷ differs from the eval forward's")
                err = float(np.abs(rec - out["recon"][0].cpu().numpy()).max())
                check(err <= DECODE_ATOL, f"{name} image {i}: decoded recon {err:.2e} from "
                                          "the eval forward's")
            check(file_comp == comp, f"{name} image {i}: the file's streams differ from a "
                                     "second encode")
            check(np.array_equal(y_dec, y_enc), f"{name} image {i}: decoded ŷ differs from "
                                                "the encoder's")
            with torch.no_grad():
                y_t = model.g_a(x) if name == "joint" else model.Encoder(x)
                z_t = model.h_a(y_t) if name == "joint" else model.priorEncoder(y_t)
            z_enc = np.round(z_t[0].cpu().numpy())
            z_dec = decode_latent(hyperprior.z_codec(model, file_comp.z_min, file_comp.z_max),
                                  file_comp.z_stream, file_comp.z_shape)
            check(np.array_equal(z_dec, z_enc), f"{name} image {i}: decoded ẑ differs")
            if name == "hyperprior":
                check(np.array_equal(y_enc, np.round(y_t[0].cpu().numpy())),
                      f"hyperprior image {i}: ŷ is not round(y)")
            if name == "joint":
                host = cheng2020._HostARContext(model)
                hyper = cheng2020._hyper(model, z_enc.astype(np.float32), dev)
                _, _, _, tids = cheng2020.ar_encode(host, y_t[0].cpu().numpy(), hyper,
                                                    model.scale_bound)
                syms = cheng2020.default_gaussian_codec(file_comp.max_sym).decode(
                    file_comp.y_stream, tids)
            elif name == "hyperprior":
                syms = y_enc
            else:
                syms = np.round(y_enc / hyperprior.sigma_of(model, z_enc.astype(np.float32)))
            bpp = 8.0 * len(data) / (h * w)
            per_image.append({
                "bytes": len(data), "bpp_rans": bpp, "bpp_est": float(out["bpp"]),
                "bpp_y_est": float(out["bpp_y"]), "bpp_z_est": float(out["bpp_z"]),
                "y_symbols": {"used": int(np.unique(syms).size), "min": int(syms.min()),
                              "max": int(syms.max()), "std": float(np.std(syms))},
                "z_symbols": {"used": int(np.unique(z_enc).size), "min": int(z_enc.min()),
                              "max": int(z_enc.max())},
                "encode_ms": per_model[name]["encode_ms"][i],
                "decode_ms": per_model[name]["decode_ms"][i]})
            check(np.isfinite(bpp) and bpp > 0 and np.isfinite(per_image[-1]["bpp_est"]),
                  f"{name} image {i}: bpp {bpp} / estimate {per_image[-1]['bpp_est']}")
        results[name] = {"per_image": per_image,
                         "encode_ms_median": statistics.median(per_model[name]["encode_ms"]),
                         "decode_ms_median": statistics.median(per_model[name]["decode_ms"])}

    lap("checks")

    # ---- the same ẑ on the card and on the CPU: σ's scale-index flips,
    # on every image and on a crop; the crop's card file is decoded on the
    # CPU where its count is 0
    cpu_models = {}
    for name, model in models.items():
        cpu = (JointAutoregressive(n) if name == "joint"
               else ScaleHyperprior(n, m, quant=model.quant))
        cpu.load_state_dict({k: v.cpu() for k, v in model.state_dict().items()})
        cpu_models[name] = cpu.eval()

    def flips(name, img):
        """(σ scale-index flips between the card and the CPU for the card's
        ẑ of ``img``, the elements compared). The joint codec's σ also
        depends on ŷ: the CPU's σ is taken along the trajectory the CPU
        decoder of the card's file follows (the card's symbols, the CPU's
        μ)."""
        model, cpu = models[name], cpu_models[name]
        with torch.no_grad():
            y_t = model.g_a(tensor(img)) if name == "joint" else model.Encoder(tensor(img))
            z = np.round((model.h_a(y_t) if name == "joint" else model.priorEncoder(y_t))[0]
                         .cpu().numpy())
        if name != "joint":
            tids = [scale_indices(hyperprior.sigma_of(mod, z), table) for mod in (model, cpu)]
            return int((tids[0] != tids[1]).sum()), int(tids[0].size)
        host = cheng2020._HostARContext(model)
        y = y_t[0].cpu().numpy()
        stream, max_sym, _, tids = cheng2020.ar_encode(host, y, cheng2020._hyper(model, z, dev),
                                                       model.scale_bound)
        syms = cheng2020.default_gaussian_codec(max_sym).decode(stream, tids)
        base = host.prep(cheng2020._hyper(cpu, z, torch.device("cpu")))
        lh, lw, _ = y.shape
        pad = host.kh // 2
        y_hat_pad = np.zeros((lh + 2 * pad, lw + 2 * pad, n), np.float32)
        at = count = 0
        for ii, jj in cheng2020._wavefronts(lh, lw):
            mu, sigma = host.mu_sigma_batch(y_hat_pad, base, ii, jj, model.scale_bound)
            k = mu.size
            count += int((scale_indices(sigma, table).reshape(-1) != tids[at: at + k]).sum())
            y_hat_pad[ii + pad, jj + pad] = syms[at: at + k].reshape(mu.shape) + mu
            at += k
        return count, int(tids.size)

    cross = {}
    crop_img = np.ascontiguousarray(images[0][: crop[0], : crop[1]])
    for name, model in models.items():
        counted = [flips(name, img) for img in images]
        entry = {"sigma_flips": [c[0] for c in counted], "elements": [c[1] for c in counted]}
        if name == "hyperprior-sigma":
            entry["note"] = "one unit-Laplace row: no scale index to flip"
        crop_flips, _ = flips(name, crop_img)
        entry["crop_sigma_flips"] = crop_flips
        if name == "hyperprior-sigma" or crop_flips == 0:
            data = codec_cli.encode_image(crop_img, model, device=device)
            rec_dev = codec_cli.decode_image(data, model, device=device)
            rec_cpu = codec_cli.decode_image(data, cpu_models[name], device="cpu")
            if name == "joint":
                comp = codec_cli.read_joint(data)[0]
                _, y_dev = cheng2020.decompress(model, comp, return_y_hat=True)
                _, y_cpu = cheng2020.decompress(cpu_models[name], comp, return_y_hat=True)
            else:
                comp = codec_cli.read_hyperprior(data)[0]
                _, y_dev = hyperprior.decompress(model, comp, return_y_hat=True)
                _, y_cpu = hyperprior.decompress(cpu_models[name], comp, return_y_hat=True)
            y_err = float(np.abs(y_dev - y_cpu).max())
            rec_err = float(np.abs(rec_dev - rec_cpu).max())
            y_ok = bool(np.all(np.abs(y_dev - y_cpu) <= Y_HAT_TOL * (1.0 + np.abs(y_dev))))
            check(y_ok, f"{name}: the card's file decoded on the CPU: ŷ {y_err:.2e} from the "
                        "card's")
            check(rec_err <= DECODE_ATOL, f"{name}: the card's file decoded on the CPU: "
                                          f"recon {rec_err:.2e} from the card's")
            entry.update(cpu_decode={"y_hat_max_abs_err": y_err, "recon_max_abs_err": rec_err})
        else:
            entry["cpu_decode"] = None  # σ crosses a table edge: the decode would desync
        cross[name] = entry

    lap("cpu_reference")

    # ---- the host AR pass on the card's host: native against numpy front
    # by front on the first image's own data, both timed on every image,
    # and a file encoded and decoded by numpy
    host_n = cheng2020._HostARContext(jm, "native")
    host_p = cheng2020._HostARContext(jm, "numpy")
    with torch.no_grad():
        y_t = jm.g_a(x0)
        z0 = np.round(jm.h_a(y_t)[0].cpu().numpy())
    y0, hyper0 = y_t[0].cpu().numpy(), cheng2020._hyper(jm, z0, dev)
    lh, lw, _ = y0.shape
    pad = host_n.kh // 2
    y_hat_pad = np.zeros((lh + 2 * pad, lw + 2 * pad, n), np.float32)
    base = host_n.prep(hyper0)
    check(np.array_equal(base, host_p.prep(hyper0)), "AR prep differs between the backends")
    ar_gap = 0.0
    for ii, jj in cheng2020._wavefronts(lh, lw):
        mu_n, sg_n = host_n.mu_sigma_batch(y_hat_pad, base, ii, jj, jm.scale_bound)
        mu_p, sg_p = host_p.mu_sigma_batch(y_hat_pad, base, ii, jj, jm.scale_bound)
        for a, b in ((mu_n, mu_p), (sg_n, sg_p)):
            ar_gap = max(ar_gap, float((np.abs(a - b) / (AR_TOL + AR_TOL * np.abs(b))).max()))
        y_hat_pad[ii + pad, jj + pad] = np.round(y0[ii, jj] - mu_n) + mu_n
    check(ar_gap <= 1.0, f"native AR vs numpy: {ar_gap:.2f}× the tolerance {AR_TOL}")
    ar_ms = {}
    for backend, host in (("native", host_n), ("numpy", host_p)):
        times = []
        for img in images:
            with torch.no_grad():
                y_t = jm.g_a(tensor(img))
                z = np.round(jm.h_a(y_t)[0].cpu().numpy())
            y, hyper = y_t[0].cpu().numpy(), cheng2020._hyper(jm, z, dev)
            t0 = time.perf_counter()
            cheng2020.ar_encode(host, y, hyper, jm.scale_bound)
            times.append(1e3 * (time.perf_counter() - t0))
        ar_ms[backend] = times
    comp_np, y_np = cheng2020.compress(jm, x0, return_y_hat=True, backend="numpy")
    _, y_np_dec = cheng2020.decompress(jm, comp_np, return_y_hat=True, backend="numpy")
    check(np.array_equal(y_np, y_np_dec), "joint: a numpy-backend file does not round-trip")

    lap("host_ar")

    # ---- one joint encode + decode under the profiler
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        codec_cli.decode_image(codec_cli.encode_image(images[0], jm, device=device), jm,
                               device=device)
        torch.cuda.synchronize()
        prof_wall = 1e3 * (time.perf_counter() - t0)
    by_kernel, n_kernels = {}, 0
    for evt in prof.events():
        if evt.device_type == torch.autograd.DeviceType.CUDA and not getattr(
                evt, "is_user_annotation", False):
            key = evt.name.split("(")[0][:60]
            by_kernel[key] = by_kernel.get(key, 0.0) + evt.time_range.elapsed_us() / 1e3
            n_kernels += 1
    busy = sum(by_kernel.values())
    peak = torch.cuda.max_memory_allocated()

    lap("profile")

    # ---- K2 at the six C = 192 shapes and K1 at the three IGDN shapes,
    # from the models' own activations of the first image
    k2_row, k1_row = tools.new_row(library=True), tools.new_row(library=False)
    with torch.no_grad():
        xs, enc = x0, hp.Encoder
        for i, (conv, gdn_m) in enumerate(((enc.conv1, enc.gdn1), (enc.conv2, enc.gdn2),
                                           (enc.conv3, enc.gdn3))):
            beta, gamma = gdn_reparam(gdn_m.params())
            args = (xs.contiguous(), conv.weight.permute(2, 3, 1, 0).contiguous(), conv.bias,
                    gamma.t().contiguous(), beta.contiguous(), 2, 2, False)
            tools.measure_k2(args, k2_row, f"K2 Analysis18 conv{i + 1}", cudnn_k1=True)
            k2_row["shapes"][-1]["where"] = f"hyperprior g_a conv{i + 1}+gdn{i + 1}"
            xs = k2.conv_gdn_plain(*args)
        sites = [("joint g_a.0", jm.g_a[0]), ("joint g_a.2", jm.g_a[2]),
                 ("joint g_a.4", jm.g_a[4]), ("joint g_s.1", jm.g_s[1]),
                 ("joint g_s.3", jm.g_s[3]), ("joint g_s.5", jm.g_s[5])]
        inputs = {}
        hooks = [blk.register_forward_pre_hook(
            lambda mod, a, where=where: inputs.setdefault(where, a[0])) for where, blk in sites]
        igdn_in = {}
        hooks += [dc.register_forward_hook(
            lambda mod, a, out, i=i: igdn_in.setdefault(i, out))
            for i, dc in enumerate((hp.Decoder.deconv1, hp.Decoder.deconv2, hp.Decoder.deconv3))]
        jm(x0)
        hp(x0)
        for hk in hooks:
            hk.remove()
        for where, blk in sites:
            tools.measure_k2(block_k2_args(blk, inputs[where]), k2_row, f"K2 {where}",
                             cudnn_k1=True)
            k2_row["shapes"][-1]["where"] = where
        add_pixels_and_partials(k2_row)
        for i, igdn in enumerate((hp.Decoder.igdn1, hp.Decoder.igdn2, hp.Decoder.igdn3)):
            tools.measure_k1(igdn_in[i].contiguous(), igdn, k1_row, f"K1 Synthesis18 igdn{i + 1}")
            k1_row["shapes"][-1]["where"] = f"hyperprior g_s igdn{i + 1}"

    lap("kernels")
    seconds = time.perf_counter() - t_phase
    summary = {name: {k: results[name][k] for k in ("encode_ms_median", "decode_ms_median")}
               for name in results}
    emit({"phase": "hyper", "ok": True, "n": n, "m": m, "seed": HYPER_SEED, "images": n_images,
          "shape": [h, w, 3], "y_std": HYPER_Y_STD, "z_std": HYPER_Z_STD,
          "launches": launches, "launches_total": path_launches,
          "per_model": {name: results[name] for name in results}, "ms": summary,
          "sigma_flips": cross,
          "host_ar": {"native_ms": ar_ms["native"], "numpy_ms": ar_ms["numpy"],
                      "native_vs_numpy_gap_of_tol": ar_gap, "tol": AR_TOL,
                      "fronts": len(cheng2020._wavefronts(lh, lw)), "latent": [lh, lw, n]},
          "profile_joint": {"wall_ms": prof_wall, "device_busy_ms": busy,
                            "device_idle_share": 1.0 - busy / prof_wall if prof_wall else None,
                            "device_kernels": n_kernels,
                            "device_ms_by_kernel": dict(sorted(by_kernel.items(),
                                                               key=lambda kv: -kv[1])[:12])},
          "peak_memory_gib": peak / 2 ** 30,
          "k2_c192": k2_row, "k1_c192": k1_row, "seconds": seconds, "section_s": laps})
    print(f"hyper phase seconds: {seconds:.1f}", flush=True)
    return {"launches": path_launches, "k2": k2_row, "k1": k1_row}


def hyper_train_phase(torch, dev, tools, steps: int = HT_STEPS,
                      resume_steps: int = HT_RESUME_STEPS, sigma_steps: int = HT_SIGMA_STEPS,
                      n_images: int = N_HT_IMAGES, img: int = HT_IMG, test_hw=(IMG_H, IMG_W),
                      n: int = HYPER_N, m: int = HYPER_M, crop: int = 0) -> dict:
    """Hyperprior and joint-AR training on the card (see the module
    docstring). ``tools`` holds the harness of ``main``: check, emit,
    time_ms, measure_k2, measure_k1, new_row. Returns the K2 and K1 rows and
    the launches of the main path. ``crop`` (0: the config's) is for a
    rehearsal on the CPU at a small size."""
    from torch.profiler import ProfilerActivity, profile

    from iclr_17_compression_tpu_torch.coding import codec_cli
    from iclr_17_compression_tpu_torch.data.datasets import (ImageFolderDataset, batch_iterator,
                                                             write_ppm)
    from iclr_17_compression_tpu_torch.models import cheng2020, hyperprior
    from iclr_17_compression_tpu_torch.ops import gdn as ops_gdn
    from iclr_17_compression_tpu_torch.ops.gdn import gdn_reparam
    from iclr_17_compression_tpu_torch.ops.kernels import conv_gdn_kernel as k2
    from iclr_17_compression_tpu_torch.ops.kernels import gdn_kernel as k1
    from iclr_17_compression_tpu_torch.ops.kernels import quant_pack_kernel as k3
    from iclr_17_compression_tpu_torch.train import cli as train_cli
    from iclr_17_compression_tpu_torch.train.checkpoint import load_train_state
    from iclr_17_compression_tpu_torch.train.config import TrainConfig
    from iclr_17_compression_tpu_torch.train.state import (build_model, create_train_state,
                                                           make_hyperprior_train_step,
                                                           step_generator)
    from iclr_17_compression_tpu_torch.train.weights import load_hyperprior, load_joint
    from iclr_17_compression_tpu_torch.utils.device import cudnn_autotune

    check, emit = tools.check, tools.emit
    t_phase = time.perf_counter()
    work = os.path.join(ROOT, "build", "chip_smoke_hyper_train")
    shutil.rmtree(work, ignore_errors=True)
    train_dir, test_dir = os.path.join(work, "train"), os.path.join(work, "test")
    os.makedirs(train_dir)
    os.makedirs(test_dir)
    rng = np.random.default_rng(6)
    for i in range(n_images):
        write_ppm(os.path.join(train_dir, f"{i:02d}.ppm"), smooth_image(rng, img, img))
    test_image = smooth_image(rng, *test_hw)
    write_ppm(os.path.join(test_dir, "0.ppm"), test_image)
    base = dataclasses.replace(
        TrainConfig.from_json(os.path.join(ROOT, "examples", "balle17.json")),
        out_channel_n=n, out_channel_m=m, joint_n=n, tot_step=steps, save_model_freq=steps,
        print_freq=10, cal_step=1, tensorboard=False, train_dir=train_dir, test_dir=test_dir,
        save_root=work)
    check((base.batch_size, base.image_size, base.train_lambda, base.lr_base, base.grad_clip)
          == (4, 256, 8192, 1e-4, 5.0),
          "examples/balle17.json is not the batch 4, 256 px, λ 8192, lr 1e-4 config")
    base = dataclasses.replace(base, image_size=crop or base.image_size)
    lam = base.train_lambda

    def counts():
        return {"conv_gdn": k2.conv_gdn.launches, "gdn": k1.gdn_fused.launches,
                "quantize_pack": k3.quantize_pack.launches}

    def reset():
        k2.conv_gdn.launches = k1.gdn_fused.launches = k3.quantize_pack.launches = 0

    # the loop's own step, timed (host clock around work that ends in a
    # synchronize), its launches counted, its first batch kept; the eval's
    # launches apart
    steps_seen, first, evals = [], {}, []
    real_make_step, real_eval = train_cli.make_hyperprior_train_step, train_cli.eval_kodak

    def timed_make_step(*args, **kw):
        step_fn = real_make_step(*args, **kw)

        def timed_step(state, x, generator):
            first.setdefault("step", state.step)
            first.setdefault("x", x.detach().clone())
            before = counts()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            metrics = step_fn(state, x, generator)
            torch.cuda.synchronize()
            t1 = time.perf_counter()
            steps_seen.append((state.step, t0, t1, float(metrics["rd_loss"]),
                               {k: v - before[k] for k, v in counts().items()}))
            return metrics

        return timed_step

    def counted_eval(*args, **kw):
        before = counts()
        res = real_eval(*args, **kw)
        evals.append((res, {k: v - before[k] for k, v in counts().items()}))
        return res

    per_step = {"hyperprior": {"conv_gdn": 3, "gdn": 3, "quantize_pack": 0},
                "joint": {"conv_gdn": 6, "gdn": 0, "quantize_pack": 0}}
    runs, states, trained, launches_total = {}, {}, {}, dict.fromkeys(counts(), 0)
    train_cli.make_hyperprior_train_step, train_cli.eval_kodak = timed_make_step, counted_eval
    try:
        for name in ("hyperprior", "joint"):
            cfg = dataclasses.replace(base, model=name)
            run_dir = os.path.join(work, name)
            paths = [os.path.join(work, f"{name}_{s}.json") for s in ("a", "b")]
            for path, c in zip(paths, (cfg, dataclasses.replace(cfg, tot_step=resume_steps))):
                with open(path, "w") as f:
                    f.write(c.to_json())
            # run A: steps 0..steps-1, the counters around it only
            steps_seen.clear()
            evals.clear()
            first.clear()
            torch.cuda.reset_peak_memory_stats()
            reset()
            t0 = time.perf_counter()
            state_a = train_cli.main(["--config", paths[0], "-n", name])
            run_a_s = time.perf_counter() - t0
            launches_a = counts()
            peak = torch.cuda.max_memory_allocated()
            steps_a, evals_a = list(steps_seen), list(evals)
            first.clear()

            # what run A saved, read back into a fresh state, equals what it held
            fresh = create_train_state(build_model(name, device=dev, out_channel_n=n,
                                                   out_channel_m=m, n=n), lr=cfg.lr_base)
            fresh, meta = load_train_state(fresh, os.path.join(run_dir, "latest.ckpt"))
            saved_opt = state_a.optimizer.state_dict()["state"]
            read_opt = fresh.optimizer.state_dict()["state"]
            check(fresh.step == steps == meta["step"], f"{name}: saved step {fresh.step}, {meta}")
            check(all(torch.equal(a, b) for a, b in zip(state_a.model.state_dict().values(),
                                                        fresh.model.state_dict().values())),
                  f"{name} resume: parameters read back differ from the saved ones")
            check(len(saved_opt) == len(read_opt) and all(
                torch.equal(saved_opt[i][k], read_opt[i][k])
                for i in saved_opt for k in ("exp_avg", "exp_avg_sq", "step")),
                f"{name} resume: Adam moments read back differ from the saved ones")
            del fresh

            # run B: --resume to resume_steps
            steps_seen.clear()
            evals.clear()
            reset()
            state_b = train_cli.main(["--config", paths[1], "-n", name, "--resume", run_dir])
            launches_b = counts()
            steps_b, evals_b = list(steps_seen), list(evals)
            per_epoch = n_images // cfg.batch_size
            epoch, skip = divmod(steps, per_epoch)
            expected = next(batch_iterator(ImageFolderDataset(train_dir, cfg.image_size,
                                                              cfg.seed),
                                           cfg.batch_size, seed=cfg.seed, epoch=epoch,
                                           skip=skip))
            check(first["step"] == steps and state_b.step == resume_steps,
                  f"{name} resume ran steps {first['step']}..{state_b.step}")
            check(torch.equal(first["x"].cpu(), torch.from_numpy(expected)),
                  f"{name} resume: the first batch is not the one the uninterrupted loop draws")
            both = steps_a + steps_b
            check(len(steps_a) == steps and len(steps_b) == resume_steps - steps,
                  f"{name}: steps run {len(steps_a)}, {len(steps_b)}")
            check(all(s[4] == per_step[name] for s in both),
                  f"{name}: launches a step {sorted({str(s[4]) for s in both})}, expected "
                  f"{per_step[name]}")
            eval_l = [e[1] for e in evals_a + evals_b]
            want_eval = {"conv_gdn": per_step[name]["conv_gdn"], "gdn": per_step[name]["gdn"],
                         "quantize_pack": 0}
            check(len(evals_a) == 1 and not evals_b and eval_l == [want_eval],
                  f"{name}: eval launches {eval_l}, expected {want_eval} once, at step {steps}")
            for got, whole, ev in ((steps_a, launches_a, evals_a), (steps_b, launches_b, evals_b)):
                run_l = {k: sum(s[4][k] for s in got) + sum(e[1][k] for e in ev) for k in whole}
                check(run_l == whole, f"{name}: the run's launches {whole} are not its steps' "
                                      f"and evals' {run_l}")
            for k in launches_total:
                launches_total[k] += sum(s[4][k] for s in both)
            losses = [s[3] for s in both]
            check(all(np.isfinite(losses)), f"{name}: an rd_loss is not finite")
            first10, last10 = float(np.mean(losses[:10])), float(np.mean(losses[-10:]))
            check(last10 < first10,
                  f"{name}: rd_loss did not fall: first 10 {first10:.2f}, last 10 {last10:.2f}")
            ev = evals_a[0][0]
            check(all(np.isfinite([ev[k] for k in ("bpp", "psnr", "ms_ssim")])),
                  f"{name}: eval metrics not finite: {ev}")
            step_ms = [1e3 * (t1 - t0) for _, t0, t1, *_ in steps_a[2:]]  # after 2 warm-ups
            runs[name] = {
                "steps": [steps, resume_steps], "launches_per_step": per_step[name],
                "eval_launches": want_eval, "rd_loss_first10": first10,
                "rd_loss_last10": last10, "rd_loss_every5": losses[::5],
                "first_step_ms": 1e3 * (steps_a[0][2] - steps_a[0][1]),
                "median_step_ms": statistics.median(step_ms),
                "images_per_s": cfg.batch_size * 1e3 / statistics.median(step_ms),
                "run_a_s": run_a_s, "peak_memory_gib": peak / 2 ** 30,
                "cudnn": "autotune (benchmark, deterministic)" if name == "joint" else "default",
                "eval": {k: ev[k] for k in ("bpp", "psnr", "ms_ssim", "ms_ssim_db")}}
            states[name] = state_b
            trained[name] = {k: v.clone() for k, v in state_b.model.state_dict().items()}

        # the hyperprior's sigma-norm quantizer: a few steps
        steps_seen.clear()
        cfg_s = dataclasses.replace(base, model="hyperprior", quant="sigma-norm",
                                    tot_step=sigma_steps, save_model_freq=sigma_steps,
                                    test_dir="")
        path = os.path.join(work, "sigma.json")
        with open(path, "w") as f:
            f.write(cfg_s.to_json())
        state_s = train_cli.main(["--config", path, "-n", "hyperprior_sigma"])
        check(state_s.model.quant == "sigma-norm" and len(steps_seen) == sigma_steps,
              f"sigma-norm: quant {state_s.model.quant}, {len(steps_seen)} steps")
        check(all(s[4] == per_step["hyperprior"] for s in steps_seen),
              f"sigma-norm: launches a step {[s[4] for s in steps_seen]}")
        check(all(np.isfinite(s[3]) for s in steps_seen), "sigma-norm: an rd_loss is not finite")
        for k in launches_total:
            launches_total[k] += sum(s[4][k] for s in steps_seen)
        runs["hyperprior_sigma"] = {"steps": sigma_steps,
                                    "rd_loss": [s[3] for s in steps_seen],
                                    "median_step_ms": statistics.median(
                                        1e3 * (t1 - t0) for _, t0, t1, *_ in steps_seen[1:])}
    finally:
        train_cli.make_hyperprior_train_step, train_cli.eval_kodak = real_make_step, real_eval

    batch = first["x"]  # run B's first batch of the joint, on the card
    step_fn = make_hyperprior_train_step(lam)

    def flags_of(model):
        """The cuDNN flags the training loop gives ``model``'s steps."""
        return cudnn_autotune() if getattr(model, "train_cudnn_autotune", False) \
            else contextlib.nullcontext()

    # a step both ways: cuDNN's heuristic (the flags' defaults) and cuDNN
    # choosing by timing, HT_CUDNN_STEPS steps each after one warm-up
    both_ways = {}
    for name in ("hyperprior", "joint"):
        for how, ctx in (("default", contextlib.nullcontext), ("autotune", cudnn_autotune)):
            st = create_train_state(build_model(name, device=dev, seed=3, out_channel_n=n,
                                                out_channel_m=m, n=n), lr=base.lr_base)
            torch.cuda.reset_peak_memory_stats()
            times = []
            with ctx():
                for i in range(1 + HT_CUDNN_STEPS):
                    torch.cuda.synchronize()
                    t0 = time.perf_counter()
                    step_fn(st, batch, step_generator(base.seed, i, dev))
                    torch.cuda.synchronize()
                    times.append(1e3 * (time.perf_counter() - t0))
            both_ways[f"{name}_{how}"] = {
                "first_ms": times[0], "step_ms": statistics.median(times[1:]),
                "peak_memory_gib": torch.cuda.max_memory_allocated() / 2 ** 30}
            del st

    # PROFILE_STEPS steps of each model under the profiler, on the trained state
    profiles = {}
    for name, state in states.items():
        with flags_of(state.model):
            for i in range(2):
                step_fn(state, batch, step_generator(base.seed, 100 + i, dev))
            torch.cuda.synchronize()
            with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
                t0 = time.perf_counter()
                for i in range(PROFILE_STEPS):
                    step_fn(state, batch, step_generator(base.seed, 200 + i, dev))
                torch.cuda.synchronize()
                window_ms = 1e3 * (time.perf_counter() - t0)
        by_kernel = device_ms_by_kernel(torch, prof)
        busy = sum(by_kernel.values())
        ours = sum(v for k, v in by_kernel.items()
                   if any(s in k for s in ("conv_gdn_kernel", "conv_gdn_reduce", "gdn_rows")))
        profiles[name] = {"steps": PROFILE_STEPS, "window_ms": window_ms,
                          "device_idle_share": 1.0 - busy / window_ms,
                          "per_step_ms": {"wall": window_ms / PROFILE_STEPS,
                                          "device_busy": busy / PROFILE_STEPS,
                                          "k1_k2_forward_kernels": ours / PROFILE_STEPS},
                          "window_ms_by_kernel": dict(sorted(by_kernel.items(),
                                                             key=lambda kv: -kv[1])[:12])}

    # gradients on the card: the kernels' Functions against the plain path
    # (K2 and K1 swapped for their plain versions), the same weights, batch
    # and noise; the floor: the plain path with every K2 and K1 output moved
    # by DSC_K2_PERTURB relative; the control: the same at TF32's error
    def grads(model, path: str, rel: float = 0.0):
        real = (k2.conv_gdn, ops_gdn.gdn_fused)
        gen_p = torch.Generator(device=dev).manual_seed(11)

        def moved(fn):
            def call(*args):
                y = fn(*args)
                return y * (1.0 + rel * torch.randn(y.shape, generator=gen_p, device=y.device))
            return call

        if path == "plain":
            k2.conv_gdn, ops_gdn.gdn_fused = k2.conv_gdn_plain, k1.gdn_fused_plain
        elif path == "perturbed":
            k2.conv_gdn, ops_gdn.gdn_fused = moved(k2.conv_gdn_plain), moved(k1.gdn_fused_plain)
        try:
            model.zero_grad(set_to_none=True)
            out = model(batch, train=True, generator=step_generator(base.seed, 7, dev))
            (lam * out["mse"] + out["bpp"]).backward()
        finally:
            k2.conv_gdn, ops_gdn.gdn_fused = real
        return {k: p.grad.clone() for k, p in model.named_parameters()}

    def gaps(ga, gb):
        return {k: float((ga[k] - gb[k]).abs().max() / gb[k].abs().max().clamp(min=1e-30))
                for k in gb}

    def stats(g, g_plain):
        """(the largest tensor's gap, the median tensor's gap)."""
        gap = list(gaps(g, g_plain).values())
        return max(gap), statistics.median(gap)

    parity = {}
    for name, state in states.items():
        model = build_model(name, device=dev, out_channel_n=n, out_channel_m=m, n=n)
        model.load_state_dict(trained[name])
        with flags_of(model):
            before = counts()
            g_kernel = grads(model, "kernel")
            ran = {k: v - before[k] for k, v in counts().items()}
            check(ran == per_step[name], f"{name} gradient parity: the kernel path ran {ran}")
            g_plain = grads(model, "plain")
            floor = stats(grads(model, "perturbed", DSC_K2_PERTURB), g_plain)
            control = stats(grads(model, "perturbed", DSC_CONTROL_PERTURB), g_plain)
        kp = gaps(g_kernel, g_plain)
        kernel = (max(kp.values()), statistics.median(kp.values()))
        # the dsc_train phase's gate on the largest tensor's gap, and the
        # same on the median tensor's, where the ReLU and leaky-ReLU kinks
        # of the small hyper tensors (a floor of 1e-2 at 1e-5 relative on
        # the largest) do not drown a TF32-size error
        gate = (max(DSC_GRAD_TOL, DSC_FLOOR_FACTOR * floor[0]), DSC_FLOOR_FACTOR * floor[1])
        parity[name] = {"max_gap": kernel[0], "median_gap": kernel[1], "floor": floor,
                        "gate": gate, "control_gap": control,
                        "worst": sorted(((v, k) for k, v in kp.items()), reverse=True)[:5]}
        del model

    # K2 and K1 at the C = 192 training shapes, from the trained models'
    # own activations on the batch; cuDNN timed under each model's loop flags
    k2_row, k1_row = tools.new_row(library=True), tools.new_row(library=False)
    hp, jm = states["hyperprior"].model, states["joint"].model
    with torch.no_grad():
        xs, enc = batch, hp.Encoder
        for i, (conv, gdn_m) in enumerate(((enc.conv1, enc.gdn1), (enc.conv2, enc.gdn2),
                                           (enc.conv3, enc.gdn3))):
            beta, gamma = gdn_reparam(gdn_m.params())
            args = (xs.contiguous(), conv.weight.permute(2, 3, 1, 0).contiguous(), conv.bias,
                    gamma.t().contiguous(), beta.contiguous(), 2, 2, False)
            tools.measure_k2(args, k2_row, f"K2 hyperprior training conv{i + 1}", cudnn_k1=True)
            k2_row["shapes"][-1].update(where=f"hyperprior g_a conv{i + 1}+gdn{i + 1}",
                                        cudnn="default")
            xs = k2.conv_gdn_plain(*args)
        sites = [("joint g_a.0", jm.g_a[0]), ("joint g_a.2", jm.g_a[2]),
                 ("joint g_a.4", jm.g_a[4]), ("joint g_s.1", jm.g_s[1]),
                 ("joint g_s.3", jm.g_s[3]), ("joint g_s.5", jm.g_s[5])]
        inputs, igdn_in = {}, {}
        hooks = [blk.register_forward_pre_hook(
            lambda mod, a, where=where: inputs.setdefault(where, a[0])) for where, blk in sites]
        hooks += [dc.register_forward_hook(lambda mod, a, out, i=i: igdn_in.setdefault(i, out))
                  for i, dc in enumerate((hp.Decoder.deconv1, hp.Decoder.deconv2,
                                          hp.Decoder.deconv3))]
        g = step_generator(base.seed, 9, dev)
        jm(batch, train=True, generator=g)
        hp(batch, train=True, generator=g)
        for hk in hooks:
            hk.remove()
        with cudnn_autotune():
            for where, blk in sites:
                tools.measure_k2(block_k2_args(blk, inputs[where]), k2_row,
                                 f"K2 {where} training", cudnn_k1=True)
                k2_row["shapes"][-1].update(where=where, cudnn="autotune")
        add_pixels_and_partials(k2_row)
        for i, igdn in enumerate((hp.Decoder.igdn1, hp.Decoder.igdn2, hp.Decoder.igdn3)):
            tools.measure_k1(igdn_in[i].contiguous(), igdn, k1_row,
                             f"K1 hyperprior training igdn{i + 1}")
            k1_row["shapes"][-1]["where"] = f"hyperprior g_s igdn{i + 1}"

    # train → codec: the hyperprior's JAX-layout iter checkpoint and the
    # joint's train-state file through the codec CLI (kinds 5 and 6); a
    # second checkpoint format of each gives the same file
    from iclr_17_compression_tpu_torch.data.datasets import _load

    test_ppm = os.path.join(test_dir, "0.ppm")
    test_image = _load(test_ppm)  # the 8-bit image the CLI reads
    x_test = torch.from_numpy(codec_cli.pad_to_multiple(test_image, 64)[None]).to(dev)
    handoff = {}
    for name, ckpts, mod, load in (
            ("hyperprior", (f"iter_{resume_steps}.ckpt", "latest.ckpt"), hyperprior,
             load_hyperprior),
            ("joint", ("latest.ckpt", f"iter_{resume_steps}.ckpt"), cheng2020, load_joint)):
        run_dir = os.path.join(work, name)
        files = []
        for ckpt in ckpts:
            icz = os.path.join(work, f"{name}_{ckpt}.icz")
            codec_cli.main(["encode", test_ppm, icz, "--model", name, "--ckpt",
                            os.path.join(run_dir, ckpt), "--n", str(n), "--m", str(m)])
            files.append(open(icz, "rb").read())
        check(files[0] == files[1], f"{name}: the two checkpoint formats code different files")
        rec_path = os.path.join(work, f"{name}.ppm")
        codec_cli.main(["decode", icz, rec_path, "--ckpt", os.path.join(run_dir, ckpts[0])])
        loaded = load(os.path.join(run_dir, ckpts[0]), device="cuda")
        check(all(torch.equal(v, trained[name][k]) for k, v in loaded.state_dict().items()),
              f"{name}: {ckpts[0]} does not hold the trained parameters")
        comp, y_enc = mod.compress(loaded, x_test, return_y_hat=True)
        file_comp = (codec_cli.read_joint(files[0]) if name == "joint"
                     else codec_cli.read_hyperprior(files[0]))[0]
        _, y_dec = mod.decompress(loaded, file_comp, return_y_hat=True)
        check(file_comp == comp, f"{name}: the CLI's file differs from the model's streams")
        check(np.array_equal(y_dec, y_enc), f"{name}: the trained model's ŷ does not round-trip")
        rec = _load(rec_path)
        check(rec.shape == test_image.shape and np.isfinite(rec).all(),
              f"{name}: bad decoded image from the trained checkpoint")
        handoff[name] = {"ckpts": list(ckpts), "bytes": len(files[0]),
                         "bpp": 8.0 * len(files[0]) / (test_hw[0] * test_hw[1]),
                         "psnr_db": float(10 * np.log10(1.0 / max(
                             float(np.mean((rec - test_image) ** 2)), 1e-12)))}

    seconds = time.perf_counter() - t_phase
    emit({"phase": "hyper_train", "ok": True, "n": n, "m": m, "batch": base.batch_size,
          "crop": base.image_size, "lambda": lam, "train_images": n_images,
          "runs": runs, "cudnn_both_ways": both_ways, "profile": profiles,
          "grad_parity": {"tol": DSC_GRAD_TOL, "floor_factor": DSC_FLOOR_FACTOR,
                          "perturb": DSC_K2_PERTURB, "control_perturb": DSC_CONTROL_PERTURB,
                          **parity},
          "launches": launches_total, "k2_c192_training": k2_row, "k1_c192_training": k1_row,
          "handoff": handoff, "seconds": seconds})
    for name, p in parity.items():
        (gate_max, gate_median), control = p["gate"], p["control_gap"]
        check(p["max_gap"] <= gate_max and p["median_gap"] <= gate_median,
              f"{name} gradients through K2/K1 vs plain: largest tensor {p['max_gap']:.2e} "
              f"(gate {gate_max:.2e}), median {p['median_gap']:.2e} (gate {gate_median:.2e})")
        check(control[0] > gate_max or control[1] > gate_median,
              f"{name}: the gradient gate does not catch a TF32-size error: control "
              f"{control} within the gate {p['gate']}")
    print(f"hyper_train phase seconds: {seconds:.1f}", flush=True)
    return {"launches": launches_total, "k2": k2_row, "k1": k1_row}


def fusion_code_ends(model):
    """(the conv whose output channels are spread into the code, the convs
    that take the code in steps) of a DSC model: g_a22's last 3×3 conv to
    the code width (the skip conv of its last widening residual block where
    it has none) and g_s22's first 3×3 conv (the first widening residual
    block's conv1 and skip where it has none)."""
    cfg = model.config
    ga = [i for i, sp in enumerate(cfg.ga22) if sp[0] == "conv3" and sp[1] == cfg.code_channels]
    last = (model.g_a22[ga[-1]] if ga else
            [b.skip for b in model.g_a22 if getattr(b, "skip", None) is not None][-1])
    gs = [i for i, sp in enumerate(cfg.gs22) if sp[0] == "conv3"]
    if gs:
        takers = [model.g_s22[gs[0]]]
    else:
        block = next(b for b in model.g_s22 if getattr(b, "skip", None) is not None)
        takers = [block.conv1, block.skip]
    return last, takers


def dsc_fusion_phase(torch, dev, tools, h: int = DSC_H, w: int = DSC_W,
                     kitti_hw=(KITTI_H, KITTI_W), frames: int = FUSION_FRAMES,
                     epochs: int = FUSION_TRAIN_EPOCHS) -> dict:
    """The DSC fusion presets on the card (see the module docstring).
    ``tools`` holds the harness of ``main``: check, emit, time_ms, call_ms,
    measure_k2, new_row, bound_ms, floor_ms. Returns the K2 and K3 rows and
    the launches of the main path."""
    from torch.profiler import ProfilerActivity, profile

    from iclr_17_compression_tpu_torch.coding import codec_cli
    from iclr_17_compression_tpu_torch.models.dsc import (DSC_PRESETS, DSCDecoder,
                                                          DSCStereoModel, quantize_code)
    from iclr_17_compression_tpu_torch.ops.kernels import conv_gdn_kernel as k2
    from iclr_17_compression_tpu_torch.ops.kernels import gdn_kernel as k1
    from iclr_17_compression_tpu_torch.ops.kernels import quant_pack_kernel as k3
    from iclr_17_compression_tpu_torch.train import cli as train_cli
    from iclr_17_compression_tpu_torch.train.config import TrainConfig

    check, emit = tools.check, tools.emit
    t_phase = time.perf_counter()

    def counts():
        return {"conv_gdn": k2.conv_gdn.launches, "gdn": k1.gdn_fused.launches,
                "quantize_pack": k3.quantize_pack.launches}

    def reset():
        k2.conv_gdn.launches = k1.gdn_fused.launches = k3.quantize_pack.launches = 0

    rng = np.random.default_rng(8)
    left = smooth_image(rng, h, w)
    right = shift_pair(left, rng)
    x = torch.from_numpy(left[None]).to(dev)
    y = torch.from_numpy(right[None]).to(dev)
    launches = dict.fromkeys(counts(), 0)
    serving, k3_rows, models = {}, [], {}
    for i, preset in enumerate(FUSION_PRESETS):
        cfg = DSC_PRESETS[preset]
        gen = torch.Generator().manual_seed(FUSION_SEED + i)
        model = gdn_off_identity_(torch, DSCStereoModel(cfg).init_(gen), gen).to(dev).eval()
        last, takers = fusion_code_ends(model)
        spread_channels_(torch, last, lambda: model.encode(x), CODE_SPREAD)
        with torch.no_grad():
            for conv in takers:
                conv.weight.div_(cfg.coarse_step)
        models[preset] = model

        # the main path: the file codec on the pair, the counters around it only
        torch.cuda.synchronize()
        reset()
        t0 = time.perf_counter()
        data = codec_cli.encode_image(left, model, device="cuda")
        t1 = time.perf_counter()
        rec = codec_cli.decode_image(data, model, device="cuda", si_image=right)
        torch.cuda.synchronize()
        t2 = time.perf_counter()
        got = counts()
        for k in launches:
            launches[k] += got[k]
        check(got == {"conv_gdn": 11, "gdn": 0, "quantize_pack": 1},
              f"{preset}: launches {got}, expected K2 4 + 7 and K3 1 an image")

        # checks outside the counted run
        syms, code = codec_cli.dsc_symbols(x, model)
        decoded, name, h0, w0 = codec_cli.read_dsc_code(data)
        check(name == preset and (h0, w0) == (h, w), f"{preset}: header {name} {h0}x{w0}")
        check(decoded.shape[-1] == cfg.code_channels
              and np.array_equal(decoded[0] / cfg.coarse_step, syms),
              f"{preset}: decoded symbols differ from the encoder's")
        check(np.array_equal(decoded, code.cpu().numpy()),
              f"{preset}: decoded code differs from K3's dequantized code")
        check(rec.shape == left.shape and np.isfinite(rec).all() and rec.min() >= 0.0
              and rec.max() <= 1.0, f"{preset}: recon not finite in [0, 1]")
        cpu = DSCStereoModel(cfg)
        cpu.load_state_dict({k: v.cpu() for k, v in model.state_dict().items()})
        rec_cpu = codec_cli.decode_image(data, cpu.eval(), device="cpu", si_image=right)
        dec_err = float(np.abs(rec - rec_cpu).max())
        check(dec_err <= DECODE_ATOL, f"{preset}: GPU vs CPU decode of one file {dec_err:.3e}")
        with torch.no_grad():
            code_pre = model.encode(x).contiguous()
        ksyms, kcode = quantize_code(code_pre, cfg)
        rsyms, rcode = k3.quantize_pack_plain(code_pre, cfg.coarse_step, cfg.code_clip)
        check(torch.equal(ksyms, rsyms) and torch.equal(kcode, rcode),
              f"{preset}: K3 on the code is not bit-exact")

        # serving: encode to host symbols + the receiver, batch 1: CUDA
        # events around it (median of 5 after 2; the host's launch gaps
        # included), and one under the profiler (device busy)
        receiver = DSCDecoder(cfg, model=model)

        def serve():
            with torch.no_grad():
                symbols, code_t = quantize_code(model.encode(x), cfg)
                symbols.cpu()
                return receiver(code_t, y)

        serve_ms = []
        for j in range(7):
            start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
            start.record()
            serve()
            end.record()
            end.synchronize()
            if j >= 2:
                serve_ms.append(start.elapsed_time(end))
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            serve()
            torch.cuda.synchronize()
        by_kernel = device_ms_by_kernel(torch, prof)
        n3 = code_pre.numel()
        b_ms, b_by = tools.bound_ms(5.0 * n3, 9.0 * n3)
        k3_rows.append({"preset": preset, "x": list(code_pre.shape), "step": cfg.coarse_step,
                        "bits": 8, "ms": tools.time_ms(lambda: quantize_code(code_pre, cfg)),
                        "plain_ms": tools.time_ms(lambda: k3.quantize_pack_plain(
                            code_pre, cfg.coarse_step, cfg.code_clip)),
                        "bound_ms": b_ms, "bound_by": b_by, "launch_floor_ms": tools.floor_ms,
                        "library_ms": None, "max_abs_err": 0.0})
        serving[preset] = {"bytes": len(data), "bpp": 8.0 * len(data) / (h * w),
                           "symbols_used": int(np.unique(syms).size),
                           "encode_ms": 1e3 * (t1 - t0), "decode_ms": 1e3 * (t2 - t1),
                           "serving_ms": statistics.median(serve_ms),
                           "serving_device_busy_ms": sum(by_kernel.values()),
                           "serving_ms_by_kernel": dict(sorted(by_kernel.items(),
                                                               key=lambda kv: -kv[1])[:8]),
                           "cpu_decode_max_abs_err": dec_err,
                           "psnr_db": float(10 * np.log10(1.0 / max(
                               float(np.mean((rec - left) ** 2)), 1e-12)))}
        del cpu

    # K2 at the fusion presets' sites (the bottleneck preset's: its wide
    # g_a22 / g_s22 blocks beside the shared g_a / g_s), from the blocks'
    # own inputs in one encode + decode, against plain and cuDNN
    model = models["bottleneck_att_1bpp"]
    cfg = model.config
    sites = [(f"{stack} l{i}", getattr(model, stack)[i])
             for stack, specs in (("g_a", cfg.ga), ("g_a22", cfg.ga22), ("g_s22", cfg.gs22),
                                  ("g_s", cfg.gs))
             for i, spec in enumerate(specs) if spec[0] in ("rbs", "rbu")]
    inputs = {}
    hooks = [block.register_forward_pre_hook(
        lambda mod, args, where=where: inputs.setdefault(where, args[0]))
        for where, block in sites]
    codec_cli.decode_image(codec_cli.encode_image(left, model, device="cuda"), model,
                           device="cuda", si_image=right)
    for hk in hooks:
        hk.remove()
    k2_row = tools.new_row(library=True)
    with torch.no_grad():
        for where, block in sites:
            tools.measure_k2(block_k2_args(block, inputs[where]), k2_row,
                             f"K2 bottleneck_att_1bpp {where}", cudnn_k1=True)
            k2_row["shapes"][-1]["where"] = where
    del models

    # train_dsc on the trainable presets: a few steps each, K2 17 a step
    work = os.path.join(ROOT, "build", "chip_smoke_dsc_fusion")
    shutil.rmtree(work, ignore_errors=True)
    train_dir = os.path.join(work, "kitti_train")
    write_kitti(train_dir, frames, rng, *kitti_hw)
    base = dataclasses.replace(
        TrainConfig.from_json(os.path.join(ROOT, "examples", "dsc_0031bpp.json")),
        tot_epoch=epochs, print_freq=1, tensorboard=False, train_dir=train_dir, test_dir="",
        save_root=work)
    steps_seen = []
    real_make_step = train_cli.make_dsc_train_step

    def timed_make_step(*args, **kw):
        step_fn = real_make_step(*args, **kw)

        def timed_step(state, im1, im2, generator):
            before = counts()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            metrics = step_fn(state, im1, im2, generator)
            torch.cuda.synchronize()
            steps_seen.append((1e3 * (time.perf_counter() - t0), float(metrics["loss"]),
                               {k: v - before[k] for k, v in counts().items()},
                               list(im1.shape)))
            return metrics

        return timed_step

    training = {}
    per_run = epochs * (2 * frames // base.batch_size)
    train_cli.make_dsc_train_step = timed_make_step
    try:
        for preset in FUSION_TRAINABLE:
            cfg_t = dataclasses.replace(base, model=f"dsc:{preset}")
            path = os.path.join(work, f"{preset}.json")
            with open(path, "w") as f:
                f.write(cfg_t.to_json())
            steps_seen.clear()
            state = train_cli.main(["--config", path, "-n", preset])
            check(state.step == per_run == len(steps_seen),
                  f"{preset}: train_dsc ran {len(steps_seen)} steps, expected {per_run}")
            check(all(s[2] == {"conv_gdn": 17, "gdn": 0, "quantize_pack": 0}
                      for s in steps_seen),
                  f"{preset}: launches a step {[s[2] for s in steps_seen]}, expected K2 17")
            check(all(np.isfinite(s[1]) for s in steps_seen), f"{preset}: a loss is not finite")
            for k in launches:
                launches[k] += sum(s[2][k] for s in steps_seen)
            training[preset] = {"steps": len(steps_seen), "batch": steps_seen[0][3],
                                "loss": state.model.config.loss,
                                "losses": [s[1] for s in steps_seen],
                                "step_ms": [s[0] for s in steps_seen]}
            del state
    finally:
        train_cli.make_dsc_train_step = real_make_step

    seconds = time.perf_counter() - t_phase
    emit({"phase": "dsc_fusion", "ok": True, "presets": list(FUSION_PRESETS), "n": 128,
          "shape": [h, w, 3], "launches": launches, "serving": serving, "training": training,
          "k2_fusion": k2_row, "k3_codes": k3_rows, "seconds": seconds})
    print(f"dsc_fusion phase seconds: {seconds:.1f}", flush=True)
    return {"launches": launches, "k2": k2_row, "k3": k3_rows}


def aux_phase(torch, dev, tools, kitti_dir: str, steps: int = AUX_STEPS,
              triplets: int = AUX_TRIPLETS, kitti_hw=(KITTI_H, KITTI_W),
              c512_batch: int = C512_BATCH) -> dict:
    """The six auxiliary trainers and K1 at C = 512 on the card (see the
    module docstring). ``kitti_dir``: the KITTI-layout root that the
    ``dsc_train`` phase wrote. ``tools`` holds the harness of ``main``: check, emit,
    measure_k1, new_row. Returns the K1 row and the launches of the path."""
    from iclr_17_compression_tpu_torch.data.datasets import write_png
    from iclr_17_compression_tpu_torch.models.dsc import DSC_PRESETS, DSCStereoModel
    from iclr_17_compression_tpu_torch.models.extra import AnalysisSmall, SynthesisSmall
    from iclr_17_compression_tpu_torch.nn.layers import GDN
    from iclr_17_compression_tpu_torch.ops.gdn import gdn_plain
    from iclr_17_compression_tpu_torch.ops.kernels import conv_gdn_kernel as k2
    from iclr_17_compression_tpu_torch.ops.kernels import gdn_kernel as k1
    from iclr_17_compression_tpu_torch.ops.kernels import quant_pack_kernel as k3
    from iclr_17_compression_tpu_torch.train import checkpoint as ckpt
    from iclr_17_compression_tpu_torch.train import cli as train_cli
    from iclr_17_compression_tpu_torch.train import trainers
    from iclr_17_compression_tpu_torch.train.config import TrainConfig
    from iclr_17_compression_tpu_torch.train.weights import dsc_params_to_jax, msgpack_dumps

    check, emit = tools.check, tools.emit
    t_phase = time.perf_counter()
    work = os.path.join(ROOT, "build", "chip_smoke_aux")
    shutil.rmtree(work, ignore_errors=True)
    rng = np.random.default_rng(AUX_SEED)
    # the enhancement triplets: a KITTI-size original, its reconstruction
    # (the original blurred and noised) and the warped side information
    fif_dir = os.path.join(work, "fif")
    for sub in ("reconstructed", "original", "SI_warped"):
        os.makedirs(os.path.join(fif_dir, sub))
    for i in range(triplets):
        orig = smooth_image(rng, -(-kitti_hw[0] // 64) * 64, -(-kitti_hw[1] // 64) * 64)[
            :kitti_hw[0], :kitti_hw[1]]
        rec = np.clip(0.5 * (orig + np.roll(orig, 1, axis=1))
                      + 0.02 * rng.standard_normal(orig.shape), 0, 1)
        for sub, img in (("original", orig), ("reconstructed", rec),
                         ("SI_warped", shift_pair(orig, rng))):
            write_png(os.path.join(fif_dir, sub, f"{i:06d}.png"), to_u8(img))
    # a frozen temp_1bpp for att_block, as the JAX-layout params file a JAX
    # run would hand over: seeded init with every GDN off the identity
    gen = torch.Generator().manual_seed(AUX_SEED)
    base_1bpp = gdn_off_identity_(torch, DSCStereoModel(DSC_PRESETS["temp_1bpp"]).init_(gen),
                                  gen)
    base_path = os.path.join(work, "temp_1bpp_params.msgpack")
    with open(base_path, "wb") as f:
        f.write(msgpack_dumps(dsc_params_to_jax(base_1bpp.state_dict(), base_1bpp.config)))
    pretrain = {"two_steps": CKPT, "decoder_only": CKPT, "att_block": base_path}

    def counts():
        return {"conv_gdn": k2.conv_gdn.launches, "gdn": k1.gdn_fused.launches,
                "quantize_pack": k3.quantize_pack.launches}

    def reset():
        k2.conv_gdn.launches = k1.gdn_fused.launches = k3.quantize_pack.launches = 0

    # each trainer's step, timed (host clock around work that ends in a
    # synchronize) with its launches; its frozen model, copied when loaded
    seen, frozen = [], {}
    real_update, real_load_frozen = trainers._update, trainers._load_frozen

    def counted_update(state, loss):
        real_update(state, loss)
        torch.cuda.synchronize()
        seen[-1]["t1"] = time.perf_counter()
        seen[-1]["loss"] = float(loss.detach())
        seen[-1]["launches"] = counts()
        reset()

    def traced_load_frozen(model, path):
        model = real_load_frozen(model, path)
        frozen["model"] = model
        frozen["before"] = {k: v.detach().clone() for k, v in model.state_dict().items()}
        return model

    makers = {}
    for name in AUX_TRAINERS:
        real_make = getattr(trainers, f"make_{name}_step")

        def make(*args, _real=real_make, **kw):
            step_fn = _real(*args, **kw)

            def timed_step(state, batch, generator):
                torch.cuda.synchronize()
                reset()
                # the run's first batch kept (``seen`` is cleared for each run)
                seen.append({"t0": time.perf_counter(), "step": state.step,
                             "batch": None if seen else tuple(np.asarray(b).copy()
                                                              for b in batch)})
                return step_fn(state, batch, generator)

            return timed_step

        makers[name] = real_make
        setattr(trainers, f"make_{name}_step", make)
    trainers._update, trainers._load_frozen = counted_update, traced_load_frozen
    runs = {}
    try:
        for name in AUX_TRAINERS:
            cfg = TrainConfig(model=name, tot_step=steps, print_freq=5, tensorboard=False,
                              save_root=work,
                              train_dir=os.path.join(fif_dir, "reconstructed")
                              if name == "fif_enhance" else kitti_dir)
            check((cfg.batch_size, cfg.image_size, cfg.lr_base, cfg.dataset)
                  == (4, 256, 1e-4, "kitti"), f"TrainConfig defaults changed: {cfg}")
            path = os.path.join(work, f"{name}.json")
            with open(path, "w") as f:
                f.write(cfg.to_json())
            frozen.clear()
            del seen[:]
            torch.cuda.reset_peak_memory_stats()
            t0 = time.perf_counter()
            argv = ["--config", path, "-n", name]
            if name in pretrain:
                argv += ["-p", pretrain[name]]
            state = train_cli.main(argv)
            runs[name] = {"state": state, "seconds": time.perf_counter() - t0,
                          "peak_bytes": torch.cuda.max_memory_allocated(),
                          "steps": list(seen), "frozen": dict(frozen)}
    finally:
        for name, real_make in makers.items():
            setattr(trainers, f"make_{name}_step", real_make)
        trainers._update, trainers._load_frozen = real_update, real_load_frozen

    launches = dict.fromkeys(counts(), 0)
    training = {}
    for name in AUX_TRAINERS:
        run = runs[name]
        got = run["steps"]
        check(len(got) == steps == run["state"].step, f"{name}: ran {len(got)} steps")
        want = dict(zip(("conv_gdn", "gdn", "quantize_pack"), AUX_LAUNCHES[name]))
        check(all(s["launches"] == want for s in got),
              f"{name}: launches a step {[s['launches'] for s in got]}, expected {want}")
        losses = [s["loss"] for s in got]
        check(all(np.isfinite(losses)), f"{name}: a loss is not finite")
        check(np.mean(losses[-5:]) < np.mean(losses[:5]),
              f"{name}: the last 5 steps' mean loss {np.mean(losses[-5:]):.5f} is not below "
              f"the first 5's {np.mean(losses[:5]):.5f}")
        for k in launches:
            launches[k] += sum(s["launches"][k] for s in got)
        if run["frozen"]:
            fm = run["frozen"]["model"]
            check(not fm.training and not any(p.requires_grad for p in fm.parameters())
                  and all(torch.equal(v.cpu(), run["frozen"]["before"][k])
                          for k, v in fm.state_dict().items()),
                  f"{name}: the frozen model moved or is not frozen")
        # its best_train.ckpt into a fresh model, through _load_frozen and
        # load_params_partial
        best = os.path.join(work, name, "best_train.ckpt")
        blob = torch.load(best, map_location="cpu", weights_only=True)["model"]
        model = run["state"].model
        fresh = [trainers._load_frozen(_fresh_like(torch, model), best),
                 ckpt.load_params_partial(_fresh_like(torch, model), best)]
        check(all(torch.equal(m.state_dict()[k].cpu(), v) for m in fresh
                  for k, v in blob.items()), f"{name}: best_train.ckpt does not load back")
        step_ms = [1e3 * (s["t1"] - s["t0"]) for s in got]
        training[name] = {"steps": len(got), "batch": [list(b.shape) for b in got[0]["batch"]],
                          "losses": losses, "step_ms": step_ms,
                          "median_step_ms": statistics.median(step_ms[2:]),
                          "peak_gib": run["peak_bytes"] / 2 ** 30,
                          "launches_per_step": got[0]["launches"],
                          "seconds": run["seconds"]}

    # decoder_only: gradients through K1's Function against the plain path
    # on the card, the trained decoder on its first batch
    dec = runs["decoder_only"]["state"].model
    enc = runs["decoder_only"]["frozen"]["model"].Encoder
    im1, im2 = (torch.from_numpy(b).to(dev) for b in runs["decoder_only"]["steps"][0]["batch"])
    with torch.no_grad():
        z1, z2 = enc(im1), enc(im2)
        noise = torch.rand(z1.shape, generator=torch.Generator(device=dev).manual_seed(5),
                           device=dev) - 0.5

    def plain_dec(z):
        z = gdn_plain(dec.deconv1(z), dec.igdn1.params(), inverse=True)
        z = gdn_plain(dec.deconv2(z), dec.igdn2.params(), inverse=True)
        return dec.deconv3(z)

    def dec_grads(fwd):
        dec.zero_grad(set_to_none=True)
        loss = (torch.mean((torch.clamp(fwd(z1 + noise), 0, 1) - im1) ** 2)
                + torch.mean((torch.clamp(fwd(z2 + noise), 0, 1) - im2) ** 2))
        loss.backward()
        return {k: p.grad.clone() for k, p in dec.named_parameters()}

    reset()
    g_kernel = dec_grads(dec)
    check(counts()["gdn"] == 4, f"decoder_only parity: K1 launched {counts()['gdn']} times")
    g_plain = dec_grads(plain_dec)
    grad_gap = max(float((g_kernel[k] - g_plain[k]).abs().max()
                         / g_plain[k].abs().max().clamp(min=1e-30)) for k in g_plain)
    check(grad_gap <= GRAD_TOL, f"decoder_only: gradients through K1 vs plain {grad_gap:.2e}")
    # K1 at C = 128 at decoder_only's two IGDN shapes: the trained decoder's
    # inputs on its first batch
    dec_inputs = []
    hooks = [m.register_forward_pre_hook(lambda mod, args: dec_inputs.append((mod, args[0])))
             for m in (dec.igdn1, dec.igdn2)]
    with torch.no_grad():
        dec(z1 + noise)
    for hk in hooks:
        hk.remove()
    k1_dec = tools.new_row(library=False)
    with torch.no_grad():
        for mod, xin in dec_inputs:
            where = f"decoder_only {'igdn1' if mod is dec.igdn1 else 'igdn2'}"
            tools.measure_k1(xin.contiguous(), mod, k1_dec, f"K1 C=128 {where}")
            k1_dec["shapes"][-1]["where"] = where

    # K1 at C = 512: AnalysisSmall's GDNs and SynthesisSmall's IGDNs at
    # their shapes (batch c512_batch of 16×16), the models' own inputs;
    # then one AnalysisSmall → SynthesisSmall forward on the card (counted:
    # K1 6) against the same forward on the CPU
    gen = torch.Generator().manual_seed(AUX_SEED + 1)
    ana = gdn_off_identity_(torch, AnalysisSmall().init_(gen), gen)
    syn = gdn_off_identity_(torch, SynthesisSmall().init_(gen), gen)
    ana_cpu, syn_cpu = AnalysisSmall(), SynthesisSmall()
    ana_cpu.load_state_dict(ana.state_dict())
    syn_cpu.load_state_dict(syn.state_dict())
    ana, syn = ana.to(dev).eval(), syn.to(dev).eval()
    x = torch.randn((c512_batch, 16, 16, 1024), generator=gen)
    gdn_inputs = []
    hooks = [m.register_forward_pre_hook(lambda mod, args: gdn_inputs.append((mod, args[0])))
             for m in list(ana.modules()) + list(syn.modules()) if isinstance(m, GDN)]
    with torch.no_grad():
        reset()
        lat = syn(ana(x.to(dev)))
        torch.cuda.synchronize()
        c512_launches = counts()
        for hk in hooks:
            hk.remove()
        lat_cpu = syn_cpu(ana_cpu(x))
    check(c512_launches == {"conv_gdn": 0, "gdn": 6, "quantize_pack": 0},
          f"AnalysisSmall → SynthesisSmall launches {c512_launches}, expected K1 6")
    for k in launches:
        launches[k] += c512_launches[k]
    fwd_err = float((lat.cpu() - lat_cpu).abs().max())
    fwd_scale = max(1.0, float(lat_cpu.abs().max()))
    check(bool(torch.isfinite(lat).all()) and fwd_err <= 1e-4 * fwd_scale,
          f"AnalysisSmall → SynthesisSmall on the card vs the CPU: {fwd_err:.3e} "
          f"(largest |value| {fwd_scale:.3e})")
    k1_row = tools.new_row(library=False)
    with torch.no_grad():
        for i, (mod, xin) in enumerate(gdn_inputs):
            where = f"{'SynthesisSmall igdn' if mod.inverse else 'AnalysisSmall gdn'}{i % 3 + 1}"
            tools.measure_k1(xin.contiguous(), mod, k1_row, f"K1 C=512 {where}")
            k1_row["shapes"][-1]["where"] = where

    seconds = time.perf_counter() - t_phase
    emit({"phase": "aux", "ok": True, "trainers": list(AUX_TRAINERS), "steps": steps,
          "launches": launches, "training": training, "decoder_only_grad_gap": grad_gap,
          "c512_forward": {"max_abs_err_vs_cpu": fwd_err, "largest": fwd_scale,
                           "launches": c512_launches},
          "k1_c512": k1_row, "k1_decoder_only": k1_dec, "seconds": seconds})
    print(f"aux phase seconds: {seconds:.1f}", flush=True)
    return {"launches": launches, "k1": k1_row, "k1_decoder_only": k1_dec}


def eval_phase(torch, dev, tools) -> dict:
    """The evaluation and analysis tools on the card with the archived
    weights (see the module docstring). ``tools`` holds the harness of
    ``main``: check, emit. Returns the launches of the path."""
    from iclr_17_compression_tpu_torch.coding import codec_cli
    from iclr_17_compression_tpu_torch.data.datasets import _read_png, write_png
    from iclr_17_compression_tpu_torch.eval import ablation, mix, similarity
    from iclr_17_compression_tpu_torch.eval.kodak import eval_kodak
    from iclr_17_compression_tpu_torch.models import NLBlock
    from iclr_17_compression_tpu_torch.models.dsc import DSCStereoModel
    from iclr_17_compression_tpu_torch.nn.layers import torch_default_init_
    from iclr_17_compression_tpu_torch.ops.kernels import conv_gdn_kernel as k2
    from iclr_17_compression_tpu_torch.ops.kernels import gdn_kernel as k1
    from iclr_17_compression_tpu_torch.ops.kernels import quant_pack_kernel as k3
    from iclr_17_compression_tpu_torch.train.weights import load_balle17, load_dsc
    from iclr_17_compression_tpu_torch.utils import dataset_tools
    from iclr_17_compression_tpu_torch.utils.device import cudnn_deterministic, image_batch

    check, emit = tools.check, tools.emit
    t_phase = time.perf_counter()
    work = os.path.join(ROOT, "build", "chip_smoke_eval")
    shutil.rmtree(work, ignore_errors=True)
    os.makedirs(work)
    rng = np.random.default_rng(EVAL_SEED)
    images = [smooth_image(rng, IMG_H, IMG_W) for _ in range(EVAL_IMAGES)]
    lefts = [smooth_image(rng, DSC_H, DSC_W) for _ in range(EVAL_PAIRS)]
    pairs = [(a, shift_pair(a, rng)) for a in lefts]
    keys = ("conv_gdn", "gdn", "quantize_pack")
    launches = dict.fromkeys(keys, 0)
    by_step = {}

    def counted(step, want, fn, *args, **kw):
        """``fn(*args, **kw)`` with the counters reset before and read after,
        added to the path's launches; ``want``: the (K2, K1, K3) launches."""
        torch.cuda.synchronize()
        k2.conv_gdn.launches = k1.gdn_fused.launches = k3.quantize_pack.launches = 0
        out = fn(*args, **kw)
        torch.cuda.synchronize()
        got = (k2.conv_gdn.launches, k1.gdn_fused.launches, k3.quantize_pack.launches)
        check(got == tuple(want), f"eval {step}: launches {got}, expected {tuple(want)}")
        by_step[step] = dict(zip(keys, got))
        for k, v in zip(keys, got):
            launches[k] += v
        return out

    def times(n, unit):
        return tuple(n * u for u in unit)

    def psnr_of(a, b):
        return 10.0 * float(np.log10(1.0 / max(float(np.mean((np.asarray(a, np.float64)
                                                              - b) ** 2)), 1e-12)))

    # ---- Ballé-17 R-D of the archived checkpoints on the card, one image
    # of each against the CPU with the card's tables
    rd = {}
    balle = {}
    for name in BALLE_CKPTS:
        path = os.path.join(ROOT, "results", "ckpts", f"{name}.ckpt")
        balle[name] = model = load_balle17(path, device=dev)
        res = counted(f"kodak {name}", times(2 * EVAL_IMAGES, BALLE_FWD), eval_kodak, model,
                      images, use_rans=True)
        cpu = eval_kodak(load_balle17(path, device="cpu"), images[:1], use_rans=True,
                         rans_bounds=res["rans_bounds"])["per_image"][0]
        card = res["per_image"][0]
        check(all(np.isfinite(r["bpp"]) and np.isfinite(r["psnr"]) for r in res["per_image"]),
              f"{name}: a bpp or PSNR is not finite")
        check(abs(res["bpp"] - res["bpp_estimated"]) <= BPP_REL_TOL * res["bpp_estimated"],
              f"{name}: rANS {res['bpp']:.5f} bpp vs estimated {res['bpp_estimated']:.5f}")
        check(abs(card["psnr"] - cpu["psnr"]) <= EVAL_PSNR_DB
              and abs(card["bpp"] - cpu["bpp"]) <= EVAL_BPP_REL * cpu["bpp"],
              f"{name}: card vs CPU PSNR {card['psnr']:.5f} / {cpu['psnr']:.5f} dB, bpp "
              f"{card['bpp']:.6f} / {cpu['bpp']:.6f}")
        rd[name] = {k: res[k] for k in ("bpp", "bpp_estimated", "psnr", "ms_ssim", "ms_ssim_db")}
        rd[name].update(latent_range=list(res["rans_bounds"]),
                        card_minus_cpu={"psnr_db": card["psnr"] - cpu["psnr"],
                                        "bpp_rel": card["bpp"] / cpu["bpp"] - 1.0})
    lam2048, lam128 = balle["lam2048_iter_19000"], balle["lam128_iter_10000"]
    dist = counted("code_distribution", times(EVAL_IMAGES, BALLE_FWD),
                   similarity.code_distribution, lam2048, images)
    check(dist["histogram"].sum() == EVAL_IMAGES * (IMG_H // 16) * (IMG_W // 16) * N_CH
          and np.isfinite(dist["per_channel_variance"]).all() and dist["gzip_factor"] > 0,
          "code_distribution: histogram, variance or gzip factor")

    # ---- mixing: A with itself averaged is A (deterministic cuDNN: the
    # decoder's transposed convs give the same bits on both calls)
    with cudnn_deterministic():
        single = counted("eval_single_image", times(EVAL_IMAGES, BALLE_FWD),
                         mix.eval_single_image, lam2048, images,
                         dump_dir=os.path.join(work, "best_worst"))
        avg = counted("average_two_models", times(2 * EVAL_IMAGES, BALLE_FWD),
                      mix.average_two_models, lam2048, lam2048, images)
    check(avg["psnr"] == single["psnr"] and avg["ms_ssim"] == single["ms_ssim"],
          f"average_two_models(A, A) {avg} differs from eval_single_image(A) {single}")
    check(len(os.listdir(os.path.join(work, "best_worst"))) == 4, "best / worst dump")
    mixed_model = copy.deepcopy(lam2048)
    mixed_model.load_state_dict(mix.mix_encoder_decoder(lam128.state_dict(),
                                                        lam2048.state_dict()))
    mixed = counted("mix_encoder_decoder", times(EVAL_IMAGES, BALLE_FWD), mix.eval_single_image,
                    mixed_model, images)
    check(np.isfinite(mixed["psnr"]) and 0.0 <= mixed["ms_ssim"] <= 1.0,
          f"mixed encoder / decoder: {mixed}")

    # ---- the diff folder, read back: clip(127 + (orig − recon)·255)
    src = os.path.join(work, "src")
    os.makedirs(src)
    for i, img in enumerate(images):
        write_png(os.path.join(src, f"{i:02d}.png"), np.rint(img * 255).astype(np.uint8))
    with cudnn_deterministic():
        written = counted("create_diff_folder", times(EVAL_IMAGES, BALLE_FWD),
                          dataset_tools.create_diff_folder, lam2048, src,
                          os.path.join(work, "diff"))
        diff_ok = True
        for i, path in enumerate(written):
            img = np.rint(images[i] * 255).astype(np.uint8).astype(np.float32) / 255.0
            with torch.no_grad():
                recon = lam2048(torch.from_numpy(img[None]).to(dev))["recon"][0].cpu().numpy()
            want = np.clip(127.0 + (img - recon) * 255.0, 0, 255).astype(np.uint8)
            with open(path, "rb") as f:
                diff_ok &= bool(np.array_equal(_read_png(f.read()), want))
    check(len(written) == EVAL_IMAGES and diff_ok, "create_diff_folder: a PNG reads back wrong")

    # ---- the flagship DSC: ablations, masked MSEs, similarity, both directions
    dsc = load_dsc(FLAGSHIP, DSC_PRESET, device=dev)
    cfg = dsc.config
    si_only = [counted(f"si_only_recon {i}", DSC_FWD, ablation.si_only_recon, dsc, b)
               for i, (_, b) in enumerate(pairs)]
    code_only = [counted(f"code_only_recon {i}", DSC_FWD, ablation.code_only_recon, dsc, a)
                 for i, (a, _) in enumerate(pairs)]
    check(dsc.config.si_mode == "use", "code_only_recon changed the caller's model")

    def diff_codec(d):
        data = codec_cli.encode_image(np.ascontiguousarray(d, np.float32), lam2048, device=dev)
        return codec_cli.decode_image(data, lam2048, device=dev)

    def dsc_recon(x, y):
        with torch.no_grad():
            return dsc(image_batch(dsc, x), image_batch(dsc, y))["recon"][0].cpu().numpy()

    two_level, base_psnr = [], []
    for i, (a, b) in enumerate(pairs):
        base = counted(f"dsc forward {i}", DSC_FWD, dsc_recon, a, b)
        final = counted(f"two_level_recon {i}", BALLE_CODEC, ablation.two_level_recon,
                        base, a, diff_codec)
        two_level.append(psnr_of(final, a))
        base_psnr.append(psnr_of(base, a))
    recons = si_only + code_only
    check(all(r.shape == lefts[0].shape and np.isfinite(r).all() and r.min() >= 0.0
              and r.max() <= 1.0 for r in recons), "an ablation's recon is not in [0, 1]")
    # the greedy search: (C + C - 1 + …) masked forwards over the pairs
    n_ch = cfg.code_channels
    n_fwd = sum(n_ch - j for j in range(EVAL_MASKS)) * EVAL_PAIRS
    chosen = counted("greedy_channel_mask_search", times(n_fwd, DSC_FWD),
                     ablation.greedy_channel_mask_search, dsc, pairs, EVAL_MASKS)
    check(len(set(chosen)) == EVAL_MASKS and all(0 <= c < n_ch for c in chosen),
          f"greedy search chose {chosen}")
    ch, cw = EVAL_CROP
    piece = [(a[:ch, :cw].copy(), b[:ch, :cw].copy()) for a, b in pairs[:1]]
    card_mses = counted("masked_mses", times(n_ch, DSC_FWD), ablation.masked_mses, dsc, piece, [])
    cpu_dsc = DSCStereoModel(cfg)
    cpu_dsc.load_state_dict({k: v.cpu() for k, v in dsc.state_dict().items()})
    cpu_mses = ablation.masked_mses(cpu_dsc.eval(), piece, [])
    mse_err = max(abs(card_mses[c] - cpu_mses[c]) / cpu_mses[c] for c in cpu_mses)
    check(mse_err <= EVAL_MSE_RTOL, f"masked MSEs card vs CPU: {mse_err:.2e} relative")

    def first_step_mse(model, ch):
        """The first greedy step's MSE on the whole first pair with ``ch``
        masked, as ``masked_mses`` computes it."""
        a, b = pairs[0]
        x, y = image_batch(model, a), image_batch(model, b)
        mask = torch.zeros(n_ch, device=x.device)
        mask[ch] = 1.0
        with torch.no_grad():
            return float(torch.mean((model(x, y, mask_channels=mask)["recon"] - x) ** 2))

    full_card = counted("masked_mse whole pair", DSC_FWD, first_step_mse, dsc, chosen[0])
    t_cpu = time.perf_counter()
    full_cpu = first_step_mse(cpu_dsc, chosen[0])
    full_pair = {"channel": chosen[0], "card": full_card, "cpu": full_cpu,
                 "rel_err": abs(full_card - full_cpu) / full_cpu,
                 "cpu_seconds": time.perf_counter() - t_cpu}
    check(full_pair["rel_err"] <= EVAL_MSE_RTOL, f"masked MSE of channel {chosen[0]} on the "
          f"whole pair, card vs CPU: {full_pair['rel_err']:.2e} relative")
    sim = counted("encoder_similarity", times(EVAL_PAIRS, DSC_FWD), similarity.encoder_similarity,
                  dsc, pairs, dump_channels_dir=os.path.join(work, "channels"))
    dists = counted("encoder_distances", times(EVAL_PAIRS, DSC_FWD),
                    similarity.encoder_distances, dsc, pairs)
    check(0.0 <= sim["normalized_hamming"] <= 1.0 and np.isfinite(dists["latent_l2"])
          and len(os.listdir(os.path.join(work, "channels"))) == cfg.n,
          f"similarity: {sim}, {dists}")
    with cudnn_deterministic():
        dumped = counted("save_both_direction_recons", times(2 * EVAL_PAIRS, DSC_FWD),
                         dataset_tools.save_both_direction_recons, dsc, pairs,
                         os.path.join(work, "both"))
        both_ok = True
        for i, (a, b) in enumerate(pairs):
            for j, (x, y) in enumerate(((a, b), (b, a))):
                r = dsc_recon(x, y)
                with open(dumped[2 * i + j], "rb") as f:
                    both_ok &= bool(np.array_equal(
                        _read_png(f.read()), (np.clip(r, 0, 1) * 255).astype(np.uint8)))
    check(len(dumped) == 2 * EVAL_PAIRS and both_ok, "save_both_direction_recons: a PNG reads "
          "back wrong")

    # ---- reference .pth files: loaded on the card, the same outputs
    x_img = torch.from_numpy(images[0][None]).to(dev)
    x_l, x_r = image_batch(dsc, pairs[0][0]), image_batch(dsc, pairs[0][1])
    pth = {}
    with cudnn_deterministic(), torch.no_grad():
        for tag, model, load, fwd in (
                ("balle17", lam2048, lambda p: load_balle17(p, device=dev),
                 lambda m: m(x_img)["recon"]),
                (DSC_PRESET, dsc, lambda p: load_dsc(p, DSC_PRESET, device=dev),
                 lambda m: m(x_l, x_r)["recon"])):
            path = os.path.join(work, f"{tag}.pth")
            torch.save({"model_state_dict": model.state_dict()}, path)
            pth[tag] = bool(torch.equal(fwd(load(path)), fwd(model)))
    check(all(pth.values()), f"reference .pth round trip: bit-equal outputs {pth}")

    # ---- NLBlock: four modes at C = 128 on the flagship's latent grid, card
    # vs CPU, w_z drawn like the other projections (at init it is zero)
    gen = torch.Generator().manual_seed(EVAL_SEED)
    grid = (DSC_H // 16, DSC_W // 16)
    x_nl = torch.randn((1, *grid, cfg.n), generator=gen) * 0.25
    nl = {}
    for mode in ("gaussian", "embedded", "dot", "concatenate"):
        block = NLBlock(cfg.n, mode=mode)
        for conv in block.children():
            torch_default_init_(conv, gen)
        with torch.no_grad():
            want = block(x_nl)
            got = counted(f"NLBlock {mode}", (0, 0, 0), lambda: block.to(dev)(x_nl.to(dev)))
        err = float((got.cpu() - want).abs().max())
        scale = float(want.abs().max())
        nl[mode] = {"max_abs_err": err, "largest": scale,
                    "moved": float((want - x_nl).abs().max())}
        check(bool(torch.isfinite(got).all()) and err <= NL_TOL * scale
              and nl[mode]["moved"] > 1e-3, f"NLBlock {mode}: card vs CPU {err:.2e} "
              f"(largest |value| {scale:.2e}), moved {nl[mode]['moved']:.2e}")

    seconds = time.perf_counter() - t_phase
    emit({"phase": "eval", "ok": True, "images": EVAL_IMAGES, "shape": [IMG_H, IMG_W, 3],
          "pairs": EVAL_PAIRS, "dsc_shape": [DSC_H, DSC_W, 3], "launches": launches,
          "launches_by_step": by_step, "balle_rd": rd,
          "code_distribution": {"gzip_factor": dist["gzip_factor"],
                                "mean_channel_variance": float(dist["per_channel_variance"]
                                                               .mean())},
          "mix": {"single": single, "average_self": avg, "mixed_lam128_lam2048": mixed},
          "dsc": {"si_only_psnr": [psnr_of(r, a) for r, (a, _) in zip(si_only, pairs)],
                  "code_only_psnr": [psnr_of(r, a) for r, (a, _) in zip(code_only, pairs)],
                  "si_assisted_psnr": base_psnr, "two_level_psnr": two_level,
                  "greedy_chosen": chosen, "masked_mse_rel_err_vs_cpu": mse_err,
                  "masked_mses_card": card_mses, "masked_mse_whole_pair": full_pair,
                  "similarity": sim, "distances": dists},
          "pth_bit_equal": pth, "nlblock": nl, "seconds": seconds})
    print(f"eval phase seconds: {seconds:.1f}", flush=True)
    return {"launches": launches}


def _fresh_like(torch, model):
    """A copy of ``model`` (its kind, widths and device) with every
    parameter moved by 1."""
    import copy

    fresh = copy.deepcopy(model)
    with torch.no_grad():
        for p in fresh.parameters():
            p.add_(1.0)
    return fresh


def main() -> int:
    t_script = time.perf_counter()
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this smoke run needs a GPU",
              file=sys.stderr)
        return 2

    from iclr_17_compression_tpu_torch.coding import codec_cli
    from iclr_17_compression_tpu_torch.ops.gdn import gdn_reparam
    from iclr_17_compression_tpu_torch.ops.kernels import _build
    from iclr_17_compression_tpu_torch.ops.kernels import conv_gdn_kernel as k2
    from iclr_17_compression_tpu_torch.ops.kernels import gdn_kernel as k1
    from iclr_17_compression_tpu_torch.ops.kernels import quant_pack_kernel as k3
    from iclr_17_compression_tpu_torch.ops.metrics import psnr
    from iclr_17_compression_tpu_torch.train.weights import load_balle17
    from iclr_17_compression_tpu_torch.utils.device import resolve_device

    dev = resolve_device("cuda")  # also turns TF32 off
    kind = torch.cuda.get_device_name(0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=10,
    ).stdout.strip()
    emit({"phase": "device", "kind": kind, "count": torch.cuda.device_count(),
          "torch": torch.__version__, "cuda": torch.version.cuda, "nvidia_smi": smi})

    t0 = time.perf_counter()
    _build.kernels()
    t_kernels = time.perf_counter() - t0
    t0 = time.perf_counter()
    _build.rans()
    t_rans = time.perf_counter() - t0
    lib = _build.kernels()
    ptxas = ptxas_report((_build.BUILD_DIR / "libiclr17c_kernels.so.log").read_text())
    dyn_smem = {"conv_gdn_kernel": lib.iclr17c_conv_gdn_smem_bytes(N_CH),
                "conv_gdn_reduce_kernel": lib.iclr17c_gdn_smem_bytes(N_CH),
                "gdn_rows_kernel": lib.iclr17c_gdn_smem_bytes(N_CH)}
    for name, nbytes in dyn_smem.items():
        ptxas.setdefault(name, {})["dynamic_smem_bytes_c128"] = nbytes
    emit({"phase": "build", "kernels_s": round(t_kernels, 3), "rans_s": round(t_rans, 3),
          "dir": str(_build.BUILD_DIR), "ptxas": ptxas})
    print(f"build seconds: nvcc kernels {t_kernels:.2f}, g++ rans {t_rans:.2f}", flush=True)
    check(t_kernels + t_rans < BUILD_LIMIT_S,
          f"build took {t_kernels + t_rans:.1f} s, over {BUILD_LIMIT_S:.0f} s")
    check(all(k in ptxas for k in KERNEL_SYMBOLS), f"ptxas report names {sorted(ptxas)}")

    def time_ms(fn, warmup: int = 3, reps: int = 20, batch: int = 10) -> float:
        """Device time of one call: CUDA events around ``batch`` calls queued
        behind a sleep kernel, so that the host's enqueue time (the Python
        wrapper) is hidden; median over ``reps`` after ``warmup`` calls. A
        call of over 10 ms (cuDNN's fp32 path at some C = 192 shapes takes
        190 ms) is timed alone, 5 times."""
        for _ in range(warmup):
            fn()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        if time.perf_counter() - t0 > 0.010:
            reps, batch = 5, 1
        times = []
        for _ in range(reps):
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            torch.cuda._sleep(20_000_000)  # ~10 ms: the host queues the batch meanwhile
            start.record()
            for _ in range(batch):
                fn()
            end.record()
            end.synchronize()
            times.append(start.elapsed_time(end) / batch)
        return statistics.median(times)

    def call_ms(fn, warmup: int = 3, reps: int = 20) -> float:
        """CUDA events around one call issued from an idle queue: the device
        time plus what the host spends in the wrapper before the launch."""
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

    def compare(out, ref, what: str, row: dict) -> None:
        """Hold a kernel's output against its plain version's; keep the
        largest absolute error and the largest relative error where
        |ref| > 0.1 in ``row``."""
        diff = (out - ref).abs()
        ok = bool(torch.all(diff <= ATOL + RTOL * ref.abs()))
        err = float(diff.max())
        big = ref.abs() > 0.1
        rel = float((diff[big] / ref.abs()[big]).max()) if bool(big.any()) else 0.0
        check(bool(torch.isfinite(out).all()), f"{what}: non-finite output")
        check(ok, f"{what}: max abs err {err:.3e} beyond rtol {RTOL} / atol {ATOL}")
        row["max_abs_err"] = max(row["max_abs_err"], err)
        row["max_rel_err"] = max(row["max_rel_err"], rel)

    def new_row(library: bool) -> dict:
        row = {"ms": 0.0, "call_ms": 0.0, "plain_ms": 0.0, "bound_ms": 0.0,
               "bound_fp32_ms": 0.0, "mma_flops": 0.0, "flops": 0.0, "bytes": 0.0,
               "max_abs_err": 0.0, "max_rel_err": 0.0, "shapes": []}
        row["library_ms"] = 0.0 if library else None
        return row

    def add_numbers(row: dict, shape: dict, mma: float, elementwise: float,
                    nbytes: float) -> None:
        """Fold one shape's measured times and computed bounds into ``row``."""
        b_ms, b_by = bound_3xtf32_ms(mma, elementwise, nbytes)
        b32_ms, _ = bound_ms(mma + elementwise, nbytes)
        shape.update(bound_ms=b_ms, bound_by=b_by, bound_fp32_ms=b32_ms,
                     gflop=(mma + elementwise) / 1e9)
        for key in ("ms", "call_ms", "plain_ms", "library_ms"):
            if row.get(key) is not None:
                row[key] += shape[key]
        for key, val in (("bound_ms", b_ms), ("bound_fp32_ms", b32_ms), ("mma_flops", mma),
                         ("flops", mma + elementwise), ("bytes", nbytes)):
            row[key] += val
        row["shapes"].append(shape)
        row["bound_by"] = bound_3xtf32_ms(row["mma_flops"], row["flops"] - row["mma_flops"],
                                          row["bytes"])[1]

    def measure_k2(args, row: dict, what: str, cudnn_k1: bool = False) -> None:
        """K2 on ``args`` (x, w, b, gamma_t, beta, stride, pad[, inverse])
        against its plain version (and the same bits on a second call), its
        device times, cuDNN ``F.conv2d`` + plain GDN and, with ``cudnn_k1``,
        cuDNN + K1."""
        x, w, b, gamma_t, beta, stride, pad = args[:7]
        inverse = bool(args[7]) if len(args) > 7 else False
        out = k2.conv_gdn(*args)
        again = k2.conv_gdn(*args)
        ref = k2.conv_gdn_plain(*args)
        torch.cuda.synchronize()
        compare(out, ref, what, row)
        check(torch.equal(out, again), f"{what}: two calls differ")
        oihw = w.permute(3, 2, 0, 1).contiguous()
        xc = x.permute(0, 3, 1, 2)

        def library():
            y = torch.nn.functional.conv2d(xc, oihw, b, stride=stride, padding=pad)
            if gamma_t is not None:
                k1.gdn_fused_plain(y.permute(0, 2, 3, 1), gamma_t, beta, inverse)

        def with_k1():
            y = torch.nn.functional.conv2d(xc, oihw, b, stride=stride, padding=pad)
            k1.gdn_fused(y.permute(0, 2, 3, 1).contiguous(), gamma_t, beta, inverse)

        _, ho, wo, cout = out.shape
        shape = {"x": list(x.shape), "w": list(w.shape), "stride": stride,
                 "gdn": gamma_t is not None,
                 "splits": k2.plan_splits(out.shape[0] * ho * wo, w.shape[0] ** 2,
                                          k2.block_slots(0, cout)),
                 "ms": time_ms(lambda: k2.conv_gdn(*args)),
                 "call_ms": call_ms(lambda: k2.conv_gdn(*args)),
                 "plain_ms": time_ms(lambda: k2.conv_gdn_plain(*args)),
                 "library_ms": time_ms(library)}
        if cudnn_k1:
            shape["cudnn_k1_ms"] = time_ms(with_k1)
        add_numbers(row, shape, *k2_work(args, out))

    def measure_k1(x, gdn, row: dict, what: str) -> None:
        """K1 (with ``gdn``'s parameters and direction) on ``x`` against its
        plain version (and the same bits on a second call), and its device
        times."""
        beta, gamma = gdn_reparam(gdn.params())
        gamma_t, beta, inv = gamma.t().contiguous(), beta.contiguous(), gdn.inverse
        out = k1.gdn_fused(x, gamma_t, beta, inv)
        again = k1.gdn_fused(x, gamma_t, beta, inv)
        ref = k1.gdn_fused_plain(x, gamma_t, beta, inv)
        torch.cuda.synchronize()
        compare(out, ref, what, row)
        check(torch.equal(out, again), f"{what}: two calls differ")
        shape = {"x": list(x.shape), "inverse": inv,
                 "ms": time_ms(lambda: k1.gdn_fused(x, gamma_t, beta, inv)),
                 "call_ms": call_ms(lambda: k1.gdn_fused(x, gamma_t, beta, inv)),
                 "plain_ms": time_ms(lambda: k1.gdn_fused_plain(x, gamma_t, beta, inv))}
        add_numbers(row, shape, *k1_work(x))

    model = load_balle17(CKPT, device="cuda")
    gen = torch.Generator(device="cpu").manual_seed(0)
    rows = {}

    with torch.no_grad():
        # ---- K2: the three encoder stages at the main path's shapes
        enc = model.Encoder
        image = torch.rand((1, IMG_H, IMG_W, 3), generator=gen).to(dev)
        stages = []
        x = image
        for conv, gdn, stride in ((enc.conv1, enc.gdn1, 4), (enc.conv2, enc.gdn2, 2),
                                  (enc.conv3, None, 2)):
            w = conv.weight.permute(2, 3, 1, 0).contiguous()
            if gdn is not None:
                beta, gamma = gdn_reparam(gdn.params())
                gamma_t, beta = gamma.t().contiguous(), beta.contiguous()
            else:
                gamma_t = beta = None
            args = (x, w, conv.bias, gamma_t, beta, stride, stride)
            stages.append(args)
            x = k2.conv_gdn_plain(*args)
        k2_row = new_row(library=True)
        for i, args in enumerate(stages):
            measure_k2(args, k2_row, f"K2 stage {i + 1}")
        # off the main path: Cout = 192 (the hyperprior / joint-AR width,
        # ROADMAP item 16; one block an SM),
        # without a split (288 tiles of 64 pixels: the conv kernel's own bias
        # and streamed-GDN epilogue) and with one (96 tiles: the reduction)
        slots192 = k2.block_slots(0, 192)
        off_path = []
        for h, wd in ((256, 288), (128, 192)):
            splits = k2.plan_splits((h // 2) * (wd // 2), 25, slots192)
            check((splits == 1) == (h == 256),
                  f"K2 Cout=192 {h}x{wd}: {splits} splits on {slots192} slots")
            off_path.append(f"Cout=192 {h}x{wd} splits={splits}")
            xs = (torch.randn((1, h, wd, N_CH), generator=gen) * 0.5).to(dev)
            ws = (torch.randn((5, 5, N_CH, 192), generator=gen) / 80).to(dev)
            bs = (torch.randn(192, generator=gen) * 0.01).to(dev)
            gs = (torch.rand((192, 192), generator=gen) * 0.02).to(dev)
            betas = (torch.rand(192, generator=gen) + 0.5).to(dev)
            for inverse in (False, True):
                args = (xs, ws, bs, gs, betas, 2, 2, inverse)
                out = k2.conv_gdn(*args)
                ref = k2.conv_gdn_plain(*args)
                torch.cuda.synchronize()
                compare(out, ref, f"K2 Cout=192 {h}x{wd} inverse={inverse}", k2_row)
        k2_row["checked_off_path"] = off_path
        rows["conv_gdn"] = k2_row
        emit({"phase": "k2_conv_gdn", "ok": True, "counter": k2.conv_gdn.launches, **k2_row})

        # ---- K1: the two decoder IGDNs (64×96 and 128×192 pixels)
        k1_row = new_row(library=False)
        for igdn, (h, wd) in ((model.Decoder.igdn1, (IMG_H // 8, IMG_W // 8)),
                              (model.Decoder.igdn2, (IMG_H // 4, IMG_W // 4))):
            x = torch.randn((1, h, wd, N_CH), generator=gen).to(dev)
            measure_k1(x, igdn, k1_row, f"K1 {h}x{wd}")
        # off the main path: the hyperprior / joint-AR width (ROADMAP item 16)
        # C = 192 and the contract's largest C = 256
        for c in (192, 256):
            x = torch.randn((1, 64, 96, c), generator=gen).to(dev)
            gamma_t = (torch.rand((c, c), generator=gen) * 0.05).to(dev)
            beta = (torch.rand(c, generator=gen) + 0.5).to(dev)
            for inverse in (False, True):
                out = k1.gdn_fused(x, gamma_t, beta, inverse)
                again = k1.gdn_fused(x, gamma_t, beta, inverse)
                ref = k1.gdn_fused_plain(x, gamma_t, beta, inverse)
                torch.cuda.synchronize()
                compare(out, ref, f"K1 C={c} inverse={inverse}", k1_row)
                check(torch.equal(out, again), f"K1 C={c}: two calls differ")
        k1_row["checked_off_path"] = ["C=192 64x96", "C=256 64x96"]
        rows["gdn"] = k1_row
        emit({"phase": "k1_gdn", "ok": True, "counter": k1.gdn_fused.launches, **k1_row})

        # ---- K3: the latent (1, 32, 48, 128) at step 1, lim 127, with exact
        # ±0.5 ties and out-of-range values mixed in
        lat = (torch.randn((1, IMG_H // 16, IMG_W // 16, N_CH), generator=gen) * 40).to(dev)
        ties = torch.arange(-130, 130, dtype=torch.float32, device=dev) + 0.5
        lat.view(-1)[: ties.numel()] = ties
        sym, deq = k3.quantize_pack(lat, 1.0, 127.0)
        rsym, rdeq = k3.quantize_pack_plain(lat, 1.0, 127.0)
        torch.cuda.synchronize()
        check(torch.equal(sym, rsym) and torch.equal(deq, rdeq), "K3: not bit-exact")
        sym16, deq16 = k3.quantize_pack(lat * 8, 16.0, 128.0)
        rsym16, rdeq16 = k3.quantize_pack_plain(lat * 8, 16.0, 128.0)
        check(torch.equal(sym16, rsym16) and torch.equal(deq16, rdeq16),
              "K3 step 16: not bit-exact")
        # the 16-bit store the file codec runs (step 1, lim 32767): ties and
        # values beyond the limit at both ends
        wide = lat * 300.0
        edge = torch.arange(-32800, -32700, dtype=torch.float32, device=dev) + 0.5
        vals = torch.cat([edge, -edge, ties])
        wide.view(-1)[: vals.numel()] = vals
        wsym, wdeq = k3.quantize_pack(wide, 1.0, 32767.0, bits=16)
        rwsym, rwdeq = k3.quantize_pack_plain(wide, 1.0, 32767.0, bits=16)
        torch.cuda.synchronize()
        check(wsym.dtype == torch.uint16 and torch.equal(wsym, rwsym)
              and torch.equal(wdeq, rwdeq), "K3 16-bit symbols: not bit-exact")
        wsym32 = wsym.to(torch.int32)  # CUDA has no min/max of uint16
        check(int(wsym32.min()) == 0 and int(wsym32.max()) == 2 * 32767,
              "K3 16-bit symbols: the clamp at ±32767 was not exercised")
        n = lat.numel()
        b_ms, b_by = bound_ms(5.0 * n, 10.0 * n)
        b8_ms, _ = bound_ms(5.0 * n, 9.0 * n)
        # the floor under any kernel's time: an empty kernel's launch, timed
        # in the same harness
        stream = torch.cuda.current_stream().cuda_stream
        floor_ms = time_ms(lambda: lib.iclr17c_empty(stream))
        # ms / plain_ms: the 16-bit variant the file codec launches; the
        # byte variant (the Pallas kernel's contract) beside it
        rows["quantize_pack"] = {
            "ms": time_ms(lambda: k3.quantize_pack(wide, 1.0, 32767.0, bits=16)),
            "call_ms": call_ms(lambda: k3.quantize_pack(wide, 1.0, 32767.0, bits=16)),
            "plain_ms": time_ms(lambda: k3.quantize_pack_plain(wide, 1.0, 32767.0, bits=16)),
            "ms_8bit": time_ms(lambda: k3.quantize_pack(lat, 1.0, 127.0)),
            "plain_ms_8bit": time_ms(lambda: k3.quantize_pack_plain(lat, 1.0, 127.0)),
            "library_ms": None, "bound_ms": b_ms, "bound_by": b_by, "bound_fp32_ms": b_ms,
            "bound_ms_8bit": b8_ms, "launch_floor_ms": floor_ms,
            "max_abs_err": 0.0,
            "max_rel_err": 0.0,
            "shapes": [{"x": list(lat.shape), "step": 1.0, "lim": 32767, "bits": 16},
                       {"x": list(lat.shape), "step": 1.0, "lim": 127, "bits": 8}],
        }
        emit({"phase": "k3_quantize_pack", "ok": True, "counter": k3.quantize_pack.launches,
              **rows["quantize_pack"]})

    # ---- main path: the file codec on 4 images, counters around it only
    rng = np.random.default_rng(0)
    images = [smooth_image(rng) for _ in range(N_IMAGES)]
    k1.gdn_fused.launches = k2.conv_gdn.launches = k3.quantize_pack.launches = 0
    files, recons, enc_ms, dec_ms = [], [], [], []
    for img in images:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        data = codec_cli.encode_image(img, model, device="cuda")
        t1 = time.perf_counter()
        rec = codec_cli.decode_image(data, model, device="cuda")
        torch.cuda.synchronize()
        t2 = time.perf_counter()
        files.append(data)
        recons.append(rec)
        enc_ms.append(1e3 * (t1 - t0))
        dec_ms.append(1e3 * (t2 - t1))
    launches = {"conv_gdn": k2.conv_gdn.launches, "gdn": k1.gdn_fused.launches,
                "quantize_pack": k3.quantize_pack.launches}

    per_image = []
    with torch.no_grad():
        for i, (img, data, rec) in enumerate(zip(images, files, recons)):
            x = torch.from_numpy(img[None]).to(dev)
            sym, _ = k3.quantize_pack(model.Encoder(x), 1.0, 32767.0, bits=16)
            encoded = sym[0].cpu().numpy().astype(np.int64) - 32767
            decoded, _, _ = codec_cli.read_latent(data, model)
            check(np.array_equal(decoded, encoded), f"image {i}: decoded symbols differ")
            check(rec.shape == img.shape and np.isfinite(rec).all()
                  and rec.min() >= 0.0 and rec.max() <= 1.0,
                  f"image {i}: recon not finite in [0, 1] of shape {img.shape}")
            est = float(model(x)["bpp"])
            bpp = 8.0 * len(data) / (IMG_H * IMG_W)
            check(abs(bpp - est) <= BPP_REL_TOL * est,
                  f"image {i}: rANS {bpp:.4f} bpp vs estimated {est:.4f}")
            per_image.append({"bpp_rans": bpp, "bpp_est": est,
                              "psnr_db": float(psnr(torch.from_numpy(rec), torch.from_numpy(img))),
                              "encode_ms": enc_ms[i], "decode_ms": dec_ms[i]})
    check(launches == {"conv_gdn": 3 * N_IMAGES, "gdn": 2 * N_IMAGES,
                       "quantize_pack": N_IMAGES},
          f"launch counts {launches}, expected 3/2/1 per image of K2/K1/K3")

    # reference on one crop: the CPU plain path decodes the same file to the
    # same image, and encodes to the same latent up to rounding flips
    crop = np.ascontiguousarray(images[0][:128, :192])
    data = codec_cli.encode_image(crop, model, device="cuda")
    rec_gpu = codec_cli.decode_image(data, model, device="cuda")
    cpu_model = load_balle17(CKPT, device="cpu")
    rec_cpu = codec_cli.decode_image(data, cpu_model, device="cpu")
    dec_err = float(np.abs(rec_gpu - rec_cpu).max())
    check(dec_err <= DECODE_ATOL, f"GPU vs CPU decode of one file: {dec_err:.3e}")
    lat_gpu, _, _ = codec_cli.read_latent(data, model)
    lat_cpu, _, _ = codec_cli.read_latent(codec_cli.encode_image(crop, cpu_model, "cpu"),
                                          cpu_model)
    flips = np.abs(lat_gpu - lat_cpu)
    check(flips.max() <= 1 and (flips > 0).mean() <= LATENT_FLIP_FRAC,
          f"GPU vs CPU latent: {(flips > 0).mean():.2e} of elements differ, max {flips.max()}")
    emit({"phase": "main", "ok": True, "images": N_IMAGES, "shape": [IMG_H, IMG_W, 3],
          "n": N_CH, "launches": launches, "per_image": per_image,
          "cpu_reference": {"decode_max_abs_err": dec_err,
                            "latent_flip_frac": float((flips > 0).mean())}})

    # where one image's time goes: the device kernels of one encode + decode
    # under the profiler (device busy vs wall), and the host coder stages
    from torch.profiler import ProfilerActivity, profile

    from iclr_17_compression_tpu_torch.coding import api

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        data = codec_cli.encode_image(images[0], model, device="cuda")
        codec_cli.decode_image(data, model, device="cuda")
        torch.cuda.synchronize()
        wall_ms = 1e3 * (time.perf_counter() - t0)
    by_kernel = {}
    for evt in prof.events():
        if evt.device_type == torch.autograd.DeviceType.CUDA:
            name = evt.name.split("(")[0][:60]
            by_kernel[name] = by_kernel.get(name, 0.0) + evt.time_range.elapsed_us() / 1e3
    busy_ms = sum(by_kernel.values())
    lat, _, _ = codec_cli.read_latent(data, model)
    t0 = time.perf_counter()
    codec = api.build_cdf_tables_from_bit_estimator(model.bitEstimator.params(),
                                                    int(lat.min()), int(lat.max()))
    t1 = time.perf_counter()
    stream = api.encode_latent(codec, lat)
    t2 = time.perf_counter()
    api.decode_latent(codec, stream, lat.shape)
    t3 = time.perf_counter()
    emit({"phase": "profile", "wall_ms": wall_ms,
          "device_busy_ms": busy_ms if by_kernel else None,
          "device_idle_share": 1.0 - busy_ms / wall_ms if by_kernel else None,
          "device_ms_by_kernel": dict(sorted(by_kernel.items(), key=lambda kv: -kv[1])[:12]),
          "host_ms": {"cdf_tables": 1e3 * (t1 - t0), "rans_encode": 1e3 * (t2 - t1),
                      "rans_decode": 1e3 * (t3 - t2)}})

    # ---- train: the Ballé-17 training path at full width
    from torch.profiler import ProfilerActivity, profile

    from iclr_17_compression_tpu_torch.data.datasets import (
        ImageFolderDataset, batch_iterator, write_ppm)
    from iclr_17_compression_tpu_torch.models.balle17 import Balle17Compressor
    from iclr_17_compression_tpu_torch.ops.conv import conv2d
    from iclr_17_compression_tpu_torch.ops.entropy import estimate_bits
    from iclr_17_compression_tpu_torch.ops.gdn import gdn_plain
    from iclr_17_compression_tpu_torch.ops.quant import add_uniform_noise
    from iclr_17_compression_tpu_torch.train import cli as train_cli
    from iclr_17_compression_tpu_torch.train.checkpoint import latest_checkpoint, load_train_state
    from iclr_17_compression_tpu_torch.train.config import TrainConfig
    from iclr_17_compression_tpu_torch.train.state import apply_gradients, create_train_state

    work = os.path.join(ROOT, "build", "chip_smoke_train")
    shutil.rmtree(work, ignore_errors=True)
    train_dir, test_dir = os.path.join(work, "train"), os.path.join(work, "test")
    os.makedirs(train_dir)
    os.makedirs(test_dir)
    rng = np.random.default_rng(1)
    for i in range(N_TRAIN_IMAGES):
        write_ppm(os.path.join(train_dir, f"{i:02d}.ppm"), smooth_image(rng, TRAIN_IMG, TRAIN_IMG))
    test_images = [smooth_image(rng) for _ in range(2)]
    for i, img in enumerate(test_images):
        write_ppm(os.path.join(test_dir, f"{i}.ppm"), img)
    cfg = dataclasses.replace(
        TrainConfig.from_json(os.path.join(ROOT, "examples", "balle17.json")),
        tot_step=TRAIN_STEPS, save_model_freq=TRAIN_STEPS, print_freq=10, cal_step=1,
        tensorboard=False, train_dir=train_dir, test_dir=test_dir, save_root=work)
    check((cfg.out_channel_n, cfg.batch_size, cfg.image_size, cfg.train_lambda,
           cfg.lr_base, cfg.grad_clip) == (N_CH, 4, 256, 8192, 1e-4, 5.0),
          "examples/balle17.json is not the N=128, batch 4, 256 px, λ 8192 config")
    run_dir = os.path.join(work, "run1")
    cfg_path, resume_cfg_path = (os.path.join(work, f) for f in ("train.json", "resume.json"))
    with open(cfg_path, "w") as f:
        f.write(cfg.to_json())
    with open(resume_cfg_path, "w") as f:
        f.write(dataclasses.replace(cfg, tot_step=RESUME_STEPS).to_json())

    # the loop's own step, timed (host clock around work that ends in a
    # synchronize), its first batch kept, a profiler over one window; the
    # eval's kernel launches counted apart
    steps, first_batch, box = [], {}, {}
    eval_launches, eval_results = {"conv_gdn": 0, "gdn": 0}, []
    real_make_step, real_eval = train_cli.make_balle17_train_step, train_cli.eval_kodak

    def timed_make_step(*args, **kw):
        step_fn = real_make_step(*args, **kw)

        def timed_step(state, x, generator):
            first_batch.setdefault("step", state.step)
            first_batch.setdefault("x", x.detach().clone())
            if state.step == box.get("profile_start"):
                box["prof"] = profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA])
                box["prof"].__enter__()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            metrics = step_fn(state, x, generator)
            torch.cuda.synchronize()
            t1 = time.perf_counter()
            steps.append((state.step, t0, t1, float(metrics["rd_loss"])))
            if "prof" in box and state.step == box["profile_start"] + PROFILE_STEPS:
                box["prof"].__exit__(None, None, None)
                box["window_ms"] = 1e3 * (t1 - steps[-PROFILE_STEPS][1])
            return metrics

        return timed_step

    def counted_eval(*args, **kw):
        before = (k2.conv_gdn.launches, k1.gdn_fused.launches)
        res = real_eval(*args, **kw)
        eval_launches["conv_gdn"] += k2.conv_gdn.launches - before[0]
        eval_launches["gdn"] += k1.gdn_fused.launches - before[1]
        eval_results.append(res)
        return res

    def read_launches():
        return {"conv_gdn": k2.conv_gdn.launches - eval_launches["conv_gdn"],
                "gdn": k1.gdn_fused.launches - eval_launches["gdn"],
                "quantize_pack": k3.quantize_pack.launches}

    def reset_launches():
        k1.gdn_fused.launches = k2.conv_gdn.launches = k3.quantize_pack.launches = 0
        eval_launches.update(conv_gdn=0, gdn=0)

    train_cli.make_balle17_train_step, train_cli.eval_kodak = timed_make_step, counted_eval
    try:
        # run A: steps 0-100, counters around it only
        torch.cuda.reset_peak_memory_stats()
        reset_launches()
        t0 = time.perf_counter()
        state_a = train_cli.main(["--config", cfg_path, "-n", "run1"])
        run_a_s = time.perf_counter() - t0
        launches_a = read_launches()
        peak_bytes = torch.cuda.max_memory_allocated()
        eval_launches_a = dict(eval_launches)
        steps_a, batch_a = list(steps), first_batch.pop("x")
        first_batch.clear()

        # what run A saved, read back into a fresh state, equals what it held
        fresh = create_train_state(Balle17Compressor(N_CH).to(dev), lr=cfg.lr_base)
        fresh, meta = load_train_state(fresh, os.path.join(run_dir, "latest.ckpt"))
        saved_opt = state_a.optimizer.state_dict()["state"]
        read_opt = fresh.optimizer.state_dict()["state"]
        check(fresh.step == TRAIN_STEPS == meta["step"], f"saved step {fresh.step}, {meta}")
        check(all(torch.equal(a, b) for a, b in zip(state_a.model.state_dict().values(),
                                                    fresh.model.state_dict().values())),
              "resume: parameters read back differ from the saved ones")
        check(len(saved_opt) == len(read_opt) and all(
            torch.equal(saved_opt[i][k], read_opt[i][k])
            for i in saved_opt for k in ("exp_avg", "exp_avg_sq", "step")),
            "resume: Adam moments read back differ from the saved ones")

        # run B: --resume to 120, profiling steps 105-115
        box["profile_start"] = TRAIN_STEPS + 5
        reset_launches()
        state_b = train_cli.main(["--config", resume_cfg_path, "-n", "run1",
                                  "--resume", run_dir])
        launches_b = read_launches()
        steps_b = steps[len(steps_a):]
    finally:
        train_cli.make_balle17_train_step, train_cli.eval_kodak = real_make_step, real_eval

    per_epoch = N_TRAIN_IMAGES // cfg.batch_size
    epoch, skip = divmod(TRAIN_STEPS, per_epoch)
    expected = next(batch_iterator(ImageFolderDataset(train_dir, cfg.image_size, cfg.seed),
                                   cfg.batch_size, seed=cfg.seed, epoch=epoch, skip=skip))
    check(first_batch["step"] == TRAIN_STEPS and state_b.step == RESUME_STEPS,
          f"resume ran steps {first_batch['step']}..{state_b.step}")
    check(torch.equal(first_batch["x"].cpu(), torch.from_numpy(expected)),
          "resume: the first batch is not the one the uninterrupted loop draws")
    n_a, n_b = len(steps_a), len(steps_b)
    check(n_a == TRAIN_STEPS and n_b == RESUME_STEPS - TRAIN_STEPS, f"steps run {n_a}, {n_b}")
    check(launches_a == {"conv_gdn": 3 * n_a, "gdn": 2 * n_a, "quantize_pack": 0}
          and launches_b == {"conv_gdn": 3 * n_b, "gdn": 2 * n_b, "quantize_pack": 0},
          f"training launches {launches_a}, {launches_b}: expected K2 3 and K1 2 a step")
    check(len(eval_results) == 1 and eval_launches_a == {"conv_gdn": 6, "gdn": 4},
          f"eval: {len(eval_results)} runs, launches {eval_launches_a}")
    losses = [s[3] for s in steps_a + steps_b]
    check(all(np.isfinite(losses)), "a training loss is not finite")
    first10, last10 = float(np.mean(losses[:10])), float(np.mean(losses[-10:]))
    check(last10 < first10, f"rd_loss did not fall: first 10 {first10:.2f}, last 10 {last10:.2f}")
    ev = eval_results[0]
    check(all(np.isfinite([ev[k] for k in ("bpp", "psnr", "ms_ssim", "ms_ssim_db")])),
          f"eval metrics not finite: {ev}")

    step_ms = [1e3 * (t1 - t0) for k, t0, t1, _ in steps_a if k >= 20]
    iter_ms = [1e3 * (b[1] - a[1]) for a, b in zip(steps_a, steps_a[1:]) if a[0] >= 20]
    med_step, med_iter = statistics.median(step_ms), statistics.median(iter_ms)

    # the window's device time: busy, by kernel, and by range
    prof = box["prof"]
    by_kernel, ranges = {}, {}
    top_backward, n_kernels = 0.0, 0

    for evt in prof.events():
        if evt.device_type == torch.autograd.DeviceType.CUDA:
            if getattr(evt, "is_user_annotation", False):
                continue  # a range's span on the device timeline, not a kernel
            name = evt.name.split("(")[0][:60]
            by_kernel[name] = by_kernel.get(name, 0.0) + evt.time_range.elapsed_us() / 1e3
            n_kernels += not name.startswith("Memcpy")
            continue
        if evt.name.startswith(("train_step/", "iclr17c::gdn_backward",
                                "iclr17c::conv_gdn_backward")):
            ranges[evt.name] = ranges.get(evt.name, 0.0) + evt.device_time_total / 1e3
        if evt.name.startswith("autograd::engine::evaluate_function"):
            parent = evt.cpu_parent
            while parent is not None and not parent.name.startswith("autograd::engine"):
                parent = parent.cpu_parent
            if parent is None:
                top_backward += evt.device_time_total / 1e3
    busy = sum(by_kernel.values())
    window_ms = box["window_ms"]
    recompute = ranges.get("iclr17c::conv_gdn_backward", 0.0) + ranges.get(
        "iclr17c::gdn_backward", 0.0)
    forward_kernels = sum(v for k, v in by_kernel.items() if "iclr17c::" in k)

    # the step's phases on the card, CUDA events, 20 steps after 3 (a fresh
    # model: what it computes does not depend on the weights)
    phase_state = create_train_state(
        Balle17Compressor(N_CH).init_(torch.Generator().manual_seed(cfg.seed)).to(dev),
        lr=cfg.lr_base)
    phases = []
    for i in range(23):
        ev_ = [torch.cuda.Event(enable_timing=True) for _ in range(4)]
        gen_i = train_cli.step_generator(cfg.seed, i, dev)
        ev_[0].record()
        out = phase_state.model(batch_a, train=True, generator=gen_i)
        loss = cfg.train_lambda * out["mse"] + out["bpp"]
        ev_[1].record()
        phase_state.optimizer.zero_grad(set_to_none=True)
        loss.backward()
        ev_[2].record()
        apply_gradients(phase_state)
        ev_[3].record()
        torch.cuda.synchronize()
        if i >= 3:
            phases.append([ev_[j].elapsed_time(ev_[j + 1]) for j in range(3)])
    phase_ms = {k: statistics.median(p[j] for p in phases)
                for j, k in enumerate(("forward", "backward", "optimizer"))}

    # gradient parity on the card: the kernels' Functions against the plain
    # path, same weights, same batch, same noise
    def plain_loss(m, x, generator):
        enc, dec = m.Encoder, m.Decoder
        y = gdn_plain(conv2d(x, enc.conv1.weight, enc.conv1.bias, stride=4, padding=4),
                      enc.gdn1.params())
        y = gdn_plain(conv2d(y, enc.conv2.weight, enc.conv2.bias, stride=2, padding=2),
                      enc.gdn2.params())
        latent = add_uniform_noise(conv2d(y, enc.conv3.weight, None, stride=2, padding=2),
                                   generator, 0.5)
        z = gdn_plain(dec.deconv1(latent), dec.igdn1.params(), inverse=True)
        z = gdn_plain(dec.deconv2(z), dec.igdn2.params(), inverse=True)
        recon = dec.deconv3(z)
        bits, _ = estimate_bits(latent, m.bitEstimator.params())
        mse = torch.mean((recon - x) ** 2)
        return (cfg.train_lambda * mse + bits / (x.shape[0] * x.shape[1] * x.shape[2]),
                torch.clamp(recon, 0.0, 1.0))

    def kernel_loss(m, x, generator):
        out = m(x, train=True, generator=generator)
        return cfg.train_lambda * out["mse"] + out["bpp"], out["recon"]

    def grads(m, loss_fn):
        m.zero_grad(set_to_none=True)
        loss, recon = loss_fn(m, batch_a, train_cli.step_generator(cfg.seed, 7, dev))
        loss.backward()
        return (float(loss.detach()), recon.detach(),
                {k: p.grad.clone() for k, p in m.named_parameters()})

    def grad_gap(ga, gb):
        return max(float((ga[k] - gb[k]).abs().max() / gb[k].abs().max().clamp(min=1e-30))
                   for k in gb)

    parity_model = Balle17Compressor(N_CH).init_(torch.Generator().manual_seed(cfg.seed)).to(dev)
    loss_k, _, g_kernel = grads(parity_model, kernel_loss)
    loss_p, _, g_plain = grads(parity_model, plain_loss)
    gap = grad_gap(g_kernel, g_plain)
    check(gap <= GRAD_TOL, f"gradients through the kernels vs plain: {gap:.2e} > {GRAD_TOL}")

    # TF32 on (PyTorch's defaults), a model moved to the card by hand: its
    # forward turns TF32 off, so forward and backward match the fp32 path
    torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = True
    tf32_model = Balle17Compressor(N_CH).init_(torch.Generator().manual_seed(cfg.seed)).cuda()
    loss_t, recon_t, g_tf32 = grads(tf32_model, kernel_loss)
    flags = (torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32)
    _, recon_p, g_tf32_plain = grads(tf32_model, plain_loss)
    tf32_recon_err = float((recon_t - recon_p).abs().max())
    tf32_gap = grad_gap(g_tf32, g_tf32_plain)
    check(flags == (False, False), f"TF32 flags after a CUDA forward: {flags}")
    check(tf32_recon_err <= DECODE_ATOL and tf32_gap <= GRAD_TOL,
          f"model moved by hand with TF32 on: recon {tf32_recon_err:.2e}, grads {tf32_gap:.2e}")

    # K2 and K1 at the training shapes against their plain versions
    enc, dec = state_b.model.Encoder, state_b.model.Decoder
    k2_train, k1_train = new_row(library=True), new_row(library=False)
    with torch.no_grad():
        x = batch_a
        for i, (conv, gdn, stride) in enumerate(((enc.conv1, enc.gdn1, 4),
                                                 (enc.conv2, enc.gdn2, 2),
                                                 (enc.conv3, None, 2))):
            w = conv.weight.permute(2, 3, 1, 0).contiguous()
            gamma_t = beta = None
            if gdn is not None:
                beta, gamma = gdn_reparam(gdn.params())
                gamma_t, beta = gamma.t().contiguous(), beta.contiguous()
            args = (x, w, conv.bias, gamma_t, beta, stride, stride)
            measure_k2(args, k2_train, f"K2 training stage {i + 1}")
            x = k2.conv_gdn_plain(*args)
        for igdn, hw in ((dec.igdn1, 32), (dec.igdn2, 64)):
            x = torch.randn((cfg.batch_size, hw, hw, N_CH), generator=gen).to(dev)
            measure_k1(x, igdn, k1_train, f"K1 training {cfg.batch_size}x{hw}x{hw}")

    # train → file codec: the last checkpoint codes a test image exactly
    last = latest_checkpoint(run_dir)
    check(last is not None and last.endswith(f"iter_{RESUME_STEPS}.ckpt"), f"last ckpt {last}")
    trained = load_balle17(last, device="cuda")
    data = codec_cli.encode_image(test_images[0], trained, device="cuda")
    rec = codec_cli.decode_image(data, trained, device="cuda")
    with torch.no_grad():
        xt = torch.from_numpy(test_images[0][None]).to(dev)
        sym, _ = k3.quantize_pack(trained.Encoder(xt), 1.0, 32767.0, bits=16)
    decoded, _, _ = codec_cli.read_latent(data, trained)
    check(np.array_equal(decoded, sym[0].cpu().numpy().astype(np.int64) - 32767),
          "trained checkpoint: decoded symbols differ from the encoder's")
    check(rec.shape == test_images[0].shape and np.isfinite(rec).all()
          and rec.min() >= 0.0 and rec.max() <= 1.0, "trained checkpoint: bad recon")

    train_launches = {k: launches_a[k] + launches_b[k] for k in launches_a}
    emit({"phase": "train", "ok": True, "n": N_CH, "batch": cfg.batch_size,
          "crop": cfg.image_size, "steps": [TRAIN_STEPS, RESUME_STEPS],
          "launches_per_step": {"conv_gdn": launches_a["conv_gdn"] / n_a,
                                "gdn": launches_a["gdn"] / n_a},
          "launches": train_launches, "eval_launches": eval_launches_a,
          "rd_loss_first10": first10, "rd_loss_last10": last10,
          "rd_loss_every10": losses[::10],
          "median_step_ms": med_step, "images_per_s": cfg.batch_size * 1e3 / med_step,
          "median_iteration_ms": med_iter,
          "loop_images_per_s": cfg.batch_size * 1e3 / med_iter,
          "run_a_s": run_a_s, "peak_memory_gib": peak_bytes / 2 ** 30,
          "phase_ms": phase_ms,
          "profile": {"steps": [TRAIN_STEPS + 5, TRAIN_STEPS + 5 + PROFILE_STEPS],
                      "device_idle_share": 1.0 - busy / window_ms,
                      "per_step_ms": {
                          "wall": window_ms / PROFILE_STEPS,
                          "device_busy": busy / PROFILE_STEPS,
                          "forward": ranges.get("train_step/forward", 0.0) / PROFILE_STEPS,
                          "k1_k2_forward_kernels": forward_kernels / PROFILE_STEPS,
                          "backward": top_backward / PROFILE_STEPS,
                          "k1_k2_backward_recompute": recompute / PROFILE_STEPS,
                          "cudnn_and_other_backward": (top_backward - recompute) / PROFILE_STEPS,
                          "optimizer": ranges.get("train_step/optimizer", 0.0) / PROFILE_STEPS},
                      "kernels_per_step": n_kernels / PROFILE_STEPS,
                      "window_ms_by_range": ranges,
                      "window_ms_by_kernel": dict(sorted(by_kernel.items(),
                                                         key=lambda kv: -kv[1])[:15])},
          "grad_parity": {"tol": GRAD_TOL, "max_gap": gap, "loss_kernel": loss_k,
                          "loss_plain": loss_p},
          "tf32_check": {"flags_after_forward": flags, "recon_max_abs_err": tf32_recon_err,
                         "grad_gap": tf32_gap},
          "k2_training": k2_train, "k1_training": k1_train,
          "eval": {k: ev[k] for k in ("bpp", "psnr", "ms_ssim", "ms_ssim_db")},
          "handoff": {"ckpt": os.path.basename(last), "bytes": len(data),
                      "bpp": 8.0 * len(data) / (IMG_H * IMG_W),
                      "psnr_db": float(psnr(torch.from_numpy(rec),
                                            torch.from_numpy(test_images[0])))}})

    # ---- dsc: the flagship DSC stereo codec (temp_0031bpp, n = 128) at
    # full width on port-init weights, 4 synthetic stereo pairs at 320×1216
    from iclr_17_compression_tpu_torch.models.dsc import (DSC_PRESETS, DSCDecoder,
                                                          DSCStereoModel, quantize_code)
    from iclr_17_compression_tpu_torch.nn.blocks import (ResidualBlockUpsample,
                                                         ResidualBlockWithStride)

    def dsc_model(preset: str, seed: int) -> DSCStereoModel:
        """The port's seeded init of ``preset`` on the card, every GDN and
        IGDN moved off its identity, so that K2's epilogue and reduce body
        are held with the norm pool's cross-channel terms and γᵀ."""
        gen_m = torch.Generator().manual_seed(seed)
        model = DSCStereoModel(DSC_PRESETS[preset]).init_(gen_m)
        return gdn_off_identity_(torch, model, gen_m).to(dev).eval()

    def padded(img):
        return torch.from_numpy(codec_cli.pad_to_multiple(img, cfg_dsc.code_div)[None]).to(dev)

    t_dsc = time.perf_counter()
    cfg_dsc = DSC_PRESETS[DSC_PRESET]
    rng = np.random.default_rng(2)
    lefts = [smooth_image(rng, DSC_H, DSC_W) for _ in range(N_PAIRS)]
    rights = [shift_pair(a, rng) for a in lefts]
    dsc = dsc_model(DSC_PRESET, DSC_SEED)
    # the code spread past the clip: each output channel of g_a22's last
    # 3×3 conv centred and scaled to CODE_SPREAD on the first left image;
    # the receiver takes the code in steps (g_s22's first 3×3 conv divided
    # by the step), as a trained one takes its scale, else the random IGDNs
    # of g_s22 and g_s square it up to 1e5 and the recon is all clipped
    last = dsc.g_a22[max(i for i, sp in enumerate(cfg_dsc.ga22) if sp[0] == "conv3")]
    first = dsc.g_s22[min(i for i, sp in enumerate(cfg_dsc.gs22) if sp[0] == "conv3")]
    spread_channels_(torch, last, lambda: dsc.encode(padded(lefts[0])), CODE_SPREAD)
    with torch.no_grad():
        first.weight.div_(cfg_dsc.coarse_step)

    # the file codec on 4 pairs, the counters around it only
    k1.gdn_fused.launches = k2.conv_gdn.launches = k3.quantize_pack.launches = 0
    dsc_files, dsc_recons, dsc_enc_ms, dsc_dec_ms = [], [], [], []
    for a, b in zip(lefts, rights):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        data = codec_cli.encode_image(a, dsc, device="cuda")
        t1 = time.perf_counter()
        rec = codec_cli.decode_image(data, dsc, device="cuda", si_image=b)
        torch.cuda.synchronize()
        t2 = time.perf_counter()
        dsc_files.append(data)
        dsc_recons.append(rec)
        dsc_enc_ms.append(1e3 * (t1 - t0))
        dsc_dec_ms.append(1e3 * (t2 - t1))
    dsc_launches = {"conv_gdn": k2.conv_gdn.launches, "gdn": k1.gdn_fused.launches,
                    "quantize_pack": k3.quantize_pack.launches}
    check(dsc_launches == {"conv_gdn": 11 * N_PAIRS, "gdn": 0, "quantize_pack": N_PAIRS},
          f"DSC launch counts {dsc_launches}, expected K2 4 + 7 and K3 1 per image")

    lim = int(cfg_dsc.code_clip / cfg_dsc.coarse_step)
    dsc_images, used, past_clip, clamped = [], set(), 0, True
    for i, (a, data, rec) in enumerate(zip(lefts, dsc_files, dsc_recons)):
        syms, code = codec_cli.dsc_symbols(padded(a), dsc)
        with torch.no_grad():
            pre = dsc.encode(padded(a))[0].cpu().numpy()
        past = np.abs(pre) > cfg_dsc.code_clip + cfg_dsc.coarse_step / 2
        past_clip += int(past.sum())
        clamped &= bool(np.array_equal(syms[past], np.sign(pre[past]).astype(np.int64) * lim))
        used.update(np.unique(syms).tolist())
        decoded, name, h0, w0 = codec_cli.read_dsc_code(data)
        check(name == DSC_PRESET and (h0, w0) == (DSC_H, DSC_W), f"pair {i}: header {name}")
        check(np.array_equal(decoded[0] / cfg_dsc.coarse_step, syms),
              f"pair {i}: decoded symbols differ from the encoder's")
        check(np.array_equal(decoded, code.cpu().numpy()),
              f"pair {i}: decoded code differs from K3's dequantized code")
        check(rec.shape == a.shape and np.isfinite(rec).all() and rec.min() >= 0.0
              and rec.max() <= 1.0, f"pair {i}: recon not finite in [0, 1]")
        dsc_images.append({"bytes": len(data), "bpp": 8.0 * len(data) / (DSC_H * DSC_W),
                           "psnr_db": float(psnr(torch.from_numpy(rec), torch.from_numpy(a))),
                           "symbols_used": int(np.unique(syms).size),
                           "encode_ms": dsc_enc_ms[i], "decode_ms": dsc_dec_ms[i]})
    check(sorted(used) == list(range(-lim, lim + 1)),
          f"the files' codes use symbols {sorted(used)}, not all {2 * lim + 1}")
    check(past_clip > 0 and clamped, f"the clamp at ±{cfg_dsc.code_clip:g}: {past_clip} "
          f"elements past it, held {clamped}")

    # the CPU plain path: the same file decodes to the same image, and the
    # same image encodes to the same symbols up to rounding flips
    cpu_dsc = DSCStereoModel(cfg_dsc)
    cpu_dsc.load_state_dict({k: v.cpu() for k, v in dsc.state_dict().items()})
    cpu_dsc.eval()
    rec_cpu = codec_cli.decode_image(dsc_files[0], cpu_dsc, device="cpu", si_image=rights[0])
    dsc_dec_err = float(np.abs(dsc_recons[0] - rec_cpu).max())
    check(dsc_dec_err <= DECODE_ATOL, f"DSC GPU vs CPU decode of one file: {dsc_dec_err:.3e}")
    syms_cpu = codec_cli.read_dsc_code(codec_cli.encode_image(lefts[0], cpu_dsc, "cpu"))[0]
    dsc_flips = np.abs(codec_cli.read_dsc_code(dsc_files[0])[0] - syms_cpu) / cfg_dsc.coarse_step
    check(dsc_flips.max() <= 1 and (dsc_flips > 0).mean() <= LATENT_FLIP_FRAC,
          f"DSC GPU vs CPU symbols: {(dsc_flips > 0).mean():.2e} differ, max {dsc_flips.max()}")

    # K3 on the first pair's code, bit-exact against its plain version
    with torch.no_grad():
        code_pre = dsc.encode(padded(lefts[0])).contiguous()
    wsyms, wcode = quantize_code(code_pre, cfg_dsc)
    rsyms, rcode = k3.quantize_pack_plain(code_pre, cfg_dsc.coarse_step, cfg_dsc.code_clip)
    check(torch.equal(wsyms, rsyms) and torch.equal(wcode, rcode),
          "K3 on the DSC code: not bit-exact")

    # a two-stage file: a second port-init model as the reg_0_0625 stage
    reg = dsc_model("reg_0_0625", DSC_SEED + 1)
    two = codec_cli.encode_composite(lefts[0], dsc, reg, device="cuda")
    two_rec = codec_cli.decode_composite(two, dsc, reg, rights[0], device="cuda")
    _, _, base_code, reg_code, _, _ = codec_cli.read_dsc_composite(two)
    for stage, code in ((dsc, base_code), (reg, reg_code)):
        sent = codec_cli.dsc_symbols(padded(lefts[0]), stage)[0]
        check(np.array_equal(code[0] / cfg_dsc.coarse_step, sent),
              f"two-stage file: {stage.config.name} symbols differ")
    check(two_rec.shape == lefts[0].shape and np.isfinite(two_rec).all()
          and two_rec.min() >= 0.0 and two_rec.max() <= 1.0, "two-stage recon not in [0, 1]")

    # serving throughput: a batch of 4, encode (to the symbols on the host)
    # then the receiver with the right images
    x4 = torch.from_numpy(np.stack(lefts)).to(dev)
    y4 = torch.from_numpy(np.stack(rights)).to(dev)
    receiver = DSCDecoder(cfg_dsc, model=dsc)

    def serve():
        with torch.no_grad():
            symbols, code = quantize_code(dsc.encode(x4), cfg_dsc)
            symbols.cpu()
            return receiver(code, y4)

    serve_ms = []
    for i in range(13):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        serve()
        torch.cuda.synchronize()
        if i >= 3:
            serve_ms.append(1e3 * (time.perf_counter() - t0))
    batch_ms = statistics.median(serve_ms)

    # where one image's time goes: encode + decode under the profiler, and
    # the host coder stages (histogram tables, rANS)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        data = codec_cli.encode_image(lefts[0], dsc, device="cuda")
        codec_cli.decode_image(data, dsc, device="cuda", si_image=rights[0])
        torch.cuda.synchronize()
        dsc_wall_ms = 1e3 * (time.perf_counter() - t0)
    dsc_by_kernel = {}
    for evt in prof.events():
        if evt.device_type == torch.autograd.DeviceType.CUDA and not getattr(
                evt, "is_user_annotation", False):
            name = evt.name.split("(")[0][:60]
            dsc_by_kernel[name] = dsc_by_kernel.get(name, 0.0) + evt.time_range.elapsed_us() / 1e3
    dsc_busy = sum(dsc_by_kernel.values())
    dsc_n_kernels = sum(1 for evt in prof.events()
                        if evt.device_type == torch.autograd.DeviceType.CUDA
                        and not getattr(evt, "is_user_annotation", False))
    syms0 = codec_cli.dsc_symbols(padded(lefts[0]), dsc)[0]
    t0 = time.perf_counter()
    codec = api.build_cdf_tables_from_histogram(syms0, offset=-lim, nsym=2 * lim + 1)
    t1 = time.perf_counter()
    stream = api.encode_latent(codec, syms0)
    t2 = time.perf_counter()
    api.decode_latent(codec, stream, syms0.shape)
    t3 = time.perf_counter()

    # K2 at each DSC shape (batch 1), from the blocks' own inputs in one
    # encode + decode, against plain, cuDNN + plain GDN and cuDNN + K1
    sites = [("g_a l1", dsc.g_a[1]), ("g_a l3", dsc.g_a[3]), ("g_a l6", dsc.g_a[6]),
             ("g_a22 l2", dsc.g_a22[2]), ("g_s22 l5", dsc.g_s22[5]), ("g_s l2", dsc.g_s[2]),
             ("g_s l4", dsc.g_s[4]), ("g_s l7", dsc.g_s[7])]
    inputs = {}
    hooks = [block.register_forward_pre_hook(
        lambda mod, args, where=where: inputs.setdefault(where, args[0]))
        for where, block in sites]
    codec_cli.decode_image(codec_cli.encode_image(lefts[0], dsc, device="cuda"), dsc,
                           device="cuda", si_image=rights[0])
    for h in hooks:
        h.remove()
    k2_dsc, k1_c64 = new_row(library=True), new_row(library=False)
    with torch.no_grad():
        for where, block in sites:
            check(isinstance(block, (ResidualBlockWithStride, ResidualBlockUpsample)), where)
            measure_k2(block_k2_args(block, inputs[where]), k2_dsc, f"K2 DSC {where}",
                       cudnn_k1=True)
            k2_dsc["shapes"][-1]["where"] = where
        # K1's body at C = 64 (g_a22's GDN) on the two pixel counts of the table
        for pixels in (97280, 380):
            x = torch.randn((1, pixels, 64), generator=gen).to(dev)
            measure_k1(x, dsc.g_a22[2].gdn, k1_c64, f"K1 C=64 {pixels}x64")
        # K3 on the code: 1×10×38×8 at step 16, clip 128 (8-bit symbols)
        n3 = code_pre.numel()
        k3_b_ms, k3_b_by = bound_ms(5.0 * n3, 9.0 * n3)
        k3_dsc = {"x": list(code_pre.shape), "step": cfg_dsc.coarse_step, "lim": lim, "bits": 8,
                  "ms": time_ms(lambda: quantize_code(code_pre, cfg_dsc)),
                  "call_ms": call_ms(lambda: quantize_code(code_pre, cfg_dsc)),
                  "plain_ms": time_ms(lambda: k3.quantize_pack_plain(
                      code_pre, cfg_dsc.coarse_step, cfg_dsc.code_clip)),
                  "bound_ms": k3_b_ms, "bound_by": k3_b_by, "launch_floor_ms": floor_ms,
                  "max_abs_err": 0.0}
    dsc_s = time.perf_counter() - t_dsc
    emit({"phase": "dsc", "ok": True, "preset": DSC_PRESET, "n": cfg_dsc.n, "seed": DSC_SEED,
          "pairs": N_PAIRS, "shape": [DSC_H, DSC_W, 3], "launches": dsc_launches,
          "per_image": dsc_images,
          "cpu_reference": {"decode_max_abs_err": dsc_dec_err,
                            "symbol_flip_frac": float((dsc_flips > 0).mean())},
          "code_range": {"symbols_used": len(used), "past_clip": past_clip,
                         "elements": N_PAIRS * int(code_pre.numel())},
          "two_stage": {"bytes": len(two), "bpp": 8.0 * len(two) / (DSC_H * DSC_W)},
          "serving": {"batch": N_PAIRS, "median_ms": batch_ms, "ms_per_image": batch_ms / N_PAIRS,
                      "mpix_per_s": N_PAIRS * DSC_H * DSC_W / (batch_ms * 1e3)},
          "profile": {"wall_ms": dsc_wall_ms, "device_busy_ms": dsc_busy,
                      "device_idle_share": 1.0 - dsc_busy / dsc_wall_ms,
                      "device_kernels": dsc_n_kernels,
                      "device_ms_by_kernel": dict(sorted(dsc_by_kernel.items(),
                                                         key=lambda kv: -kv[1])[:12]),
                      "host_ms": {"histogram_tables": 1e3 * (t1 - t0),
                                  "rans_encode": 1e3 * (t2 - t1),
                                  "rans_decode": 1e3 * (t3 - t2)}},
          "k2_dsc": k2_dsc, "k1_c64": k1_c64, "k3_step16": k3_dsc, "seconds": dsc_s})
    print(f"dsc phase seconds: {dsc_s:.1f}", flush=True)

    tools = types.SimpleNamespace(check=check, emit=emit, time_ms=time_ms, call_ms=call_ms,
                                  measure_k2=measure_k2, measure_k1=measure_k1, new_row=new_row,
                                  bound_ms=bound_ms, floor_ms=floor_ms)
    dsc_train = dsc_train_phase(torch, dev, tools)
    dsc_train_launches = dsc_train["launches"]
    hyper = hyper_phase(torch, dev, tools)
    hyper_launches = hyper["launches"]
    hyper_train = hyper_train_phase(torch, dev, tools)
    fusion = dsc_fusion_phase(torch, dev, tools)
    aux = aux_phase(torch, dev, tools, KITTI_TRAIN_DIR)
    evals = eval_phase(torch, dev, tools)
    paths = {"codec": launches, "train": train_launches, "dsc": dsc_launches,
             "dsc_train": dsc_train_launches, "hyper": hyper_launches,
             "hyper_train": hyper_train["launches"], "dsc_fusion": fusion["launches"],
             "aux": aux["launches"], "eval": evals["launches"]}

    kernels = []
    meta = {
        "gdn": ("iclr_17_compression_tpu_torch/ops/kernels/csrc/gdn.cu",
                "iclr_17_compression_tpu/ops/pallas/gdn_kernel.py:37"),
        "conv_gdn": ("iclr_17_compression_tpu_torch/ops/kernels/csrc/conv_gdn.cu",
                     "iclr_17_compression_tpu/ops/pallas/conv_gdn_kernel.py:89"),
        "quantize_pack": ("iclr_17_compression_tpu_torch/ops/kernels/csrc/quant_pack.cu",
                          "iclr_17_compression_tpu/ops/pallas/quant_pack_kernel.py:51"),
    }
    for name in ("conv_gdn", "gdn", "quantize_pack"):
        row = rows[name]
        entry = {"name": name, "route": "cuda", "source": meta[name][0],
                 "replaces": meta[name][1],
                 "launches": sum(path[name] for path in paths.values()),
                 "launches_by_path": {p: path[name] for p, path in paths.items()},
                 "max_abs_err": row["max_abs_err"], "ms": row["ms"],
                 "plain_ms": row["plain_ms"], "bound_ms": row["bound_ms"],
                 "bound_by": row["bound_by"], "library_ms": row["library_ms"],
                 "bound_route": "3xtf32" if name != "quantize_pack" else "fp32"}
        if name == "conv_gdn":
            entry["stages"] = [{k: st[k] for k in ("ms", "plain_ms", "library_ms", "bound_ms")}
                               for st in row["shapes"]]
        train_row = {"conv_gdn": k2_train, "gdn": k1_train}.get(name)
        if train_row is not None:
            entry["max_abs_err"] = max(row["max_abs_err"], train_row["max_abs_err"])
            entry["training_shapes"] = [
                {k: st.get(k) for k in ("x", "ms", "plain_ms", "library_ms", "bound_ms")}
                for st in train_row["shapes"]]
        c192_keys = ("where", "x", "splits", "partial_bytes", "ms", "call_ms", "plain_ms",
                     "library_ms", "cudnn_k1_ms", "cudnn", "bound_ms", "bound_by")
        for key, phase in (("c192_shapes", hyper), ("c192_training_shapes", hyper_train)):
            phase_row = {"conv_gdn": phase["k2"], "gdn": phase["k1"]}.get(name)
            if phase_row is not None:
                entry["max_abs_err"] = max(entry["max_abs_err"], phase_row["max_abs_err"])
                entry[key] = [{k: st.get(k) for k in c192_keys if k in st}
                              for st in phase_row["shapes"]]
        if name == "conv_gdn":
            k2_tr = dsc_train["k2_training"]
            entry["max_abs_err"] = max(entry["max_abs_err"], k2_dsc["max_abs_err"],
                                       k2_tr["max_abs_err"])
            entry["dsc_training_shapes"] = [
                {k: st.get(k) for k in ("where", "x", "splits", "ms", "call_ms", "plain_ms",
                                        "library_ms", "cudnn_k1_ms", "bound_ms", "bound_by")}
                for st in k2_tr["shapes"]]
            entry["dsc_shapes"] = [
                {k: st.get(k) for k in ("where", "x", "splits", "ms", "call_ms", "plain_ms",
                                        "library_ms", "cudnn_k1_ms", "bound_ms", "bound_by")}
                for st in k2_dsc["shapes"]]
            entry["max_abs_err"] = max(entry["max_abs_err"], fusion["k2"]["max_abs_err"])
            entry["fusion_shapes"] = [
                {k: st.get(k) for k in ("where", "x", "splits", "ms", "plain_ms", "library_ms",
                                        "cudnn_k1_ms", "bound_ms", "bound_by")}
                for st in fusion["k2"]["shapes"]]
        elif name == "gdn":
            entry["max_abs_err"] = max(entry["max_abs_err"], k1_c64["max_abs_err"],
                                       aux["k1"]["max_abs_err"],
                                       aux["k1_decoder_only"]["max_abs_err"])
            entry["c64_shapes"] = [{k: st.get(k) for k in ("x", "ms", "plain_ms", "bound_ms")}
                                   for st in k1_c64["shapes"]]
            entry["c512_shapes"] = [
                {k: st.get(k) for k in ("where", "x", "inverse", "ms", "call_ms", "plain_ms",
                                        "bound_ms", "bound_by")}
                for st in aux["k1"]["shapes"]]
            entry["decoder_only_shapes"] = [
                {k: st.get(k) for k in ("where", "x", "inverse", "ms", "call_ms", "plain_ms",
                                        "bound_ms", "bound_by")}
                for st in aux["k1_decoder_only"]["shapes"]]
        else:
            entry.update(launch_floor_ms=row["launch_floor_ms"], dsc_step16=k3_dsc,
                         dsc_validation=dsc_train["k3_validation"], fusion_codes=fusion["k3"])
        kernels.append(entry)
    print(f"chip_smoke seconds: {time.perf_counter() - t_script:.1f}", flush=True)
    print(smi, flush=True)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                             "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    try:
        sys.exit(main())
    except SmokeFailure as e:
        print(f"chip_smoke: FAILED: {e}", file=sys.stderr, flush=True)
        sys.exit(1)
