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
          for 40 steps, then --resume to 50, with the launch counters reset just before and
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
          Numbers: median step ms over steps 20-40 and images/s, peak
          memory, the step's phases (CUDA events), a 3-step profile (device
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
          and a 2-frame test root: 24 steps, then --resume for 6 more, with
          the launch counters reset just before and read just after; checks:
          K2 17 launches a step and a validation frame, K3 0 a step and 1 a
          validation frame, K1 none (DSC's GDNs run fused in K2); every
          loss finite and the last 10 steps' mean below the first 10's; the gradient of every parameter through K2's
          Function against the plain path on the card within 4× a floor
          measured in the same run (the plain path against itself with K2's
          outputs moved by K2's own error, the largest of four seeded
          draws; DSC_GRAD_TOL; every pass of the gate under deterministic
          cuDNN, where the plain path must repeat bit for bit), on the largest
          and on the median tensor's gap, and a control at TF32's error
          (1e-3 relative) beyond one of the two gates; K2 at the training
          sites (five shapes) and K3 at the validation code against plain;
          the resume's parameters, Adam moments, LR and plateau state read
          back bit-equal and its first batch the uninterrupted loop's;
          best_train.ckpt through load_dsc and the codec CLI with exact
          symbols; reg_stage for 2 steps over the trained model written as
          JAX-layout params (K2 28, K3 1 and K1 0 a step, the frozen base
          bit-unchanged, finite losses); a model moved to the card by hand
          with TF32 on trains in fp32. Numbers: median step ms and pairs/s,
          peak memory, a 3-step profile (device busy, idle share, K2
          forward, K2's backward recompute, cuDNN's convolutions, top
          kernels), validation ms a frame, K2 at each training shape with
          cuDNN + plain GDN and cuDNN + K1 and its bound, K3 against its
          launch floor
  hyper   the scale-hyperprior (both quantizers) and joint-AR codecs at
          N = 192, M = 320 (the codec CLI's defaults) on the port's seeded
          init, every GDN off the identity and the analysis and
          hyper-analysis outputs spread over many symbols, on one synthetic
          768×512 image: encode_image → bytes → decode_image, with the launch
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
          cuDNN's defaults and autotuned, a 3-step profile of each model
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
          crops) of att_0031bpp, bottleneck_att_1bpp and pam_0031bpp for 2
          steps each on synthetic KITTI frames: every loss finite, K2 17 a
          step. Numbers: encode / decode ms, serving ms and device busy ms
          an image (one profiled), K2
          at the bottleneck preset's sites and K3 on each preset's code
          against plain, step ms
  aux     the six auxiliary trainers through the training CLI's main at the
          JAX TrainConfig's defaults (batch 4, image_size 256, lr 1e-4,
          KITTI layout) for 10 steps each: two_steps and decoder_only over
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
          eval_kodak with rANS on 2 synthetic 768×512 images (finite, rANS
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
  precision  bf16 storage and blocked image I/O: the Ballé-17 headline
          (io_block = 4, the archived lam2048 weights, 8 synthetic 768×512
          images) in its four forms (fp32 / bf16 storage × unblocked /
          blocked), each with its launches per kernel and dtype (K2 3 and K1
          2 of its own dtype only) and its forward ms and Mpix/s; the DSC
          flagship's serving split (g_a → g_a22 → K3; the receiver's g_a
          over the SI image, g_s22, fusion, g_s) on the archived weights, 4
          synthetic 320×1216 pairs, in fp32 and bf16 (K2 4 + 7 and K3 1 of
          its dtype only); checks: blocked against unblocked in fp32, bf16
          against fp32 under the JAX bf16 test's criteria, the DSC split's
          bf16 K3 symbols against fp32's (share stated) and its recon PSNR,
          K2 and K1 in bf16 within one bf16 ulp of their plain versions at
          the headline's stages (conv1 blocked and unblocked, conv2, conv3,
          both IGDNs) and two DSC sites, K3 in bf16 bit-exact on the DSC
          code and the Ballé latent, K2 in fp32 at the blocked conv1 (rtol
          1e-4 / atol 1e-5), off the main paths K1 in bf16 at C = 64, 96,
          192, 256, 512 and K2 in bf16 at Cout = 192 (tiles of 128 and 64
          pixels) and 256, K2 bf16's SASS (wgmma, HGMMA, in every instance, no bf16
          mma.sync), the precision policy's flags under high and default,
          restored after. Numbers: bf16 and fp32 kernel times, the
          plain versions', cuDNN bf16 + plain GDN for K2, bounds at the bf16
          dense peak, the plan K2 bf16's wrapper launched (its tile of 64 or
          128 pixels; K never split, no partials), ptxas's registers, shared
          memory and spills of both bf16 kernels, one profiled bf16 headline
          forward (device ms by kernel, idle share; its trace must hold the
          three K2 bf16 launches within TRACE_K2_BAND of their CUDA-event
          time). Then the
          joint-AR and hyperprior codecs on bf16 storage (ROADMAP item 22):
          the JAX bench_joint configuration
          (N = 192, 16 synthetic 512×768 images, bf16 storage and bf16
          images; the hyperprior at N = 192, M = 320 on the same images) on a
          fresh seeded init, with bench_joint_host_codec's realism fix (y
          spread to a std of 2.5, the joint's σ biased to match) and on the
          hyper phase's calibrated weights, each forward's launches (joint K2
          6, hyperprior K2 3 + K1 3, all bf16), ms, Mpix/s, bpp, and bf16
          against fp32 on one image (MSE under 5% of the distortion on all;
          on the calibrated weights also bpp_y within 5% with the rate terms
          of the bf16 forward's ŷ and σ in fp32, and the decoder's
          arithmetic within 0.1; the bf16 rate arithmetic's bpp, as JAX's,
          recorded); on the calibrated weights, K2 bf16 at the
          joint's 3×3 s1 blocks and the hyperprior's 5×5 s2 analysis and K1
          bf16 at its IGDNs (C = 192) against plain, with cuDNN bf16 + plain
          GDN; one profiled realism forward each (cuDNN's bf16 route); one
          768×512 file each from the bf16-stored weights (the codecs compute
          in fp32 on the bf16-rounded weights): ŷ equal, σ's scale-index
          flips between the card and the CPU
  tiled   tiled serving on one card (ROADMAP items 20a, 20c), every tile on
          cuda:0: the archived Ballé-17 lam2048 through make_tiled_codec in
          4 W-tiles on a 768×512 image and a 3840×2160 frame (K2 3, K1 2, K3
          1 a tile, the counters around encode + decode only), against the
          untiled codec (latent flips ≤ 0.1% by one, recon ≥ 60 dB), the
          per-tile rANS streams against one set of tables decoding to the
          encoder's symbols, the CPU decoding the card's serialized
          TiledStreams (and, for the 768×512 image, its tiled receiver within
          1e-4 of the card's recon); K2 at a tile's (p, 0) padding on the
          3840×2160 frame's second tile at the three encoder stages against
          plain, with cuDNN + plain GDN and cuDNN + K1; the archived DSC
          flagship in 2 W-tiles and pam_0031bpp (the fusion phase's seeded
          weights) in 2 H-tiles through make_tiled_dsc (K2 4 + 7, K3 1 a
          tile), code flips ≤ 0.1% and the receiver ≥ 60 dB against untiled,
          per-tile streams (ROADMAP item 20c:) the fusion presets whose
          modules see the whole latent, fif_0031bpp, att_0031bpp and
          bottleneck_att_1bpp at n = 128 (the fusion phase's seeded
          weights) on one 320×1216 pair in 2 W-tiles and att_0031bpp in 2
          H-tiles, those modules on the gathered tiles, with the same gates,
          K2 and K3 launches a tile, K3 on a tile's code against plain
          (bit-exact) and the CPU decoding the card's serialized streams;
          the W-tiled ring PAM (2 tiles) against the
          replicated PAM on the PAM's inputs in the receiver (rtol 1e-4 /
          atol 1e-5). Numbers: device ms (CUDA events) and host ms (wall
          around a synchronized call) tiled against untiled, stream bytes,
          the host rANS ms
  mesh_train  the training mesh on one card (ROADMAP items 20b-20d), every slot
          on cuda:0: Ballé-17 at examples/balle17.json's widths (N = 128,
          batch 4, 256×256 crops, λ 8192) on 1×1, 4×1 and 2×2 meshes for 10
          steps each from one seeded state on the same batches; the DSC
          flagship (temp_0031bpp, n = 128, batch 2, the dsc_train phase's
          KITTI-layout crops, GDNs off the identity) on 1×1, 2×1 and 2×2;
          (ROADMAP item 20d:) the hyperprior at N = 192, M = 320 on 1×1,
          1×2 and 2×2 (round, 2 steps) and 1×1 and 1×2 (sigma-norm, 1
          step), the joint at N = 192 on 1×1 and 1×2 (2 steps), in W-tiles
          of 64 columns; (item 20c:) att_0031bpp and pam_0031bpp on 1×1 and
          1×2 on 320² crops of the KITTI layout, 1 step each, the attention
          and PAM on the gathered tiles; checks: K2 and K1 launches a step the slots times the
          one-device count (K2 a tile on the tiled meshes), every mesh's
          step-1 metrics within RTOL of 1×1's, Ballé's step-10 rd_loss
          within 1% of 1×1's, the step-1 gradients under deterministic cuDNN
          against 1×1's (Ballé within GRAD_TOL; DSC, hyperprior, joint and
          the fusion presets by the dsc_train phase's floor gate, whose
          TF32-size control must miss), train_single_image on a 2×2 mesh of
          4 slots and of the hyperprior on 1×2 W-tiles resuming bit-equal to
          the uninterrupted run, K2 at a hyperprior tile's conv2 (5×5 s2, C
          = 192, padding (2, 0)) and K1 at its IGDN3 against plain, K2's Function at a 2×2 tile's
          conv2 (padding (2, 0)) against the plain path forward and
          backward, fp32 K1 at C = 160 and K2's split reduction at Cout =
          160 against plain (off the paths), and dryrun_multichip on 8
          slots. Numbers: host and CUDA-event ms a step per mesh, one
          profiled step per mesh (device busy, idle share), the gradient
          gaps, K2 at the tile's conv2 with its times and bound
Then the script's seconds, the card's name and power limit, one line with
every kernel's numbers (the bf16 variants as entries of their own), and
last the line {"ok": true, "device": {...}}.
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
PEAK_BF16_FLOPS = 989e12
PEAK_HBM_BYTES = 3.35e12
# The kernels' symbols in the library: K2's conv and its split-K reduction,
# K1, K3, and their bf16 variants.
KERNEL_SYMBOLS = ("conv_gdn_kernel", "conv_gdn_reduce_kernel", "gdn_rows_kernel",
                  "quant_pack_kernel", "conv_gdn_bf16_kernel", "gdn_rows_bf16_kernel",
                  "quant_pack_bf16_kernel")
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
TRAIN_STEPS, RESUME_STEPS = 40, 50
N_TRAIN_IMAGES, TRAIN_IMG = 16, 512
PROFILE_START, PROFILE_STEPS = 40, 3
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
# DSC_TRAIN_FRAMES frames × (_10, _11) = 12 pairs, 6 steps an epoch, 3
# epochs (18 steps; cut from 8, then 4, for time), then --resume for 1
# more; a 2-frame test root for the validation pass; REG_STEPS steps of the
# reg_stage trainer.
KITTI_H, KITTI_W = 375, 1242
KITTI_TRAIN_DIR = os.path.join(ROOT, "build", "chip_smoke_dsc_train", "kitti_train")
DSC_TRAIN_FRAMES, DSC_TRAIN_EPOCHS, DSC_RESUME_EPOCHS, REG_STEPS = 6, 3, 1, 2
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
# median tensor's gap scales with the perturbation. The largest gap is a
# heavy-tailed statistic (one kink flip sets it), so the floor is the
# largest over DSC_PERTURB_SEEDS' seeded draws of the perturbation, not one
# draw: with one draw the gate failed one run in six on an H100 (kernel
# 4.46e-2 against a gate of 2.37e-2).
DSC_GRAD_TOL = 1e-3
DSC_K2_PERTURB = 1e-5
DSC_PERTURB_SEEDS = (11, 12, 13, 14)
DSC_FLOOR_FACTOR = 4.0
DSC_CONTROL_PERTURB = 1e-3

# Hyperprior / joint-AR phase: hyperprior, hyperprior-sigma and joint at
# N = 192, M = 320 (the codec CLI's defaults) on the port's seeded init, one
# synthetic 768×512 image (it was two; cut for time); every GDN and
# IGDN moved off the identity (the dsc phase's law), each channel of the
# analysis transform's last conv centred and scaled to a std of
# HYPER_Y_STD, and of the hyper-analysis' last conv to HYPER_Z_STD, on the
# first image, so that y and z spread over many symbols. The card's file of
# a 128×192 crop is decoded on the CPU where no σ changes its scale index
# between the devices.
HYPER_SEED, N_HYPER_IMAGES, HYPER_N, HYPER_M = 4321, 1, 192, 320
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
FUSION_SEED, FUSION_FRAMES, FUSION_TRAIN_EPOCHS = 2468, 2, 1


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
AUX_STEPS, AUX_TRIPLETS, AUX_SEED, C512_BATCH = 10, 4, 97, 4

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
EVAL_SEED, EVAL_IMAGES, EVAL_PAIRS, EVAL_MASKS, EVAL_CROP = 4242, 2, 2, 2, (128, 256)
BALLE_FWD, DSC_FWD, BALLE_CODEC = (3, 2, 0), (17, 0, 1), (3, 2, 1)
# Card vs CPU on the same inputs: PSNR 1e-3 dB and bpp 0.1% (the rule of
# the R-D row of PERF.md §2), the masked MSEs rtol 1e-4, NLBlock's output
# 1e-4 of its largest |value| (cuBLAS and the CPU's fp32 sums).
EVAL_PSNR_DB, EVAL_BPP_REL, EVAL_MSE_RTOL, NL_TOL = 1e-3, 1e-3, 1e-4, 1e-4

# Precision phase: bf16 storage and blocked image I/O. The Ballé-17 headline
# (the archived lam2048 weights, PREC_BATCH synthetic 768×512 images) in the
# four forms (fp32 / bf16 storage × unblocked / io_block 4), and the DSC
# flagship's serving split (the archived temp_0031bpp weights, PREC_PAIRS
# synthetic 320×1216 pairs) in fp32 and bf16. Blocked against unblocked in
# fp32 (the same model, conv1 and deconv3 summed in another order): latent
# flips at most LATENT_FLIP_FRAC, by 1, the recons within BLOCKED_PSNR_DB of
# each other, bpp and mse within BLOCKED_RATE_REL. bf16 against fp32: the
# JAX bf16 test's criteria (recon MSE under 5% of the fp32 recon's
# distortion, max |diff| under 0.1, bpp within 5%); the DSC split's K3
# symbols may differ on at most DSC_SYMBOL_SHARE (a code_pre within bf16
# rounding of a k + ½ step boundary), its recon at least DSC_BF16_PSNR_DB
# from fp32's. K1 and K2 in bf16 within one bf16 ulp of their plain
# versions (ATOL where a value sits near zero), K3 bit-exact. The profiled
# bf16 headline forward's trace must hold its three K2 bf16 launches, their
# device time within TRACE_K2_BAND of the three stages' time by CUDA events
# (a kernel the trace cannot see would drop out of its busy and idle share).
# That forward is traced in a fresh process (headline_trace, started before
# the eval phase so that its set-up overlaps it): late in this script the
# in-process trace of it held neither its three K2 bf16 launches nor its K3
# one, while fresh processes' traces held them all.
PREC_SEED, PREC_BATCH, PREC_PAIRS = 1414, 8, 4
TRACE_K2_BAND = (0.7, 1.5)
TRACE_CHILD_S = 300
BLOCKED_PSNR_DB, BLOCKED_RATE_REL = 60.0, 1e-3
DSC_SYMBOL_SHARE, DSC_BF16_PSNR_DB = 0.02, 35.0

# Tiled phase: the Ballé-17 file codec's transforms (the archived lam2048,
# N = 128) in TILES W-tiles on one card, on a 768×512 image and a
# 3840×2160 frame; the DSC flagship (archived weights, 320×1216) in
# DSC_TILES W-tiles, pam_0031bpp (the fusion phase's seeded weights) in
# DSC_TILES H-tiles and through the W-tiled ring PAM, and fif_0031bpp,
# att_0031bpp and bottleneck_att_1bpp (seeded alike) in DSC_TILES W-tiles
# and att_0031bpp in DSC_TILES H-tiles. Tiled against untiled
# on the card: latent (code) flips at most LATENT_FLIP_FRAC, by one (K2
# splits a tile's K in another grouping than the whole image's: plan_splits
# reads the pixel count); the recons at least TILED_PSNR_DB apart; the ring
# PAM within the kernels' rtol / atol of the replicated one.
# The joint-AR and hyperprior on bf16 storage: bench_joint's batch of
# JOINT_BATCH 512×768 images at N = 192 (M = 320 for the hyperprior), on
# three sets of seeded weights: bench_joint's fresh init, that init with
# bench_joint_host_codec's realism fix (g_a's last conv scaled to a y std of
# REALISM_Y_STD, the joint's σ biased by REALISM_SIGMA_BIAS), and the hyper
# phase's calibrated weights (σ in a trained model's range, the decoder at
# a unit scale). bf16 against fp32 on the first PREC_CRIT_IMAGES (the fp32
# joint's 3×3 convs take cuDNN's FFT route, ~0.2 s a call), on the last two
# (the fresh init's latents round to almost all zeros: its forward is only
# timed): the recon MSE under 5% of the distortion; on the calibrated
# weights also bpp_y within 5% with the rate terms of the bf16 forward's ŷ
# and σ taken in fp32, and the largest recon difference under 0.1 on the
# decoder's arithmetic (the bf16 decoder on the fp32 latent). The JAX
# package runs these models' rate terms in the storage's dtype (the port
# follows it; tests/test_torch_joint_bf16.py holds the two within 2 bf16
# ulps), so their bpp in bf16 arithmetic is recorded beside it, as is the
# whole forward's largest recon difference (a latent that bf16 rounds to
# the other integer moves its patch); on the realism-fixed weights, at no
# trained scale, all but the MSE is recorded, not held.
JOINT_BATCH, PREC_CRIT_IMAGES = 16, 1
REALISM_Y_STD, REALISM_SIGMA_BIAS = 2.5, 2.5

TILED_SEED, TILES, DSC_TILES = 2020, 4, 2
TILED_FRAME_H, TILED_FRAME_W = 2160, 3840
TILED_PSNR_DB = 60.0

# Training-mesh phase, every slot on the one card: Ballé-17 on BALLE_MESHES
# for MESH_BALLE_STEPS steps, the DSC flagship on DSC_MESHES for
# MESH_DSC_STEPS (step 1 gated, step 2 timed; cut from 3 for time), the
# hyperprior and joint on HYPER_MESHES for MESH_STEPS, each run then one
# step under the profiler.
MESH_SEED = 1717
BALLE_MESHES, DSC_MESHES, HYPER_MESHES = ((1, 1), (4, 1), (2, 2)), ((1, 1), (2, 1), (2, 2)), \
    ((1, 1), (1, 2), (2, 2))
MESH_BALLE_STEPS, MESH_DSC_STEPS, MESH_STEPS, MESH_BATCHES = 10, 2, 2, 4
# the tile axis of the hyperprior (both quantizers) and joint codecs in
# 64-column W-tiles (ẑ's downsampling); the fusion presets that train, with
# their whole-latent modules on the gathered tiles, on FUSION_MESH_CROP²
# crops of the KITTI layout
SIGMA_NORM_MESHES, JOINT_MESHES, FUSION_MESHES = ((1, 1), (1, 2)), ((1, 1), (1, 2)), \
    ((1, 1), (1, 2))
MESH_SIGMA_NORM_STEPS, MESH_FUSION_STEPS, FUSION_MESH_CROP = 1, 1, 320
FUSION_MESH_PRESETS = ("att_0031bpp", "pam_0031bpp")
MESH_HYPER_CLI_STEPS, MESH_HYPER_CLI_RESUME = 1, 2
MESH_LOSS_REL = 0.01
# a step-1 gradient gap is a share of the tensor's largest |gradient|, but
# never of less than MESH_GRAD_FLOOR_SHARE of the model's largest (the CPU
# tests' TINY_TENSOR): a tensor whose gradient is rounding alone (PAM's key
# bias, zero in exact arithmetic) set a floor of 2.0 on its own scale (an
# NVIDIA H100 80GB HBM3 at 700.00 W) and left the largest-gap gate unable
# to fail
MESH_GRAD_FLOOR_SHARE = 1e-5
MESH_CLI_STEPS, MESH_CLI_RESUME, MESH_CLI_IMAGES = 3, 6, 8
MESH_DRYRUN_DEVICES = 8
C160 = 160


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


def kernel_name(symbol: str) -> str:
    """A kernel's name from its mangled symbol: the name of KERNEL_SYMBOLS it
    carries, with the template arguments of an instance (``<128,2>``)."""
    base = next((k for k in KERNEL_SYMBOLS if k in symbol), None)
    if base is None:
        return symbol
    t = re.match(r"I((?:Li\d+E)+)E", symbol[symbol.index(base) + len(base):])
    return f"{base}<{','.join(re.findall(r'Li(\d+)E', t.group(1)))}>" if t else base


def ptxas_report(log: str) -> dict:
    """Registers, static shared memory and spills of each kernel (each
    instance of a template), from the ``nvcc -Xptxas -v`` output the build
    keeps."""
    out, name = {}, None
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '(\w+)'", line)
        if m:
            name = kernel_name(m.group(1))
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


def sass_report(lib_path) -> dict:
    """Tensor-core instructions in each kernel's SASS, from the CUDA
    toolkit's ``cuobjdump --dump-sass`` of the built library: {kernel:
    {"HGMMA": n (wgmma), "HMMA": n (mma.sync), "HMMA_BF16": n (its bf16
    form)}}."""
    from iclr_17_compression_tpu_torch.ops.kernels import _build

    tool = os.path.join(os.path.dirname(_build._nvcc()), "cuobjdump")
    text = subprocess.run([tool, "--dump-sass", str(lib_path)], capture_output=True, text=True,
                          timeout=120, check=True).stdout
    out, name = {}, None
    for line in text.splitlines():
        m = re.search(r"Function : (\w+)", line)
        if m:
            name = kernel_name(m.group(1))
            out[name] = {"HGMMA": 0, "HMMA": 0, "HMMA_BF16": 0}
        elif name is not None and "HGMMA" in line:
            out[name]["HGMMA"] += 1
        elif name is not None and "HMMA" in line:
            out[name]["HMMA"] += 1
            out[name]["HMMA_BF16"] += ".BF16" in line
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


def trace_launch_lead_ms(torch, prof):
    """The least time, in ms, from a kernel's launch call (``cudaLaunch*``,
    host clock) to the kernel's start (card clock) over a ``torch.profiler``
    run's kernels: a few microseconds where the two clocks agree, below
    zero where the card's timestamps run ahead of the host's. None where
    the trace pairs no kernel with its launch."""
    launch = {e.id: e.time_range.start for e in prof.events()
              if e.device_type == torch.autograd.DeviceType.CPU
              and e.name.startswith("cudaLaunch")}
    leads = [e.time_range.start - launch[e.id] for e in prof.events()
             if e.device_type == torch.autograd.DeviceType.CUDA and e.id in launch]
    return min(leads) / 1e3 if leads else None


def start_headline_trace():
    """``headline_trace`` in a fresh process (a ``subprocess.Popen``), which
    sets up (CUDA, the model, the images) at once and traces when it reads
    "go" on its standard input; it prints its result as one JSON line."""
    return subprocess.Popen(
        [sys.executable, "-c", "import json, chip_smoke\n"
         "r = chip_smoke.headline_trace(wait=True)\nif r:\n    print(json.dumps(r))"],
        cwd=ROOT, stdin=subprocess.PIPE, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
        text=True)


def headline_trace(wait: bool = False) -> dict:
    """One ``torch.profiler`` trace of the bf16 headline forward (the
    archived lam2048 at io_block 4, bf16 storage, the precision phase's
    PREC_BATCH images), after three untraced ones, in this process:
    {"wall_ms", "device_ms_by_kernel", "k2_bf16_ms": each K2 bf16 launch's
    device ms, "launch_lead_ms"}; with ``wait``, set up first and then wait
    for "go" on the standard input ({} on anything else). The precision
    phase runs it in a fresh process (``start_headline_trace``), whose trace
    holds every kernel."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from iclr_17_compression_tpu_torch.models.balle17 import Balle17Compressor
    from iclr_17_compression_tpu_torch.ops import precision
    from iclr_17_compression_tpu_torch.ops.conv import space_to_depth
    from iclr_17_compression_tpu_torch.train.weights import load_balle17
    from iclr_17_compression_tpu_torch.utils.device import resolve_device

    dev = resolve_device("cuda")
    rng = np.random.default_rng(PREC_SEED)
    imgs = torch.from_numpy(np.stack([smooth_image(rng) for _ in range(PREC_BATCH)])).to(dev)
    model = Balle17Compressor(N_CH, io_block=4).to(dev).eval()
    model.load_state_dict(load_balle17(CKPT, device="cuda").state_dict())
    model = precision.cast_storage(model, torch.bfloat16)
    x = space_to_depth(imgs, 4).to(torch.bfloat16).contiguous()
    torch.cuda.synchronize()
    if wait and sys.stdin.readline().strip() != "go":
        return {}
    with torch.no_grad():
        for _ in range(3):
            model(x)
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            model(x)
            torch.cuda.synchronize()
            wall_ms = 1e3 * (time.perf_counter() - t0)
    return {"wall_ms": wall_ms, "device_ms_by_kernel": device_ms_by_kernel(torch, prof),
            "k2_bf16_ms": [e.time_range.elapsed_us() / 1e3 for e in prof.events()
                           if e.device_type == torch.autograd.DeviceType.CUDA
                           and "conv_gdn_bf16_kernel" in e.name],
            "launch_lead_ms": trace_launch_lead_ms(torch, prof)}


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
    new_row, bound_ms, floor_ms. The gradient gate's passes run under
    ``cudnn_deterministic``, where the plain path repeats bit for bit (a
    check). Returns the K2 and K3 rows and launches."""
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
    from iclr_17_compression_tpu_torch.utils.device import cudnn_deterministic

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
    def grads(m, path: str, rel: float = 0.0, seed: int = DSC_PERTURB_SEEDS[0]):
        real = k2.conv_gdn
        gen_p = torch.Generator(device=dev).manual_seed(seed)

        def perturbed(*args):
            y = k2.conv_gdn_plain(*args)
            return y * (1.0 + rel * torch.randn(y.shape, generator=gen_p, device=y.device))

        k2.conv_gdn = {"kernel": real, "plain": k2.conv_gdn_plain, "perturbed": perturbed}[path]
        try:
            with cudnn_deterministic():
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
        None, and with ``control`` a record: whether the plain path repeated
        bit for bit, the gate's premise, and the first draw's floor) of model
        ``m``: the hyper_train phase's two statistics. The
        floor of each statistic is the largest over DSC_PERTURB_SEEDS' draws
        of the perturbation."""
        before = k2.conv_gdn.launches
        _, g_kernel = grads(m, "kernel")
        check(k2.conv_gdn.launches - before == 17, "gradient parity: the kernel path ran no K2")
        _, g_plain = grads(m, "plain")
        draws = [stats(grads(m, "perturbed", DSC_K2_PERTURB, seed)[1], g_plain)
                 for seed in DSC_PERTURB_SEEDS]
        floor = (max(d[0] for d in draws), max(d[1] for d in draws))
        kp = gaps(g_kernel, g_plain)
        worst = sorted(((v, k) for k, v in kp.items()), reverse=True)[:5]
        missed = (stats(grads(m, "perturbed", DSC_CONTROL_PERTURB)[1], g_plain)
                  if control else None)
        gate = (max(DSC_GRAD_TOL, DSC_FLOOR_FACTOR * floor[0]), DSC_FLOOR_FACTOR * floor[1])
        record = None
        if control:  # the gated model: the plain path's repeat, the gate's premise
            g_again = grads(m, "plain")[1]
            record = {"plain_repeats_bit_equal": all(torch.equal(g_plain[k], g_again[k])
                                                     for k in g_plain),
                      "one_draw_floor": draws[0]}
        return ((max(kp.values()), statistics.median(kp.values())), floor, gate, worst, missed,
                record)

    parity = build_model(cfg.model, device=dev, seed=cfg.seed)
    parity.load_state_dict(model.state_dict())  # the trained weights
    gap, floor, gate, worst, control_gap, repeat = parity_of(parity, control=True)
    check(repeat["plain_repeats_bit_equal"], "gradient parity: the plain path's gradients did not repeat bit for bit "
                  "under cudnn_deterministic")
    del parity

    # TF32 on (PyTorch's defaults), a model moved to the card by hand: its
    # forward turns TF32 off, so it trains in fp32 and matches the plain path
    torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = True
    tf32_model = DSCStereoModel(preset).cuda()
    tf32_model.load_state_dict(model.state_dict())
    flags_before = (torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32)
    tf32_gap, tf32_floor, tf32_gate, _, _, _ = parity_of(tf32_model)
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
                              "perturb": DSC_K2_PERTURB, "floor_seeds": list(DSC_PERTURB_SEEDS),
                              "max_gap": gap[0],
                              "median_gap": gap[1], "floor": floor, "gate": gate,
                              "worst": worst,
                              "control_perturb": DSC_CONTROL_PERTURB,
                              "control_gap": control_gap,
                              **repeat},
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


def sigma_flips(torch, dev, joint: bool, model, cpu, x) -> tuple:
    """(σ scale-index flips between the card and the CPU for the card's ẑ
    of the image tensor ``x``, the elements compared) of a hyperprior or
    (``joint``) joint-AR ``model`` and its CPU copy ``cpu``, both in the
    file codec's arithmetic (``ops.precision.promoted``). The joint codec's
    σ also depends on ŷ: the CPU's σ is taken along the trajectory the CPU
    decoder of the card's file follows (the card's symbols, the CPU's μ)."""
    from iclr_17_compression_tpu_torch.coding.gaussian import default_scale_table, scale_indices
    from iclr_17_compression_tpu_torch.models import cheng2020, hyperprior
    from iclr_17_compression_tpu_torch.ops.precision import promoted

    model, cpu = promoted(model), promoted(cpu)
    table = default_scale_table()
    with torch.no_grad():
        y_t = model.g_a(x) if joint else model.Encoder(x)
        z = np.round((model.h_a(y_t) if joint else model.priorEncoder(y_t))[0].cpu().numpy())
    if not joint:
        tids = [scale_indices(hyperprior.sigma_of(mod, z), table) for mod in (model, cpu)]
        return int((tids[0] != tids[1]).sum()), int(tids[0].size)
    host = cheng2020._HostARContext(model)
    y = y_t[0].cpu().numpy()
    stream, max_sym, _, tids = cheng2020.ar_encode(host, y, cheng2020._hyper(model, z, dev),
                                                   model.scale_bound)
    syms = cheng2020.default_gaussian_codec(max_sym).decode(stream, tids)
    base = host.prep(cheng2020._hyper(cpu, z, torch.device("cpu")))
    lh, lw, n = y.shape
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


def calibrated_codecs(torch, dev, gen, x0, n: int = HYPER_N, m: int = HYPER_M) -> tuple:
    """The hyper phase's seeded hyperprior, hyperprior-sigma (the same
    weights) and joint-AR models on ``dev``, every GDN off the identity and
    calibrated on the image tensor ``x0``: the spread of y and z, σ in a
    trained model's range (hyperprior σ = exp(N(log 2, 0.5²)), joint σ ≈
    N(2, 0.5²), μ ≈ N(0, 0.5²)), and each decoder stage at a unit scale with
    the recon near [0, 1] (the random IGDNs square their input, so a raw
    5×5 decoder reaches 1e6)."""
    from iclr_17_compression_tpu_torch.models.cheng2020 import JointAutoregressive
    from iclr_17_compression_tpu_torch.models.hyperprior import ScaleHyperprior

    hp = gdn_off_identity_(torch, ScaleHyperprior(n, m).init_(gen), gen).to(dev).eval()
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
    jm = gdn_off_identity_(torch, JointAutoregressive(n).init_(gen), gen).to(dev).eval()
    spread_channels_(torch, jm.g_a[6], lambda: jm.g_a(x0), HYPER_Y_STD)
    spread_channels_(torch, jm.h_a[8], lambda: jm.h_a(jm.g_a(x0)), HYPER_Z_STD)
    ep_mean = torch.cat([torch.full((n,), 2.0), torch.zeros(n)]).to(dev)
    spread_channels_(torch, jm.entropy_parameters[4], lambda: jm(x0), 0.5, ep_mean)
    spread_channels_(torch, jm.g_s[7][0], lambda: jm.g_s(torch.round(jm.g_a(x0))), 0.2, 0.5)
    return hp, hps, jm


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

    def tensor(img):
        return torch.from_numpy(codec_cli.pad_to_multiple(img, 64)[None]).to(dev)

    x0 = tensor(images[0])
    hp, hps, jm = calibrated_codecs(torch, dev, gen, x0, n, m)
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
        return sigma_flips(torch, dev, name == "joint", models[name], cpu_models[name],
                           tensor(img))

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
    # the numpy file of the first image's crop (cut for time)
    comp_np, y_np = cheng2020.compress(jm, tensor(crop_img), return_y_hat=True,
                                       backend="numpy")
    _, y_np_dec = cheng2020.decompress(jm, comp_np, return_y_hat=True, backend="numpy")
    check(np.array_equal(y_np, y_np_dec), "joint: a numpy-backend file does not round-trip")

    lap("host_ar")

    # ---- one joint encode + decode of the first image's crop under the
    # profiler, its device activity only (on the whole image, 132,539
    # kernels, the section took 28 s on the H100 machine; with the host's
    # activity too, 39 s)
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        codec_cli.decode_image(codec_cli.encode_image(crop_img, jm, device=device), jm,
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
          "profile_joint": {"shape": list(crop_img.shape), "wall_ms": prof_wall,
                            "device_busy_ms": busy,
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


def fusion_pair(h: int = DSC_H, w: int = DSC_W):
    """The fusion phase's synthetic stereo pair: (left, right, the generator
    that drew them, for what the phase draws next)."""
    rng = np.random.default_rng(8)
    left = smooth_image(rng, h, w)
    return left, shift_pair(left, rng), rng


def fusion_model(torch, dev, preset: str, x):
    """The fusion phase's seeded model of ``preset`` (one of
    FUSION_PRESETS): the port's init, every GDN off the identity, the code
    spread to CODE_SPREAD on the image ``x`` and taken in steps."""
    from iclr_17_compression_tpu_torch.models.dsc import DSC_PRESETS, DSCStereoModel

    cfg = DSC_PRESETS[preset]
    gen = torch.Generator().manual_seed(FUSION_SEED + FUSION_PRESETS.index(preset))
    model = gdn_off_identity_(torch, DSCStereoModel(cfg).init_(gen), gen).to(dev).eval()
    last, takers = fusion_code_ends(model)
    spread_channels_(torch, last, lambda: model.encode(x), CODE_SPREAD)
    with torch.no_grad():
        for conv in takers:
            conv.weight.div_(cfg.coarse_step)
    return model


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

    left, right, rng = fusion_pair(h, w)
    x = torch.from_numpy(left[None]).to(dev)
    y = torch.from_numpy(right[None]).to(dev)
    launches = dict.fromkeys(counts(), 0)
    serving, k3_rows, models = {}, [], {}
    for i, preset in enumerate(FUSION_PRESETS):
        cfg = DSC_PRESETS[preset]
        model = fusion_model(torch, dev, preset, x)
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


def k2_work_bf16(args, out):
    """(conv product flops, GDN product flops, elementwise flops, bytes) of
    one K2 call on bf16 storage: x, the weight and the output 2 bytes an
    element, the bias and the GDN parameters 4."""
    x, w, b, gamma_t = args[:4]
    _, ho, wo, cout = out.shape
    kk, cin = w.shape[0], w.shape[2]
    p = out.shape[0] * ho * wo
    conv = 2.0 * p * kk * kk * cin * cout
    gdn = 2.0 * p * cout * cout if gamma_t is not None else 0.0
    elementwise = (p * cout if b is not None else 0.0) + (4.0 * p * cout if gdn else 0.0)
    nbytes = 2.0 * (x.numel() + w.numel() + out.numel()) + 4.0 * (
        (cout if b is not None else 0) + (cout * cout + cout if gdn else 0))
    return conv, gdn, elementwise, nbytes


def bound_bf16_ms(bf16_flops: float, tf32x3_flops: float, elementwise_flops: float,
                  nbytes: float):
    """The least time of a bf16-storage kernel: its bf16 products at the
    bf16 dense peak, its fp32-accurate products (K2's GDN norm) as three
    TF32 products, the elementwise work in fp32, against its bytes."""
    t_ops = (bf16_flops / PEAK_BF16_FLOPS + 3.0 * tf32x3_flops / PEAK_TF32_FLOPS
             + elementwise_flops / PEAK_FP32_FLOPS)
    t_bytes = nbytes / PEAK_HBM_BYTES
    return 1e3 * max(t_ops, t_bytes), ("operations" if t_ops >= t_bytes else "bytes")


def bf16_ulp_check(torch, out, ref) -> tuple:
    """(every element within one bf16 ulp of the plain version's, or within
    ATOL where the value sits near zero; the share that differ at all; the
    largest absolute difference)."""
    out, ref = out.float(), ref.float()
    big = torch.maximum(out.abs(), ref.abs()).clamp_min(1e-30)
    ulp = torch.exp2(torch.floor(torch.log2(big)) - 7)
    diff = (out - ref).abs()
    ok = bool(torch.all((diff <= ulp) | (diff <= ATOL)))
    return ok, float((diff > 0).float().mean()), float(diff.max())


def bpp_y_fp32_rate(torch, out: dict, joint: bool) -> float:
    """bpp_y of a forward's ŷ, σ (and the joint's μ) with the rate terms
    evaluated in fp32: what bf16 storage alone moves, apart from the rate
    arithmetic, which the JAX package runs in the storage's dtype."""
    from iclr_17_compression_tpu_torch.models import cheng2020, hyperprior

    y_hat, sigma = out["latent"].float(), out["sigma"].float()
    if joint:
        delta = y_hat - out["mu"].float()
        prob = (cheng2020.normal_cdf((delta + 0.5) / sigma)
                - cheng2020.normal_cdf((delta - 0.5) / sigma))
    else:
        prob = hyperprior.laplace_cdf(y_hat + 0.5, sigma) - hyperprior.laplace_cdf(y_hat - 0.5,
                                                                                  sigma)
    n, h, w, _ = y_hat.shape
    return float(cheng2020._clip_bits(prob).sum()) / (n * h * w * 256)


def realism_fix_(torch, model, x) -> None:
    """bench_joint_host_codec's realism fix (bench.py:310-334), in place:
    the analysis' last conv scaled so that y has a std of REALISM_Y_STD on
    ``x``, and the joint's σ half of the entropy parameters' last bias raised
    by REALISM_SIGMA_BIAS (a trained model's calibrated scales; a
    hyperprior's σ comes from its hyper decoder, untouched)."""
    joint = hasattr(model, "g_a")
    last = model.g_a[6] if joint else model.Encoder.conv4
    with torch.no_grad():
        y0 = model.g_a(x) if joint else model.Encoder(x)
        gain = REALISM_Y_STD / max(float(y0.std()), 1e-6)
        last.weight.mul_(gain)
        last.bias.mul_(gain)
        if joint:
            model.entropy_parameters[4].bias[: model.n] += REALISM_SIGMA_BIAS


def precision_phase(torch, dev, tools, trace_child=None) -> dict:
    """bf16 storage and blocked image I/O on the card (see the module
    docstring). ``tools`` holds the harness of ``main``: check, emit,
    time_ms, call_ms, compare, new_row, floor_ms. Returns the bf16 kernel
    rows, the fp32 K2 row at the blocked conv1 and the bf16 launches."""
    import copy

    from torch.profiler import ProfilerActivity, profile

    from iclr_17_compression_tpu_torch.models.balle17 import Balle17Compressor
    from iclr_17_compression_tpu_torch.models.dsc import DSCDecoder, quantize_code
    from iclr_17_compression_tpu_torch.ops import precision
    from iclr_17_compression_tpu_torch.ops.conv import depth_to_space, space_to_depth
    from iclr_17_compression_tpu_torch.ops.gdn import gdn_reparam
    from iclr_17_compression_tpu_torch.ops.kernels import conv_gdn_kernel as k2
    from iclr_17_compression_tpu_torch.ops.kernels import gdn_kernel as k1
    from iclr_17_compression_tpu_torch.ops.kernels import quant_pack_kernel as k3
    from iclr_17_compression_tpu_torch.train.weights import load_balle17, load_dsc

    check, emit, time_ms, call_ms = tools.check, tools.emit, tools.time_ms, tools.call_ms
    bf = torch.bfloat16
    t_phase = time.perf_counter()
    rng = np.random.default_rng(PREC_SEED)
    keys = ("conv_gdn", "gdn", "quantize_pack")

    def counts():
        return {"conv_gdn": (k2.conv_gdn.launches, k2.conv_gdn.launches_bf16),
                "gdn": (k1.gdn_fused.launches, k1.gdn_fused.launches_bf16),
                "quantize_pack": (k3.quantize_pack.launches, k3.quantize_pack.launches_bf16)}

    def zero_counts():
        for fn in (k2.conv_gdn, k1.gdn_fused, k3.quantize_pack):
            fn.launches = fn.launches_bf16 = 0

    def by_dtype(c):
        """{kernel: {"fp32": n, "bf16": n}} of a counts() reading."""
        return {k: {"fp32": tot - b16, "bf16": b16} for k, (tot, b16) in c.items()}

    # ---- the Ballé-17 headline: the archived lam2048 weights, batch 8 at
    # 768×512, in the four forms (fp32 / bf16 storage × unblocked / io_block 4)
    base = load_balle17(CKPT, device="cuda")
    blocked = Balle17Compressor(N_CH, io_block=4).to(dev).eval()
    blocked.load_state_dict(base.state_dict())
    models = {("fp32", 1): base, ("fp32", 4): blocked,
              ("bf16", 1): precision.cast_storage(copy.deepcopy(base), bf),
              ("bf16", 4): precision.cast_storage(copy.deepcopy(blocked), bf)}
    imgs = torch.from_numpy(np.stack([smooth_image(rng) for _ in range(PREC_BATCH)])).to(dev)
    inputs = {(dt, s): (space_to_depth(imgs, s) if s > 1 else imgs).to(
        torch.float32 if dt == "fp32" else bf).contiguous() for dt, s in models}
    outs, forms, form_launches = {}, {}, {}
    with torch.no_grad():
        for form, model in models.items():
            zero_counts()
            out = model(inputs[form])
            torch.cuda.synchronize()
            form_launches[f"{form[0]}_io{form[1]}"] = by_dtype(counts())
            recon = out["recon"].float()
            outs[form] = {"recon": depth_to_space(recon, form[1]) if form[1] > 1 else recon,
                          "latent": out["latent"].float(), "bpp": float(out["bpp"]),
                          "mse": float(out["mse"])}
            fwd_ms = time_ms(lambda: model(inputs[form]), warmup=2, reps=5, batch=2)
            forms[f"{form[0]}_io{form[1]}"] = {
                "forward_ms": fwd_ms,
                "mpix_per_s": PREC_BATCH * IMG_H * IMG_W / (fwd_ms * 1e3),
                "bpp": outs[form]["bpp"], "mse": outs[form]["mse"]}
    for name, got in form_launches.items():
        dt = name[:4]
        other = "fp32" if dt == "bf16" else "bf16"
        want = {"conv_gdn": 3, "gdn": 2, "quantize_pack": 0}
        check(all(got[k][dt] == want[k] and got[k][other] == 0 for k in keys),
              f"Ballé {name}: launches {got}, expected K2 3 and K1 2 of {dt} only")
    x32 = imgs
    # blocked against unblocked in fp32: the same model up to conv1's and
    # deconv3's sum order
    a, b = outs[("fp32", 1)], outs[("fp32", 4)]
    flips = (a["latent"] != b["latent"])
    blk = {"latent_flip_share": float(flips.float().mean()),
           "latent_max_step": float((a["latent"] - b["latent"]).abs().max()),
           "recon_psnr_db": float(10 * torch.log10(1 / ((a["recon"] - b["recon"]) ** 2).mean()
                                               .clamp_min(1e-20))),
           "bpp_rel": abs(a["bpp"] - b["bpp"]) / a["bpp"], "mse_rel": abs(a["mse"] - b["mse"]) / a["mse"]}
    check(blk["latent_flip_share"] <= LATENT_FLIP_FRAC and blk["latent_max_step"] <= 1,
          f"blocked vs unblocked fp32 latents: {blk}")
    check(blk["recon_psnr_db"] >= BLOCKED_PSNR_DB and blk["bpp_rel"] <= BLOCKED_RATE_REL
          and blk["mse_rel"] <= BLOCKED_RATE_REL, f"blocked vs unblocked fp32: {blk}")
    # bf16 against fp32 in each layout, under the JAX bf16 test's criteria
    crit = {}
    for s in (1, 4):
        r32, rbf = outs[("fp32", s)], outs[("bf16", s)]
        d2 = ((r32["recon"] - rbf["recon"]) ** 2).mean()
        dist = ((r32["recon"] - x32) ** 2).mean()
        c = {"mse_ratio": float(d2 / dist), "max_abs": float((r32["recon"] - rbf["recon"]).abs().max()),
             "bpp_rel": abs(r32["bpp"] - rbf["bpp"]) / max(r32["bpp"], 1e-9),
             "latent_flip_share": float((r32["latent"] != rbf["latent"]).float().mean()),
             "psnr_vs_fp32_db": float(10 * torch.log10(1 / d2.clamp_min(1e-20)))}
        check(c["mse_ratio"] < 0.05 and c["max_abs"] < 0.1 and c["bpp_rel"] < 0.05,
              f"Ballé bf16 vs fp32 io_block={s}: {c}")
        crit[f"io{s}"] = c

    # where the bf16 headline's device time goes: one forward traced in a
    # fresh process, set up beforehand (start_headline_trace)
    torch.cuda.empty_cache()
    if trace_child is None:
        trace_child = start_headline_trace()
    try:
        out, err = trace_child.communicate("go\n", timeout=TRACE_CHILD_S)
    except subprocess.TimeoutExpired:
        trace_child.kill()
        out, err = trace_child.communicate()
    lines = [ln for ln in out.splitlines() if ln.startswith("{")]
    check(trace_child.returncode == 0 and bool(lines),
          f"the bf16 headline's traced process failed: {err[-2000:]}")
    trace = json.loads(lines[-1])
    prof_by_kernel, prof_wall = trace["device_ms_by_kernel"], trace["wall_ms"]
    prof_busy = sum(prof_by_kernel.values())

    # ---- the kernels against their plain versions at the headline's shapes
    rows = {"conv_gdn_bf16": tools.new_row(library=True),
            "gdn_bf16": tools.new_row(library=False)}
    for row in rows.values():
        row.update(share_diff=0.0, bf16_flops=0.0, tf32x3_flops=0.0)

    def add(row, shape, conv, gdn, elementwise, nbytes):
        b_ms, b_by = bound_bf16_ms(conv, gdn, elementwise, nbytes)
        shape.update(bound_ms=b_ms, bound_by=b_by)
        for key in ("ms", "call_ms", "plain_ms", "library_ms"):
            if row.get(key) is not None and key in shape:
                row[key] += shape[key]
        row["bound_ms"] += b_ms
        row["bf16_flops"] += conv
        row["tf32x3_flops"] += gdn
        row["flops"] += conv + gdn + elementwise
        row["bytes"] += nbytes
        row["bound_by"] = bound_bf16_ms(row["bf16_flops"], row["tf32x3_flops"],
                                        row["flops"] - row["bf16_flops"] - row["tf32x3_flops"],
                                        row["bytes"])[1]
        row["shapes"].append(shape)

    def hold_bf16(out, ref, what, row):
        check(out.dtype == bf and bool(torch.isfinite(out.float()).all()), f"{what}: {out.dtype}")
        ok, share, err = bf16_ulp_check(torch, out, ref)
        check(ok, f"{what}: beyond one bf16 ulp of the plain version (max abs {err:.3e})")
        row["max_abs_err"] = max(row["max_abs_err"], err)
        row["share_diff"] = max(row["share_diff"], share)
        return share

    def measure_k2_bf16(args, where, row):
        out = k2.conv_gdn(*args)
        again = k2.conv_gdn(*args)
        ref = k2.conv_gdn_plain(*args)
        torch.cuda.synchronize()
        share = hold_bf16(out, ref, f"K2 bf16 {where}", row)
        check(torch.equal(out, again), f"K2 bf16 {where}: two calls differ")
        x, w, b, gamma_t, beta, stride, pad = args[:7]
        inverse = bool(args[7]) if len(args) > 7 else False
        oihw = w.permute(3, 2, 0, 1).contiguous()
        xc = x.permute(0, 3, 1, 2)

        def library():  # cuDNN's bf16 conv, then the plain GDN in fp32 rounded to bf16
            y = torch.nn.functional.conv2d(xc, oihw, None if b is None else b.to(bf),
                                           stride=stride, padding=pad)
            if gamma_t is not None:
                k1.gdn_fused_plain(y.permute(0, 2, 3, 1).float(), gamma_t, beta, inverse).to(bf)

        _, ho, wo, cout = out.shape
        shape = {"where": where, "x": list(x.shape), "w": list(w.shape), "stride": stride,
                 "gdn": gamma_t is not None, "share_diff": share,
                 # the wrapper's plan: its tile, no K split, no partials
                 "bm": k2.tile_bf16(out.shape[0] * ho * wo, w.shape[0] ** 2 * w.shape[2], cout,
                                    k2.sm_count(0)),
                 "splits": 1, "partial_bytes": 0,
                 "ms": time_ms(lambda: k2.conv_gdn(*args)),
                 "call_ms": call_ms(lambda: k2.conv_gdn(*args)),
                 "plain_ms": time_ms(lambda: k2.conv_gdn_plain(*args)),
                 "library_ms": time_ms(library)}
        xf, wf = x.float(), w.float().contiguous()
        fargs = (xf, wf) + tuple(args[2:])
        shape["fp32_ms"] = time_ms(lambda: k2.conv_gdn(*fargs))
        add(row, shape, *k2_work_bf16(args, out))

    def measure_k1_bf16(x, gdn, where, row):
        beta, gamma = gdn_reparam(gdn.params())
        gamma_t, beta, inv = gamma.t().contiguous().to(bf), beta.float(), gdn.inverse
        out = k1.gdn_fused(x, gamma_t, beta, inv)
        again = k1.gdn_fused(x, gamma_t, beta, inv)
        ref = k1.gdn_fused_plain(x, gamma_t, beta, inv)
        torch.cuda.synchronize()
        share = hold_bf16(out, ref, f"K1 bf16 {where}", row)
        check(torch.equal(out, again), f"K1 bf16 {where}: two calls differ")
        xf, gf = x.float(), gamma_t.float()
        c = x.shape[-1]
        p = x.numel() // c
        shape = {"where": where, "x": list(x.shape), "inverse": inv, "share_diff": share,
                 "ms": time_ms(lambda: k1.gdn_fused(x, gamma_t, beta, inv)),
                 "call_ms": call_ms(lambda: k1.gdn_fused(x, gamma_t, beta, inv)),
                 "plain_ms": time_ms(lambda: k1.gdn_fused_plain(x, gamma_t, beta, inv)),
                 "fp32_ms": time_ms(lambda: k1.gdn_fused(xf, gf, beta, inv))}
        add(row, shape, 2.0 * p * c * c, 0.0, 4.0 * p * c, 2.0 * 2 * x.numel() + 2.0 * c * c + 4.0 * c)

    mb = models[("bf16", 4)]
    with torch.no_grad():
        enc = mb.Encoder
        xb = inputs[("bf16", 4)]
        y = xb
        stages = []
        for conv, gdn, where in ((enc.conv1, enc.gdn1, "balle conv1 blocked 3x3 s1"),
                                 (enc.conv2, enc.gdn2, "balle conv2 5x5 s2"),
                                 (enc.conv3, None, "balle conv3 5x5 s2")):
            if gdn is not None:
                beta, gamma = gdn_reparam(gdn.params())
                gamma_t, beta = gamma.t().contiguous().float(), beta.float()
            else:
                gamma_t = beta = None
            if conv.input_block > 1:
                w, stride, pad = conv.blocked_weight(), 1, 1
            else:
                w, stride, pad = conv.weight.permute(2, 3, 1, 0), conv.stride[0], conv.padding[0]
            b = None if conv.bias is None else conv.bias.float()
            # the weight as conv_gdn_module hands it: K-major rows seen as HWIO
            args = (y, k2.k_major_hwio(w.to(bf)), b, gamma_t, beta, stride, pad)
            stages.append((args, where))
            y = k2.conv_gdn_plain(*args)
        # the unblocked conv1 (Cin = 3: ordinary loads into shared memory)
        c1 = models[("bf16", 1)].Encoder
        beta, gamma = gdn_reparam(c1.gdn1.params())
        stages.append(((inputs[("bf16", 1)], k2.k_major_hwio(c1.conv1.weight.permute(2, 3, 1, 0)),
                        c1.conv1.bias.float(), gamma.t().contiguous().float(), beta.float(), 4, 4),
                       "balle conv1 9x9 s4 (unblocked)"))
        for args, where in stages:
            measure_k2_bf16(args, where, rows["conv_gdn_bf16"])
        # the trace sees K2 bf16: the profiled forward's three launches
        # against the three stages' CUDA-event time
        trace_k2 = trace["k2_bf16_ms"]
        events_ms = sum(sh["ms"] for sh in rows["conv_gdn_bf16"]["shapes"][:3])
        trace_k2_check = {"launches": len(trace_k2), "trace_ms": sum(trace_k2),
                          "events_ms": events_ms, "ratio": sum(trace_k2) / events_ms,
                          "band": TRACE_K2_BAND}
        check(len(trace_k2) == 3 and TRACE_K2_BAND[0] <= trace_k2_check["ratio"]
              <= TRACE_K2_BAND[1],
              f"the bf16 headline's trace holds K2 bf16 as {trace_k2_check}, expected 3 "
              f"launches within {TRACE_K2_BAND} of the stages' CUDA-event ms")
        lat = torch.round(y)
        dec = mb.Decoder
        z = dec.deconv1(lat)
        measure_k1_bf16(z.contiguous(), dec.igdn1, "balle igdn1", rows["gdn_bf16"])
        z = dec.deconv2(dec.igdn1(z))
        measure_k1_bf16(z.contiguous(), dec.igdn2, "balle igdn2", rows["gdn_bf16"])

        # fp32 K2 at the blocked conv1 (rtol 1e-4 / atol 1e-5, as every K2 check)
        fp_row = tools.new_row(library=True)
        args32 = tuple(t.float().contiguous() if isinstance(t, torch.Tensor) else t
                       for t in stages[0][0])
        out = k2.conv_gdn(*args32)
        ref = k2.conv_gdn_plain(*args32)
        torch.cuda.synchronize()
        tools.compare(out, ref, "K2 fp32 blocked conv1", fp_row)
        oihw = args32[1].permute(3, 2, 0, 1).contiguous()
        fp_row.update(
            x=list(args32[0].shape), w=list(args32[1].shape),
            splits=k2.plan_splits(out.shape[0] * out.shape[1] * out.shape[2], 9,
                                  k2.block_slots(0, N_CH)),
            ms=time_ms(lambda: k2.conv_gdn(*args32)),
            call_ms=call_ms(lambda: k2.conv_gdn(*args32)),
            plain_ms=time_ms(lambda: k2.conv_gdn_plain(*args32)),
            library_ms=time_ms(lambda: k1.gdn_fused_plain(torch.nn.functional.conv2d(
                args32[0].permute(0, 3, 1, 2), oihw, args32[2], padding=1).permute(0, 2, 3, 1),
                args32[3], args32[4])))
        mma, elementwise, nbytes = k2_work(args32, out)
        fp_row["bound_ms"], fp_row["bound_by"] = bound_3xtf32_ms(mma, elementwise, nbytes)

    # ---- the DSC flagship's serving split in bf16 and fp32: the archived
    # weights, batch 4 at 320×1216
    from iclr_17_compression_tpu_torch.models.dsc import DSC_PRESETS

    dsc32 = load_dsc(FLAGSHIP, DSC_PRESET, device="cuda")
    dscbf = precision.cast_storage(copy.deepcopy(dsc32), bf)
    cfg = DSC_PRESETS[DSC_PRESET]
    lefts = [smooth_image(rng, DSC_H, DSC_W) for _ in range(PREC_PAIRS)]
    im1 = torch.from_numpy(np.stack(lefts)).to(dev)
    im2 = torch.from_numpy(np.stack([shift_pair(a, rng) for a in lefts])).to(dev)
    split = {}
    with torch.no_grad():
        for dt, model in (("fp32", dsc32), ("bf16", dscbf)):
            a1, a2 = (im1, im2) if dt == "fp32" else (im1.to(bf), im2.to(bf))
            receiver = DSCDecoder(cfg, model=model)

            def serve():
                symbols, code = quantize_code(model.encode(a1), cfg)
                return symbols, code, receiver(code, a2)

            zero_counts()
            symbols, code, recon = serve()
            torch.cuda.synchronize()
            got = by_dtype(counts())
            other = "fp32" if dt == "bf16" else "bf16"
            check(all(got[k][other] == 0 for k in keys) and got["conv_gdn"][dt] == 11
                  and got["quantize_pack"][dt] == 1 and got["gdn"][dt] == 0,
                  f"DSC split {dt}: launches {got}, expected K2 4 + 7 and K3 1 of {dt} only")
            serve_ms = time_ms(serve, warmup=2, reps=5, batch=1)
            split[dt] = {"symbols": symbols, "recon": recon.float(), "code": code,
                         "launches": got, "serving_ms": serve_ms,
                         "mpix_per_s": PREC_PAIRS * DSC_H * DSC_W / (serve_ms * 1e3)}
    s32, sbf = split["fp32"], split["bf16"]
    sym_share = float((s32["symbols"] != sbf["symbols"]).float().mean())
    d2 = ((s32["recon"] - sbf["recon"]) ** 2).mean()
    dsc_crit = {"symbol_share_differ": sym_share, "symbols": int(s32["symbols"].numel()),
                "recon_psnr_vs_fp32_db": float(10 * torch.log10(1 / d2.clamp_min(1e-20))),
                "mse_ratio": float(d2 / ((s32["recon"] - im1) ** 2).mean()),
                "max_abs": float((s32["recon"] - sbf["recon"]).abs().max())}
    check(sym_share <= DSC_SYMBOL_SHARE and dsc_crit["recon_psnr_vs_fp32_db"] >= DSC_BF16_PSNR_DB
          and dsc_crit["mse_ratio"] < 0.05 and dsc_crit["max_abs"] < 0.1,
          f"DSC bf16 split vs fp32: {dsc_crit}")

    # K3 bf16 on the DSC code (step 16, 8-bit) and the Ballé latent (step 1,
    # 16-bit), bit-exact against the plain version
    with torch.no_grad():
        code_pre = dscbf.encode(im1.to(bf)).contiguous()
        lat16 = models[("bf16", 4)].Encoder(inputs[("bf16", 4)]).contiguous()
        k3_row = {"shapes": [], "max_abs_err": 0.0, "ms": 0.0, "call_ms": 0.0, "plain_ms": 0.0,
                  "bound_ms": 0.0, "library_ms": None}
        for x, step, clip, bits, where in ((code_pre, 16.0, 128.0, 8, "dsc code"),
                                           (lat16, 1.0, 32767.0, 16, "balle latent")):
            sym, deq = k3.quantize_pack(x, step, clip, bits)
            rsym, rdeq = k3.quantize_pack_plain(x, step, clip, bits)
            torch.cuda.synchronize()
            check(torch.equal(sym, rsym) and torch.equal(deq, rdeq) and deq.dtype == bf,
                  f"K3 bf16 {where}: not bit-exact")
            n = x.numel()
            b_ms, b_by = bound_ms(5.0 * n, (5.0 if bits == 8 else 6.0) * n)
            shape = {"where": where, "x": list(x.shape), "step": step, "bits": bits,
                     "ms": time_ms(lambda: k3.quantize_pack(x, step, clip, bits)),
                     "call_ms": call_ms(lambda: k3.quantize_pack(x, step, clip, bits)),
                     "plain_ms": time_ms(lambda: k3.quantize_pack_plain(x, step, clip, bits)),
                     "fp32_ms": time_ms(lambda: k3.quantize_pack(x.float(), step, clip, bits)),
                     "bound_ms": b_ms, "bound_by": b_by}
            for key in ("ms", "call_ms", "plain_ms", "bound_ms"):
                k3_row[key] += shape[key]
            k3_row["bound_by"] = b_by
            k3_row["shapes"].append(shape)
        k3_row["launch_floor_ms"] = tools.floor_ms
    rows["quantize_pack_bf16"] = k3_row

    # the DSC K2 sites in bf16 against plain: g_a's last stride block and
    # g_s's first upsample block at the split's shapes
    from iclr_17_compression_tpu_torch.nn.blocks import ResidualBlockUpsample, ResidualBlockWithStride

    with torch.no_grad():
        hooks, seen = [], []
        sites = [m for m in dscbf.modules()
                 if isinstance(m, (ResidualBlockWithStride, ResidualBlockUpsample))]
        for site in (sites[0], sites[-1]):
            hooks.append(site.register_forward_pre_hook(
                lambda mod, a: seen.append((mod, a[0])) if len(seen) < 2 else None))
        DSCDecoder(cfg, model=dscbf)(sbf["code"], im2.to(bf))  # g_a over the SI, then g_s
        for h in hooks:
            h.remove()
        for site, xin in seen:
            args = block_k2_args(site, xin)
            args = (args[0], k2.k_major_hwio(args[1].to(bf)), args[2].float(), args[3].float(),
                    args[4].float()) + tuple(args[5:])
            kind = "rbs conv2 + GDN" if hasattr(site, "gdn") else "rbu conv + IGDN"
            measure_k2_bf16(args, f"dsc {kind} {list(xin.shape)}", rows["conv_gdn_bf16"])

    # ---- the joint-AR and hyperprior codecs on bf16 storage (ROADMAP item
    # 22): bench_joint's configuration (N = 192, JOINT_BATCH images of
    # 512×768, bf16 storage and bf16 images) on a fresh seeded init, and with
    # bench_joint_host_codec's realism fix; the hyperprior (N = 192, M = 320)
    # on the same images
    from iclr_17_compression_tpu_torch.models import cheng2020, hyperprior
    from iclr_17_compression_tpu_torch.models.cheng2020 import JointAutoregressive
    from iclr_17_compression_tpu_torch.models.hyperprior import ScaleHyperprior

    gen = torch.Generator().manual_seed(PREC_SEED)
    batch = torch.from_numpy(np.stack([smooth_image(rng) for _ in range(JOINT_BATCH)])).to(dev)
    cal_hp, _, cal_jm = calibrated_codecs(torch, dev, gen, batch[:1], HYPER_N, HYPER_M)
    hyper_rows, hyper_launches = {}, dict.fromkeys(keys, 0)
    for kind in ("joint", "hyperprior"):
        joint = kind == "joint"
        fresh = (JointAutoregressive(HYPER_N) if joint else ScaleHyperprior(HYPER_N, HYPER_M))
        fresh = fresh.init_(gen).to(dev).eval()
        fixed = copy.deepcopy(fresh)
        realism_fix_(torch, fixed, batch[:1])
        for variant, m32 in (("fresh", fresh), ("realism", fixed),
                             ("calibrated", cal_jm if joint else cal_hp)):
            mbf = precision.cast_storage(copy.deepcopy(m32), bf)
            xb = batch.to(bf)
            with torch.no_grad():
                zero_counts()
                out = mbf(xb)
                torch.cuda.synchronize()
                got = by_dtype(counts())
                want = {"conv_gdn": 6, "gdn": 0, "quantize_pack": 0} if joint else {
                    "conv_gdn": 3, "gdn": 3, "quantize_pack": 0}
                check(all(got[k]["bf16"] == want[k] and got[k]["fp32"] == 0 for k in keys),
                      f"{kind} {variant} bf16 forward: launches {got}, expected {want} in bf16")
                if variant == "calibrated":
                    for k in keys:
                        hyper_launches[k] += got[k]["bf16"]
                fwd_ms = time_ms(lambda: mbf(xb), warmup=1, reps=3, batch=1)
                row = hyper_rows[f"{kind}_{variant}"] = {
                    "launches": got, "forward_ms": fwd_ms,
                    "mpix_per_s": JOINT_BATCH * IMG_H * IMG_W / (fwd_ms * 1e3),
                    "bpp": float(out["bpp"]), "bpp_y": float(out["bpp_y"]),
                    "bpp_z": float(out["bpp_z"]),
                    "latent_nonzero_share": float((out["latent"] != 0).float().mean())}
                if variant == "fresh":  # its latents round to almost all zeros
                    continue
                # bf16 against fp32 on the first PREC_CRIT_IMAGES images (what
                # is held where: the constants' comment)
                xs = batch[:PREC_CRIT_IMAGES]
                o32, obf = m32(xs), mbf(xs.to(bf))
                decoder = mbf.g_s if joint else mbf.Decoder
                same = torch.clamp(decoder(o32["latent"].to(bf)), 0.0, 1.0).float()
            r32, rb = o32["recon"], obf["recon"].float()
            d2 = ((r32 - rb) ** 2).mean()
            bpp_y32 = float(o32["bpp_y"])
            c = {"mse_ratio": float(d2 / ((r32 - xs) ** 2).mean()),
                 "max_abs": float((r32 - rb).abs().max()),
                 "same_latent_max_abs": float((r32 - same).abs().max()),
                 "bpp_rel": abs(float(o32["bpp"]) - float(obf["bpp"])) / max(float(o32["bpp"]),
                                                                             1e-9),
                 "bpp_y_fp32_rate_rel": abs(bpp_y_fp32_rate(torch, obf, joint) - bpp_y32)
                 / max(bpp_y32, 1e-9),
                 "latent_flip_share": float((o32["latent"] != obf["latent"].float())
                                            .float().mean()),
                 "bpp_fp32": float(o32["bpp"]), "bpp_bf16": float(obf["bpp"])}
            check(c["mse_ratio"] < 0.05 and (variant != "calibrated" or (
                c["bpp_y_fp32_rate_rel"] < 0.05 and c["same_latent_max_abs"] < 0.1)),
                  f"{kind} {variant} bf16 vs fp32: {c}")
            row["bf16_vs_fp32"] = c
            if variant != "calibrated":
                continue

            # where the bf16 forward's device time goes (cuDNN's bf16 route)
            with torch.no_grad(), profile(activities=[ProfilerActivity.CPU,
                                                      ProfilerActivity.CUDA]) as prof:
                mbf(xb)
                torch.cuda.synchronize()
            by_k = device_ms_by_kernel(torch, prof)
            row["profile"] = {
                "device_busy_ms": sum(by_k.values()),
                "device_ms_by_kernel": dict(sorted(by_k.items(), key=lambda kv: -kv[1])[:10])}

            # the kernels at the new shapes, one image: K2 bf16 at the joint's
            # 3×3 s1 blocks / the hyperprior's 5×5 s2 analysis, K1 bf16 at the
            # hyperprior's IGDNs, against their plain versions
            x1 = batch[:1].to(bf)
            with torch.no_grad():
                if joint:
                    seen = {}
                    sites = {"joint g_a[2] rbs conv2 + GDN": mbf.g_a[2],
                             "joint g_s[3] rbu conv + IGDN": mbf.g_s[3]}
                    hooks = [b.register_forward_pre_hook(
                        lambda mod, a, w=w: seen.setdefault(w, a[0])) for w, b in sites.items()]
                    mbf.g_s(torch.round(mbf.g_a(x1)))
                    for hk in hooks:
                        hk.remove()
                    for where, block in sites.items():
                        a = block_k2_args(block, seen[where])
                        a = (a[0], k2.k_major_hwio(a[1].to(bf)), a[2].float(), a[3].float(),
                             a[4].float()) + tuple(a[5:])
                        measure_k2_bf16(a, where, rows["conv_gdn_bf16"])
                else:
                    y = x1
                    enc = mbf.Encoder
                    for i, (conv, gdn) in enumerate(((enc.conv1, enc.gdn1), (enc.conv2, enc.gdn2),
                                                     (enc.conv3, enc.gdn3))):
                        beta, gamma = gdn_reparam(gdn.params())
                        a = (y, k2.k_major_hwio(conv.weight.permute(2, 3, 1, 0).to(bf)),
                             conv.bias.float(), gamma.t().contiguous().float(), beta.float(), 2, 2)
                        measure_k2_bf16(a, f"hyperprior conv{i + 1} 5x5 s2 + GDN",
                                        rows["conv_gdn_bf16"])
                        y = k2.conv_gdn_plain(*a)
                    z = mbf.Decoder.deconv1(torch.round(enc.conv4(y)))
                    for i, igdn in enumerate((mbf.Decoder.igdn1, mbf.Decoder.igdn2,
                                              mbf.Decoder.igdn3)):
                        measure_k1_bf16(z.contiguous(), igdn, f"hyperprior igdn{i + 1}",
                                        rows["gdn_bf16"])
                        z = getattr(mbf.Decoder, f"deconv{i + 2}")(igdn(z))

            # one 768×512 file from the bf16-stored weights: compressed and
            # decompressed on the card (fp32 arithmetic on the bf16-rounded
            # weights, as the JAX functions' dtype promotion would), ŷ equal;
            # σ's scale-index flips between the card and the CPU
            codec = cheng2020 if joint else hyperprior
            x1 = batch[:1]
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            comp, y_hat = codec.compress(mbf, x1, return_y_hat=True)
            t1 = time.perf_counter()
            rec, y_dec = codec.decompress(mbf, comp, return_y_hat=True)
            t2 = time.perf_counter()
            check(np.array_equal(y_hat, y_dec) and np.isfinite(rec).all(),
                  f"{kind} file from bf16 weights: ŷ decoded differs from the encoder's")
            cpu = (JointAutoregressive(HYPER_N) if joint else ScaleHyperprior(HYPER_N, HYPER_M))
            cpu.load_state_dict({k: v.cpu() for k, v in mbf.state_dict().items()})
            flips, elements = sigma_flips(torch, dev, joint, mbf, cpu.eval(), x1)
            row["file"] = {
                "bytes": comp.num_bits // 8, "bpp": comp.num_bits / (IMG_H * IMG_W),
                "encode_ms": 1e3 * (t1 - t0), "decode_ms": 1e3 * (t2 - t1),
                "sigma_flips": flips, "elements": elements,
                "recon_psnr_db": float(10 * np.log10(1 / max(float(np.mean(
                    (rec - batch[:1].cpu().numpy()) ** 2)), 1e-20)))}

    # off the main paths: K1 bf16 at the other widths it takes (C % 32 == 0
    # up to 512: γᵀ's fragments in shared memory up to 256, read from device
    # memory past it), K2 bf16 at Cout = 192 unsplit and split and at 256
    gen = torch.Generator().manual_seed(PREC_SEED)
    off_k1, off_k2 = [], []
    with torch.no_grad():
        for c in (64, 96, 192, 256, 512):
            x = (torch.randn((2, 16, 24, c), generator=gen) * 0.8).to(dev, bf)
            gamma_t = (torch.rand((c, c), generator=gen) * 0.03).to(dev, bf)
            beta = (torch.rand(c, generator=gen) + 0.5).to(dev)
            for inverse in (False, True):
                out = k1.gdn_fused(x, gamma_t, beta, inverse)
                again = k1.gdn_fused(x, gamma_t, beta, inverse)
                ref = k1.gdn_fused_plain(x, gamma_t, beta, inverse)
                torch.cuda.synchronize()
                hold_bf16(out, ref, f"K1 bf16 C={c} inverse={inverse}", rows["gdn_bf16"])
                check(torch.equal(out, again), f"K1 bf16 C={c}: two calls differ")
            off_k1.append(f"C={c} 2x16x24")
        for (h, wd, k, stride, cout) in ((256, 288, 5, 2, 192), (128, 192, 5, 2, 192),
                                         (64, 96, 3, 1, 256)):
            xs = (torch.randn((1, h, wd, N_CH), generator=gen) * 0.5).to(dev, bf)
            ws = (torch.randn((k, k, N_CH, cout), generator=gen) / (k * k * N_CH) ** 0.5).to(
                dev, bf)
            bs = (torch.randn(cout, generator=gen) * 0.01).to(dev)
            gs = (torch.rand((cout, cout), generator=gen) * 0.02).to(dev)
            betas = (torch.rand(cout, generator=gen) + 0.5).to(dev)
            for inverse in (False, True):
                args = (xs, ws, bs, gs, betas, stride, k // 2, inverse)
                out = k2.conv_gdn(*args)
                again = k2.conv_gdn(*args)
                ref = k2.conv_gdn_plain(*args)
                torch.cuda.synchronize()
                hold_bf16(out, ref, f"K2 bf16 Cout={cout} {h}x{wd} inverse={inverse}",
                          rows["conv_gdn_bf16"])
                check(torch.equal(out, again), f"K2 bf16 Cout={cout} {h}x{wd}: two calls differ")
            pixels = (h // stride) * (wd // stride)
            off_k2.append(f"Cout={cout} {h}x{wd} {k}x{k} s{stride} "
                          f"bm={k2.tile_bf16(pixels, k * k * N_CH, cout, k2.sm_count(0))}")
    rows["gdn_bf16"]["checked_off_path"] = off_k1
    rows["conv_gdn_bf16"]["checked_off_path"] = off_k2

    # the two bf16 kernels as built: ptxas's registers, shared memory and
    # spills, and their tensor-core instructions in the SASS (K2 bf16 must
    # issue wgmma, HGMMA, and no bf16 mma.sync)
    bf16_build = {}
    if dev.type == "cuda":
        from iclr_17_compression_tpu_torch.ops.kernels import _build

        ptxas = ptxas_report((_build.BUILD_DIR / "libiclr17c_kernels.so.log").read_text())
        sass = sass_report(_build.BUILD_DIR / "libiclr17c_kernels.so")
        bf16_build = {name: {**ptxas.get(name, {}), **sass.get(name, {})}
                      for name in sorted(set(ptxas) | set(sass))
                      if name.startswith(("conv_gdn_bf16_kernel", "gdn_rows_bf16_kernel"))}
        k2_sass = {n: v for n, v in bf16_build.items() if n.startswith("conv_gdn_bf16_kernel")}
        check(bool(k2_sass) and all(v.get("HGMMA", 0) > 0 and v.get("HMMA_BF16", 0) == 0
                                    for v in k2_sass.values()),
              f"K2 bf16's SASS: {k2_sass}, expected HGMMA and no bf16 HMMA in every instance")

    # the policy's flags under high and default, restored after
    flags = {}
    before = precision.current_flags()
    for name in ("high", "default"):
        with precision.precision_scope(name), torch.no_grad():
            base(inputs[("fp32", 1)][:1])  # a forward applies the policy again
            flags[name] = list(precision.current_flags())
    after = precision.current_flags()
    check(flags == {"high": [True, "high"], "default": [True, "medium"]}
          and before == after == (False, "highest"),
          f"policy flags: before {before}, under {flags}, after {after}")

    seconds = time.perf_counter() - t_phase
    launches = {k: form_launches["bf16_io4"][k]["bf16"] + split["bf16"]["launches"][k]["bf16"]
                + hyper_launches[k] for k in keys}
    check(all(launches[k] > 0 for k in keys), f"bf16 launches on the main paths: {launches}")
    result = {"phase": "precision", "ok": True, "batch": PREC_BATCH, "shape": [IMG_H, IMG_W, 3],
              "dsc_pairs": PREC_PAIRS, "dsc_shape": [DSC_H, DSC_W, 3], "forms": forms,
              "form_launches": form_launches, "blocked_vs_unblocked_fp32": blk,
              "bf16_vs_fp32": crit,
              "dsc_split": {dt: {k: v for k, v in split[dt].items()
                                 if k in ("launches", "serving_ms", "mpix_per_s")}
                            for dt in split},
              "dsc_bf16_vs_fp32": dsc_crit,
              "profile_bf16_io4": {"wall_ms": prof_wall, "device_busy_ms": prof_busy,
                                   "device_idle_share": 1.0 - prof_busy / prof_wall,
                                   "k2_bf16_in_trace": trace_k2_check,
                                   "launch_lead_ms": trace["launch_lead_ms"],
                                   "device_ms_by_kernel": dict(sorted(
                                       prof_by_kernel.items(), key=lambda kv: -kv[1])[:12])},
              "joint_hyperprior_bf16": hyper_rows, "joint_batch": JOINT_BATCH,
              "policy_flags": flags, "bf16_launches": launches,
              "k2_bf16": rows["conv_gdn_bf16"], "k1_bf16": rows["gdn_bf16"],
              "k3_bf16": k3_row, "k2_fp32_blocked_conv1": fp_row,
              "bf16_kernels_build": bf16_build, "seconds": seconds}
    emit(result)
    print(f"precision phase seconds: {seconds:.1f}", flush=True)
    return {"rows": rows, "k2_fp32_blocked_conv1": fp_row, "launches": launches}


def tiled_phase(torch, dev, tools) -> dict:
    """Tiled serving on the card (see the module docstring), every tile on
    cuda:0. ``tools`` holds the harness of ``main``. Returns the K2 row at
    the tiles' (p, 0) padding and the launches of the tiled paths."""
    from iclr_17_compression_tpu_torch.coding import api
    from iclr_17_compression_tpu_torch.models.dsc import DSCDecoder, code_symbols, quantize_code
    from iclr_17_compression_tpu_torch.ops.gdn import gdn_reparam
    from iclr_17_compression_tpu_torch.ops.kernels import conv_gdn_kernel as k2
    from iclr_17_compression_tpu_torch.ops.kernels import gdn_kernel as k1
    from iclr_17_compression_tpu_torch.ops.kernels import quant_pack_kernel as k3
    from iclr_17_compression_tpu_torch.parallel import (
        TiledStreams, decode_streams_to_code, encode_tiles_to_streams, gather_tiles, make_mesh,
        make_tiled_codec, make_tiled_dsc, pam_eval_ring, split_tiles)
    from iclr_17_compression_tpu_torch.parallel.tiled import TileRun
    from iclr_17_compression_tpu_torch.parallel.halo import halo_exchange_w, tiled_conv_gdn
    from iclr_17_compression_tpu_torch.train.weights import load_balle17, load_dsc

    check, emit, time_ms = tools.check, tools.emit, tools.time_ms
    t_phase = time.perf_counter()
    rng = np.random.default_rng(TILED_SEED)
    keys = ("conv_gdn", "gdn", "quantize_pack")

    def counts():
        return {"conv_gdn": k2.conv_gdn.launches, "gdn": k1.gdn_fused.launches,
                "quantize_pack": k3.quantize_pack.launches}

    def reset():
        k2.conv_gdn.launches = k1.gdn_fused.launches = k3.quantize_pack.launches = 0

    def host_ms(fn, reps: int = 5) -> float:
        """Median wall time of a synchronized call (the host's enqueue and
        the device's work), after one warm-up."""
        fn()
        times = []
        for _ in range(reps):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            times.append(1e3 * (time.perf_counter() - t0))
        return statistics.median(times)

    def psnr_db(a, b) -> float:
        return float(10 * torch.log10(1 / ((a - b) ** 2).mean().clamp_min(1e-20)))

    launches = dict.fromkeys(keys, 0)
    paths = {}

    # ---- Ballé-17: the archived lam2048 (N = 128) in TILES W-tiles, one
    # 768×512 image and one 3840×2160 frame
    model = load_balle17(CKPT, device=str(dev))
    cpu_model = load_balle17(CKPT, device="cpu")
    mesh = make_mesh(1, TILES, [dev] * TILES)
    enc, dec = make_tiled_codec(model, mesh)
    _, cpu_dec = make_tiled_codec(cpu_model, make_mesh(1, TILES, ["cpu"] * TILES))
    frames = [(f"{IMG_W}x{IMG_H}", smooth_image(rng)),
              (f"{TILED_FRAME_W}x{TILED_FRAME_H}", smooth_image(  # smooth_image takes × 64
                  rng, -(-TILED_FRAME_H // 64) * 64, TILED_FRAME_W)[:TILED_FRAME_H])]
    k2_rows = tools.new_row(library=True)
    for i, (name, img) in enumerate(frames):
        x = torch.from_numpy(img[None]).to(dev)
        torch.cuda.synchronize()
        reset()
        latent = enc(x)
        recon = dec(latent)
        torch.cuda.synchronize()
        got = counts()
        for k in keys:
            launches[k] += got[k]
        check(got == {"conv_gdn": 3 * TILES, "gdn": 2 * TILES, "quantize_pack": TILES},
              f"tiled Ballé {name}: launches {got}, expected K2 3, K1 2, K3 1 a tile")
        with torch.no_grad():
            whole = k3.quantize_pack(model.Encoder(x), 1.0, 32767.0, bits=16)[1]
            whole_recon = torch.clamp(model.Decoder(whole), 0.0, 1.0)
        lat, rec = gather_tiles(latent), gather_tiles(recon)
        flips = lat != whole
        res = {"tiles": TILES, "tile_widths": [t.shape[2] for t in latent],
               "launches": got, "latent_flip_share": float(flips.float().mean()),
               "latent_max_step": float((lat - whole).abs().max()),
               "recon_psnr_vs_untiled_db": psnr_db(rec, whole_recon),
               "recon_max_abs_vs_untiled": float((rec - whole_recon).abs().max())}
        check(res["latent_flip_share"] <= LATENT_FLIP_FRAC and res["latent_max_step"] <= 1
              and res["recon_psnr_vs_untiled_db"] >= TILED_PSNR_DB,
              f"tiled Ballé {name} against untiled: {res}")
        # per-tile streams against one set of tables (the whole latent's range)
        lo, hi = int(lat.min()), int(lat.max())
        codec = api.build_cdf_tables_from_bit_estimator(model.bitEstimator.params(), lo, hi)
        t0 = time.perf_counter()
        ts = encode_tiles_to_streams(latent, codec, TILES)
        t1 = time.perf_counter()
        back = decode_streams_to_code(ts, codec)
        t2 = time.perf_counter()
        check(np.array_equal(back, lat.cpu().numpy()), f"tiled Ballé {name}: per-tile streams "
                                                       "do not decode to the encoder's symbols")
        blob = ts.serialize()
        # the CPU decodes the card's serialized streams with its own tables
        cpu_codec = api.build_cdf_tables_from_bit_estimator(cpu_model.bitEstimator.params(),
                                                            lo, hi)
        cpu_code = decode_streams_to_code(TiledStreams.deserialize(blob), cpu_codec)
        check(np.array_equal(cpu_code, back), f"tiled Ballé {name}: the CPU's decode of the "
                                              "card's streams differs")
        if i == 0:  # the CPU's tiled receiver on the card's streams
            cpu_rec = gather_tiles(cpu_dec(torch.from_numpy(cpu_code)))
            err = float((cpu_rec - rec.cpu()).abs().max())
            check(err <= DECODE_ATOL, f"tiled Ballé {name}: CPU vs card recon {err:.2e}")
            res["cpu_recon_max_abs_err"] = err
        res.update(bytes=len(blob), bpp=8.0 * len(blob) / (img.shape[0] * img.shape[1]),
                   stream_bytes=[len(s) for s in ts.streams],
                   host_rans_ms={"encode": 1e3 * (t1 - t0), "decode": 1e3 * (t2 - t1)})
        with torch.no_grad():
            def untiled():
                w = k3.quantize_pack(model.Encoder(x), 1.0, 32767.0, bits=16)[1]
                return model.Decoder(w)

            res["device_ms"] = {"tiled": time_ms(lambda: dec(enc(x)), warmup=2, reps=5,
                                                 batch=1),
                                "untiled": time_ms(untiled, warmup=2, reps=5, batch=1)}
            res["host_ms"] = {"tiled": host_ms(lambda: dec(enc(x))), "untiled": host_ms(untiled)}
        paths[f"balle_{name}"] = res

    # K2 at a tile's (p, 0) padding: the 3840×2160 frame's second tile, each
    # encoder stage on its input with the halo columns, against plain
    enc_m = model.Encoder
    with torch.no_grad():
        tiles = split_tiles(torch.from_numpy(frames[1][1][None]).to(dev), mesh)
        for conv, gdn, where in ((enc_m.conv1, enc_m.gdn1, "conv1 9x9 s4"),
                                 (enc_m.conv2, enc_m.gdn2, "conv2 5x5 s2"),
                                 (enc_m.conv3, None, "conv3 5x5 s2")):
            k, s, p = conv.kernel_size[1], conv.stride[1], conv.padding[1]
            halo = halo_exchange_w(tiles, p, max(k - s - p, 0))[1]
            if gdn is not None:
                beta, gamma = gdn_reparam(gdn.params())
                gamma_t, beta = gamma.t().contiguous(), beta.contiguous()
            else:
                gamma_t = beta = None
            args = (halo, conv.weight.permute(2, 3, 1, 0).contiguous(), conv.bias, gamma_t, beta,
                    s, (p, 0))
            tools.measure_k2(args, k2_rows, f"K2 tile {where} (p, 0)", cudnn_k1=gdn is not None)
            k2_rows["shapes"][-1]["where"] = f"4K tile 2 of {TILES}, {where}, padding ({p}, 0)"
            tiles = tiled_conv_gdn(tiles, [conv] * TILES, [gdn] * TILES)

    # ---- the DSC flagship (archived weights) in DSC_TILES W-tiles, and the
    # pam_0031bpp preset (the fusion phase's seeded weights) in DSC_TILES
    # H-tiles and through the W-tiled ring PAM
    lefts = smooth_image(rng, DSC_H, DSC_W)
    rights = shift_pair(lefts, rng)
    fl, fr, _ = fusion_pair()
    x_fl = torch.from_numpy(fl[None]).to(dev)
    att = fusion_model(torch, dev, "att_0031bpp", x_fl)
    cases = (("flagship_w", load_dsc(FLAGSHIP, DSC_PRESET, device=str(dev)), "width", lefts,
              rights),
             ("pam_h", fusion_model(torch, dev, "pam_0031bpp", x_fl), "height", fl, fr),
             # the fusion presets whose modules see the whole latent: those
             # modules on the gathered tiles (TileRun.whole)
             ("fif_w", fusion_model(torch, dev, "fif_0031bpp", x_fl), "width", fl, fr),
             ("att_w", att, "width", fl, fr), ("att_h", att, "height", fl, fr),
             ("bottleneck_att_w", fusion_model(torch, dev, "bottleneck_att_1bpp", x_fl),
              "width", fl, fr))
    mesh2 = make_mesh(1, DSC_TILES, [dev] * DSC_TILES)
    fusion_launches = dict.fromkeys(keys, 0)
    k3_tile_rows = []
    for name, dsc, axis, left, right in cases:
        cfg = dsc.config
        x, y = (torch.from_numpy(a[None]).to(dev) for a in (left, right))
        t_enc, t_dec = make_tiled_dsc(dsc, mesh2, axis=axis)
        whole = cfg.fusion_pre == "fif" or cfg.fusion_post in ("bot_att", "patch_att")
        t_case = time.perf_counter()
        torch.cuda.synchronize()
        reset()
        code = t_enc(x)
        recon = t_dec(code, y)
        torch.cuda.synchronize()
        got = counts()
        for k in keys:
            launches[k] += got[k]
            if whole:
                fusion_launches[k] += got[k]
        check(got == {"conv_gdn": 11 * DSC_TILES, "gdn": 0, "quantize_pack": DSC_TILES},
              f"tiled DSC {name}: launches {got}, expected K2 4 + 7 and K3 1 a tile")
        receiver = DSCDecoder(cfg, model=dsc)
        with torch.no_grad():
            whole_code = quantize_code(dsc.encode(x), cfg)[1]
            code_t = gather_tiles(code, axis)
            whole_recon = receiver(code_t, y)  # the tiled code: the receivers alone compared
        rec = gather_tiles(recon, axis)
        lim, _ = code_symbols(cfg)
        step = float(cfg.coarse_step)
        syms = torch.round(code_t / step).to(torch.int64).cpu().numpy()
        codec = api.build_cdf_tables_from_histogram(syms, offset=-lim, nsym=2 * lim + 1)
        dim = 2 if axis == "width" else 1
        ts = encode_tiles_to_streams(code, codec, DSC_TILES, step=step, axis=dim)
        back = decode_streams_to_code(ts, codec, step=step, axis=dim)
        res = {"preset": cfg.name, "axis": axis, "tiles": DSC_TILES, "launches": got,
               "launches_per_tile": {k: v / DSC_TILES for k, v in got.items()},
               "whole_fusion_module": whole,
               "code_flip_share": float((code_t != whole_code).float().mean()),
               "code_max_step": float((code_t - whole_code).abs().max()) / step,
               "recon_psnr_vs_untiled_db": psnr_db(rec, whole_recon),
               "recon_max_abs_vs_untiled": float((rec - whole_recon).abs().max()),
               "stream_bytes": [len(s) for s in ts.streams]}
        check(res["code_flip_share"] <= LATENT_FLIP_FRAC and res["code_max_step"] <= 1
              and res["recon_psnr_vs_untiled_db"] >= TILED_PSNR_DB,
              f"tiled DSC {name} against untiled: {res}")
        check(np.array_equal(back, code_t.cpu().numpy()),
              f"tiled DSC {name}: per-tile streams do not decode to the code")
        if whole:
            # K3 on a tile's own code (the tiled encoder's g_a22 output on tile
            # 2 of 2) against its plain version: bit-exact
            with torch.no_grad():
                run = TileRun([dsc] * DSC_TILES, axis)
                pre = run.stack("g_a22", run.stack("g_a", split_tiles(x, mesh2, axis)))[1]
            k3_sym, k3_code = quantize_code(pre, cfg)
            r_sym, r_code = k3.quantize_pack_plain(pre, step, cfg.code_clip)
            check(torch.equal(k3_sym, r_sym) and torch.equal(k3_code, r_code),
                  f"tiled DSC {name}: K3 on a tile's code is not bit-exact")
            n3 = pre.numel()
            b_ms, b_by = tools.bound_ms(5.0 * n3, 9.0 * n3)
            k3_tile_rows.append({
                "where": f"{cfg.name} {axis}-tile 2 of {DSC_TILES}", "x": list(pre.shape),
                "step": step, "bits": 8, "ms": time_ms(lambda: quantize_code(pre, cfg)),
                "plain_ms": time_ms(lambda: k3.quantize_pack_plain(pre, step, cfg.code_clip)),
                "bound_ms": b_ms, "bound_by": b_by, "launch_floor_ms": tools.floor_ms,
                "library_ms": None, "max_abs_err": 0.0})
        # the CPU decodes the card's serialized streams with tables of its own
        cpu_codec = api.build_cdf_tables_from_histogram(syms, offset=-lim, nsym=2 * lim + 1)
        cpu_back = decode_streams_to_code(TiledStreams.deserialize(ts.serialize()), cpu_codec,
                                          step=step, axis=dim)
        check(np.array_equal(cpu_back, back),
              f"tiled DSC {name}: the CPU's decode of the card's streams differs")
        with torch.no_grad():
            res["device_ms"] = {
                "tiled": time_ms(lambda: t_dec(t_enc(x), y), warmup=2, reps=5, batch=1),
                "untiled": time_ms(lambda: receiver(quantize_code(dsc.encode(x), cfg)[1], y),
                                   warmup=2, reps=5, batch=1)}
            res["host_ms"] = {
                "tiled": host_ms(lambda: t_dec(t_enc(x), y)),
                "untiled": host_ms(lambda: receiver(quantize_code(dsc.encode(x), cfg)[1], y))}
        res["seconds"] = time.perf_counter() - t_case
        paths[f"dsc_{name}"] = res
        if cfg.fusion_post != "pam":
            continue
        # the ring PAM in W-tiles against the replicated PAM, on the PAM's own
        # inputs in the receiver
        seen = []
        hook = dsc.pam.register_forward_pre_hook(lambda mod, a: seen.append(a[:2]))
        with torch.no_grad():
            receiver(code_t, y)
        hook.remove()
        fused, z2 = seen[0]
        with torch.no_grad():
            ref = dsc.pam(fused, z2, train=False)
            ring = gather_tiles(pam_eval_ring(dsc.pam, fused, z2, mesh2))
        err = float((ring - ref).abs().max())
        check(bool(torch.all((ring - ref).abs() <= ATOL + RTOL * ref.abs())),
              f"ring PAM against replicated: max abs {err:.2e} beyond rtol {RTOL} / atol {ATOL}")
        paths["ring_pam"] = {"tiles": DSC_TILES, "x": list(fused.shape), "max_abs_err": err,
                             "device_ms": {"ring": time_ms(lambda: pam_eval_ring(
                                 dsc.pam, fused, z2, mesh2)), "replicated": time_ms(
                                 lambda: dsc.pam(fused, z2, train=False))}}

    seconds = time.perf_counter() - t_phase
    emit({"phase": "tiled", "ok": True, "paths": paths, "launches": launches,
          "launches_fusion": fusion_launches, "k2_tile_padding": k2_rows,
          "k3_fusion_tiles": k3_tile_rows, "seconds": seconds})
    print(f"tiled phase seconds: {seconds:.1f}", flush=True)
    return {"launches": launches, "launches_fusion": fusion_launches, "k2": k2_rows,
            "k3": k3_tile_rows}


def mesh_train_phase(torch, dev, tools, hw: int = 256, kitti_dir: str = KITTI_TRAIN_DIR,
                     balle_n: int = N_CH, hyper_n: int = HYPER_N, hyper_m: int = HYPER_M,
                     dsc_preset: str = DSC_PRESET, balle_steps: int = MESH_BALLE_STEPS,
                     cli_img: int = 320) -> dict:
    """The training mesh on one card (ROADMAP items 20b-20d), every slot on
    ``dev`` (see the module docstring). ``tools`` holds the harness of
    ``main``. Returns the launches of the mesh paths (and of the steps on
    meshes with a tile axis), the K2 rows (a Ballé and a hyperprior tile's
    conv2 at (p, 0); Cout = 160 with a split) and the K1 rows (C = 160; a
    hyperprior tile's IGDN3)."""
    from torch.profiler import ProfilerActivity, profile

    from iclr_17_compression_tpu_torch.data.datasets import (StereoKittiDataset, batch_iterator,
                                                             write_ppm)
    from iclr_17_compression_tpu_torch.ops import gdn as ops_gdn
    from iclr_17_compression_tpu_torch.ops.gdn import gdn_reparam
    from iclr_17_compression_tpu_torch.ops.kernels import conv_gdn_kernel as k2
    from iclr_17_compression_tpu_torch.ops.kernels import gdn_kernel as k1
    from iclr_17_compression_tpu_torch.ops.kernels import quant_pack_kernel as k3
    from iclr_17_compression_tpu_torch.parallel import make_mesh, split_tiles
    from iclr_17_compression_tpu_torch.parallel.halo import (TileLayers, halo_exchange_w,
                                                             tiled_hyperprior_train,
                                                             tiled_joint_train)
    from iclr_17_compression_tpu_torch.train import cli as train_cli
    from iclr_17_compression_tpu_torch.train.config import TrainConfig
    from iclr_17_compression_tpu_torch.train.dryrun import dryrun_multichip
    from iclr_17_compression_tpu_torch.train.mesh_step import shard_train_step
    from iclr_17_compression_tpu_torch.train.trainers import make_stereo_dataset
    from iclr_17_compression_tpu_torch.train.state import (build_model, create_train_state,
                                                           make_balle17_train_step,
                                                           make_dsc_train_step,
                                                           make_hyperprior_train_step,
                                                           step_generator)
    from iclr_17_compression_tpu_torch.utils.device import cudnn_autotune, cudnn_deterministic

    check, emit = tools.check, tools.emit
    t_phase = time.perf_counter()
    keys = ("conv_gdn", "gdn", "quantize_pack")
    launches = dict.fromkeys(keys, 0)
    tile_launches = dict.fromkeys(keys, 0)  # the steps on meshes with a tile axis
    section_s, t_lap = {}, [t_phase]

    def lap(name):
        now = time.perf_counter()
        section_s[name] = now - t_lap[0]
        t_lap[0] = now

    def counts():
        return {"conv_gdn": k2.conv_gdn.launches, "gdn": k1.gdn_fused.launches,
                "quantize_pack": k3.quantize_pack.launches}

    def reset():
        k2.conv_gdn.launches = k1.gdn_fused.launches = k3.quantize_pack.launches = 0

    def counted(fn):
        """``fn()`` with the counters reset just before and read just after,
        added to the phase's launches: (its result, its launches)."""
        torch.cuda.synchronize()
        reset()
        out = fn()
        torch.cuda.synchronize()
        got = counts()
        for k in keys:
            launches[k] += got[k]
        return out, got

    def mesh_of(shape):
        return make_mesh(*shape, [dev] * (shape[0] * shape[1]))

    def ms_pair(fn):
        """(host ms: wall around a synchronized call, CUDA-event ms around it)."""
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        start.record()
        out = fn()
        end.record()
        torch.cuda.synchronize()
        return out, 1e3 * (time.perf_counter() - t0), start.elapsed_time(end)

    def profiled(fn) -> dict:
        """One call under torch.profiler (device activity only): its wall
        ms, device busy ms and idle share."""
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            _, wall, _ = ms_pair(fn)
        busy = sum(device_ms_by_kernel(torch, prof).values())
        return {"wall_ms": wall, "device_busy_ms": busy,
                "device_idle_share": 1.0 - busy / wall if busy else None}

    def runs(model0, make_step, shape, batches, n_steps, flags, per_slot, seed, lr, clip):
        """``n_steps`` steps of the split step on ``shape`` from a copy of
        ``model0`` (its own Adam), batch i % len(batches), noise from
        (seed, step): each step's metrics, host and event ms and launches
        (checked: ``per_slot`` a slot), and one more step profiled."""
        mesh = mesh_of(shape)
        slots = shape[0] * shape[1]
        state = create_train_state(copy.deepcopy(model0), lr=lr, grad_clip=clip)
        step = shard_train_step(make_step(), mesh, len(batches[0]))
        rows = []
        for i in range(n_steps):
            args = batches[i % len(batches)]
            gen = step_generator(seed, i, dev)
            with flags():
                (metrics, host, event), got = counted(lambda: ms_pair(
                    lambda: step(state, *args, gen)))
            want = {k: v * slots for k, v in per_slot.items()}
            check(got == want, f"mesh {shape}: step {i + 1} launches {got}, expected {want}")
            if shape[1] > 1:
                for k in keys:
                    tile_launches[k] += got[k]
            rows.append({"metrics": {k: float(v) for k, v in metrics.items()},
                         "host_ms": host, "event_ms": event})
        args = batches[n_steps % len(batches)]
        gen = step_generator(seed, n_steps, dev)
        with flags():
            prof = profiled(lambda: step(state, *args, gen))
        timed = rows[1:] or rows  # the first step of several warms up
        return {"mesh": list(shape), "steps": rows, "profile": prof,
                "median_host_ms": statistics.median(r["host_ms"] for r in timed),
                "median_event_ms": statistics.median(r["event_ms"] for r in timed),
                "launches_per_step": {k: v * slots for k, v in per_slot.items()}}

    def step_grads(model0, make_step, shape, args, flags, seed, swap=None, rel=0.0,
                   draw=DSC_PERTURB_SEEDS[0]):
        """The summed gradients (unclamped) of one step from a copy of
        ``model0`` on ``shape``, noise from (seed, 0); ``swap`` "plain" runs
        K2 and K1 as their plain versions, "perturbed" moves each of their
        outputs by ``rel``·N(0, 1) relative (draw ``draw``)."""
        model = copy.deepcopy(model0)
        state = create_train_state(model, grad_clip=float("inf"))
        step = shard_train_step(make_step(), mesh_of(shape), len(args))
        real = (k2.conv_gdn, ops_gdn.gdn_fused)
        gen_p = torch.Generator(device=dev).manual_seed(draw)

        def moved(fn):
            def call(*a):
                y = fn(*a)
                return y * (1.0 + rel * torch.randn(y.shape, generator=gen_p, device=y.device))
            return call

        if swap == "plain":
            k2.conv_gdn, ops_gdn.gdn_fused = k2.conv_gdn_plain, k1.gdn_fused_plain
        elif swap == "perturbed":
            k2.conv_gdn, ops_gdn.gdn_fused = moved(k2.conv_gdn_plain), moved(k1.gdn_fused_plain)
        try:
            with flags():
                metrics = step(state, *args, step_generator(seed, 0, dev))
        finally:
            k2.conv_gdn, ops_gdn.gdn_fused = real
        return ({k: float(v) for k, v in metrics.items()},
                {k: p.grad.clone() for k, p in model.named_parameters()})

    def gaps(ga, gb):
        """Each tensor's largest gap in shares of its largest |gradient| in
        ``gb``, at least MESH_GRAD_FLOOR_SHARE of the model's largest."""
        floor = MESH_GRAD_FLOOR_SHARE * max(float(g.abs().max()) for g in gb.values())
        return {k: float((ga[k] - gb[k]).abs().max()) / max(float(gb[k].abs().max()), floor,
                                                            1e-30)
                for k in gb}

    def stats(g, g_ref):
        """(the largest tensor's gap, the median tensor's gap)."""
        gap = list(gaps(g, g_ref).values())
        return max(gap), statistics.median(gap)

    def floor_gate(model0, make_step, args, flags, seed, split_shapes):
        """The dsc_train phase's gate on the split steps' step-1 gradients
        against the 1×1 step's: the floor, the plain 1×1 step against itself
        with K2's and K1's outputs moved by DSC_K2_PERTURB (the largest of
        DSC_PERTURB_SEEDS' draws), on the largest and on the median tensor's
        gap; the control at DSC_CONTROL_PERTURB must miss one of the two."""
        _, g_one = step_grads(model0, make_step, (1, 1), args, flags, seed)
        _, g_plain = step_grads(model0, make_step, (1, 1), args, flags, seed, "plain")
        draws = [stats(step_grads(model0, make_step, (1, 1), args, flags, seed, "perturbed",
                                  DSC_K2_PERTURB, d)[1], g_plain) for d in DSC_PERTURB_SEEDS]
        floor = (max(d[0] for d in draws), max(d[1] for d in draws))
        gate = (max(DSC_GRAD_TOL, DSC_FLOOR_FACTOR * floor[0]), DSC_FLOOR_FACTOR * floor[1])
        control = stats(step_grads(model0, make_step, (1, 1), args, flags, seed, "perturbed",
                                   DSC_CONTROL_PERTURB)[1], g_plain)
        out = {"floor": floor, "gate": gate, "control_gap": control,
               "control_missed": control[0] > gate[0] or control[1] > gate[1], "split": {}}
        for shape in split_shapes:
            gap = stats(step_grads(model0, make_step, shape, args, flags, seed)[1], g_one)
            out["split"][f"{shape[0]}x{shape[1]}"] = {"max_gap": gap[0], "median_gap": gap[1]}
            check(gap[0] <= gate[0] and gap[1] <= gate[1],
                  f"mesh {shape}: step-1 gradients against 1x1 {gap} beyond the gate {gate}")
        check(out["control_missed"], f"the TF32-size control {control} did not miss {gate}")
        return out

    def hold_step1(res, names, what):
        """Every mesh's step-1 metrics within RTOL of the 1×1 run's."""
        for shape, r in res.items():
            for k in names:
                a, want = r["steps"][0]["metrics"][k], res["1x1"]["steps"][0]["metrics"][k]
                check(abs(a - want) <= RTOL * abs(want),
                      f"{what} {shape}: step-1 {k} {a} vs 1x1 {want}")

    base = TrainConfig.from_json(os.path.join(ROOT, "examples", "balle17.json"))
    check((base.batch_size, base.image_size, base.train_lambda, base.lr_base,
           base.grad_clip) == (4, 256, 8192, 1e-4, 5.0),
          "examples/balle17.json is not the batch 4, 256 px, λ 8192 config")
    b, lam = base.batch_size, base.train_lambda
    rng = np.random.default_rng(MESH_SEED)
    gen = torch.Generator().manual_seed(MESH_SEED)
    crops = [torch.from_numpy(np.stack([smooth_image(rng, hw, hw) for _ in range(b)]))
             for _ in range(MESH_BATCHES)]
    result = {}

    # ---- Ballé-17 at examples/balle17.json's widths
    balle = build_model("balle17", device=dev, seed=MESH_SEED, out_channel_n=balle_n)
    deterministic = cudnn_deterministic
    balle_runs = {f"{d}x{t}": runs(balle, lambda: make_balle17_train_step(lam), (d, t),
                                   [(c,) for c in crops], balle_steps, deterministic,
                                   {"conv_gdn": 3, "gdn": 2, "quantize_pack": 0}, MESH_SEED,
                                   base.lr_base, base.grad_clip)
                  for d, t in BALLE_MESHES}
    one = balle_runs["1x1"]
    hold_step1(balle_runs, ("rd_loss", "mse", "bpp", "psnr"), "Ballé")
    last = one["steps"][-1]["metrics"]["rd_loss"]
    loss_gap = {k: r["steps"][-1]["metrics"]["rd_loss"] / last - 1.0
                for k, r in balle_runs.items()}
    check(all(abs(v) <= MESH_LOSS_REL for v in loss_gap.values()),
          f"Ballé step-{balle_steps} rd_loss against 1x1: {loss_gap}")
    _, g_one = step_grads(balle, lambda: make_balle17_train_step(lam), (1, 1), (crops[0],),
                          deterministic, MESH_SEED)
    balle_grads = {}
    for shape in BALLE_MESHES[1:]:
        _, g = step_grads(balle, lambda: make_balle17_train_step(lam), shape, (crops[0],),
                          deterministic, MESH_SEED)
        gp = gaps(g, g_one)
        worst = max(gp.values())
        balle_grads[f"{shape[0]}x{shape[1]}"] = {
            "max_gap": worst, "worst": sorted(((v, k) for k, v in gp.items()), reverse=True)[:3]}
        check(worst <= GRAD_TOL, f"Ballé {shape}: step-1 gradients {worst:.2e} from 1x1")
    result["balle17"] = {"n": balle_n, "batch": b, "crop": hw, "lambda": lam,
                         "runs": balle_runs, "step_last_rd_loss_gap": loss_gap,
                         "step1_grad_gap": balle_grads}
    lap("balle17")

    # K2's Function at a 2×2 tile's conv2 (its halo'd input at padding (p, 0))
    # against the plain path's autograd, forward and backward
    enc = balle.Encoder
    with torch.no_grad():
        y1 = k2.conv_gdn_module(crops[0][: b // 2].to(dev), enc.conv1, enc.gdn1)
        x_t = halo_exchange_w([t.contiguous() for t in torch.tensor_split(y1, 2, dim=2)],
                              2, 1)[1]
    beta2, gamma2 = gdn_reparam(enc.gdn2.params())
    leaves = [t.detach().clone().contiguous() for t in (
        x_t, enc.conv2.weight.permute(2, 3, 1, 0), enc.conv2.bias, gamma2.t(), beta2)]
    probe = None
    grads = {}
    for path, fn in (("kernel", k2.conv_gdn), ("plain", k2.conv_gdn_plain)):
        args = [t.clone().requires_grad_() for t in leaves]
        out = fn(*args, 2, (2, 0), False)
        if probe is None:
            probe = torch.randn(out.shape, generator=torch.Generator(device=dev).manual_seed(5),
                                device=dev)
        torch.sum(out * probe).backward()
        grads[path] = (out.detach(), [a.grad for a in args])
    k2_rows = tools.new_row(library=True)
    tools.compare(grads["kernel"][0], grads["plain"][0], "K2 tile conv2 (2, 0)", k2_rows)
    fn_gaps = [float((a - p).abs().max() / p.abs().max().clamp(min=1e-30))
               for a, p in zip(grads["kernel"][1], grads["plain"][1])]
    check(max(fn_gaps) <= GRAD_TOL, f"K2 Function backward at (2, 0): gaps {fn_gaps}")
    tools.measure_k2((leaves[0], leaves[1], leaves[2], leaves[3], leaves[4], 2, (2, 0)),
                     k2_rows, "K2 mesh tile conv2 (2, 0)", cudnn_k1=True)
    k2_rows["shapes"][-1]["where"] = "Ballé 2x2 mesh, a data part's tile 2 of 2: conv2 (2, 0)"
    result["k2_function_tile_conv2"] = {"x": list(x_t.shape), "backward_gaps_x_w_b_gt_beta":
                                        fn_gaps}

    # off the paths: C = 160, fp32 K1 (one warp row: two would be 320
    # threads) and K2's split reduction (conv_gdn_reduce_kernel)
    k1_rows = tools.new_row(library=False)
    with torch.no_grad():
        x160 = torch.randn((1, 64, 96, C160), generator=gen).to(dev)
        gt160 = (torch.rand((C160, C160), generator=gen) * 0.02).to(dev)
        be160 = (torch.rand(C160, generator=gen) + 0.5).to(dev)
        for inverse in (False, True):
            tools.compare(k1.gdn_fused(x160, gt160, be160, inverse),
                          k1.gdn_fused_plain(x160, gt160, be160, inverse),
                          f"K1 C={C160} inverse={inverse}", k1_rows)
        xs = (torch.randn((1, 32, 48, N_CH), generator=gen) * 0.5).to(dev)
        ws = (torch.randn((5, 5, N_CH, C160), generator=gen) / 80).to(dev)
        bs = (torch.randn(C160, generator=gen) * 0.01).to(dev)
        splits = k2.plan_splits(16 * 24, 25, k2.block_slots(0, C160))
        check(splits > 1, f"K2 Cout={C160}: {splits} splits, the reduction is not run")
        for inverse in (False, True):
            args = (xs, ws, bs, gt160, be160, 2, 2, inverse)
            tools.compare(k2.conv_gdn(*args), k2.conv_gdn_plain(*args),
                          f"K2 Cout={C160} splits={splits} inverse={inverse}", k2_rows)
    result["c160_off_path"] = {"k1": [list(x160.shape)], "k2": [list(xs.shape)],
                               "k2_splits": splits, "k1_max_abs_err": k1_rows["max_abs_err"],
                               "k2_max_abs_err": k2_rows["max_abs_err"]}
    lap("k2_k1_checks")

    # ---- the DSC flagship at dsc_0031bpp.json's widths on KITTI-layout crops
    dcfg = TrainConfig.from_json(os.path.join(ROOT, "examples", "dsc_0031bpp.json"))
    check((dcfg.model, dcfg.batch_size) == (f"dsc:{DSC_PRESET}", 2),
          "examples/dsc_0031bpp.json is not the temp_0031bpp, batch 2 config")
    dataset = make_stereo_dataset(dataclasses.replace(dcfg, train_dir=kitti_dir,
                                                      seed=MESH_SEED))
    pairs = [tuple(torch.from_numpy(a) for a in batch) for batch, _ in zip(
        batch_iterator(dataset, dcfg.batch_size, seed=MESH_SEED, epoch=0),
        range(MESH_DSC_STEPS + 1))]
    dsc = gdn_off_identity_(torch, build_model(f"dsc:{dsc_preset}", device="cpu",
                                               seed=MESH_SEED), gen).to(dev)
    lap("dsc_data_model")
    dsc_runs = {f"{d}x{t}": runs(dsc, make_dsc_train_step, (d, t), pairs, MESH_DSC_STEPS,
                                 deterministic, {"conv_gdn": 17, "gdn": 0, "quantize_pack": 0},
                                 MESH_SEED, dcfg.lr_base, dcfg.grad_clip) for d, t in DSC_MESHES}
    hold_step1(dsc_runs, ("loss", "loss_full", "loss_base", "loss_z"), "DSC")
    lap("dsc_runs")
    result["dsc"] = {"preset": dsc.config.name, "n": dsc.config.n, "batch": dcfg.batch_size,
                     "crop": list(pairs[0][0].shape[1:3]), "runs": dsc_runs,
                     "step1_grad_gate": floor_gate(dsc, make_dsc_train_step, pairs[0],
                                                   deterministic, MESH_SEED, DSC_MESHES[1:])}
    lap("dsc_gate")

    # ---- the hyperprior (both quantizers) and joint codecs at N = 192, M =
    # 320 on the data and tile axes (64-column W-tiles)
    hyper_slot = {"conv_gdn": 3, "gdn": 3, "quantize_pack": 0}
    hyper_models = {}
    for name, quant, meshes, n_steps, per_slot in (
            ("hyperprior", "round", HYPER_MESHES, MESH_STEPS, hyper_slot),
            ("hyperprior", "sigma-norm", SIGMA_NORM_MESHES, MESH_SIGMA_NORM_STEPS, hyper_slot),
            ("joint", None, JOINT_MESHES, MESH_STEPS,
             {"conv_gdn": 6, "gdn": 0, "quantize_pack": 0})):
        key = name if quant in (None, "round") else f"{name}_{quant}"
        model = build_model(name, device="cpu", seed=MESH_SEED, out_channel_n=hyper_n,
                            out_channel_m=hyper_m, n=hyper_n, quant=quant)
        model = gdn_off_identity_(torch, model, gen).to(dev)
        flags = cudnn_autotune if getattr(model, "train_cudnn_autotune", False) \
            else deterministic
        tiled = tiled_joint_train if name == "joint" else tiled_hyperprior_train
        make = lambda: make_hyperprior_train_step(lam, tiled=tiled)  # noqa: E731
        res = {f"{d}x{t}": runs(model, make, (d, t), [(c,) for c in crops], n_steps, flags,
                                per_slot, MESH_SEED, base.lr_base, base.grad_clip)
               for d, t in meshes}
        hold_step1(res, ("rd_loss", "mse", "bpp", "bpp_y", "bpp_z"), key)
        result[key] = {"n": hyper_n, "m": hyper_m, "quant": quant, "batch": b, "crop": hw,
                       "tile_unit": 64, "runs": res,
                       "step1_grad_gate": floor_gate(model, make, (crops[0],), flags,
                                                     MESH_SEED, meshes[1:])}
        hyper_models[key] = model
        lap(key)

    # K2 at a hyperprior tile's conv2 (5×5 s2, C = 192, its halo'd input at
    # padding (2, 0)) and K1 at its IGDN3 (C = 192), on the round model and
    # the first batch's second of two W-tiles, against plain
    hyper = hyper_models["hyperprior"]
    enc, dec = hyper.Encoder, hyper.Decoder
    seen = {}

    class Probe(TileLayers):
        """The transforms' own tiled run, each layer's input tiles kept."""

        def conv_gdn(self, x, conv, gdn):
            seen[conv] = x
            return super().conv_gdn(x, conv, gdn)

        def layer(self, x, name):
            seen[name] = x
            return super().layer(x, name)

    with torch.no_grad():
        tiles = split_tiles(crops[0].to(dev), [dev] * 2, unit=64)
        dec.transform(Probe([dec] * 2), [torch.round(t) for t in
                                         enc.transform(Probe([enc] * 2), tiles)])
        x2 = halo_exchange_w(seen["conv2"], 2, 1)[1]
        x_igdn3 = seen["igdn3"][1].contiguous()
    beta2, gamma2 = gdn_reparam(enc.gdn2.params())
    tools.measure_k2((x2, enc.conv2.weight.permute(2, 3, 1, 0).contiguous(), enc.conv2.bias,
                      gamma2.t().contiguous(), beta2.contiguous(), 2, (2, 0)), k2_rows,
                     "K2 hyperprior tile conv2 (2, 0)", cudnn_k1=True)
    k2_rows["shapes"][-1]["where"] = ("hyperprior 1x2 mesh, tile 2 of 2: conv2 5x5 s2, "
                                      f"C = {hyper_n}, padding (2, 0)")
    tools.measure_k1(x_igdn3, dec.igdn3, k1_rows, "K1 hyperprior tile IGDN3")
    k1_rows["shapes"][-1]["where"] = f"hyperprior 1x2 mesh, tile 2 of 2: IGDN3, C = {hyper_n}"
    result["hyperprior_tile_kernels"] = {"k2_x": list(x2.shape), "k1_x": list(x_igdn3.shape)}
    del hyper_models, hyper, enc, dec
    lap("hyperprior_tile_kernels")

    # ---- the fusion presets that train (FIF excepted: ROADMAP Queue 3) on
    # 1×2, their bottleneck attention and PAM on the gathered W-tiles
    fusion_data = StereoKittiDataset([kitti_dir], train=True,
                                     crop=(FUSION_MESH_CROP, FUSION_MESH_CROP), seed=MESH_SEED)
    fusion_pairs = [tuple(torch.from_numpy(a) for a in batch) for batch, _ in zip(
        batch_iterator(fusion_data, dcfg.batch_size, seed=MESH_SEED, epoch=0),
        range(MESH_FUSION_STEPS + 1))]
    for preset in FUSION_MESH_PRESETS:
        model = gdn_off_identity_(torch, build_model(f"dsc:{preset}", device="cpu",
                                                     seed=MESH_SEED), gen).to(dev)
        res = {f"{d}x{t}": runs(model, make_dsc_train_step, (d, t), fusion_pairs,
                                MESH_FUSION_STEPS, deterministic,
                                {"conv_gdn": 17, "gdn": 0, "quantize_pack": 0}, MESH_SEED,
                                dcfg.lr_base, dcfg.grad_clip) for d, t in FUSION_MESHES}
        hold_step1(res, ("loss", "loss_full", "loss_base", "loss_z"), preset)
        result[preset] = {"n": model.config.n, "batch": dcfg.batch_size,
                          "crop": list(fusion_pairs[0][0].shape[1:3]), "runs": res,
                          "step1_grad_gate": floor_gate(model, make_dsc_train_step,
                                                        fusion_pairs[0], deterministic,
                                                        MESH_SEED, FUSION_MESHES[1:])}
        del model
        lap(preset)

    # ---- the training CLI on a 2×2 mesh of one card, with its resume
    work = os.path.join(ROOT, "build", "chip_smoke_mesh_train")
    shutil.rmtree(work, ignore_errors=True)
    os.makedirs(os.path.join(work, "train"))
    for i in range(MESH_CLI_IMAGES):
        write_ppm(os.path.join(work, "train", f"{i}.ppm"), smooth_image(rng, cli_img, cli_img))
    cli_cfg = dataclasses.replace(base, out_channel_n=balle_n, image_size=hw, mesh_data=2,
                                  mesh_tile=2, print_freq=1, cal_step=1, tensorboard=False,
                                  train_dir=os.path.join(work, "train"), test_dir="",
                                  save_root=work, save_model_freq=MESH_CLI_STEPS,
                                  seed=MESH_SEED)

    def cli_run(name, steps, resume=""):
        with cudnn_deterministic():
            return train_cli.train_single_image(
                dataclasses.replace(cli_cfg, tot_step=steps), name, resume=resume,
                device=str(dev), devices=[dev] * 4)

    (full, cli_ms, _), got_full = counted(lambda: ms_pair(lambda: cli_run("full",
                                                                          MESH_CLI_RESUME)))
    _, got_half = counted(lambda: cli_run("half", MESH_CLI_STEPS))
    resumed, got_resumed = counted(lambda: cli_run("half", MESH_CLI_RESUME,
                                                   os.path.join(work, "half")))
    cli_launches = {k: got_full[k] + got_half[k] + got_resumed[k] for k in keys}
    steps_run = 2 * MESH_CLI_RESUME
    check(cli_launches == {"conv_gdn": 3 * 4 * steps_run, "gdn": 2 * 4 * steps_run,
                           "quantize_pack": 0},
          f"train_single_image 2x2: launches {cli_launches} over {steps_run} steps")
    check(full.step == resumed.step == MESH_CLI_RESUME, "train_single_image 2x2: steps")
    same_params = all(torch.equal(a, c) for a, c in zip(full.model.state_dict().values(),
                                                       resumed.model.state_dict().values()))
    sa, sr = full.optimizer.state_dict()["state"], resumed.optimizer.state_dict()["state"]
    same_moments = all(torch.equal(sa[i][k], sr[i][k]) for i in sa
                       for k in ("exp_avg", "exp_avg_sq", "step"))
    check(same_params and same_moments, "train_single_image 2x2: the resumed run's parameters "
                                        "or Adam moments differ from the uninterrupted run's")
    log = open(os.path.join(work, "full", "train.log")).read()
    check("mesh: data=2 tile=2" in log, "train_single_image 2x2: no mesh line in train.log")
    result["train_single_image_2x2"] = {"steps": MESH_CLI_RESUME, "resumed_from": MESH_CLI_STEPS,
                                        "params_bit_equal": same_params,
                                        "adam_moments_bit_equal": same_moments,
                                        "launches": cli_launches, "seconds_full": cli_ms / 1e3}
    lap("train_single_image")

    # ---- train_single_image of the hyperprior on 1×2 W-tiles, with its resume
    hyper_cfg = dataclasses.replace(cli_cfg, model="hyperprior", out_channel_n=hyper_n,
                                    out_channel_m=hyper_m, mesh_data=1, mesh_tile=2,
                                    save_model_freq=MESH_HYPER_CLI_STEPS)

    def hyper_cli_run(name, steps, resume=""):
        with cudnn_deterministic():
            return train_cli.train_single_image(
                dataclasses.replace(hyper_cfg, tot_step=steps), name, resume=resume,
                device=str(dev), devices=[dev] * 2)

    (h_full, h_ms, _), h_got_full = counted(lambda: ms_pair(lambda: hyper_cli_run(
        "hyper_full", MESH_HYPER_CLI_RESUME)))
    _, h_got_half = counted(lambda: hyper_cli_run("hyper_half", MESH_HYPER_CLI_STEPS))
    h_resumed, h_got_resumed = counted(lambda: hyper_cli_run(
        "hyper_half", MESH_HYPER_CLI_RESUME, os.path.join(work, "hyper_half")))
    h_launches = {k: h_got_full[k] + h_got_half[k] + h_got_resumed[k] for k in keys}
    for k in keys:
        tile_launches[k] += h_launches[k]
    h_steps = 2 * MESH_HYPER_CLI_RESUME
    check(h_launches == {"conv_gdn": 3 * 2 * h_steps, "gdn": 3 * 2 * h_steps,
                         "quantize_pack": 0},
          f"train_single_image hyperprior 1x2: launches {h_launches} over {h_steps} steps")
    check(h_full.step == h_resumed.step == MESH_HYPER_CLI_RESUME,
          "train_single_image hyperprior 1x2: steps")
    h_params = all(torch.equal(a, c) for a, c in zip(h_full.model.state_dict().values(),
                                                    h_resumed.model.state_dict().values()))
    sa, sr = h_full.optimizer.state_dict()["state"], h_resumed.optimizer.state_dict()["state"]
    h_moments = all(torch.equal(sa[i][k], sr[i][k]) for i in sa
                    for k in ("exp_avg", "exp_avg_sq", "step"))
    check(h_params and h_moments, "train_single_image hyperprior 1x2: the resumed run's "
                                  "parameters or Adam moments differ from the uninterrupted "
                                  "run's")
    check("mesh: data=1 tile=2" in open(os.path.join(work, "hyper_full", "train.log")).read(),
          "train_single_image hyperprior 1x2: no mesh line in train.log")
    result["train_single_image_hyperprior_1x2"] = {
        "steps": MESH_HYPER_CLI_RESUME, "resumed_from": MESH_HYPER_CLI_STEPS,
        "params_bit_equal": h_params, "adam_moments_bit_equal": h_moments,
        "launches": h_launches, "seconds_full": h_ms / 1e3}
    lap("train_single_image_hyperprior")

    # ---- the port's dryrun_multichip on 8 slots of the card
    (dry, dry_ms, _), dry_launches = counted(lambda: ms_pair(
        lambda: dryrun_multichip([dev] * MESH_DRYRUN_DEVICES)))
    check(all(dry_launches[k] > 0 for k in keys), f"dryrun_multichip: launches {dry_launches}")
    result["dryrun_multichip"] = {**dry, "launches": dry_launches, "seconds": dry_ms / 1e3}
    lap("dryrun_multichip")

    seconds = time.perf_counter() - t_phase
    emit({"phase": "mesh_train", "ok": True, **result, "launches": launches,
          "launches_tiles": tile_launches, "k2_mesh": k2_rows, "k1_mesh": k1_rows,
          "section_s": section_s, "seconds": seconds})
    print(f"mesh_train phase seconds: {seconds:.1f}", flush=True)
    return {"launches": launches, "launches_tiles": tile_launches, "k2": k2_rows,
            "k1": k1_rows}


def _fresh_like(torch, model):
    """A copy of ``model`` (its kind, widths and device) with every
    parameter moved by 1."""
    import copy

    fresh = copy.deepcopy(model)
    with torch.no_grad():
        for p in fresh.parameters():
            p.add_(1.0)
    return fresh


def harness(torch, lib) -> types.SimpleNamespace:
    """The helpers every phase takes as ``tools``: check, emit, the device
    timers (time_ms, call_ms), compare, new_row, add_numbers, measure_k2,
    measure_k1, bound_ms, and floor_ms (an empty kernel's launch, the floor
    under any kernel's time, timed in the same harness). ``lib`` is the
    built kernel library."""
    from iclr_17_compression_tpu_torch.ops.gdn import gdn_reparam
    from iclr_17_compression_tpu_torch.ops.kernels import conv_gdn_kernel as k2
    from iclr_17_compression_tpu_torch.ops.kernels import gdn_kernel as k1

    def time_ms(fn, warmup: int = 3, reps: int = 20, batch: int = 10) -> float:
        """Device time of one call: CUDA events around ``batch`` calls queued
        behind a sleep kernel, so that the host's enqueue time (the Python
        wrapper) is hidden; median over ``reps`` after ``warmup`` calls. A
        call of over 10 ms (cuDNN's fp32 path at some C = 192 shapes takes
        190 ms) is timed alone, 5 times, after one warmup call."""
        fn()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        if time.perf_counter() - t0 > 0.010:
            reps, batch = 5, 1
        else:
            for _ in range(warmup - 1):
                fn()
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

    stream = torch.cuda.current_stream().cuda_stream
    floor_ms = time_ms(lambda: lib.iclr17c_empty(stream))
    return types.SimpleNamespace(check=check, emit=emit, time_ms=time_ms, call_ms=call_ms,
                                 compare=compare, new_row=new_row, add_numbers=add_numbers,
                                 measure_k2=measure_k2, measure_k1=measure_k1, bound_ms=bound_ms,
                                 floor_ms=floor_ms)


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
    # K2 bf16's instances at their NT channels and BM-pixel tiles
    for name in ptxas:
        m = re.fullmatch(r"conv_gdn_bf16_kernel<(\d+),(\d+)>", name)
        if m:
            ptxas[name]["dynamic_smem_bytes"] = lib.iclr17c_conv_gdn_smem_bytes_bf16(
                int(m.group(1)), int(m.group(2)))
    emit({"phase": "build", "kernels_s": round(t_kernels, 3), "rans_s": round(t_rans, 3),
          "dir": str(_build.BUILD_DIR), "ptxas": ptxas})
    print(f"build seconds: nvcc kernels {t_kernels:.2f}, g++ rans {t_rans:.2f}", flush=True)
    check(t_kernels + t_rans < BUILD_LIMIT_S,
          f"build took {t_kernels + t_rans:.1f} s, over {BUILD_LIMIT_S:.0f} s")
    check(all(any(n.split("<")[0] == k for n in ptxas) for k in KERNEL_SYMBOLS),
          f"ptxas report names {sorted(ptxas)}")

    tools = harness(torch, lib)
    time_ms, call_ms, compare, new_row = tools.time_ms, tools.call_ms, tools.compare, tools.new_row
    measure_k2, measure_k1, floor_ms = tools.measure_k2, tools.measure_k1, tools.floor_ms

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

        # run B: --resume to RESUME_STEPS, profiling PROFILE_STEPS from TRAIN_STEPS + 5
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

    dsc_train = dsc_train_phase(torch, dev, tools)
    dsc_train_launches = dsc_train["launches"]
    hyper = hyper_phase(torch, dev, tools)
    hyper_launches = hyper["launches"]
    hyper_train = hyper_train_phase(torch, dev, tools)
    fusion = dsc_fusion_phase(torch, dev, tools)
    aux = aux_phase(torch, dev, tools, KITTI_TRAIN_DIR)
    trace_child = start_headline_trace()  # its set-up overlaps the eval phase
    try:
        evals = eval_phase(torch, dev, tools)
        prec = precision_phase(torch, dev, tools, trace_child)
    finally:
        trace_child.kill()  # gone already, unless a phase failed first
        trace_child.wait()
    tiled = tiled_phase(torch, dev, tools)
    mesh = mesh_train_phase(torch, dev, tools)
    paths = {"codec": launches, "train": train_launches, "dsc": dsc_launches,
             "dsc_train": dsc_train_launches, "hyper": hyper_launches,
             "hyper_train": hyper_train["launches"], "dsc_fusion": fusion["launches"],
             "aux": aux["launches"], "eval": evals["launches"], "tiled": tiled["launches"],
             "mesh_train": mesh["launches"]}
    # parts of the paths above (counted there too): the fusion presets'
    # tiled serving, and the training steps on meshes with a tile axis
    parts = {"tiled/fusion_presets": tiled["launches_fusion"],
             "mesh_train/tile_axis": mesh["launches_tiles"]}

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
                 "launches_by_path": {p: path[name] for p, path in {**paths, **parts}.items()},
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
                                       aux["k1_decoder_only"]["max_abs_err"],
                                       mesh["k1"]["max_abs_err"])
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
            entry["mesh_train_shapes"] = [
                {k: st.get(k) for k in ("where", "x", "inverse", "ms", "call_ms", "plain_ms",
                                        "bound_ms", "bound_by")}
                for st in mesh["k1"]["shapes"]]
        else:
            entry.update(launch_floor_ms=row["launch_floor_ms"], dsc_step16=k3_dsc,
                         dsc_validation=dsc_train["k3_validation"], fusion_codes=fusion["k3"],
                         fusion_tile_codes=tiled["k3"])
        if name == "conv_gdn":
            tr = tiled["k2"]
            entry["max_abs_err"] = max(entry["max_abs_err"], tr["max_abs_err"])
            entry["tile_padding_shapes"] = [
                {k: st.get(k) for k in ("where", "x", "splits", "ms", "call_ms", "plain_ms",
                                        "library_ms", "cudnn_k1_ms", "bound_ms", "bound_by")}
                for st in tr["shapes"]]
            mr = mesh["k2"]
            entry["max_abs_err"] = max(entry["max_abs_err"], mr["max_abs_err"])
            entry["mesh_train_shapes"] = [
                {k: st.get(k) for k in ("where", "x", "splits", "ms", "call_ms", "plain_ms",
                                        "library_ms", "cudnn_k1_ms", "bound_ms", "bound_by")}
                for st in mr["shapes"]]
            fp = prec["k2_fp32_blocked_conv1"]
            entry["max_abs_err"] = max(entry["max_abs_err"], fp["max_abs_err"])
            entry["blocked_conv1"] = {k: fp.get(k) for k in (
                "x", "w", "splits", "ms", "call_ms", "plain_ms", "library_ms", "bound_ms",
                "bound_by", "max_abs_err", "max_rel_err")}
        kernels.append(entry)
    # the bf16 variants: their launches on the precision phase's two main
    # paths (the Ballé headline in bf16 with io_block 4, the DSC serving split
    # in bf16); bound at the bf16 dense peak and 2 bytes an element
    for name in ("conv_gdn", "gdn", "quantize_pack"):
        row = prec["rows"][name + "_bf16"]
        entry = {"name": name + "_bf16", "route": "cuda", "source": meta[name][0],
                 "replaces": meta[name][1], "launches": prec["launches"][name],
                 "max_abs_err": row["max_abs_err"], "ms": row["ms"], "plain_ms": row["plain_ms"],
                 "bound_ms": row["bound_ms"], "bound_by": row["bound_by"],
                 "library_ms": row["library_ms"], "bound_route": "bf16",
                 "shapes": [{k: st.get(k) for k in (
                     "where", "x", "splits", "ms", "call_ms", "plain_ms", "library_ms", "fp32_ms",
                     "bound_ms", "bound_by", "share_diff") if k in st} for st in row["shapes"]]}
        if name == "quantize_pack":
            entry["launch_floor_ms"] = row["launch_floor_ms"]
        else:
            entry["share_diff"] = row["share_diff"]
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
