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
          queue (wrapper included), and the bound from the shapes; K1 and K2
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
Then the card's name and power limit, one line with every kernel's numbers,
and last the line {"ok": true, "device": {...}}. Any failed check exits
non-zero. Imports nothing of JAX.
"""

import json
import os
import re
import statistics
import subprocess
import sys
import time

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


def smooth_image(rng: np.random.Generator) -> np.ndarray:
    """A natural-looking synthetic HWC image in [0, 1]: a few low-frequency
    colour waves, edges from a random step pattern, and fine texture."""
    yy, xx = np.mgrid[0:IMG_H, 0:IMG_W].astype(np.float32)
    img = np.zeros((IMG_H, IMG_W, 3), np.float32) + rng.uniform(0.3, 0.7, 3).astype(np.float32)
    for _ in range(6):
        fy, fx = rng.uniform(-6, 6, 2) / np.array([IMG_H, IMG_W])
        phase = rng.uniform(0, 2 * np.pi)
        amp = rng.uniform(0.03, 0.12, 3).astype(np.float32)
        img += amp * np.cos(2 * np.pi * (fy * yy + fx * xx) + phase)[..., None]
    blocks = rng.uniform(-0.15, 0.15, (IMG_H // 64, IMG_W // 64, 3)).astype(np.float32)
    img += np.repeat(np.repeat(blocks, 64, axis=0), 64, axis=1)
    img += 0.03 * rng.standard_normal((IMG_H, IMG_W, 3)).astype(np.float32)
    return np.clip(img, 0.0, 1.0)


def main() -> int:
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
        wrapper) is hidden; median over ``reps`` after ``warmup`` calls."""
        for _ in range(warmup):
            fn()
        torch.cuda.synchronize()
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
        k2_row = {"ms": 0.0, "call_ms": 0.0, "plain_ms": 0.0, "library_ms": 0.0, "bound_ms": 0.0,
                  "bound_fp32_ms": 0.0, "mma_flops": 0.0, "flops": 0.0, "bytes": 0.0,
                  "max_abs_err": 0.0, "max_rel_err": 0.0, "shapes": []}
        for i, args in enumerate(stages):
            x, w, b, gamma_t, beta, stride, pad = args
            out = k2.conv_gdn(*args)
            again = k2.conv_gdn(*args)
            ref = k2.conv_gdn_plain(*args)
            torch.cuda.synchronize()
            compare(out, ref, f"K2 stage {i + 1}", k2_row)
            check(torch.equal(out, again), f"K2 stage {i + 1}: two calls differ")
            ms = time_ms(lambda: k2.conv_gdn(*args))
            one_call = call_ms(lambda: k2.conv_gdn(*args))
            plain = time_ms(lambda: k2.conv_gdn_plain(*args))
            oihw = w.permute(3, 2, 0, 1).contiguous()
            xc = x.permute(0, 3, 1, 2)

            def library():
                y = torch.nn.functional.conv2d(xc, oihw, b, stride=stride, padding=pad)
                if gamma_t is not None:
                    k1.gdn_fused_plain(y.permute(0, 2, 3, 1), gamma_t, beta)

            lib_ms = time_ms(library)
            _, h, wd, cin = x.shape
            _, ho, wo, cout = out.shape
            kk = w.shape[0]
            p = ho * wo
            mma = 2.0 * p * kk * kk * cin * cout
            elementwise = p * cout if b is not None else 0.0
            nbytes = 4.0 * (x.numel() + w.numel() + out.numel() + (cout if b is not None else 0))
            if gamma_t is not None:
                mma += 2.0 * p * cout * cout
                elementwise += 4.0 * p * cout
                nbytes += 4.0 * (cout * cout + cout)
            b_ms, b_by = bound_3xtf32_ms(mma, elementwise, nbytes)
            b32_ms, _ = bound_ms(mma + elementwise, nbytes)
            for key, val in (("ms", ms), ("call_ms", one_call), ("plain_ms", plain),
                             ("library_ms", lib_ms), ("bound_ms", b_ms), ("bound_fp32_ms", b32_ms),
                             ("mma_flops", mma), ("flops", mma + elementwise), ("bytes", nbytes)):
                k2_row[key] += val
            k2_row["shapes"].append({"x": list(x.shape), "w": list(w.shape), "stride": stride,
                                     "gdn": gamma_t is not None,
                                     "splits": k2.plan_splits(p, kk * kk,
                                                              k2.block_slots(0, cout)),
                                     "ms": ms, "call_ms": one_call, "plain_ms": plain,
                                     "library_ms": lib_ms, "bound_ms": b_ms, "bound_by": b_by,
                                     "bound_fp32_ms": b32_ms, "gflop": (mma + elementwise) / 1e9})
        k2_row["bound_by"] = bound_3xtf32_ms(k2_row["mma_flops"],
                                             k2_row["flops"] - k2_row["mma_flops"],
                                             k2_row["bytes"])[1]
        # off the main path: Cout = 192 (slice 2's width, one block an SM),
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
        k1_row = {"ms": 0.0, "call_ms": 0.0, "plain_ms": 0.0, "bound_ms": 0.0,
                  "bound_fp32_ms": 0.0, "mma_flops": 0.0, "flops": 0.0, "bytes": 0.0,
                  "max_abs_err": 0.0, "max_rel_err": 0.0, "shapes": []}
        for igdn, (h, wd) in ((model.Decoder.igdn1, (IMG_H // 8, IMG_W // 8)),
                              (model.Decoder.igdn2, (IMG_H // 4, IMG_W // 4))):
            beta, gamma = gdn_reparam(igdn.params())
            gamma_t, beta = gamma.t().contiguous(), beta.contiguous()
            x = torch.randn((1, h, wd, N_CH), generator=gen).to(dev)
            out = k1.gdn_fused(x, gamma_t, beta, True)
            again = k1.gdn_fused(x, gamma_t, beta, True)
            ref = k1.gdn_fused_plain(x, gamma_t, beta, True)
            torch.cuda.synchronize()
            compare(out, ref, f"K1 {h}x{wd}", k1_row)
            check(torch.equal(out, again), f"K1 {h}x{wd}: two calls differ")
            ms = time_ms(lambda: k1.gdn_fused(x, gamma_t, beta, True))
            one_call = call_ms(lambda: k1.gdn_fused(x, gamma_t, beta, True))
            plain = time_ms(lambda: k1.gdn_fused_plain(x, gamma_t, beta, True))
            p = h * wd
            mma = 2.0 * p * N_CH * N_CH
            elementwise = 4.0 * p * N_CH
            nbytes = 4.0 * (2 * x.numel() + N_CH * N_CH + N_CH)
            b_ms, b_by = bound_3xtf32_ms(mma, elementwise, nbytes)
            b32_ms, _ = bound_ms(mma + elementwise, nbytes)
            for key, val in (("ms", ms), ("call_ms", one_call), ("plain_ms", plain),
                             ("bound_ms", b_ms), ("bound_fp32_ms", b32_ms), ("mma_flops", mma),
                             ("flops", mma + elementwise), ("bytes", nbytes)):
                k1_row[key] += val
            k1_row["shapes"].append({"x": list(x.shape), "ms": ms, "call_ms": one_call,
                                     "plain_ms": plain, "bound_ms": b_ms, "bound_by": b_by,
                                     "bound_fp32_ms": b32_ms, "gflop": (mma + elementwise) / 1e9})
        k1_row["bound_by"] = bound_3xtf32_ms(k1_row["mma_flops"],
                                             k1_row["flops"] - k1_row["mma_flops"],
                                             k1_row["bytes"])[1]
        k1_row["library_ms"] = None
        # off the main path: slice 2's C = 192 and the contract's largest C = 256
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
        n = lat.numel()
        b_ms, b_by = bound_ms(5.0 * n, 9.0 * n)
        rows["quantize_pack"] = {
            "ms": time_ms(lambda: k3.quantize_pack(lat, 1.0, 127.0)),
            "call_ms": call_ms(lambda: k3.quantize_pack(lat, 1.0, 127.0)),
            "plain_ms": time_ms(lambda: k3.quantize_pack_plain(lat, 1.0, 127.0)),
            "library_ms": None, "bound_ms": b_ms, "bound_by": b_by, "bound_fp32_ms": b_ms,
            "max_abs_err": 0.0,
            "max_rel_err": 0.0,
            "shapes": [{"x": list(lat.shape), "step": 1.0, "lim": 127}],
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
            sym, _ = k3.quantize_pack(model.Encoder(x), 1.0, 127.0)
            encoded = sym[0].cpu().numpy().astype(np.int64) - 127
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
                 "replaces": meta[name][1], "launches": launches[name],
                 "max_abs_err": row["max_abs_err"], "ms": row["ms"],
                 "plain_ms": row["plain_ms"], "bound_ms": row["bound_ms"],
                 "bound_by": row["bound_by"], "library_ms": row["library_ms"],
                 "bound_route": "3xtf32" if name != "quantize_pack" else "fp32"}
        if name == "conv_gdn":
            entry["stages"] = [{k: st[k] for k in ("ms", "plain_ms", "library_ms", "bound_ms")}
                               for st in row["shapes"]]
        kernels.append(entry)
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
