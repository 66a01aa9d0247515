#!/usr/bin/env python3
"""The bf16 kernels K2 (``conv_gdn_bf16_kernel``) and K1
(``gdn_rows_bf16_kernel``) alone on the card, at the shapes of
``chip_smoke.py``'s ``precision`` phase, on seeded random data.

    python3 tools/chip_bf16_kernels.py [--out chiprun_out/bf16_kernels.jsonl]

Needs one CUDA card. Builds the kernels, prints their ``ptxas`` report and
their tensor-core instructions (``cuobjdump --dump-sass``), then for each
shape holds the wrapper's output within one bf16 ulp of the plain version
(or ATOL near zero), checks that two calls give the same bits, and times the
kernel, the fp32 kernel, the plain version and (K2) cuDNN's bf16 conv + the
plain GDN, beside the bound. K2 is also launched through the C entry at
each tile it is built for (64 and, for 64 < Cout <= 192, 128 output
pixels a block), each held and timed: the numbers ``tile_bf16``'s choice rests on.
Then K2 at the Ballé-17 encoder's stages on the archived lam2048 weights
and ``chip_smoke.py``'s images, at each tile, within one bf16 ulp; and
``torch.profiler``'s trace of those three stages and of the bf16 headline
forward against their CUDA-event time (the trace must see every K2 bf16
launch). One JSON line a shape and a summary line; exits non-zero if a
check failed.
"""

import argparse
import json
import os
import subprocess
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import chip_smoke  # noqa: E402

# (where, x shape (N, H, W, Cin), k, stride, Cout, bias, GDN: None, "gdn", "igdn")
K2_SHAPES = (
    ("balle conv1 blocked 3x3 s1", (8, 128, 192, 48), 3, 1, 128, True, "gdn"),
    ("balle conv2 5x5 s2", (8, 128, 192, 128), 5, 2, 128, True, "gdn"),
    ("balle conv3 5x5 s2", (8, 64, 96, 128), 5, 2, 128, False, None),
    ("balle conv1 9x9 s4 (unblocked)", (8, 512, 768, 3), 9, 4, 128, True, "gdn"),
    ("dsc rbs conv2 + GDN", (4, 160, 608, 128), 3, 1, 128, True, "gdn"),
    ("dsc rbu conv + IGDN", (4, 160, 608, 128), 3, 1, 128, True, "igdn"),
    ("joint rbs conv2 + GDN", (1, 128, 192, 192), 3, 1, 192, True, "gdn"),
    ("joint rbu conv + IGDN", (1, 128, 192, 192), 3, 1, 192, True, "igdn"),
    ("hyperprior conv1 5x5 s2", (1, 512, 768, 3), 5, 2, 192, True, "gdn"),
    ("hyperprior conv2 5x5 s2", (1, 256, 384, 192), 5, 2, 192, True, "gdn"),
    ("hyperprior conv3 5x5 s2", (1, 128, 192, 192), 5, 2, 192, True, "gdn"),
    # off the precision phase's main paths: every NT instance, at each tile
    ("Cout=256 3x3 s1", (1, 64, 96, 128), 3, 1, 256, True, "igdn"),
    ("Cout=192 small 5x5 s2", (1, 32, 48, 128), 5, 2, 192, True, "gdn"),
    ("Cout=64 3x3 s1", (2, 40, 152, 128), 3, 1, 64, True, "gdn"),
    ("Cout=32 3x3 s2", (2, 20, 76, 64), 3, 2, 32, True, "igdn"),
    ("Cout=96 3x3 s1 no GDN", (1, 48, 64, 96), 3, 1, 96, True, None),
    ("Cout=160 5x5 s2", (1, 256, 256, 160), 5, 2, 160, False, "gdn"),
    ("Cout=224 3x3 s1", (1, 40, 56, 224), 3, 1, 224, True, "igdn"),
)
# (where, x shape (..., C), inverse)
K1_SHAPES = (
    ("balle igdn1", (8, 64, 96, 128), True),
    ("balle igdn2", (8, 128, 192, 128), True),
    ("hyperprior igdn1", (1, 64, 96, 192), True),
    ("hyperprior igdn2", (1, 128, 192, 192), True),
    ("hyperprior igdn3", (1, 256, 384, 192), True),
    ("C=64", (2, 16, 24, 64), False),
    ("C=96", (2, 16, 24, 96), True),
    ("C=256", (2, 16, 24, 256), False),
    ("C=512", (2, 16, 24, 512), True),
    ("C=128 ragged", (1, 7, 13, 128), False),
)


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--out", default=None)
    args = parser.parse_args()

    import torch

    from iclr_17_compression_tpu_torch.ops.kernels import _build
    from iclr_17_compression_tpu_torch.ops.kernels import conv_gdn_kernel as k2
    from iclr_17_compression_tpu_torch.ops.kernels import gdn_kernel as k1
    from iclr_17_compression_tpu_torch.utils.device import resolve_device

    dev = resolve_device("cuda")
    bf = torch.bfloat16
    lines = []

    def emit(obj):
        print(json.dumps(obj), flush=True)
        lines.append(obj)

    failures = []

    def check(cond, what):
        if not cond:
            failures.append(what)
            print(f"FAILED: {what}", file=sys.stderr, flush=True)

    t0 = time.perf_counter()
    lib = _build.kernels()
    build_s = time.perf_counter() - t0
    lib_path = _build.BUILD_DIR / "libiclr17c_kernels.so"
    ptxas = chip_smoke.ptxas_report((_build.BUILD_DIR / "libiclr17c_kernels.so.log").read_text())
    sass = chip_smoke.sass_report(lib_path)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=10).stdout.strip()
    emit({"phase": "build", "seconds": build_s, "device": torch.cuda.get_device_name(0),
          "nvidia_smi": smi,
          "ptxas": {k: v for k, v in ptxas.items() if "bf16" in k},
          "sass": {k: v for k, v in sass.items() if "bf16" in k}})
    for name, c in sass.items():
        if name.startswith("conv_gdn_bf16_kernel"):
            check(c["HGMMA"] > 0 and c["HMMA_BF16"] == 0, f"{name} SASS: {c}")
    tools = chip_smoke.harness(torch, lib)
    time_ms = tools.time_ms
    gen = torch.Generator().manual_seed(2024)

    def rand(*shape, scale=1.0):
        return torch.randn(shape, generator=gen) * scale

    for where, xs, k, stride, cout, has_bias, gdn in K2_SHAPES:
        n, h, w, cin = xs
        x = rand(*xs, scale=0.5).to(dev, bf)
        wt = (rand(k, k, cin, cout) / (k * k * cin) ** 0.5).to(dev, bf)
        b = (rand(cout) * 0.05).to(dev) if has_bias else None
        gamma_t = (torch.rand((cout, cout), generator=gen) * 0.02).to(dev) if gdn else None
        beta = (torch.rand(cout, generator=gen) + 0.5).to(dev) if gdn else None
        cargs = (x, wt, b, gamma_t, beta, stride, k // 2, gdn == "igdn")
        row = {"where": where, "x": list(xs), "k": k, "stride": stride, "cout": cout,
               "bias": has_bias, "gdn": gdn}
        try:
            out = k2.conv_gdn(*cargs)
            again = k2.conv_gdn(*cargs)
            ref = k2.conv_gdn_plain(*cargs)
            torch.cuda.synchronize()
        except RuntimeError as e:
            check(False, f"K2 {where}: {e}")
            emit({**row, "error": str(e)})
            break
        ok, share, err = chip_smoke.bf16_ulp_check(torch, out, ref)
        check(ok, f"K2 {where}: beyond one bf16 ulp (max abs {err:.3e})")
        check(torch.equal(out, again), f"K2 {where}: two calls differ")
        conv, norm, elementwise, nbytes = chip_smoke.k2_work_bf16(cargs, out)
        bound, bound_by = chip_smoke.bound_bf16_ms(conv, norm, elementwise, nbytes)
        oihw = wt.permute(3, 2, 0, 1).contiguous()
        xc = x.permute(0, 3, 1, 2)

        def library():  # cuDNN's bf16 conv, then the plain GDN in fp32 rounded to bf16
            y = torch.nn.functional.conv2d(xc, oihw, None if b is None else b.to(bf),
                                           stride=stride, padding=k // 2)
            if gamma_t is not None:
                k1.gdn_fused_plain(y.permute(0, 2, 3, 1).float(), gamma_t, beta,
                                   gdn == "igdn").to(bf)

        fargs = (x.float(), wt.float()) + cargs[2:]
        p = out.shape[0] * out.shape[1] * out.shape[2]
        row.update(ok=ok, share_diff=share, max_abs_err=err, bound_ms=bound, bound_by=bound_by,
                   bm=k2.tile_bf16(p, k * k * cin, cout, k2.sm_count(0)),
                   ms=time_ms(lambda: k2.conv_gdn(*cargs)),
                   library_ms=time_ms(library),
                   fp32_ms=time_ms(lambda: k2.conv_gdn(*fargs)),
                   plain_ms=time_ms(lambda: k2.conv_gdn_plain(*cargs)))
        tiles = {}
        for bm in k2.BF16_TILES:
            if bm == 128 and not 64 < cout <= 192:
                continue
            got = torch.empty_like(out)
            launch = c_entry(torch, lib, _build, cargs, got, bm)
            launch()
            torch.cuda.synchronize()
            t_ok = chip_smoke.bf16_ulp_check(torch, got, ref)[0]
            check(t_ok, f"K2 {where} bm={bm}: beyond one bf16 ulp")
            check(bm != row["bm"] or torch.equal(got, out),
                  f"K2 {where} bm={bm}: the C entry differs from the wrapper")
            tiles[bm] = {"ok": t_ok, "ms": time_ms(launch)}
        row["tiles"] = tiles
        emit(row)

    # the Ballé-17 encoder's bf16 stages on the archived lam2048 weights and
    # chip_smoke.py's smooth images (batch PREC_BATCH, blocked input): real
    # data, where outputs that cancel show the sum's drift, at every split
    real_data_k2(torch, k2, lib, check, emit)
    trace_k2(torch, k2, check, emit, time_ms)

    for where, xs, inverse in K1_SHAPES:
        c = xs[-1]
        x = (rand(*xs) * 0.8).to(dev, bf)
        gamma_t = (torch.rand((c, c), generator=gen) * 0.03).to(dev, bf)
        beta = (torch.rand(c, generator=gen) + 0.5).to(dev)
        row = {"where": where, "x": list(xs), "inverse": inverse}
        try:
            out = k1.gdn_fused(x, gamma_t, beta, inverse)
            again = k1.gdn_fused(x, gamma_t, beta, inverse)
            ref = k1.gdn_fused_plain(x, gamma_t, beta, inverse)
            torch.cuda.synchronize()
        except RuntimeError as e:
            check(False, f"K1 {where}: {e}")
            emit({**row, "error": str(e)})
            break
        ok, share, err = chip_smoke.bf16_ulp_check(torch, out, ref)
        check(ok, f"K1 {where}: beyond one bf16 ulp (max abs {err:.3e})")
        check(torch.equal(out, again), f"K1 {where}: two calls differ")
        p = x.numel() // c
        bound, bound_by = chip_smoke.bound_bf16_ms(2.0 * p * c * c, 0.0, 4.0 * p * c,
                                                   4.0 * x.numel() + 2.0 * c * c + 4.0 * c)
        xf, gf = x.float(), gamma_t.float()
        row.update(ok=ok, share_diff=share, max_abs_err=err, bound_ms=bound, bound_by=bound_by,
                   smem_bytes=lib.iclr17c_gdn_bf16_smem_bytes(c),
                   ms=time_ms(lambda: k1.gdn_fused(x, gamma_t, beta, inverse)),
                   fp32_ms=time_ms(lambda: k1.gdn_fused(xf, gf, beta, inverse)),
                   plain_ms=time_ms(lambda: k1.gdn_fused_plain(x, gamma_t, beta, inverse)))
        emit(row)

    summary = {"failures": failures, "device": torch.cuda.get_device_name(0)}
    emit(summary)
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
        with open(args.out, "w") as f:
            for obj in lines:
                f.write(json.dumps(obj) + "\n")
    return 1 if failures else 0


def c_entry(torch, lib, _build, args, out, bm):
    """A launch of K2 bf16 through its C entry with the wrapper's arguments
    ``args`` (x, HWIO w, b, γᵀ, β, stride, padding[, inverse]) into ``out``
    at a ``bm``-pixel tile."""
    from iclr_17_compression_tpu_torch.ops.kernels import conv_gdn_kernel as k2

    x, w, b, gamma_t, beta, stride, pad = args[:7]
    inverse = bool(args[7]) if len(args) > 7 else False
    rows, ldw = k2.k_major_weight(w)
    n, h, wd, cin = x.shape
    _, ho, wo, cout = out.shape

    def launch():
        err = lib.iclr17c_conv_gdn_bf16(
            x.data_ptr(), rows.data_ptr(), None if b is None else b.data_ptr(),
            None if gamma_t is None else gamma_t.data_ptr(),
            None if beta is None else beta.data_ptr(), out.data_ptr(), bm, ldw, n, h, wd, cin,
            ho, wo, cout, w.shape[0], stride, pad, pad, int(gamma_t is not None), int(inverse),
            torch.cuda.current_stream().cuda_stream)
        _build.check_launch(err, "conv_gdn_bf16")

    return launch


def trace_k2(torch, k2, check, emit, time_ms) -> None:
    """``torch.profiler``'s view of K2 bf16: the Ballé-17 headline's three
    stages, 5 calls each, and the bf16 io_block-4 forward at batch
    ``PREC_BATCH`` on the archived lam2048 weights; the launches the trace
    holds and their device ms against the CUDA-event ms."""
    import copy

    import numpy as np
    from torch.profiler import ProfilerActivity, profile

    from iclr_17_compression_tpu_torch.models.balle17 import Balle17Compressor
    from iclr_17_compression_tpu_torch.ops import precision
    from iclr_17_compression_tpu_torch.ops.conv import space_to_depth
    from iclr_17_compression_tpu_torch.train.weights import load_balle17

    bf = torch.bfloat16
    rng = np.random.default_rng(chip_smoke.PREC_SEED)
    base = load_balle17(chip_smoke.CKPT, device="cuda")
    blocked = Balle17Compressor(chip_smoke.N_CH, io_block=4).cuda().eval()
    blocked.load_state_dict(base.state_dict())
    model = precision.cast_storage(copy.deepcopy(blocked), bf)
    imgs = np.stack([chip_smoke.smooth_image(rng) for _ in range(chip_smoke.PREC_BATCH)])
    x = space_to_depth(torch.from_numpy(imgs).cuda(), 4).to(bf).contiguous()

    def k2_events(prof):
        return [e.time_range.elapsed_us() / 1e3 for e in prof.events()
                if e.device_type == torch.autograd.DeviceType.CUDA
                and "conv_gdn_bf16_kernel" in e.name]

    enc = model.Encoder
    with torch.no_grad():
        y = x
        for i, (conv, gdn) in enumerate(((enc.conv1, enc.gdn1), (enc.conv2, enc.gdn2),
                                         (enc.conv3, None))):
            args = stage_args(torch, k2, conv, gdn, y)
            k2.conv_gdn(*args)
            torch.cuda.synchronize()
            with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
                for _ in range(5):
                    k2.conv_gdn(*args)
                torch.cuda.synchronize()
            ev = k2_events(prof)
            row = {"where": f"trace: balle stage {i + 1}, 5 calls", "trace_launches": len(ev),
                   "trace_ms": sum(ev) / max(len(ev), 1),
                   "events_ms": time_ms(lambda: k2.conv_gdn(*args))}
            check(len(ev) == 5, f"{row['where']}: the trace holds {len(ev)} K2 bf16 launches")
            emit(row)
            y = k2.conv_gdn_plain(*args)
        model(x)
        torch.cuda.synchronize()
        for rep in range(2):
            with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
                model(x)
                torch.cuda.synchronize()
            ev = k2_events(prof)
            row = {"where": f"trace: bf16 io_block 4 forward, batch {chip_smoke.PREC_BATCH}, "
                            f"run {rep + 1}",
                   "trace_launches": len(ev), "trace_ms": sum(ev),
                   "busy_ms": sum(chip_smoke.device_ms_by_kernel(torch, prof).values())}
            check(len(ev) == 3, f"{row['where']}: the trace holds {len(ev)} K2 bf16 launches")
            emit(row)


def stage_args(torch, k2, conv, gdn, y) -> tuple:
    """The K2 call of a bf16 Ballé-17 encoder stage (conv + GDN, or conv3
    alone) on its input ``y``, with the weight as ``conv_gdn_module`` hands
    it (K-major rows seen as HWIO)."""
    from iclr_17_compression_tpu_torch.ops.gdn import gdn_reparam

    gamma_t = beta = None
    if gdn is not None:
        beta, gamma = gdn_reparam(gdn.params())
        gamma_t, beta = gamma.t().contiguous().float(), beta.float()
    w, stride, pad = ((conv.blocked_weight(), 1, 1) if conv.input_block > 1 else
                      (conv.weight.permute(2, 3, 1, 0), conv.stride[0], conv.padding[0]))
    b = None if conv.bias is None else conv.bias.float()
    return (y, k2.k_major_hwio(w.to(torch.bfloat16)), b, gamma_t, beta, stride, pad)


def real_data_k2(torch, k2, lib, check, emit) -> None:
    import copy

    import numpy as np

    from iclr_17_compression_tpu_torch.models.balle17 import Balle17Compressor
    from iclr_17_compression_tpu_torch.ops import precision
    from iclr_17_compression_tpu_torch.ops.conv import space_to_depth
    from iclr_17_compression_tpu_torch.ops.kernels import _build
    from iclr_17_compression_tpu_torch.train.weights import load_balle17

    bf = torch.bfloat16
    rng = np.random.default_rng(chip_smoke.PREC_SEED)
    base = load_balle17(chip_smoke.CKPT, device="cuda")
    blocked = Balle17Compressor(chip_smoke.N_CH, io_block=4).cuda().eval()
    blocked.load_state_dict(base.state_dict())
    enc = precision.cast_storage(copy.deepcopy(blocked), bf).Encoder
    imgs = np.stack([chip_smoke.smooth_image(rng) for _ in range(chip_smoke.PREC_BATCH)])
    y = space_to_depth(torch.from_numpy(imgs).cuda(), 4).to(bf).contiguous()
    with torch.no_grad():
        for conv, gdn, where in ((enc.conv1, enc.gdn1, "balle conv1 blocked (lam2048)"),
                                 (enc.conv2, enc.gdn2, "balle conv2 (lam2048)"),
                                 (enc.conv3, None, "balle conv3 (lam2048)")):
            args = stage_args(torch, k2, conv, gdn, y)
            ref = k2.conv_gdn_plain(*args)
            row = {"where": where, "x": list(y.shape), "tiles": {}}
            for bm in k2.BF16_TILES:
                got = torch.empty_like(ref)
                c_entry(torch, lib, _build, args, got, bm)()
                torch.cuda.synchronize()
                ok, share, diff = chip_smoke.bf16_ulp_check(torch, got, ref)
                check(ok, f"K2 {where} bm={bm}: beyond one bf16 ulp (max abs {diff:.3e})")
                row["tiles"][bm] = {"ok": ok, "share_diff": share, "max_abs_err": diff}
            emit(row)
            y = ref


if __name__ == "__main__":
    sys.exit(main())
