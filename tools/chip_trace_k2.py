#!/usr/bin/env python3
"""Which process histories keep K2 bf16 (``conv_gdn_bf16_kernel``) out of
``torch.profiler``'s trace of the card.

    python3 tools/chip_trace_k2.py [--out chiprun_out/trace_k2.jsonl]

Needs one CUDA card. Runs each variant in a fresh process: the Ballé-17
headline's three K2 bf16 stages (batch 8, blocked 768×512 input, seeded
random weights) and one K1 bf16 call, each launched once untraced, then
traced together; before that, depending on the variant, profiler sessions
over fp32 work, a first bf16 launch inside a session, or eager module
loading. One JSON line a variant (the K2 and K1 bf16 launches the trace
holds, of 3 and 1, and the kernel names it holds) and a summary line.
"""

import argparse
import json
import os
import subprocess
import sys

VARIANTS = {
    # (profiler sessions over fp32 work before the first bf16 launch, the
    # first bf16 launch inside a session, environment)
    "fresh": (0, False, {}),
    "sessions_before": (1, False, {}),
    "many_sessions_before": (20, False, {}),
    "first_launch_traced": (1, True, {}),
    "sessions_before_eager": (1, False, {"CUDA_MODULE_LOADING": "EAGER"}),
}


def run_variant(name: str) -> dict:
    sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    import torch
    from torch.profiler import ProfilerActivity, profile

    from iclr_17_compression_tpu_torch.ops.kernels import conv_gdn_kernel as k2
    from iclr_17_compression_tpu_torch.ops.kernels import gdn_kernel as k1

    sessions, first_traced, _ = VARIANTS[name]
    dev = torch.device("cuda")
    bf = torch.bfloat16
    gen = torch.Generator().manual_seed(16)

    def rand(*shape, scale=1.0):
        return (torch.randn(shape, generator=gen) * scale).to(dev)

    def stage(x, k, stride, cout, gdn):
        cin = x.shape[-1]
        w = k2.k_major_hwio((rand(k, k, cin, cout) / (k * k * cin) ** 0.5).to(bf))
        gamma_t = (torch.rand((cout, cout), generator=gen) * 0.02).to(dev) if gdn else None
        beta = (torch.rand(cout, generator=gen) + 0.5).to(dev) if gdn else None
        return (x, w, rand(cout, scale=0.05), gamma_t, beta, stride, k // 2)

    x = rand(8, 128, 192, 48, scale=0.5).to(bf)
    s1 = stage(x, 3, 1, 128, True)
    y1 = k2.conv_gdn_plain(*s1)
    s2 = stage(y1, 5, 2, 128, True)
    s3 = stage(k2.conv_gdn_plain(*s2), 5, 2, 128, False)
    g_t = (torch.rand((128, 128), generator=gen) * 0.03).to(dev, bf)
    g_b = (torch.rand(128, generator=gen) + 0.5).to(dev)

    def bf16_work():
        for args in (s1, s2, s3):
            k2.conv_gdn(*args)
        k1.gdn_fused(y1, g_t, g_b, True)

    xf = rand(4, 64, 64, 128)
    wf = rand(3, 3, 128, 128, scale=0.03)
    for _ in range(sessions):  # fp32 work under the profiler, as earlier phases do
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]):
            k2.conv_gdn(xf, wf, None, None, None, 1, 1)
            torch.relu(xf).sum()
            torch.cuda.synchronize()
    if first_traced:
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]):
            bf16_work()
            torch.cuda.synchronize()
    else:
        bf16_work()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        bf16_work()
        torch.cuda.synchronize()
    names = sorted({e.name.split("(")[0][:60] for e in prof.events()
                    if e.device_type == torch.autograd.DeviceType.CUDA})
    count = lambda key: sum(1 for e in prof.events()  # noqa: E731
                            if e.device_type == torch.autograd.DeviceType.CUDA and key in e.name)
    return {"variant": name, "k2_bf16_launches": count("conv_gdn_bf16_kernel"),
            "k1_bf16_launches": count("gdn_rows_bf16_kernel"), "kernels": names}


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--variant", choices=sorted(VARIANTS))
    parser.add_argument("--out", default=None)
    args = parser.parse_args()
    if args.variant:
        print(json.dumps(run_variant(args.variant)), flush=True)
        return 0
    rows = []
    for name, (_, _, env) in VARIANTS.items():
        proc = subprocess.run([sys.executable, os.path.abspath(__file__), "--variant", name],
                              capture_output=True, text=True, timeout=600,
                              env={**os.environ, **env})
        lines = [ln for ln in proc.stdout.splitlines() if ln.startswith("{")]
        row = json.loads(lines[-1]) if lines else {"variant": name, "error": proc.stderr[-2000:]}
        rows.append(row)
        print(json.dumps(row), flush=True)
    summary = {"seen": {r["variant"]: r.get("k2_bf16_launches") == 3 for r in rows}}
    print(json.dumps(summary), flush=True)
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
        with open(args.out, "w") as f:
            for row in rows + [summary]:
                f.write(json.dumps(row) + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
