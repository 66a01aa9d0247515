"""The yardstick's arithmetic: the model-FLOP counters, the kernel calls a
unit launches, the bounds, the kernels' names and the rate's count of
the window's work."""

import numpy as np
import pytest

from port_bench import work
from port_bench.traffic import codec
from port_bench.adapters import balle17_lam2048 as balle
from port_bench.harness import load_workload
from port_bench.reference import balle17_lam2048 as balle_ref


def _wl(name, **kw):
    wl = load_workload(name)
    wl.update(kw)
    return wl


def test_balle17_counts_22448_macs_a_pixel():
    # convs 1944 + 6400 + 1600, GDNs 1024 + 256, and the mirror image
    assert balle_ref.model_macs((1, 512, 768, 3)) == 22_448 * 512 * 768
    assert balle_ref.model_macs((3, 64, 96, 3)) == 22_448 * 3 * 64 * 96


def test_blocked_and_unblocked_layouts_count_the_same_model_flops():
    blocked, plain = _wl("balle17.serve_bf16_b128"), _wl("balle17.eval_fp32_b32", batch=128)
    assert blocked["io_block"] == 4 and plain["io_block"] == 1
    assert balle.model_flops(blocked) == balle.model_flops(plain) == 2.0 * 22_448 * 128 * 512 * 768
    # the kernels' work is the layout's: the blocked conv1 is a 3×3 conv over 48 channels
    k2_blocked = [c for c in balle.kernel_calls(blocked) if c.kernel == "K2"][0]
    k2_plain = [c for c in balle.kernel_calls(plain) if c.kernel == "K2"][0]
    assert k2_blocked.out() == k2_plain.out() == (128, 128, 192, 128)
    assert work.k2_work(k2_blocked)[0] > work.k2_work(k2_plain)[0]


@pytest.mark.parametrize("name", ["balle17.serve_bf16_b128", "balle17.eval_fp32_b32"])
def test_kernel_calls_a_unit(name):
    wl = _wl(name)
    calls = balle.kernel_calls(wl)
    assert {k: sum(c.kernel == k for c in calls) for k in ("K1", "K2", "K3")} == \
        {"K1": 2, "K2": 3, "K3": 0}
    for c in calls:
        assert c.dtype == wl["storage"]
        if c.kernel == "K2":
            assert c.out()[0] == wl["batch"] and all(d > 0 for d in c.out())


def test_bounds_follow_the_frozen_arithmetic():
    call = work.KernelCall("K2", "float32", (1, 32, 32, 128), (5, 5, 128, 128), 2, 2)
    mma, elementwise, nbytes = work.k2_work(call)
    p = 16 * 16
    assert mma == 2.0 * p * 25 * 128 * 128 + 2.0 * p * 128 * 128
    assert elementwise == p * 128 + 4.0 * p * 128
    assert nbytes == 4.0 * (32 * 32 * 128 + 25 * 128 * 128 + p * 128 + 128 + 128 * 128 + 128)
    assert work.bound_of(call) == pytest.approx(
        1e3 * max(3 * mma / 495e12 + elementwise / 67e12, nbytes / 3.35e12))
    bf = work.KernelCall("K1", "bfloat16", (8, 64, 96, 128))
    flops, elementwise, nbytes = work.k1_work_bf16(bf)
    assert work.bound_of(bf) == pytest.approx(
        1e3 * max(flops / 989e12 + elementwise / 67e12, nbytes / 3.35e12))


@pytest.mark.parametrize("name, kind", [
    ("void conv_gdn_kernel(ConvArgs)", "K2"),
    ("void conv_gdn_bf16_kernel<2, 64>(Bf16Args)", "K2"),
    ("void conv_gdn_reduce_kernel(RowsArgs)", "K2-reduce"),
    ("void gdn_rows_kernel(RowsArgs)", "K1"),
    ("void gdn_rows_bf16_kernel<128, 4>(...)", "K1"),
    ("void quant_pack_kernel<unsigned char>(float const*, ...)", "K3"),
    ("void quant_pack_bf16_kernel<unsigned short>(...)", "K3"),
    ("sm90_xmma_fprop_implicit_gemm_bf16bf16", None),
])
def test_kernel_names(name, kind):
    assert work.kernel_of(name) == kind


def test_the_rate_counts_the_share_of_the_batch_running_at_the_close():
    done, submitted = np.array([1.0, 2.0, 3.0]), np.array([0.0, 0.5, 1.5])
    # the third ran from the second's completion (2.0) to 3.0: half of it by 2.5
    assert codec.batches_done(done, submitted, 0.0, 2.5) == pytest.approx(2.5)
    assert codec.batches_done(done, submitted, 0.0, 3.5) == 3.0
    # the first ran from its submission (after the window's start)
    assert codec.batches_done(done, np.array([0.2, 0.5, 1.5]), 0.0, 0.6) == pytest.approx(0.5)
    # a batch submitted after the previous one completed starts at its submission
    assert codec.batches_done(done, np.array([0.0, 1.5, 2.5]), 0.0, 1.75) == pytest.approx(1.5)
