"""The plain references against the port's plain path on the CPU at a small
size (and, marked ``card``, against the port on the card): the same
weights and images give the same outputs."""

import pytest
import torch

from port_bench import images
from port_bench.adapters import balle17_lam2048 as balle
from port_bench.harness import HERE, load_json, load_workload
from port_bench.reference import _plain, balle17_lam2048 as balle_ref


def _wl(name, **kw):
    wl = load_workload(name)
    wl.update(kw)
    return wl


def _balle(device):
    cfg = load_json(HERE / "configs" / "balle17_lam2048.json")
    sd = balle_ref.state(cfg, 0, device)
    x = balle_ref.make_batch(images.generator(7, 1, device), 2, (64, 96), device)
    program = balle.build(_wl("balle17.eval_fp32_b32"), cfg, sd, device)
    return sd, x, program.canonical(program.submit(program.prepare(x)))


def _check_balle(sd, x, out, tol):
    ref = balle_ref.Reference(sd).forward(x)
    assert float((out["latent"] != ref["latent"]).float().mean()) <= 1e-3
    assert float((out["recon"] - ref["recon"]).abs().max()) <= tol
    assert abs(float(out["bpp"]) - float(ref["bpp"])) <= tol * float(ref["bpp"])
    nums = balle_ref.compare(sd, x, out)
    assert nums["recon_rmse"] <= tol and nums["bpp_gap"] <= tol


def test_balle17_reference_matches_the_port_on_the_cpu():
    _check_balle(*_balle("cpu"), tol=1e-5)


@pytest.mark.card
def test_balle17_reference_matches_the_port_on_the_card(cuda):
    _check_balle(*_balle(cuda), tol=1e-4)


def test_archived_weights_load_into_both_sides_alike():
    cfg = load_json(HERE / "configs" / "balle17_lam2048.json")
    sd = balle_ref.state(cfg, 0, "cpu")
    from iclr_17_compression_tpu_torch.train.weights import load_balle17

    port = load_balle17(str(balle_ref.ROOT / cfg["weights"]["file"]), device="cpu").state_dict()
    assert sorted(port) == sorted(sd)
    for k in sd:
        assert torch.equal(port[k], sd[k]), k


def test_the_controls_round_as_stated():
    x = torch.tensor([1.0 + 2.0 ** -11, 1.0 + 2.0 ** -10 + 2.0 ** -12, -3.0 - 2.0 ** -9 * 3, 300.0])
    tf32 = _plain.Cast("tf32")(x)
    # 10 mantissa bits, ties away from zero; 3·2^-9 above 3 is 3 ulps there
    assert tf32.tolist() == [1.0 + 2.0 ** -10, 1.0 + 2.0 ** -10, -3.0 - 2.0 ** -9 * 3, 300.0]
    # e4m3 under the scale 1 (448 / 300 < 2): 3 mantissa bits, 300 → 288
    fp8 = _plain.Cast("fp8")(x)
    assert fp8.tolist() == [1.0, 1.0, -3.0, 288.0]
    y = x.clone().requires_grad_()
    _plain.Cast("fp8")(y).sum().backward()
    assert torch.equal(y.grad, torch.ones_like(x))
