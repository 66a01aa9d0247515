"""No run loads JAX or the JAX package, and the references load nothing of
the port."""

import subprocess
import sys

from port_bench import harness

PROBE = """
import sys
sys.path.insert(0, {root!r})
import port_bench.reference.balle17_lam2048
print(sorted({{m.split('.', 1)[0] for m in sys.modules}}))
"""


def test_the_references_import_nothing_of_the_port_or_jax():
    out = subprocess.run([sys.executable, "-c", PROBE.format(root=str(harness.ROOT))],
                         capture_output=True, text=True, check=True).stdout
    loaded = set(eval(out))
    assert "port_bench" in loaded and "torch" in loaded
    assert not loaded & {"iclr_17_compression_tpu_torch", "iclr_17_compression_tpu", "jax",
                         "jaxlib", "flax"}


def test_banned_modules_compare_whole_top_level_names(monkeypatch):
    for name in list(sys.modules):
        if name.split(".", 1)[0] in harness.BANNED:
            monkeypatch.delitem(sys.modules, name)
    monkeypatch.setitem(sys.modules, "iclr_17_compression_tpu_torch.fake", object())
    monkeypatch.setitem(sys.modules, "jaxtyping_like", object())
    assert harness.banned_modules() == []
    monkeypatch.setitem(sys.modules, "iclr_17_compression_tpu.ops", object())
    monkeypatch.setitem(sys.modules, "flax", object())
    assert harness.banned_modules() == ["flax", "iclr_17_compression_tpu"]
