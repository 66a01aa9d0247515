"""The model's conv, deconv and (I)GDN FLOPs of the window's batches (the
unblocked model's, ``adapters/<config>.py`` ``model_flops``), over the
window, as a % of the storage dtype's dense peak (bf16 989 TFLOP/s, fp32
as TF32 495 TFLOP/s)."""

from port_bench.metrics.readers import mfu as read  # noqa: F401
