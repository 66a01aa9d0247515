"""Training configuration — a typed superset of the reference JSON schema.

Counterpart of ``iclr_17_compression_tpu/train/config.py``, with the same
fields, so one JSON file configures either package. The reference parses
``examples/example/config.json`` into module globals (reference
train.py:41-66, schema keys: tot_epoch, tot_step, train_lambda, batch_size,
print_freq, save_model_freq, cal_step, lr{base,decay, decay_interval}).
Here the same keys load into one frozen dataclass. ``mesh_data`` ×
``mesh_tile`` is the training mesh of ``train/cli.py`` (the auxiliary
trainers run on one device, as the JAX package's do); it refuses
``fif_0031bpp`` and the hyperprior's and joint's tile axis.
"""

import dataclasses
import json
from dataclasses import dataclass
from typing import Optional, Tuple


@dataclass(frozen=True)
class TrainConfig:
    # reference-parity fields (examples/example/config.json)
    tot_epoch: int = 1000000
    tot_step: int = 2500000
    train_lambda: float = 8192.0
    batch_size: int = 4
    print_freq: int = 100
    save_model_freq: int = 50000
    cal_step: int = 40
    lr_base: float = 1e-4
    lr_decay: float = 0.1
    lr_decay_interval: int = 2200000
    warmup_step: int = 0
    grad_clip: float = 5.0
    # ReduceLROnPlateau patience in EPOCHS (DSC/aux loops). The reference's
    # torch default (10) assumes KITTI-sized epochs (~500 steps); on a small
    # corpus a 13-step epoch makes 10-epoch patience fire after ~130 steps
    # and collapse the LR before the code path has trained — scale patience
    # so patience×steps_per_epoch matches the reference's ~5000-step window.
    plateau_patience: int = 10
    image_size: int = 256
    seed: int = 1234

    # framework extensions
    model: str = "balle17"            # balle17 | hyperprior | joint | dsc:<preset>
    out_channel_n: int = 128
    out_channel_m: int = 320
    joint_n: int = 192                 # width N of the joint-AR codec
    quant: str = "noise-round"
    loss: Optional[str] = None         # override DSC preset loss
    mesh_data: Optional[int] = None    # None = auto (largest divisor of batch)
    mesh_tile: int = 1                 # spatial W-tiling axis size
    save_epoch_freq: int = 1           # DSC loop: write latest/best-train
                                       # ckpts every N epochs
    dtype: str = "float32"             # params dtype; compute may be bf16
    save_root: str = "checkpoints"     # checkpoints land in <save_root>/<name>

    # data
    dataset: str = "kitti"             # stereo source: kitti | holopix | pairs
    train_dir: str = ""
    test_dir: str = ""
    num_workers: int = 1

    # observability (train/observability.py)
    tensorboard: bool = True           # scalars to <save_dir>/tb if available
    profile_dir: str = ""              # non-empty → trace a step window
    profile_start_step: int = 10
    profile_num_steps: int = 5
    debug_nans: bool = False           # autograd anomaly detection (NaN at the op)

    @classmethod
    def from_json(cls, path: str) -> "TrainConfig":
        """Load the reference JSON schema (nested ``lr`` dict supported)."""
        with open(path) as f:
            raw = json.load(f)
        kw = {}
        fields = {f.name for f in dataclasses.fields(cls)}
        for k, v in raw.items():
            if k == "lr" and isinstance(v, dict):
                if "base" in v:
                    kw["lr_base"] = float(v["base"])
                if "decay" in v:
                    kw["lr_decay"] = float(v["decay"])
                if "decay_interval" in v:
                    kw["lr_decay_interval"] = int(v["decay_interval"])
            elif k in fields:
                kw[k] = v
        return cls(**kw)

    def to_json(self) -> str:
        return json.dumps(dataclasses.asdict(self), indent=2)
