"""Evaluation: Kodak-style and stereo R-D, the auxiliary nets, mixing and
similarity (the JAX package's ``eval`` exports). The names are imported on
first use, so that ``python -m iclr_17_compression_tpu_torch.eval.kodak``
(or ``.stereo``) runs its module once."""
import importlib

_EXPORTS = {
    "eval_kodak": "kodak",
    "eval_stereo_dsc": "stereo",
    "eval_reg_stage": "reg_stage",
    "compose_recon": "reg_stage",
    "eval_passr": "passr",
    "eval_enhance": "enhance",
    "encoder_similarity": "similarity",
    "encoder_distances": "similarity",
    "code_distribution": "similarity",
    "save_channel_images": "similarity",
    "gzip_factor": "similarity",
    "mix_encoder_decoder": "mix",
    "eval_single_image": "mix",
    "average_two_models": "mix",
}

__all__ = list(_EXPORTS)


def __getattr__(name):
    if name not in _EXPORTS:
        raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
    return getattr(importlib.import_module(f".{_EXPORTS[name]}", __name__), name)
