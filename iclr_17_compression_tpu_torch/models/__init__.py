from .balle17 import Analysis17, Balle17Compressor, Synthesis17
from .dsc import DSC_PRESETS, DSCConfig, DSCDecoder, DSCStereoModel

__all__ = ["Analysis17", "Balle17Compressor", "Synthesis17", "DSC_PRESETS", "DSCConfig",
           "DSCDecoder", "DSCStereoModel"]
