from .attention import NLBlock
from .balle17 import Analysis17, Balle17Compressor, Synthesis17
from .cheng2020 import JointAutoregressive
from .dsc import DSC_PRESETS, DSCConfig, DSCDecoder, DSCStereoModel
from .hyperprior import ScaleHyperprior

__all__ = ["Analysis17", "Balle17Compressor", "Synthesis17", "DSC_PRESETS", "DSCConfig",
           "DSCDecoder", "DSCStereoModel", "JointAutoregressive", "NLBlock", "ScaleHyperprior"]
