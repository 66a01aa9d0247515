from .layers import GDN, BitEstimator, TorchConv, TorchConvTranspose

__all__ = ["GDN", "BitEstimator", "TorchConv", "TorchConvTranspose"]
