from .balle17 import Analysis17, Balle17Compressor, Synthesis17

__all__ = ["Analysis17", "Balle17Compressor", "Synthesis17"]
