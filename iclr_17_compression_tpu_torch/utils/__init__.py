from .device import no_tf32, resolve_device

__all__ = ["no_tf32", "resolve_device"]
