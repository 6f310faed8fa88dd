"""The native C++ host data loader (libjpeg decode, prefetching batches)."""

from .host_loader import HostLoader, NativeRuntime, get_runtime

__all__ = ["HostLoader", "NativeRuntime", "get_runtime"]
