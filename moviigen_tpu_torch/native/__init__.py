from .loader import NativeReaderPool, native_available, read_npy_batch

__all__ = ["NativeReaderPool", "native_available", "read_npy_batch"]
