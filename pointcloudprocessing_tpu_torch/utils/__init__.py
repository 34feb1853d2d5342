"""Host-side helpers: the loader of the repo's C++ runtime helpers and the
profiling hooks."""

from pointcloudprocessing_tpu_torch.utils.native import crc32c, native_available

__all__ = ["crc32c", "native_available"]
