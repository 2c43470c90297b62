from .devices import check_same_device, numpy_dtype, resolve_device  # noqa: F401
