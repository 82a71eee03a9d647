"""Typed exceptions of the PyTorch port.

Counterpart of `implicitglobalgrid_tpu/utils/exceptions.py`: the same class
names and hierarchy, so callers catch the same errors on either package, plus
`KernelError` for a CUDA kernel that does not build or does not launch.
"""

__all__ = [
    "GlobalGridError",
    "ModuleInternalError",
    "NotInitializedError",
    "AlreadyInitializedError",
    "InvalidArgumentError",
    "IncoherentArgumentError",
    "KeywordArgumentError",
    "NotLoadedError",
    "NotSupportedError",
    "ResilienceError",
    "KernelError",
]


class GlobalGridError(Exception):
    """Base class for all framework errors."""


class ModuleInternalError(GlobalGridError):
    """An internal invariant was violated."""


class NotInitializedError(GlobalGridError):
    """API used before `init_global_grid` / after `finalize_global_grid`."""


class AlreadyInitializedError(GlobalGridError):
    """`init_global_grid` called twice."""


class InvalidArgumentError(GlobalGridError):
    """An argument value is invalid on its own."""


class IncoherentArgumentError(GlobalGridError):
    """Arguments are individually valid but mutually incoherent."""


class KeywordArgumentError(GlobalGridError):
    """A keyword argument is not supported in this context."""


class NotLoadedError(GlobalGridError):
    """A required backend is not available (no CUDA device, no `nvcc`)."""


class NotSupportedError(GlobalGridError):
    """Feature unsupported for the given input, or not ported yet."""


class ResilienceError(GlobalGridError):
    """Reserved for the resilient runtime (not ported yet)."""


class KernelError(GlobalGridError):
    """A CUDA kernel failed to build, or its launch returned a CUDA error."""
