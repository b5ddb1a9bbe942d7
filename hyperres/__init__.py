"""hyperres — EMIT x Sentinel-2 hyperspectral super-resolution in JAX.

A ground-up JAX/XLA re-design of the capabilities of
``martasumyk/hyperspectral_super-resolution``: GLT orthorectification,
SRF band synthesis, OT/polynomial fusion, ridge spectral super-resolution,
FFT phase-correlation coregistration, paired tiling, catalog search and
run artifacts — with the compute path on the GPU and a self-contained host
runtime (own CRS math and GeoTIFF/ENVI/HDF5 codecs).
"""

__version__ = "0.1.0"

from . import core

# subpackages are imported lazily on attribute access to keep bare
# `import hyperres` light
_SUBMODULES = ("io", "kernels", "ortho", "spectral", "fusion", "coreg",
               "tiling", "parallel", "catalog", "artifacts", "viz",
               "testing", "pipeline", "batch", "cli", "utils", "native")


def __getattr__(name):
    if name in _SUBMODULES:
        import importlib
        return importlib.import_module(f".{name}", __name__)
    raise AttributeError(f"module 'hyperres' has no attribute {name!r}")


__all__ = ["core", "__version__", *_SUBMODULES]
