"""strique_tpu: nanopore raw-signal STR detection on a JAX accelerator.

A from-scratch JAX reimplementation of the capabilities of
giesselmann/STRique, with CUDA kernels for the GPU hot path.  See
README.md for architecture and usage.
"""

__version__ = "0.1.0"

from .pore_model import PoreModel  # noqa: F401


def __getattr__(name):
    # lazy imports keep `import strique_tpu` light (no jax import)
    if name == "RepeatCounter":
        from .detect.counter import RepeatCounter

        return RepeatCounter
    if name == "RepeatDetector":
        from .detect.detector import RepeatDetector

        return RepeatDetector
    if name == "Fast5Index":
        from .io.fast5 import Fast5Index

        return Fast5Index
    raise AttributeError(name)
