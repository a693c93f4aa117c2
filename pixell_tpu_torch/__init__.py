"""pixell_tpu_torch: the PyTorch / CUDA port of pixell_tpu.

Sky maps on rectangular pixels, with spherical harmonic transforms whose
Legendre stage runs in hand-written CUDA kernels for NVIDIA Hopper
(csrc/legendre.cu) and in plain PyTorch on the CPU. Module names mirror
pixell_tpu's. This first slice covers the spin-0 curved-sky
map2alm/alm2map path on full-sky CAR geometries.
"""
__version__ = "0.1.0"

from . import utils
from . import bunch
from . import wcsutils
from . import enmap
from . import fft
from . import sht
from . import powspec
from . import curvedsky
