"""pixell_tpu_torch: the PyTorch / CUDA port of pixell_tpu.

Sky maps on rectangular pixels, with spherical harmonic transforms whose
Legendre and NUFFT point stages run in hand-written CUDA kernels for
NVIDIA Hopper (csrc/) and in plain PyTorch on the CPU, the flat sky's
FFTs, spin rotations and binned spectra on torch.fft, and the pixel-space
reprojection (cut-outs, resolution changes, spline interpolation) in plain
torch, HEALPix with the CAR <-> HEALPix reprojection, thumbnails and
coordinate transforms, and lensing (flat and curved sky, the curved sky's
point stage on the NUFFT kernels) with Doppler aberration, and point
sources and wavelets: multi-geometry maps (multimap), one harmonic
interface over the flat and the curved sky (uharm), wavelet transforms on
the SHT kernels (wavelets) and the cell painter of objects (pointsrcs), and
angular distance transforms on their own kernels (distances), masks,
matched filters and source finders (analysis), ephemerides (ephem) and
atom-graph coordinate systems (coordsys), and multi-device maps and
transforms over torch.distributed: meshes, communicators and the ring- and
m-sharded SHTs (parallel, mpi, mpiutils) and tiled, distributable maps
(tilemap), and maps on disk with the runtime around them: FITS through a
native box reader built at first use (fits_io) with HDF5 and .npy maps
(enmap's IO), devices and memory figures (device, memory), checkpoints
(checkpoint), settings (config), sqlite databases (sqlite) and watched
arrays (warray). Module names mirror pixell_tpu's.
"""
__version__ = "0.1.0"

from . import utils
from . import bunch
from . import wcsutils
from . import interpol
from . import enmap
from . import resample
from . import array_ops
from . import fft
from . import sht
from . import powspec
from . import curvedsky
from . import sites
from . import coordinates
from . import healpix
from . import reproject
from . import lensing
from . import aberration
from . import old_aberration
from . import multimap
from . import uharm
from . import wavelets
from . import pointsrcs
from . import distances
from . import analysis
from . import ephem
from . import coordsys
from . import parallel
from . import mpi
from . import mpiutils
from . import tilemap
from . import fits_io
from . import device
from . import memory
from . import checkpoint
from . import config
from . import sqlite
from . import warray
