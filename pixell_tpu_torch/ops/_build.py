"""Build and load the CUDA kernels of pixell_tpu_torch/csrc.

At first use, nvcc compiles every csrc/*.cu into one shared library with a
plain C interface, in build/pixell_tpu_torch/<hash of sources and flags>/
beside the package, and ctypes loads it. A changed source builds into a new
directory; an unchanged one is reused. There is no fallback: a missing nvcc
or a failed build raises.
"""
from __future__ import annotations
import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_ROOT = Path(__file__).resolve().parents[2] / "build" / "pixell_tpu_torch"
# no --use_fast_math: the recurrence needs correctly rounded arithmetic
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
	"-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]


def _sources():
	return sorted(CSRC.glob("*.cu"))


def build_dir():
	"""The build directory for the current sources and flags."""
	h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
	for p in sorted(CSRC.iterdir()):
		h.update(p.name.encode()); h.update(p.read_bytes())
	return BUILD_ROOT / h.hexdigest()[:16]


def _nvcc():
	for cand in (shutil.which("nvcc"), "/usr/local/cuda/bin/nvcc"):
		if cand and os.path.exists(cand): return cand
	raise RuntimeError("nvcc not found: the pixell_tpu_torch CUDA kernels cannot be built")


def load():
	"""Build the kernel library if needed and return it as a ctypes.CDLL.
	The compiler's output, including the per-kernel register and shared
	memory use that -Xptxas -v reports, is kept in build.log beside it."""
	d = build_dir()
	lib = d/"liblegendre.so"
	if not lib.exists():
		d.mkdir(parents=True, exist_ok=True)
		tmp = d/("liblegendre.%d.so" % os.getpid())
		cmd = [_nvcc()] + NVCC_FLAGS + ["-o", str(tmp)] + [str(s) for s in _sources()]
		r = subprocess.run(cmd, capture_output=True, text=True)
		(d/"build.log").write_text(" ".join(cmd) + "\n" + r.stdout + r.stderr)
		if r.returncode != 0:
			raise RuntimeError("nvcc failed (%d):\n%s" % (r.returncode, r.stderr[-6000:]))
		os.replace(tmp, lib)
	return ctypes.CDLL(str(lib))
