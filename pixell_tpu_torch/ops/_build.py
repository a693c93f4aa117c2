"""Build and load the CUDA kernels of pixell_tpu_torch/csrc.

At first use, nvcc compiles every csrc/*.cu into an object -- legendre.cu
once per mode (-DLEGENDRE_MODE=0..4), blockleg.cu once per Legendre mode
(0..3) -- with all compilers started together, and links the objects into one shared library with a plain C
interface, in build/pixell_tpu_torch/<hash of sources and flags>/ beside the
package; ctypes loads it. A changed source builds into a new directory; an
unchanged one is reused. There is no fallback: a missing nvcc or a failed
build raises.

The host libraries of pixell_tpu_torch/cpp (the native FITS reader) are built
the same way by the host C++ compiler, one library per source, at first use
(load_host).
"""
from __future__ import annotations
import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

CSRC = Path(__file__).resolve().parent.parent / "csrc"
HOST_SRC = Path(__file__).resolve().parent.parent / "cpp"
BUILD_ROOT = Path(__file__).resolve().parents[2] / "build" / "pixell_tpu_torch"
# no --use_fast_math: the recurrence needs correctly rounded arithmetic
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
	"-Xcompiler", "-fPIC", "-Xptxas", "-v"]
# sources compiled more than once, with these extra flags each time
VARIANTS = {"legendre.cu": [["-DLEGENDRE_MODE=%d" % k] for k in range(5)],
	"blockleg.cu": [["-DLEGENDRE_MODE=%d" % k] for k in range(4)]}


def _sources(csrc=CSRC):
	return sorted(csrc.glob("*.cu"))


def build_dir(csrc=CSRC):
	"""The build directory for the sources in csrc and the flags."""
	h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
	h.update(repr(sorted(VARIANTS.items())).encode())
	for p in sorted(csrc.iterdir()):
		h.update(p.name.encode()); h.update(p.read_bytes())
	return BUILD_ROOT / h.hexdigest()[:16]


def _nvcc():
	for cand in (shutil.which("nvcc"), "/usr/local/cuda/bin/nvcc"):
		if cand and os.path.exists(cand): return cand
	raise RuntimeError("nvcc not found: the pixell_tpu_torch CUDA kernels cannot be built")


def compile_commands(d, nvcc, csrc=CSRC):
	"""[(object path, nvcc command)] for every object of the library."""
	out = []
	for src in _sources(csrc):
		for i, extra in enumerate(VARIANTS.get(src.name, [[]])):
			obj = d/("%s.%d.o" % (src.stem, i))
			out.append((obj, [nvcc] + NVCC_FLAGS + extra + ["-c", "-o", str(obj), str(src)]))
	return out


def load(csrc=CSRC):
	"""Build the kernel library of the sources in csrc (by default the
	package's) if needed and return it as a ctypes.CDLL. The compilers'
	output, including the per-kernel register and shared memory use that
	-Xptxas -v reports, is kept in build.log beside it."""
	d = build_dir(csrc)
	lib = d/"libpixell_kernels.so"
	if not lib.exists():
		d.mkdir(parents=True, exist_ok=True)
		nvcc = _nvcc()
		cmds = compile_commands(d, nvcc, csrc)
		procs = [subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
			text=True) for _, cmd in cmds]
		logs, failed = [], []
		for (obj, cmd), p in zip(cmds, procs):
			out, _ = p.communicate()
			logs.append(" ".join(cmd) + "\n" + out)
			if p.returncode != 0: failed.append(out)
		if not failed:
			tmp = d/("libpixell_kernels.%d.so" % os.getpid())
			cmd = [nvcc, "-gencode", "arch=compute_90a,code=sm_90a", "-shared", "-o",
				str(tmp)] + [str(obj) for obj, _ in cmds]
			r = subprocess.run(cmd, capture_output=True, text=True)
			logs.append(" ".join(cmd) + "\n" + r.stdout + r.stderr)
			if r.returncode != 0: failed.append(r.stderr)
		(d/"build.log").write_text("\n".join(logs))
		if failed:
			raise RuntimeError("nvcc failed:\n%s" % failed[0][-6000:])
		os.replace(tmp, lib)
	return ctypes.CDLL(str(lib))


HOST_FLAGS = ["-O3", "-fPIC", "-fopenmp", "-std=c++17", "-shared"]


def _cxx():
	"""g++ from the PATH (not $CXX, which may name a compiler without OpenMP)."""
	cxx = shutil.which("g++")
	if cxx is None:
		raise RuntimeError("g++ not found: the pixell_tpu_torch host libraries cannot be built")
	return cxx


def load_host(name, src=HOST_SRC):
	"""Build the host library of src/<name>.cpp with the host C++ compiler, if
	needed, into build/pixell_tpu_torch/host-<hash of source and flags>/, and
	return it as a ctypes.CDLL. A failed build raises."""
	source = src/(name + ".cpp")
	h = hashlib.sha256(" ".join(HOST_FLAGS).encode())
	h.update(source.read_bytes())
	d = BUILD_ROOT/("host-" + h.hexdigest()[:16])
	lib = d/("lib%s.so" % name)
	if not lib.exists():
		d.mkdir(parents=True, exist_ok=True)
		tmp = d/("lib%s.%d.so" % (name, os.getpid()))
		cmd = [_cxx()] + HOST_FLAGS + ["-o", str(tmp), str(source)]
		r = subprocess.run(cmd, capture_output=True, text=True)
		(d/("%s.build.log" % name)).write_text(" ".join(cmd) + "\n" + r.stdout + r.stderr)
		if r.returncode != 0:
			raise RuntimeError("building %s failed:\n%s" % (source, r.stderr[-6000:]))
		os.replace(tmp, lib)
	return ctypes.CDLL(str(lib))
