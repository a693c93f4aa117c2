"""Legendre-stage dispatch and the CUDA kernel wrappers.

Counterpart of pixell_tpu/ops/sht_pallas.py. The kernels themselves are in
pixell_tpu_torch/csrc/legendre.cu, each in the modes scalar, deriv, spin1
and spin2 (K6):

  sym_synthesis   K1, replaces _synthesis_scan_pallas_sym (sht_pallas.py:1686)
  sym_analysis    K2, replaces _analysis_scan_pallas_sym (sht_pallas.py:1850)
  full_synthesis  K3, replaces _synthesis_scan_pallas_full (sht_pallas.py:1540)
  full_analysis   K4, replaces _analysis_scan_pallas_full (sht_pallas.py:1954)

Each wrapper takes prepared tables (sht_core.Geom plus the coefficient
tables built here), checks its arguments, and launches its kernel on a CUDA
tensor, adding one to LAUNCHES[name] and to LAUNCHES_BY_MODE[(name, mode)].
On a CPU tensor it runs its plain PyTorch version (PLAIN[name], same
arguments) instead; on any other device it raises.

synthesis_scan / analysis_scan are the engine entry points the SHT calls.
CPU tensors go to the plain scan (sht_core); CUDA tensors go through the
reference's dispatch (synthesis_scan_pallas :498,
analysis_scan_pallas_chunked :2108, _maybe_polar_analysis :1797,
_analysis_sym_entry :1825), with its thresholds, in every mode:
  - float32: bulk rings use K1/K2 when the ring set is south-symmetric with
    at most 2*SYM_MAX_NH rings, else K3/K4 in float32. The rings within
    POLAR_AMP/lmax of a pole, for m < POLAR_MMAX, then run through K3/K4 in
    float64 (the TPU ran them in double-single): synthesis overwrites those
    rings, analysis adds their contribution.
  - float64: K1-K4 in float64, with no polar split.
"""
from __future__ import annotations
import ctypes
import functools
import numpy as np
import torch
from . import sht_core, _build
from .sht_core import NFUN, PSIGN

SYM_MAX_NH = 1536   # half-sky kernels only up to 2*SYM_MAX_NH rings
POLAR_AMP = 60.0    # near-pole rings: theta < POLAR_AMP/lmax (and mirrored)
POLAR_MMAX = 128    # m-extent of the near-pole pass
TCHUNK = 2048       # rings per analysis chunk
MAX_PLANES = 8      # partial-sum planes per analysis kernel launch
KERNEL_C = (4, 2)   # coefficient columns a kernel instantiation takes

KERNELS = ("sym_synthesis", "sym_analysis", "full_synthesis", "full_analysis")
LAUNCHES = {name: 0 for name in KERNELS}
LAUNCHES_BY_MODE = {(name, mode): 0 for name in KERNELS for mode in sht_core.MODES}


def reset_launches():
	for k in LAUNCHES: LAUNCHES[k] = 0
	for k in LAUNCHES_BY_MODE: LAUNCHES_BY_MODE[k] = 0


# ---------------------------------------------------------------------------
# Host-side preparation
# ---------------------------------------------------------------------------
def detect_sym(theta):
	"""Number of northern rings nh if theta (ascending, float64) is
	south-symmetric (theta[::-1] == pi - theta) with 16..2*SYM_MAX_NH rings,
	else None (pixell_tpu.ops.sht_pallas._detect_sym). Ring i pairs with
	nt-1-i; for odd nt the middle ring pairs with itself."""
	th = np.asarray(theta, np.float64)
	if th.ndim != 1 or th.shape[0] < 16 or th.shape[0] > 2*SYM_MAX_NH: return None
	if not np.allclose(th[::-1], np.pi - th, atol=1e-6): return None
	return (th.shape[0] + 1)//2


def polar_counts(theta, lmax):
	"""(n_north, n_south): rings within POLAR_AMP/lmax of either pole, for
	ascending theta (pixell_tpu.ops.sht_pallas._polar_counts)."""
	th = np.asarray(theta, np.float64)
	tcut = POLAR_AMP/max(lmax, 1)
	return int(np.searchsorted(th, tcut)), int(np.sum(th > np.pi - tcut))


def coef_tables(nl, nm, dtype, device=None):
	"""[3, nl, nm]: the recurrence coefficients a_lm, b_lm and the mode
	functions' e_lm, computed outside the kernels with correctly rounded
	sqrt and divide by the plain scan's own formulas (sht_core.recur_ab,
	recur_e; pixell_tpu.ops.sht_pallas._recur_ab_tables :88)."""
	l = torch.arange(nl, dtype=dtype, device=device)[:, None]
	m = torch.arange(nm, dtype=dtype, device=device)[None, :]
	a, b = sht_core.recur_ab(l, m)
	return torch.stack([a, b, sht_core.recur_e(l, m)]).contiguous()


def l_tables(nl, mode, dtype, device=None):
	"""[2, nl]: the per-degree norm and half pole factor of the mode
	functions (sht_core.l_norms); zeros in scalar mode, which reads none."""
	if mode == "scalar": return torch.zeros((2, nl), dtype=dtype, device=device)
	return torch.stack(sht_core.l_norms(mode, torch.arange(nl, dtype=dtype, device=device)))


@functools.lru_cache(maxsize=8)
def _coef_cached(nl, nm, dtype, device):
	return coef_tables(nl, nm, dtype, device)


@functools.lru_cache(maxsize=16)
def _lt_cached(nl, mode, dtype, device):
	return l_tables(nl, mode, dtype, device)


@functools.lru_cache(maxsize=16)
def _geom_cached(theta_bytes, mmax, dtype, device):
	theta = np.frombuffer(theta_bytes, np.float64)
	return sht_core.prepare_geom(theta, mmax, dtype, device)


def geom(theta, mmax, dtype, device):
	"""Seeds, two-part cos(theta) and mode rows for the rings theta, cached
	per ring set, dtype and device (pixell_tpu.ops.sht_pallas._prep_inputs
	:468 and _ct_parts :454)."""
	th = np.ascontiguousarray(theta, np.float64)
	return _geom_cached(th.tobytes(), int(mmax), dtype, torch.device(device))


# ---------------------------------------------------------------------------
# Kernel wrappers
# ---------------------------------------------------------------------------
@functools.lru_cache(maxsize=None)
def library():
	"""The built kernel library, with argument types declared."""
	lib = _build.load()
	P, I = ctypes.c_void_p, ctypes.c_int
	for mode in sht_core.MODES:
		for name in ("pt_sym_synthesis", "pt_full_synthesis"):
			fn = getattr(lib, "%s_%s" % (name, mode))
			fn.argtypes = [I, I] + [P]*9 + [I]*3 + [P]
			fn.restype = I
		for name in ("pt_sym_analysis", "pt_full_analysis"):
			fn = getattr(lib, "%s_%s" % (name, mode))
			fn.argtypes = [I, I] + [P]*9 + [I]*4 + [P]
			fn.restype = I
	lib.pt_tile_theta_scalar.argtypes = []
	lib.pt_tile_theta_scalar.restype = I
	return lib


def _on_card(x):
	"""True for a CUDA tensor (launch the kernel), False for a CPU tensor
	(run the plain version); any other device raises."""
	if x.device.type == "cuda": return True
	if x.device.type == "cpu": return False
	raise RuntimeError("no Legendre kernel for device '%s'" % x.device)


def _check(x, g, shape, what):
	if x.dtype != g.dtype:
		raise TypeError("%s: dtype %s does not match the geometry's %s" % (what, x.dtype, g.dtype))
	if x.device != g.ct.device:
		raise ValueError("%s: tensor on %s, geometry on %s" % (what, x.device, g.ct.device))
	if tuple(x.shape) != tuple(shape):
		raise ValueError("%s: shape %s, expected %s" % (what, tuple(x.shape), tuple(shape)))
	if max(shape) >= 2**31:
		raise ValueError("%s: shape %s too large" % (what, tuple(x.shape)))


def _ptrs(g, ab, lt):
	return [ab.data_ptr(), lt.data_ptr(), g.ct.data_ptr(), g.ct_lo.data_ptr(),
		g.rows.data_ptr(), g.seed_val.data_ptr(), g.seed_level.data_ptr()]


def _launch(name, mode, device, *args):
	# the C entry points launch on the thread's current device
	with torch.cuda.device(device):
		err = getattr(library(), "pt_%s_%s" % (name, mode))(*args)
	if err != 0:
		raise RuntimeError("%s (%s) kernel launch failed: CUDA error %d" % (name, mode, err))
	LAUNCHES[name] += 1
	LAUNCHES_BY_MODE[(name, mode)] += 1


def _col_chunks(C):
	"""Split C coefficient columns into launches of KERNEL_C widths, widest
	first: a spin-2 block (C = 4) runs its recurrence once. C is even, as
	the SHT's (re, im) column pairs make it."""
	if C % 2: raise ValueError("the kernels take an even number of columns, not %d" % C)
	out, c0 = [], 0
	while c0 < C:
		w = next(k for k in KERNEL_C if k <= C - c0)
		out.append((c0, c0 + w)); c0 += w
	return out


def _synthesis_launch(name, A, g, lmax, mode, out_shape_of):
	nl, nm, C = A.shape
	ab = _coef_cached(nl, nm, g.dtype, A.device)
	lt = _lt_cached(nl, mode, g.dtype, A.device)
	stream = torch.cuda.current_stream(A.device).cuda_stream
	outs = []
	for c0, c1 in _col_chunks(C):
		Ac = A[..., c0:c1].contiguous()
		out = torch.empty(out_shape_of(c1 - c0), dtype=g.dtype, device=A.device)
		_launch(name, mode, A.device, int(g.dtype == torch.float64), c1 - c0, Ac.data_ptr(),
			*_ptrs(g, ab, lt), out.data_ptr(), nl, nm, g.nt, stream)
		outs.append(out)
	return torch.cat(outs, 1)


def _analysis_launch(name, F, g, lmax, mode):
	C = F.shape[1]
	nl, nm = lmax + 1, g.nm
	ab = _coef_cached(nl, nm, g.dtype, F.device)
	lt = _lt_cached(nl, mode, g.dtype, F.device)
	stream = torch.cuda.current_stream(F.device).cuda_stream
	ntiles = -(-g.nt//library().pt_tile_theta_scalar())
	# each plane loops over an equal share of the ring tiles
	nplanes = -(-ntiles//(-(-ntiles//MAX_PLANES)))
	outs = []
	for c0, c1 in _col_chunks(C):
		Fc = F[:, c0:c1].contiguous()
		part = torch.zeros((nplanes, nl, nm, c1 - c0), dtype=g.dtype, device=F.device)
		_launch(name, mode, F.device, int(g.dtype == torch.float64), c1 - c0, Fc.data_ptr(),
			*_ptrs(g, ab, lt), part.data_ptr(), nl, nm, g.nt, nplanes, stream)
		outs.append(part.sum(0))
	return torch.cat(outs, -1)


def _parity(nl, nm, dtype, device):
	"""(-1)^(l+m) as [nl, nm]."""
	lm = torch.arange(nl, device=device)[:, None] + torch.arange(nm, device=device)[None, :]
	return (1 - 2*(lm % 2)).to(dtype)


def _psign(mode, dtype, device):
	return torch.tensor(PSIGN[mode], dtype=dtype, device=device)


def _sym_synthesis_plain(A, g, lmax, mode="scalar"):
	C = A.shape[-1]
	sgn = _parity(lmax + 1, g.nm, A.dtype, A.device)[..., None]
	# one pass: the mirror ring is sum_l PSIGN[f] (-1)^(l+m) u_f A
	G = sht_core.synthesis(torch.cat([A, A*sgn], -1), g, lmax, mode)   # [nfun, 2C, nm, nh]
	mirror = G[:, C:]*_psign(mode, G.dtype, G.device)[:, None, None, None]
	return torch.stack([G[:, :C], mirror], 2)

def _even_odd(EO, mode):
	"""EO [nfun, C, 2, nm, nh] -> [nfun, 2C, nm, nh]: for each function the
	plane it reads at even l+m, then the one at odd l+m. Function f reads
	the even plane where PSIGN[f] (-1)^(l+m) = +1."""
	even = torch.stack([EO[f, :, 0 if s > 0 else 1] for f, s in enumerate(PSIGN[mode])])
	odd = torch.stack([EO[f, :, 1 if s > 0 else 0] for f, s in enumerate(PSIGN[mode])])
	return torch.cat([even, odd], 1)

def _sym_analysis_plain(EO, g, lmax, mode="scalar"):
	C = EO.shape[1]
	# one pass for the even (l+m), one for the odd, selected per (l, m)
	R = sht_core.analysis(_even_odd(EO, mode), g, lmax, mode)   # [nl, nm, 2C]
	lodd = _parity(lmax + 1, g.nm, torch.int64, EO.device)[..., None] < 0
	return torch.where(lodd, R[..., C:], R[..., :C])

# The plain PyTorch version of each kernel, on the same arguments (mode
# included). The wrappers use it for CPU tensors; it runs on any device.
PLAIN = {"sym_synthesis": _sym_synthesis_plain, "sym_analysis": _sym_analysis_plain,
	"full_synthesis": sht_core.synthesis, "full_analysis": sht_core.analysis}


def sym_synthesis(A, g, lmax, mode="scalar"):
	"""K1: half-sky synthesis. A [nl, nm, C] on the northern rings of g ->
	[nfun, C, 2, nm, nh]: plane 0 is ring t, plane 1 its mirror
	pi - theta_t, from u_f(pi - theta) = PSIGN[f] (-1)^(l+m) u_f(theta)."""
	sht_core.check_mode(mode)
	nl, C = lmax + 1, A.shape[-1]
	_check(A, g, (nl, g.nm, C), "sym_synthesis")
	if not _on_card(A): return PLAIN["sym_synthesis"](A, g, lmax, mode)
	return _synthesis_launch("sym_synthesis", A, g, lmax, mode,
		lambda c: (NFUN[mode], c, 2, g.nm, g.nt))


def full_synthesis(A, g, lmax, mode="scalar"):
	"""K3: synthesis on any ring set. A [nl, nm, C] -> [nfun, C, nm, nt]."""
	sht_core.check_mode(mode)
	nl, C = lmax + 1, A.shape[-1]
	_check(A, g, (nl, g.nm, C), "full_synthesis")
	if not _on_card(A): return PLAIN["full_synthesis"](A, g, lmax, mode)
	return _synthesis_launch("full_synthesis", A, g, lmax, mode,
		lambda c: (NFUN[mode], c, g.nm, g.nt))


def sym_analysis(EO, g, lmax, mode="scalar"):
	"""K2: half-sky analysis. EO [nfun, C, 2, nm, nh] holds E = F_north +
	F_south and O = F_north - F_south on the northern rings of g ->
	[nl, nm, C]; function f of (l, m) takes E where PSIGN[f] (-1)^(l+m) is
	+1 and O where it is -1."""
	sht_core.check_mode(mode)
	C = EO.shape[1]
	_check(EO, g, (NFUN[mode], C, 2, g.nm, g.nt), "sym_analysis")
	if not _on_card(EO): return PLAIN["sym_analysis"](EO, g, lmax, mode)
	return _analysis_launch("sym_analysis", EO, g, lmax, mode)


def full_analysis(F, g, lmax, mode="scalar"):
	"""K4: analysis on any ring set. F [nfun, C, nm, nt] -> [nl, nm, C]."""
	sht_core.check_mode(mode)
	C = F.shape[1]
	_check(F, g, (NFUN[mode], C, g.nm, g.nt), "full_analysis")
	if not _on_card(F): return PLAIN["full_analysis"](F, g, lmax, mode)
	return _analysis_launch("full_analysis", F, g, lmax, mode)


# ---------------------------------------------------------------------------
# Dispatch
# ---------------------------------------------------------------------------
def synthesis_scan(A, theta, lmax, mmax, mode="scalar", dtype=torch.float32):
	"""G[f,c,m,t] = sum_l u_f(l,m,theta_t) A[l,m,c] with the recurrence in
	dtype: the plain scan on CPU, the kernels on CUDA."""
	if not _on_card(A):
		return sht_core.synthesis_scan(A, theta, lmax, mmax, mode=mode, dtype=dtype)
	return kernel_synthesis(A, theta, lmax, mmax, mode, dtype)


def analysis_scan(F, theta, lmax, mmax, mode="scalar", dtype=torch.float32):
	"""A[l,m,c] = sum_f sum_t u_f(l,m,theta_t) F[f,c,m,t] with the recurrence
	in dtype: the plain scan on CPU, the kernels on CUDA."""
	if not _on_card(F):
		return sht_core.analysis_scan(F, theta, lmax, mmax, mode=mode, dtype=dtype)
	return kernel_analysis(F, theta, lmax, mmax, mode, dtype)


def _polar_split(theta, lmax, mmax):
	"""(nn, ns, Mp, polar theta) of the near-pole pass."""
	nn, ns = polar_counts(theta, lmax)
	nt = len(theta)
	return nn, ns, min(mmax + 1, POLAR_MMAX), np.concatenate([theta[:nn], theta[nt-ns:]])


def kernel_synthesis(A, theta, lmax, mmax, mode="scalar", dtype=torch.float32):
	"""The kernel dispatch of synthesis_scan (pixell_tpu.ops.sht_pallas.
	synthesis_scan_pallas :498): A [nl, nm, C] -> [nfun, C, nm, nt]. Runs
	the kernels' plain versions on CPU tensors."""
	theta = np.asarray(theta, np.float64)
	nt = len(theta)
	if dtype == torch.float64:
		return _synth_rings(A, theta, lmax, mmax, mode, dtype)
	if dtype != torch.float32: raise TypeError("dtype must be float32 or float64")
	nn, ns, Mp, pth = _polar_split(theta, lmax, mmax)
	if nn + ns >= nt:
		# a ring set that is all near-pole runs entirely in float64
		return _synth_rings(A, theta, lmax, mmax, mode, torch.float64).to(dtype)
	G = _synth_rings(A, theta, lmax, mmax, mode, dtype)
	if nn or ns:
		# overwrite the near-pole rings, for m < POLAR_MMAX, with a float64
		# pass: the recurrence amplifies f32 rounding there by ~min(l, 1/theta)^2
		pol = full_synthesis(A[:, :Mp].to(torch.float64).contiguous(),
			geom(pth, Mp - 1, torch.float64, A.device), lmax, mode).to(dtype)
		G[..., :Mp, :nn] = pol[..., :nn]
		G[..., :Mp, nt-ns:] = pol[..., nn:]
	return G


def _synth_rings(A, theta, lmax, mmax, mode, dtype):
	"""[nfun, C, nm, nt] through K1 (symmetric ring set) or K3."""
	A = A.to(dtype).contiguous()
	nt = len(theta)
	nh = detect_sym(theta)
	if nh is None:
		return full_synthesis(A, geom(theta, mmax, dtype, A.device), lmax, mode)
	pair = sym_synthesis(A, geom(theta[:nh], mmax, dtype, A.device), lmax, mode)
	return torch.cat([pair[:, :, 0], pair[:, :, 1, :, :nt - nh].flip(-1)], -1)


def kernel_analysis(F, theta, lmax, mmax, mode="scalar", dtype=torch.float32):
	"""The kernel dispatch of analysis_scan (pixell_tpu.ops.sht_pallas.
	analysis_scan_pallas_chunked :2108 with _maybe_polar_analysis :1797):
	F [nfun, C, nm, nt] -> [nl, nm, C]. Runs the kernels' plain versions on
	CPU tensors."""
	theta = np.asarray(theta, np.float64)
	nt = len(theta)
	if dtype == torch.float64:
		return _anal_rings(F, theta, lmax, mmax, mode, dtype)
	if dtype != torch.float32: raise TypeError("dtype must be float32 or float64")
	nn, ns, Mp, pth = _polar_split(theta, lmax, mmax)
	if nn + ns >= nt:
		return _anal_rings(F, theta, lmax, mmax, mode, torch.float64).to(dtype)
	if not (nn or ns):
		return _anal_rings(F, theta, lmax, mmax, mode, dtype)
	out = _anal_rings(F[..., nn:nt-ns], theta[nn:nt-ns], lmax, mmax, mode, dtype)
	# near-pole rings contribute through a float64 pass, for m < POLAR_MMAX
	Fp = torch.cat([F[..., :nn], F[..., nt-ns:]], -1)[..., :Mp, :]
	pol = full_analysis(Fp.to(torch.float64).contiguous(),
		geom(pth, Mp - 1, torch.float64, F.device), lmax, mode)
	out[:, :Mp] += pol.to(dtype)
	return out


def _anal_rings(F, theta, lmax, mmax, mode, dtype):
	"""[nl, nm, C] through K2 (symmetric ring set) or K4, in chunks of
	TCHUNK rings (pixell_tpu.ops.sht_pallas._analysis_sym_entry :1825)."""
	F = F.to(dtype)
	nt = F.shape[-1]
	nh = detect_sym(theta)
	if nh is not None:
		# even/odd hemisphere combinations on the northern rings
		south = F[..., nh:].flip(-1)
		if nt - nh < nh:   # odd nt: the middle ring pairs with itself
			south = torch.nn.functional.pad(south, (0, nh - (nt - nh)))
		north = F[..., :nh]
		F, theta, kern = torch.stack([north + south, north - south], 2), theta[:nh], sym_analysis
	else:
		kern = full_analysis
	out = None
	for i0 in range(0, len(theta), TCHUNK):
		i1 = min(i0 + TCHUNK, len(theta))
		part = kern(F[..., i0:i1].contiguous(), geom(theta[i0:i1], mmax, dtype, F.device),
			lmax, mode)
		out = part if out is None else out + part
	return out
