"""Legendre-stage dispatch and the CUDA kernel wrappers.

Counterpart of pixell_tpu/ops/sht_pallas.py. The kernels themselves are in
pixell_tpu_torch/csrc/legendre.cu, each in the modes scalar, deriv, spin1
and spin2 (K6):

  sym_synthesis   K1, replaces _synthesis_scan_pallas_sym (sht_pallas.py:1686)
  sym_analysis    K2, replaces _analysis_scan_pallas_sym (sht_pallas.py:1850)
  full_synthesis  K3, replaces _synthesis_scan_pallas_full (sht_pallas.py:1540)
  full_analysis   K4, replaces _analysis_scan_pallas_full (sht_pallas.py:1954)

and K3/K4 also in the wigner mode (K7, any spin s; wigner_synthesis_scan_pallas
sht_pallas.py:2165, wigner_analysis_scan_pallas :2221), on a geometry prepared
with that s. K3/K4 take a table of dead tiles (the reference's lstop,
_dead_table sht_pallas.py:677): blocks beyond the horizon of their rings,
which they skip.

Each wrapper takes prepared tables (sht_core.Geom plus the coefficient
tables built here), checks its arguments, and launches its kernel on a CUDA
tensor, adding one to LAUNCHES[name], to LAUNCHES_BY_MODE[(name, mode)] and
to LAUNCHES_BY_DTYPE[(name, mode, "float32" or "float64")].
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
  - wigner mode (wigner_synthesis_scan_pallas :2165, wigner_analysis_scan_pallas
    :2221): always K3/K4, the near-pole pass for m < max(POLAR_MMAX, s + 1).
  - the dead-tile table goes to every float32 launch of K3/K4, with the
    mode's s (0 for the Legendre modes). The float64 launches compute every
    tile: the skipped terms, ~1e-12 of the peak and up to ~1e-7 in spin 2,
    are above what a float64 transform promises.
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
TILE_M, TILE_T = 4, 64   # m rows and rings of a kernel block (csrc/legendre.cu MY, TX)

KERNELS = ("sym_synthesis", "sym_analysis", "full_synthesis", "full_analysis")
LAUNCHES = {name: 0 for name in KERNELS}
LAUNCHES_BY_MODE = {(name, mode): 0 for name in KERNELS for mode in sht_core.MODES}
LAUNCHES_BY_DTYPE = {k + (dt,): 0 for k in LAUNCHES_BY_MODE for dt in ("float32", "float64")}


def reset_launches():
	for d in (LAUNCHES, LAUNCHES_BY_MODE, LAUNCHES_BY_DTYPE):
		for k in d: d[k] = 0


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


def wigner_tables(nl, nm, s, dtype, device=None):
	"""[3, nl, nm]: a = 1/v(l), b = v(l-1) and c = m s/((l-1) l) of the
	Wigner-d recurrence for spin s (sht_core.wigner_abc; pixell_tpu.ops.
	sht_pallas._wigner_ab_tables :108), zero for l <= max(m, s). The two
	branches share a and b and take +c and -c. Computed in float64 and
	rounded once to dtype: near the poles the recurrence amplifies the
	rounding of c by ~l^2, so the float64 near-pole pass reads float64
	tables."""
	l = torch.arange(nl, dtype=torch.float64, device=device)[:, None]
	m = torch.arange(nm, dtype=torch.float64, device=device)[None, :]
	return torch.stack(sht_core.wigner_abc(l, m, s)).to(dtype).contiguous()


def l_tables(nl, mode, dtype, device=None):
	"""[2, nl]: the per-degree norm and half pole factor of the mode
	functions (sht_core.l_norms); zeros in the scalar and wigner modes, which
	read none."""
	if mode in ("scalar", "wigner"): return torch.zeros((2, nl), dtype=dtype, device=device)
	return torch.stack(sht_core.l_norms(mode, torch.arange(nl, dtype=dtype, device=device)))


def dead_table(theta, lmax, mmax, tile_m, tile_t, s=0):
	"""[ceil(nm/tile_m), ceil(nt/tile_t)] bool: True where a tile of tile_m
	m rows by tile_t rings lies wholly beyond the horizon,
	m_lo - s > lmax max(sin theta) + 1.6 sqrt(lmax) + 20, so that every
	lambda_lm (or d^l_ms) on it is below ~1e-12 for every l <= lmax
	(pixell_tpu.ops.sht_pallas._dead_table :677). s is 0 for the Legendre
	modes, which are all built on lambda_lm, and the spin in wigner mode."""
	th = np.asarray(theta, np.float64)
	nmb, ntb = -(-(mmax + 1)//tile_m), -(-len(th)//tile_t)
	st = np.zeros(ntb*tile_t)
	st[:len(th)] = np.sin(th)
	smax = st.reshape(ntb, tile_t).max(1)
	slack = 1.6*np.sqrt(max(lmax, 1)) + 20
	m_lo = np.arange(nmb)*tile_m
	return (m_lo[:, None] - s) > (lmax*smax[None, :] + slack)


@functools.lru_cache(maxsize=32)
def _dead_cached(theta_bytes, lmax, mmax, s, device):
	dead = dead_table(np.frombuffer(theta_bytes, np.float64), lmax, mmax, TILE_M, TILE_T, s)
	return torch.from_numpy(dead.astype(np.int32)).to(device) if dead.any() else None


def dead_tiles(theta, lmax, mmax, s, device):
	"""The dead-tile table of K3/K4's own blocks for the rings theta, as an
	int32 tensor [ceil(nm/TILE_M), ceil(nt/TILE_T)] on device (1 = dead), or
	None where no tile is dead (pixell_tpu.ops.sht_pallas._dead_lstop :704).
	Cached per ring set."""
	th = np.ascontiguousarray(theta, np.float64)
	return _dead_cached(th.tobytes(), int(lmax), int(mmax), int(s), torch.device(device))


def live_mask(dead, nm, nt):
	"""[nm, nt] bool from a dead-tile table: the entries K3/K4 compute."""
	full = dead.repeat_interleave(TILE_M, 0).repeat_interleave(TILE_T, 1)
	return full[:nm, :nt] == 0


@functools.lru_cache(maxsize=8)
def _coef_cached(nl, nm, dtype, device, s=None):
	if s is not None: return wigner_tables(nl, nm, s, dtype, device)
	return coef_tables(nl, nm, dtype, device)


@functools.lru_cache(maxsize=16)
def _lt_cached(nl, mode, dtype, device):
	return l_tables(nl, mode, dtype, device)


@functools.lru_cache(maxsize=16)
def _geom_cached(theta_bytes, mmax, dtype, device, s):
	theta = np.frombuffer(theta_bytes, np.float64)
	return sht_core.prepare_geom(theta, mmax, dtype, device, s)


def geom(theta, mmax, dtype, device, s=None):
	"""Seeds, two-part cos(theta) and mode rows for the rings theta, cached
	per ring set, dtype and device (pixell_tpu.ops.sht_pallas._prep_inputs
	:468 and _ct_parts :454); with s, for the wigner mode at spin s."""
	th = np.ascontiguousarray(theta, np.float64)
	return _geom_cached(th.tobytes(), int(mmax), dtype, torch.device(device),
		None if s is None else int(s))


# ---------------------------------------------------------------------------
# Kernel wrappers
# ---------------------------------------------------------------------------
@functools.lru_cache(maxsize=None)
def library():
	"""The built kernel library, with argument types declared."""
	lib = _build.load()
	P, I = ctypes.c_void_p, ctypes.c_int
	for mode in sht_core.MODES:
		for name in KERNELS:
			if mode == "wigner" and name.startswith("sym"): continue   # no half-sky form
			fn = getattr(lib, "pt_%s_%s" % (name, mode))
			# (f64, C), 9 pointers, (nl, nm, nt[, nplanes], s), the dead table, the stream
			fn.argtypes = [I, I] + [P]*9 + [I]*(4 if name.endswith("synthesis") else 5) + [P, P]
			fn.restype = I
	for fn, want in ((lib.pt_tile_theta_scalar, TILE_T), (lib.pt_tile_m_scalar, TILE_M)):
		fn.argtypes, fn.restype = [], I
		if fn() != want:
			raise RuntimeError("the built kernels' block is not TILE_M x TILE_T = %d x %d"
				% (TILE_M, TILE_T))
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


def _launch(name, mode, device, f64, *args):
	# the C entry points launch on the thread's current device
	with torch.cuda.device(device):
		err = getattr(library(), "pt_%s_%s" % (name, mode))(int(f64), *args)
	if err != 0:
		raise RuntimeError("%s (%s) kernel launch failed: CUDA error %d" % (name, mode, err))
	LAUNCHES[name] += 1
	LAUNCHES_BY_MODE[(name, mode)] += 1
	LAUNCHES_BY_DTYPE[(name, mode, "float64" if f64 else "float32")] += 1


def _mode_args(g, nl, mode, dead, device):
	"""(ab, lt, s, dead pointer) of a launch in mode on geometry g, after
	checking that the geometry fits the mode and the dead table the grid."""
	if (mode == "wigner") != (g.s is not None):
		raise ValueError("mode '%s' on a geometry prepared %s a spin" % (mode,
			"without" if g.s is None else "with"))
	if dead is not None:
		want = (-(-g.nm//TILE_M), -(-g.nt//TILE_T))
		if dead.dtype != torch.int32 or dead.device != device or tuple(dead.shape) != want \
				or not dead.is_contiguous():
			raise ValueError("dead-tile table: need contiguous int32 %s on %s" % (want, device))
	return (_coef_cached(nl, g.nm, g.dtype, device, g.s), _lt_cached(nl, mode, g.dtype, device),
		0 if g.s is None else int(g.s), 0 if dead is None else dead.data_ptr())


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


def _synthesis_launch(name, A, g, lmax, mode, out_shape_of, dead=None):
	nl, nm, C = A.shape
	ab, lt, s, dead_ptr = _mode_args(g, nl, mode, dead, A.device)
	stream = torch.cuda.current_stream(A.device).cuda_stream
	outs = []
	for c0, c1 in _col_chunks(C):
		Ac = A[..., c0:c1].contiguous()
		out = torch.empty(out_shape_of(c1 - c0), dtype=g.dtype, device=A.device)
		_launch(name, mode, A.device, g.dtype == torch.float64, c1 - c0, Ac.data_ptr(),
			*_ptrs(g, ab, lt), out.data_ptr(), nl, nm, g.nt, s, dead_ptr, stream)
		outs.append(out)
	return torch.cat(outs, 1)


def _analysis_launch(name, F, g, lmax, mode, dead=None):
	C = F.shape[1]
	nl, nm = lmax + 1, g.nm
	ab, lt, s, dead_ptr = _mode_args(g, nl, mode, dead, F.device)
	stream = torch.cuda.current_stream(F.device).cuda_stream
	ntiles = -(-g.nt//TILE_T)
	# each plane loops over an equal share of the ring tiles
	nplanes = -(-ntiles//(-(-ntiles//MAX_PLANES)))
	outs = []
	for c0, c1 in _col_chunks(C):
		Fc = F[:, c0:c1].contiguous()
		part = torch.zeros((nplanes, nl, nm, c1 - c0), dtype=g.dtype, device=F.device)
		_launch(name, mode, F.device, g.dtype == torch.float64, c1 - c0, Fc.data_ptr(),
			*_ptrs(g, ab, lt), part.data_ptr(), nl, nm, g.nt, nplanes, s, dead_ptr, stream)
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

def _full_synthesis_plain(A, g, lmax, mode="scalar", dead=None):
	return sht_core.synthesis(A, g, lmax, mode,
		None if dead is None else live_mask(dead, g.nm, g.nt))

def _full_analysis_plain(F, g, lmax, mode="scalar", dead=None):
	return sht_core.analysis(F, g, lmax, mode,
		None if dead is None else live_mask(dead, g.nm, g.nt))

# The plain PyTorch version of each kernel, on the same arguments (mode and
# dead table included). The wrappers use it for CPU tensors; it runs on any
# device.
PLAIN = {"sym_synthesis": _sym_synthesis_plain, "sym_analysis": _sym_analysis_plain,
	"full_synthesis": _full_synthesis_plain, "full_analysis": _full_analysis_plain}


def _check_sym_mode(mode):
	sht_core.check_mode(mode)
	if mode not in PSIGN: raise ValueError("the half-sky kernels have no '%s' mode" % mode)


def sym_synthesis(A, g, lmax, mode="scalar"):
	"""K1: half-sky synthesis. A [nl, nm, C] on the northern rings of g ->
	[nfun, C, 2, nm, nh]: plane 0 is ring t, plane 1 its mirror
	pi - theta_t, from u_f(pi - theta) = PSIGN[f] (-1)^(l+m) u_f(theta)."""
	_check_sym_mode(mode)
	nl, C = lmax + 1, A.shape[-1]
	_check(A, g, (nl, g.nm, C), "sym_synthesis")
	if not _on_card(A): return PLAIN["sym_synthesis"](A, g, lmax, mode)
	return _synthesis_launch("sym_synthesis", A, g, lmax, mode,
		lambda c: (NFUN[mode], c, 2, g.nm, g.nt))


def full_synthesis(A, g, lmax, mode="scalar", dead=None):
	"""K3 (K7 in wigner mode, on a geometry prepared with the spin):
	synthesis on any ring set. A [nl, nm, C] -> [nfun, C, nm, nt]. dead, a
	table from dead_tiles, marks blocks to skip, whose output is 0; None
	skips nothing."""
	sht_core.check_mode(mode)
	nl, C = lmax + 1, A.shape[-1]
	_check(A, g, (nl, g.nm, C), "full_synthesis")
	if not _on_card(A): return PLAIN["full_synthesis"](A, g, lmax, mode, dead)
	return _synthesis_launch("full_synthesis", A, g, lmax, mode,
		lambda c: (NFUN[mode], c, g.nm, g.nt), dead)


def sym_analysis(EO, g, lmax, mode="scalar"):
	"""K2: half-sky analysis. EO [nfun, C, 2, nm, nh] holds E = F_north +
	F_south and O = F_north - F_south on the northern rings of g ->
	[nl, nm, C]; function f of (l, m) takes E where PSIGN[f] (-1)^(l+m) is
	+1 and O where it is -1."""
	_check_sym_mode(mode)
	C = EO.shape[1]
	_check(EO, g, (NFUN[mode], C, 2, g.nm, g.nt), "sym_analysis")
	if not _on_card(EO): return PLAIN["sym_analysis"](EO, g, lmax, mode)
	return _analysis_launch("sym_analysis", EO, g, lmax, mode)


def full_analysis(F, g, lmax, mode="scalar", dead=None):
	"""K4 (K7 in wigner mode, on a geometry prepared with the spin): analysis
	on any ring set. F [nfun, C, nm, nt] -> [nl, nm, C]. dead, a table from
	dead_tiles, marks blocks whose rings are not read; None skips nothing."""
	sht_core.check_mode(mode)
	C = F.shape[1]
	_check(F, g, (NFUN[mode], C, g.nm, g.nt), "full_analysis")
	if not _on_card(F): return PLAIN["full_analysis"](F, g, lmax, mode, dead)
	return _analysis_launch("full_analysis", F, g, lmax, mode, dead)


# ---------------------------------------------------------------------------
# Dispatch
# ---------------------------------------------------------------------------
def synthesis_scan(A, theta, lmax, mmax, mode="scalar", dtype=torch.float32, s=None):
	"""G[f,c,m,t] = sum_l u_f(l,m,theta_t) A[l,m,c] with the recurrence in
	dtype: the plain scan on CPU, the kernels on CUDA. mode "wigner" takes
	the spin s."""
	if not _on_card(A):
		return sht_core.synthesis(A, geom(theta, mmax, dtype, A.device, s), lmax, mode)
	return kernel_synthesis(A, theta, lmax, mmax, mode, dtype, s)


def analysis_scan(F, theta, lmax, mmax, mode="scalar", dtype=torch.float32, s=None):
	"""A[l,m,c] = sum_f sum_t u_f(l,m,theta_t) F[f,c,m,t] with the recurrence
	in dtype: the plain scan on CPU, the kernels on CUDA. mode "wigner" takes
	the spin s."""
	if not _on_card(F):
		return sht_core.analysis(F, geom(theta, mmax, dtype, F.device, s), lmax, mode)
	return kernel_analysis(F, theta, lmax, mmax, mode, dtype, s)


def _polar_split(theta, lmax, mmax, s=None):
	"""(nn, ns, Mp, polar theta) of the near-pole pass; in wigner mode its
	m-extent covers the spin (pixell_tpu.ops.sht_pallas._wigner_polar_mmax
	:2142)."""
	nn, ns = polar_counts(theta, lmax)
	nt = len(theta)
	Mp = min(mmax + 1, POLAR_MMAX if s is None else max(POLAR_MMAX, int(s) + 1))
	return nn, ns, Mp, np.concatenate([theta[:nn], theta[nt-ns:]])


def _check_spin(mode, s):
	sht_core.check_mode(mode)
	if (mode == "wigner") != (s is not None):
		raise ValueError("mode '%s' %s a spin s" % (mode, "needs" if s is None else "takes no"))


def kernel_synthesis(A, theta, lmax, mmax, mode="scalar", dtype=torch.float32, s=None):
	"""The kernel dispatch of synthesis_scan (pixell_tpu.ops.sht_pallas.
	synthesis_scan_pallas :498, wigner_synthesis_scan_pallas :2165):
	A [nl, nm, C] -> [nfun, C, nm, nt]. Runs the kernels' plain versions on
	CPU tensors."""
	_check_spin(mode, s)
	theta = np.asarray(theta, np.float64)
	nt = len(theta)
	if dtype == torch.float64:
		return _synth_rings(A, theta, lmax, mmax, mode, dtype, s)
	if dtype != torch.float32: raise TypeError("dtype must be float32 or float64")
	nn, ns, Mp, pth = _polar_split(theta, lmax, mmax, s)
	if nn + ns >= nt:
		# a ring set that is all near-pole runs entirely in float64
		return _synth_rings(A, theta, lmax, mmax, mode, torch.float64, s).to(dtype)
	G = _synth_rings(A, theta, lmax, mmax, mode, dtype, s)
	if nn or ns:
		# overwrite the near-pole rings, for m < Mp, with a float64 pass: the
		# recurrence amplifies f32 rounding there by ~min(l, 1/theta)^2
		pol = full_synthesis(A[:, :Mp].to(torch.float64).contiguous(),
			geom(pth, Mp - 1, torch.float64, A.device, s), lmax, mode).to(dtype)
		G[..., :Mp, :nn] = pol[..., :nn]
		G[..., :Mp, nt-ns:] = pol[..., nn:]
	return G


def _f32_dead(theta, lmax, mmax, dtype, s, device):
	"""The dead-tile table for a K3/K4 launch in dtype: float32 only."""
	if dtype != torch.float32: return None
	return dead_tiles(theta, lmax, mmax, 0 if s is None else s, device)


def _synth_rings(A, theta, lmax, mmax, mode, dtype, s=None):
	"""[nfun, C, nm, nt] through K1 (symmetric ring set, Legendre modes) or K3."""
	A = A.to(dtype).contiguous()
	nt = len(theta)
	nh = None if mode == "wigner" else detect_sym(theta)
	if nh is None:
		return full_synthesis(A, geom(theta, mmax, dtype, A.device, s), lmax, mode,
			_f32_dead(theta, lmax, mmax, dtype, s, A.device))
	pair = sym_synthesis(A, geom(theta[:nh], mmax, dtype, A.device), lmax, mode)
	return torch.cat([pair[:, :, 0], pair[:, :, 1, :, :nt - nh].flip(-1)], -1)


def kernel_analysis(F, theta, lmax, mmax, mode="scalar", dtype=torch.float32, s=None):
	"""The kernel dispatch of analysis_scan (pixell_tpu.ops.sht_pallas.
	analysis_scan_pallas_chunked :2108 with _maybe_polar_analysis :1797,
	wigner_analysis_scan_pallas :2221): F [nfun, C, nm, nt] -> [nl, nm, C].
	Runs the kernels' plain versions on CPU tensors."""
	_check_spin(mode, s)
	theta = np.asarray(theta, np.float64)
	nt = len(theta)
	if dtype == torch.float64:
		return _anal_rings(F, theta, lmax, mmax, mode, dtype, s)
	if dtype != torch.float32: raise TypeError("dtype must be float32 or float64")
	nn, ns, Mp, pth = _polar_split(theta, lmax, mmax, s)
	if nn + ns >= nt:
		return _anal_rings(F, theta, lmax, mmax, mode, torch.float64, s).to(dtype)
	if not (nn or ns):
		return _anal_rings(F, theta, lmax, mmax, mode, dtype, s)
	out = _anal_rings(F[..., nn:nt-ns], theta[nn:nt-ns], lmax, mmax, mode, dtype, s)
	# near-pole rings contribute through a float64 pass, for m < Mp
	Fp = torch.cat([F[..., :nn], F[..., nt-ns:]], -1)[..., :Mp, :]
	pol = full_analysis(Fp.to(torch.float64).contiguous(),
		geom(pth, Mp - 1, torch.float64, F.device, s), lmax, mode)
	out[:, :Mp] += pol.to(dtype)
	return out


def _anal_rings(F, theta, lmax, mmax, mode, dtype, s=None):
	"""[nl, nm, C] through K2 (symmetric ring set, Legendre modes) or K4, in
	chunks of TCHUNK rings (pixell_tpu.ops.sht_pallas._analysis_sym_entry
	:1825, _wigner_anal_full :2195)."""
	F = F.to(dtype)
	nt = F.shape[-1]
	nh = None if mode == "wigner" else detect_sym(theta)
	if nh is not None:
		# even/odd hemisphere combinations on the northern rings
		south = F[..., nh:].flip(-1)
		if nt - nh < nh:   # odd nt: the middle ring pairs with itself
			south = torch.nn.functional.pad(south, (0, nh - (nt - nh)))
		north = F[..., :nh]
		F, theta = torch.stack([north + south, north - south], 2), theta[:nh]
	out = None
	for i0 in range(0, len(theta), TCHUNK):
		i1 = min(i0 + TCHUNK, len(theta))
		Fc, th = F[..., i0:i1].contiguous(), theta[i0:i1]
		if nh is not None:
			part = sym_analysis(Fc, geom(th, mmax, dtype, F.device), lmax, mode)
		else:
			part = full_analysis(Fc, geom(th, mmax, dtype, F.device, s), lmax, mode,
				_f32_dead(th, lmax, mmax, dtype, s, F.device))
		out = part if out is None else out + part
	return out
