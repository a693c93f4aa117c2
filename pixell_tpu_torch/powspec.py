"""Power spectrum packing and I/O (counterpart of pixell_tpu/powspec.py).

The reference is host numpy, and so is this port of all of it: the
symmetric packing (sym_compress, sym_expand, compressed_order), the C_l /
D_l scaling, the readers and writers of CAMB-style ascii files, the
lensing-potential helpers and spec2corr (the Legendre sum of a spectrum at
angles).
"""
from __future__ import annotations
import numpy as np


def sym_compress(mat, which=None, n=None, scheme=None, axes=[0, 1]):
	"""Extract the unique components of a symmetric matrix spectrum
	mat[n,n,nl] -> [m,nl] (reference powspec.sym_compress:5)."""
	mat = np.asarray(mat)
	if n is None: n = mat.shape[axes[0]]
	if which is None:
		which = compressed_order(n*(n+1)//2 if scheme in [None, "standard"] else n, scheme)
	mat = np.moveaxis(mat, axes, (0, 1))
	res = np.array([mat[w[0], w[1]] for w in which])
	return res

def sym_expand(mat, which=None, ncomp=None, scheme=None, axis=0):
	"""Inverse of sym_compress: [m,nl] -> [n,n,nl]."""
	mat = np.asarray(mat)
	mat = np.moveaxis(mat, axis, 0)
	m = mat.shape[0]
	if which is None: which = compressed_order(m, scheme)
	if ncomp is None: ncomp = int(np.max([max(w) for w in which]))+1
	res = np.zeros((ncomp, ncomp) + mat.shape[1:], mat.dtype)
	for i, w in enumerate(which):
		res[w[0], w[1]] = mat[i]
		res[w[1], w[0]] = mat[i]
	return res

def compressed_order(n, scheme=None):
	"""The (i,j) ordering of compressed symmetric matrix entries
	(reference powspec.compressed_order:53)."""
	if scheme is None: scheme = "standard"
	if scheme == "diag":
		# diagonal-major: 00,11,22,01,12,02
		ncomp = int((-1+(1+8*n)**0.5)/2)
		res = []
		for d in range(ncomp):
			for i in range(ncomp-d):
				res.append((i, i+d))
		return res[:n]
	else:
		# row-major upper triangle: 00,01,02,11,12,22
		ncomp = int((-1+(1+8*n)**0.5)/2)
		res = []
		for i in range(ncomp):
			for j in range(i, ncomp):
				res.append((i, j))
		return res[:n]

def scale_spectrum(ps, direction, extra=0, l=None):
	"""Convert between C_l and D_l = l(l+1)C_l/2pi conventions.
	direction > 0: multiply by (l(l+1)/2pi)^direction."""
	ps = np.asarray(ps, float).copy()
	if l is None: l = np.arange(ps.shape[-1], dtype=float)
	with np.errstate(divide="ignore", invalid="ignore"):
		fac = (l*(l+1)/(2*np.pi))**direction * (l**extra if extra else 1)
		res = ps*fac
	res[..., l == 0] = 0
	return np.nan_to_num(res)

def read_spectrum(fname, inds=True, scale=True, expand="diag"):
	"""Read a power spectrum from an ascii file [l, cl11, cl12, ...]
	(reference powspec.read_spectrum:135). By default assumes D_l CAMB
	convention and converts to C_l."""
	data = np.loadtxt(fname).T
	l = data[0]
	spec = data[1:]
	if scale:
		spec = scale_spectrum(spec, -1, l=l)
	# re-grid onto l = 0..lmax
	lmax = int(l.max())
	res = np.zeros((len(spec), lmax+1))
	li = l.astype(int)
	res[:, li] = spec
	if expand is not None and inds:
		res = sym_expand(res, scheme=expand)
	return res

def read_camb_scalar(fname, expand=True):
	"""Read a CAMB scalarCls file: l TT EE TE (+phi stuff)
	(reference powspec.read_camb_scalar:157). Returns ([TT,EE,TE] expanded)"""
	data = np.loadtxt(fname).T
	l = data[0]
	lmax = int(l.max())
	li = l.astype(int)
	cl = np.zeros((3, lmax+1))
	for i in range(3):
		cl[i, li] = data[1+i]
	cl = scale_spectrum(cl, -1)
	if expand:
		full = np.zeros((2, 2, lmax+1))
		full[0, 0] = cl[0]; full[1, 1] = cl[1]
		full[0, 1] = full[1, 0] = cl[2]
		return full
	return cl

def read_camb_full_lens(fname, expand=True):
	"""Read a CAMB lensedCls-type file: l TT EE BB TE
	(reference powspec.read_camb_full_lens:166). Returns [4,4,nl] matrix with
	T,E,B,phi ordering (phi part zero unless present)."""
	data = np.loadtxt(fname).T
	l = data[0]
	lmax = int(l.max())
	li = l.astype(int)
	ncol = data.shape[0]-1
	cols = np.zeros((ncol, lmax+1))
	for i in range(ncol):
		cols[i, li] = data[1+i]
	cols = scale_spectrum(cols, -1)
	res = np.zeros((4, 4, lmax+1))
	res[0, 0] = cols[0]             # TT
	if ncol > 1: res[1, 1] = cols[1]  # EE
	if ncol > 2: res[2, 2] = cols[2]  # BB
	if ncol > 3: res[0, 1] = res[1, 0] = cols[3]  # TE
	return res if expand else cols

def write_spectrum(fname, spec, inds=True, scale=True, expand="diag"):
	spec = np.asarray(spec)
	if spec.ndim == 3:
		spec = sym_compress(spec, scheme=expand)
	l = np.arange(spec.shape[-1], dtype=float)
	out = spec
	if scale:
		out = scale_spectrum(spec, 1, l=l)
	np.savetxt(fname, np.concatenate([l[None], out], 0).T, fmt="%15.7e")

def spec2corr(spec, pos, iscos=False, symmetric=True):
	"""Angular power spectrum -> correlation function at angles pos (radians)
	(reference powspec.spec2corr:186): C(theta) = sum (2l+1)/4pi cl P_l(cos)."""
	spec = np.asarray(spec)
	x = pos if iscos else np.cos(pos)
	nl = spec.shape[-1]
	l = np.arange(nl)
	# evaluate legendre polys via recurrence
	res = np.zeros(spec.shape[:-1] + np.shape(x))
	p0 = np.ones_like(x); p1 = x.copy() if hasattr(x, 'copy') else np.asarray(x)*1.0
	res = res + spec[..., 0:1]*(1/(4*np.pi))*p0
	if nl > 1: res = res + spec[..., 1:2]*(3/(4*np.pi))*p1
	for ll in range(2, nl):
		p0, p1 = p1, ((2*ll-1)*x*p1 - (ll-1)*p0)/ll
		res = res + spec[..., ll:ll+1]*((2*ll+1)/(4*np.pi))*p1
	return res


def expand_inds(x, y):
	"""Scatter columns y[:,len(x)] to positions x (reference
	powspec.expand_inds)."""
	x = np.asarray(x, int); y = np.asarray(y)
	n = int(np.max(x)) + 1
	res = np.zeros((y.shape[0], n))
	res[:, x] = y
	return res

def sym_expand_camb_full_lens(a):
	"""Expand camb full-lens columns into a [4,4,nl] matrix (reference
	powspec.sym_expand_camb_full_lens)."""
	a = np.asarray(a)
	res = np.zeros((4, 4) + a.shape[1:], a.dtype)
	res[0, 0] = a[4]
	res[0, 1] = res[1, 0] = a[5]
	res[0, 2] = res[2, 0] = a[6]
	res[1, 1], res[2, 2], res[3, 3] = a[:3]
	res[1, 2] = res[2, 1] = a[3]
	return res

def scale_camb_scalar_phi(a, direction, l=None):
	"""Convert camb's dimensionless deflection spectrum to/from phi
	(reference powspec.scale_camb_scalar_phi)."""
	a = np.array(a, float)
	if l is None: l = np.arange(a.shape[-1])
	a[..., 1:] /= (l[1:]**4*2.726e6**2)**direction
	a[..., 0] = 0
	return a

def read_phi_spectrum(fname, coloff=0, inds=True, scale=True, expand="diag"):
	"""Read a lensing potential spectrum from a camb scalar file
	(reference powspec.read_phi_spectrum)."""
	a = read_spectrum(fname, inds=inds, scale=False, expand=None)[coloff]
	if scale: a = scale_camb_scalar_phi(a, 1)
	if expand is not None: a = a[None, None]
	return a
