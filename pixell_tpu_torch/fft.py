"""FFT sizes, spectrum resampling and the ES-kernel NUFFT (counterpart of
pixell_tpu/fft.py).

Ports fft_len (pixell_tpu/fft.py:199), resample (:244) with its transpose,
and the NUFFT suite (:299-658, :878-929): _es_params, the ES kernel, the
grid correction (host numpy, cached per size and device), the fine-grid
build (deconvolve, zero-pad, inverse FFT; the real-output Hermitian form
and the chunked build), the point stage, u2nu, nu2u (its transpose, written
out: the spread kernel, then the fine-grid build taken back stage by stage,
where the reference takes jax.linear_transpose), interpol_nufft and
u2nu_plan. The transforms themselves are torch.fft; the point stage runs in
the hand-written kernels of ops.nufft_cuda (K10, K11) on the card and in
their plain PyTorch twins on the CPU. Not ported: iu2nu, inu2u and the
nufft* aliases; _u2nu_rowband_core and shift_interp (lensing's); and the
TPU-shaped _block_gather_eval with its GATHER_CHUNK, which the kernels make
unneeded.

The entry points that take numpy arrays (u2nu, nu2u, interpol_nufft,
u2nu_plan) put them on device="cuda" unless told otherwise; tensors stay
where they are.
"""
from __future__ import annotations
import functools
import numpy as np
import torch
from .ops import nufft_cuda


def fft_len(n, direction="below", factors=None):
	"""Closest fast FFT size to n (products of 2, 3, 5, 7)."""
	if factors is None: factors = [2, 3, 5, 7]
	def ok(m):
		for f in factors:
			while m % f == 0: m //= f
		return m == 1
	m = int(n)
	step = -1 if direction == "below" else 1
	while m > 1 and not ok(m): m += step
	return max(m, 1)


def resample(fa, n, axes=(-1,)):
	"""Fourier-space resample: truncate or zero-pad the (unshifted) spectrum
	fa to n samples along each of axes. An even-length Nyquist bin is split
	symmetrically when padding and absorbs both halves when truncating."""
	naxes = [int(ax) % fa.ndim for ax in np.atleast_1d(axes)]
	ns = (np.zeros(len(naxes), int) + np.asarray(n)).tolist()
	for ax, n_new in zip(naxes, ns):
		n_old = fa.shape[ax]
		fa = fa.movedim(ax, -1)
		nh_old, nh_new = n_old//2, n_new//2
		if n_new < n_old:
			keep_lo = (n_new+1)//2
			fa2 = torch.cat([fa[..., :keep_lo], fa[..., n_old-nh_new:]], -1)
			if n_new % 2 == 0:
				fa2[..., keep_lo] += fa[..., nh_new]
			fa = fa2
		elif n_new > n_old:
			keep_lo = (n_old+1)//2
			zeros = fa.new_zeros(fa.shape[:-1] + (n_new - n_old - (n_old % 2 == 0),))
			if n_old % 2 == 0:
				nyq = fa[..., nh_old:nh_old+1]/2
				fa = torch.cat([fa[..., :nh_old], nyq, zeros, nyq, fa[..., nh_old+1:]], -1)
			else:
				fa = torch.cat([fa[..., :keep_lo], zeros, fa[..., keep_lo:]], -1)
		fa = fa.movedim(-1, ax)
	return fa


def _resample_t(ft, n_old):
	"""The transpose of resample(fa, ft.shape[-1]) along the last axis for
	fa of n_old samples: ft[..., n_new] -> [..., n_old]. A padded
	even-length Nyquist bin, split in two halves, takes back their mean; a
	truncated one gives its sum to both bins it came from."""
	n_new = ft.shape[-1]
	if n_new == n_old: return ft
	if n_new > n_old:
		nh, keep_lo = n_old//2, (n_old + 1)//2
		if n_old % 2: return torch.cat([ft[..., :keep_lo], ft[..., n_new-(n_old-keep_lo):]], -1)
		nyq = (ft[..., nh:nh+1] + ft[..., n_new-nh:n_new-nh+1])/2
		return torch.cat([ft[..., :nh], nyq, ft[..., n_new-nh+1:]], -1)
	nh_new, keep_lo = n_new//2, (n_new + 1)//2
	out = ft.new_zeros(ft.shape[:-1] + (n_old,))
	out[..., :keep_lo] = ft[..., :keep_lo]
	out[..., n_old-nh_new:] = ft[..., keep_lo:]
	if n_new % 2 == 0: out[..., nh_new] += ft[..., keep_lo]
	return out


def _resample2_t(ft, shape):
	"""_resample_t along the last two axes, to shape (ny, nx)."""
	ft = _resample_t(ft, int(shape[1]))
	return _resample_t(ft.movedim(-2, -1), int(shape[0])).movedim(-1, -2)


# ---------------------------------------------------------------------------
# The ES-kernel NUFFT (pixell_tpu/fft.py:299-658): an oversampled FFT and an
# exponential-of-semicircle spreading kernel
# ---------------------------------------------------------------------------
def _tensor(x, device):
	"""x as a tensor: a tensor as it is, anything else on device."""
	return x if isinstance(x, torch.Tensor) else torch.as_tensor(np.asarray(x), device=device)


def _cdtype(dtype):
	return dtype if dtype.is_complex else {torch.float32: torch.complex64,
		torch.float64: torch.complex128}[dtype]


def _rdtype(dtype):
	return {torch.complex64: torch.float32, torch.complex128: torch.float64}.get(dtype, dtype)


def _es_params(epsilon, sigma=2.0):
	"""(kernel width w, beta) for the target accuracy epsilon at
	oversampling sigma (pixell_tpu.fft._es_params :299)."""
	w = max(2, int(np.ceil(np.log10(1.0/epsilon))) + 1)
	w = min(w, 16)
	return w, 2.30*w


def _es_correction(n, w, beta, dtype):
	"""The Fourier-space grid correction 1/phi_hat[n] of a length-n fine
	grid, in fft order, by Gauss-Legendre quadrature of the kernel's
	transform at each frequency (pixell_tpu.fft._es_correction :311); host
	numpy of numpy dtype."""
	q = int(3*w + 24)
	x, wq = np.polynomial.legendre.leggauss(q)
	k = np.fft.fftfreq(n)*n
	phi = np.exp(beta*(np.sqrt(1-x**2)-1))
	ph = (phi*wq) @ np.cos(np.pi*np.outer(x*(w/2.), k)*2/n)
	ph *= 0.5*w
	return (1.0/ph).astype(dtype)


@functools.lru_cache(maxsize=32)
def _correction_on(n, w, beta, dtype, device):
	"""_es_correction as a tensor of dtype on device, computed once per
	arguments (callers must not write into it)."""
	ndt = np.float32 if dtype == torch.float32 else np.float64
	return torch.from_numpy(_es_correction(n, w, beta, ndt)).to(device)


def _fine_shape(shape, sigma=2):
	"""The fine grid of a [ny, nx] spectrum: the 2-3-5-7-smooth sizes above
	sigma ny and sigma nx."""
	return fft_len(int(shape[0]*sigma), "above"), fft_len(int(shape[1]*sigma), "above")


def _u2nu_fine_one(grid, nfine, w, beta, forward, fft_order, real_out):
	"""One field's fine grid (pixell_tpu.fft._u2nu_fine_jit :514): the
	spectrum grid [..., ny, nx] deconvolved by the correction, zero-padded
	to nfine and inverse-FFT'd (forward: FFT'd). real_out returns only the
	real part, built exactly from the Hermitian half-spectrum by irfftn."""
	nfy, nfx = nfine
	rdt = _rdtype(grid.dtype)
	g = grid if fft_order else torch.fft.ifftshift(grid, dim=(-2, -1))
	spec = resample(g, (nfy, nfx), axes=(-2, -1))
	spec = spec*_correction_on(nfy, w, beta, rdt, grid.device)[:, None]
	spec *= _correction_on(nfx, w, beta, rdt, grid.device)
	if real_out:
		S = torch.conj(spec) if forward else spec
		# H[k1, k2] = (S[k1, k2] + conj(S[-k1, -k2]))/2 for k2 <= nfx/2
		Sm = torch.cat([S[..., :, :1], S[..., :, nfx - nfx//2:].flip(-1)], -1)
		Sm = torch.roll(Sm.flip(-2), 1, dims=-2)
		Sh = 0.5*(S[..., :, :nfx//2+1] + torch.conj(Sm))
		return torch.fft.irfftn(Sh, s=(nfy, nfx), dim=(-2, -1))*(nfy*nfx)
	if forward: return torch.fft.fftn(spec, dim=(-2, -1))
	return torch.fft.ifftn(spec, dim=(-2, -1))*(nfy*nfx)


def _u2nu_fine(grid, epsilon, forward, fft_order, real_out=False, chunked=False):
	"""Stage 1 of u2nu (pixell_tpu.fft._u2nu_fine :544): (fine grid, nfine,
	w, beta). chunked builds one field of the leading dimensions at a time,
	so the complex spectrum's transient is one field's."""
	rdt = _rdtype(grid.dtype)
	if epsilon is None: epsilon = 1e-5 if rdt == torch.float32 else 1e-10
	w, beta = _es_params(epsilon)
	ny, nx = grid.shape[-2:]
	nfine = _fine_shape((ny, nx))
	grid = grid.to(_cdtype(grid.dtype))
	args = (nfine, w, float(beta), bool(forward), bool(fft_order), bool(real_out))
	if chunked and grid.ndim > 2 and int(np.prod(grid.shape[:-2])) > 1:
		flat = grid.reshape((-1, ny, nx))
		fine = torch.stack([_u2nu_fine_one(flat[i], *args) for i in range(flat.shape[0])])
		fine = fine.reshape(grid.shape[:-2] + nfine)
	else:
		fine = _u2nu_fine_one(grid, *args)
	return fine, nfine, w, float(beta)


def _u2nu_fine_t(F, shape, w, beta, forward, fft_order):
	"""The transpose of the complex fine-grid build (_u2nu_fine_one without
	real_out) for a spectrum of shape (ny, nx): F [..., nfy, nfx] ->
	[..., ny, nx]. The DFT matrices are symmetric, so each stage is its own
	transpose but the zero-pad (_resample2_t) and the shift (fftshift).
	With forward=True and a real F it is also the transpose over real and
	imaginary parts of the real-output build with forward=False: that build
	is Re(L g), L = N ifft C pad, whose transpose is L^H = pad^T C fft."""
	nfy, nfx = F.shape[-2:]
	rdt = _rdtype(F.dtype)
	S = torch.fft.fftn(F, dim=(-2, -1)) if forward else torch.fft.ifftn(F, dim=(-2, -1))*(nfy*nfx)
	S = S*_correction_on(nfy, w, beta, rdt, F.device)[:, None]
	S *= _correction_on(nfx, w, beta, rdt, F.device)
	g = _resample2_t(S, shape)
	return g if fft_order else torch.fft.fftshift(g, dim=(-2, -1))


def _coords64(coords, device):
	"""coords [npt, 2] as a contiguous float64 tensor on device."""
	return _tensor(coords, device).to(device=device, dtype=torch.float64).reshape(-1, 2).contiguous()


def _u2nu_points(fine, nfine, w, beta, coords, periodicity, pre):
	"""Stage 2 of u2nu (pixell_tpu.fft._u2nu_points :571): the fine grid
	[..., nfy, nfx] at coords [npt, 2] -> [*pre, npt], through K10. The
	positions are split into base and fraction in float64 (ops.nufft_core)."""
	per = np.broadcast_to(np.asarray(periodicity, float), (2,))
	flat = fine.reshape((-1,) + tuple(nfine)).contiguous()
	co = _coords64(coords, fine.device)
	res = nufft_cuda.u2nu_points(flat, co, per, w, beta)
	return res.reshape(tuple(pre) + (co.shape[0],))


def u2nu(grid, coords, forward=False, epsilon=None, nthread=None, out=None,
		periodicity=2*np.pi, fft_order=True, *, device="cuda"):
	"""Evaluate the Fourier series with coefficients grid[..., ny, nx] at the
	nonuniform points coords[npt, 2] (radians, periodic with periodicity):
	the type-2 NUFFT (pixell_tpu.fft.u2nu :597). forward uses e^{-ikx};
	fft_order says grid is in FFT order (else centred). Into out when
	given."""
	grid = _tensor(grid, device)
	if _tensor(coords, grid.device).shape[-1] != 2: raise ValueError("Only 2D u2nu implemented")
	fine, nfine, w, beta = _u2nu_fine(grid, epsilon, forward, fft_order)
	res = _u2nu_points(fine, nfine, w, beta, coords, periodicity, grid.shape[:-2])
	return res if out is None else out.copy_(res)


def nu2u(vals, coords, out=None, oshape=None, forward=True, epsilon=None,
		nthread=None, periodicity=2*np.pi, fft_order=True, *, device="cuda"):
	"""The transpose of u2nu: spread the nonuniform samples vals[..., npt]
	at coords onto a uniform Fourier grid of shape oshape (the type-1
	NUFFT, pixell_tpu.fft.nu2u :618). nu2u(forward=True) is the transpose
	(not the conjugate transpose) of u2nu(forward=True): e^{-ikx} gridding.
	Written out: K11 spreads, then the fine-grid build is taken back."""
	vals = _tensor(vals, device)
	if oshape is None and out is not None: oshape = out.shape
	ny, nx = oshape[-2:]
	rdt = _rdtype(vals.dtype)
	if epsilon is None: epsilon = 1e-5 if rdt == torch.float32 else 1e-10
	w, beta = _es_params(epsilon)
	nfine = _fine_shape((ny, nx))
	per = np.broadcast_to(np.asarray(periodicity, float), (2,))
	pre = vals.shape[:-1]
	flat = vals.to(_cdtype(vals.dtype)).reshape(-1, vals.shape[-1]).contiguous()
	F = nufft_cuda.nu2u_spread(flat, _coords64(coords, vals.device), nfine, per, w, beta)
	res = torch.stack([_u2nu_fine_t(F[i], (ny, nx), w, beta, forward, fft_order)
		for i in range(F.shape[0])]).reshape(pre + (ny, nx))
	return res if out is None else out.copy_(res)


def interpol_nufft(map, inds, out=None, epsilon=None, nthread=None, nofft=False, *,
		device="cuda"):
	"""Interpolate the periodic uniform-grid map[..., ny, nx] at the
	fractional pixel positions inds[{y, x}, ...] by the NUFFT
	(pixell_tpu.fft.interpol_nufft :640); with nofft, map is its own FFT
	already."""
	map = _tensor(map, device)
	inds = _tensor(inds, map.device).to(torch.float64)
	ishape = inds.shape[1:]
	flat = inds.reshape(2, -1).T
	ny, nx = map.shape[-2:]
	coords = torch.stack([flat[:, 0]/ny, flat[:, 1]/nx], -1)*(2*np.pi)
	fmap = map if nofft else torch.fft.fftn(map, dim=(-2, -1))/(ny*nx)
	res = u2nu(fmap, coords, epsilon=epsilon)
	if not map.is_complex(): res = res.real.to(map.dtype)
	res = res.reshape(map.shape[:-2] + tuple(ishape))
	return res if out is None else out.copy_(res)


class u2nu_plan:
	"""The type-2 NUFFT of fixed Fourier fields fa[..., gshape] at point
	sets given later (pixell_tpu.fft.u2nu_plan :878): the deconvolved,
	oversampled fine grid is built once, field by field, and kept on the
	device; eval(inds) runs only the point stage. inds[2, ...] are in grid
	units (periodicity defaults to the grid shape). complex=False keeps only
	the real part of the fine grid (the real-output build): half the
	memory, and K10 reads half the bytes."""
	def __init__(self, fa, axes, periodicity=None, epsilon=None, nthread=None,
			normalize=False, forward=False, complex=True, op=None, *, device="cuda"):
		fa = _tensor(fa, device)
		axes = tuple(int(a) for a in np.atleast_1d(axes) % fa.ndim)
		if len(axes) != 2: raise ValueError("Only 2D u2nu_plan implemented")
		perm = [i for i in range(fa.ndim) if i not in axes] + list(axes)
		fa = fa.permute(perm)
		if op is not None: fa = op(fa)
		self.pshape = tuple(fa.shape[:-2])
		self.gshape = tuple(fa.shape[-2:])
		if periodicity is None: periodicity = self.gshape
		self.periodicity = periodicity
		self.ctype = _cdtype(fa.dtype)
		self.dtype = _rdtype(fa.dtype)
		if epsilon is None: epsilon = 1e-5 if self.dtype == torch.float32 else 1e-10
		self.epsilon = epsilon
		self.complex = complex
		self.normalize = normalize
		self.norm = int(np.prod(self.gshape))
		self.fine, self.nfine, self.w, self.beta = _u2nu_fine(fa, epsilon, forward, fft_order=True,
			real_out=not complex, chunked=True)

	def eval(self, inds, out=None):
		"""The fields at inds[2, ...] (grid units) -> [*pshape, ...]; into
		out when given."""
		inds = _tensor(inds, self.fine.device)
		ishape = tuple(inds.shape[1:])
		res = self._eval_coords(inds.reshape(2, -1).T)
		res = res.reshape(self.pshape + ishape)
		return res if out is None else out.copy_(res)

	def _eval_coords(self, coords):
		"""The fields at coords [npt, 2] -> [*pshape, npt]."""
		res = _u2nu_points(self.fine, self.nfine, self.w, self.beta, coords, self.periodicity,
			self.pshape)
		if not self.complex and res.is_complex(): res = res.real
		if self.normalize: res = res/self.norm
		return res
