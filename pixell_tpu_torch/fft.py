"""FFTs, DCTs, spectrum resampling and the ES-kernel NUFFT (counterpart
of pixell_tpu/fft.py).

The transforms are torch.fft (cuFFT on the card): fft / ifft / rfft /
irfft with FFTW's unnormalized convention and the complex promotion
(pixell_tpu/fft.py:37-75); the eight DCT / DST types by zero-embedding in
an FFT (:110-196) with redft00, chebt and ichebt; the Fourier shift, the
FFT resample (:223-297) and measure_shift; the size and frequency helpers
and the engine shims (:20-29, :661-760), whose one engine is torch.fft.
Then fft_len (:199), resample (:244) with its transpose, and the NUFFT
suite (:299-658, :878-929): _es_params, the ES kernel, the grid correction
(host numpy, cached per size and device), the fine-grid build (deconvolve,
zero-pad, inverse FFT; the real-output Hermitian form and the chunked
build), the point stage, u2nu, nu2u (its transpose, written out: the
spread kernel, then the fine-grid build taken back stage by stage, where
the reference takes jax.linear_transpose), interpol_nufft and u2nu_plan.
The NUFFT's point stage runs in the hand-written kernels of ops.nufft_cuda
(K10, K11) on the card and in their plain PyTorch twins on the CPU. The
inverse NUFFTs iu2nu / inu2u (:784-832) and their aliases nufft, inufft,
nufft_adjoint and inufft_adjoint (:834-877) solve the normal equations by
ops.solvers.cg_solve on the data's device (the reference's _cg_solve :767
runs in numpy on the host). shift_interp (:475) is one K10 launch at the
displaced pixels. Not ported: the TPU-shaped _block_gather_eval with its
GATHER_CHUNK, which the kernels make unneeded; shift_interp's roll-and-FMA
form and _u2nu_rowband_core (:409), gather-free evaluations written for the
TPU's slow gathers, since K10 reads each point's window itself.

The functions that take arrays put numpy input on device="cuda" unless
told otherwise; tensors stay where they are, and the result is on their
device. A float32 input gives complex64 coefficients, a float64 one
complex128.
"""
from __future__ import annotations
import functools
import numpy as np
import torch
from .ops import nufft_cuda, solvers


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


def resample(fa, n, axes=(-1,), norm=True):
	"""Fourier-space resample: truncate or zero-pad the (unshifted) spectrum
	fa to n samples along each of axes. An even-length Nyquist bin is split
	symmetrically when padding and absorbs both halves when truncating.
	norm is accepted and ignored, as in the reference."""
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
# Transforms on torch.fft (pixell_tpu/fft.py:20-297)
# ---------------------------------------------------------------------------
engines = {}   # the reference's engine table, kept empty as there
engine = "torch"

def set_engine(name):
	"""Select the FFT engine; the port has one, "torch" (torch.fft)."""
	global engine
	if name != "torch": raise ValueError("Only the 'torch' engine exists in pixell_tpu_torch")
	engine = name

def nthread_fft(): return 1
def nthread_ifft(): return 1


def _axes(a, axes):
	if axes is None: return tuple(range(a.ndim))
	return tuple(int(ax) % a.ndim for ax in np.atleast_1d(axes))


def _floating(a):
	"""a as a floating or complex tensor (integers and bools to float64)."""
	return a if a.is_floating_point() or a.is_complex() else a.to(torch.float64)


def _out(res, out):
	"""res, copied into out when out is given (then out is returned)."""
	if out is None: return res
	if isinstance(out, torch.Tensor): return out.copy_(res)
	out[...] = res.detach().cpu().numpy()
	return out


def fft(tod, ft=None, nthread=0, axes=(-1,), flags=None, normalize=False, *, device="cuda"):
	"""Complex FFT along axes, unnormalized (FFTW's convention; with
	normalize divided by the transform size). Real input is promoted to
	the complex dtype of its precision. Into ft when given."""
	a = _tensor(tod, device)
	a = a.to(_cdtype(_floating(a).dtype))
	res = torch.fft.fftn(a, dim=_axes(a, axes), norm="forward" if normalize else "backward")
	return _out(res, ft)


def ifft(tod, ft=None, nthread=0, axes=(-1,), flags=None, normalize=False, *, device="cuda"):
	"""Inverse complex FFT along axes, unnormalized: ifft(fft(x)) = N x
	unless normalize. The first argument holds the coefficients; into ft
	when given."""
	a = _tensor(tod, device)
	a = a.to(_cdtype(_floating(a).dtype))
	res = torch.fft.ifftn(a, dim=_axes(a, axes), norm="backward" if normalize else "forward")
	return _out(res, ft)


def rfft(tod, ft=None, nthread=0, axes=(-1,), flags=None, normalize=False, *, device="cuda"):
	"""Real-to-complex FFT, the half spectrum along the last of axes
	(complex over the rest); complex input is taken by its real part."""
	a = _floating(_tensor(tod, device))
	if a.is_complex(): a = a.real
	res = torch.fft.rfftn(a, dim=_axes(a, axes), norm="forward" if normalize else "backward")
	return _out(res, ft)


def irfft(ft, tod=None, n=None, nthread=0, axes=(-1,), flags=None, normalize=False, *,
		device="cuda"):
	"""Complex-to-real inverse FFT, unnormalized unless normalize. n (else
	tod's shape, else 2 (m-1)) is the real length of the last of axes."""
	a = _tensor(ft, device)
	a = a.to(_cdtype(_floating(a).dtype))
	axs = _axes(a, axes)
	if n is None and tod is not None: n = tod.shape[axs[-1]]
	if n is None: n = 2*(a.shape[axs[-1]]-1)
	s = [a.shape[ax] for ax in axs[:-1]] + [int(n)]
	res = torch.fft.irfftn(a, s=s, dim=axs, norm="backward" if normalize else "forward")
	return _out(res, tod)


def redft00(a, b=None, nthread=0, normalize=False, flags=None, *, device="cuda"):
	"""DCT-I along the last axis (FFTW's REDFT00)."""
	return _out(dct(a, type="DCT-I", axes=(-1,), normalize=normalize, device=device), b)


def _scale_ends(a, fac):
	a = a.clone()
	a[..., 0] *= fac
	a[..., -1] *= fac
	return a


def chebt(a, b=None, nthread=0, *, device="cuda"):
	"""Chebyshev coefficients of samples at the Chebyshev nodes, by DCT-I."""
	a = _tensor(a, device)
	return _out(_scale_ends(redft00(a)/(a.shape[-1]-1), 0.5), b)


def ichebt(a, b=None, nthread=0, *, device="cuda"):
	"""Samples at the Chebyshev nodes of Chebyshev coefficients: chebt's inverse."""
	return _out(redft00(_scale_ends(_tensor(a, device), 2.0))*0.5, b)


# The eight DCT / DST types (FFTW's r2r kinds), unnormalized, by
# zero-embedding in an FFT along the last axis (pixell_tpu/fft.py:100-196)
_dct_names = {
	"dct-i": "redft00", "dct-ii": "redft10", "dct-iii": "redft01", "dct-iv": "redft11",
	"dst-i": "rodft00", "dst-ii": "rodft10", "dst-iii": "rodft01", "dst-iv": "rodft11",
	"cos": "redft10", "sin": "rodft10",
}
_inverse_kind = {"redft00": "redft00", "redft10": "redft01", "redft01": "redft10",
	"redft11": "redft11", "rodft00": "rodft00", "rodft10": "rodft01",
	"rodft01": "rodft10", "rodft11": "rodft11"}

def _canon_type(type):
	t = str(type).lower()
	return _dct_names.get(t, t)


def _embed(x, size, sl):
	"""x placed at sl of zeros of length size along the last axis."""
	z = x.new_zeros(x.shape[:-1] + (size,))
	z[..., sl] = x
	return z


def _dct1d(x, kind):
	"""The unnormalized r2r transform of kind along the last axis."""
	n = x.shape[-1]
	F = torch.fft.fft
	if kind == "redft00":
		if n < 2: return 2.0*x
		return F(torch.cat([x, x[..., 1:-1].flip(-1)], -1))[..., :n].real
	if kind == "redft10":
		return 2*F(_embed(x, 4*n, slice(1, 2*n, 2)))[..., :n].real
	if kind == "redft01":
		return 2*F(_embed(x, 4*n, slice(0, n)))[..., 1:2*n:2].real - x[..., :1]
	if kind == "redft11":
		return 2*F(_embed(x, 8*n, slice(1, 2*n, 2)))[..., 1:2*n:2].real
	if kind == "rodft00":
		return -2*F(_embed(x, 2*(n+1), slice(1, n+1)))[..., 1:n+1].imag
	if kind == "rodft10":
		return -2*F(_embed(x, 4*n, slice(1, 2*n, 2)))[..., 1:n+1].imag
	if kind == "rodft01":
		sign = torch.ones(n, dtype=x.dtype, device=x.device)
		sign[::2] = -1
		return -2*F(_embed(x, 4*n, slice(1, n+1)))[..., 1:2*n:2].imag + x[..., -1:]*sign
	if kind == "rodft11":
		return -2*F(_embed(x, 8*n, slice(1, 2*n, 2)))[..., 1:2*n:2].imag
	raise ValueError("Unknown r2r kind '%s'" % kind)


def _logical_size(kind, n):
	if kind == "redft00": return 2*(n-1)
	if kind == "rodft00": return 2*(n+1)
	return 2*n


def _r2r(a, kind, axes, normalize, device):
	x = _floating(_tensor(a, device))
	if x.is_complex(): x = x.real
	norm = 1
	for ax in _axes(x, axes):
		x = _dct1d(x.movedim(ax, -1), kind).movedim(-1, ax)
		norm *= _logical_size(kind, x.shape[ax])
	return x/norm if normalize else x


def dct(a, b=None, nthread=0, type="DCT-I", axes=(-2, -1), normalize=False, flags=None, *,
		device="cuda"):
	"""The DCT or DST of type (DCT-I ... DST-IV) along axes, unnormalized
	as in FFTW; normalize divides by the logical transform size."""
	return _out(_r2r(a, _canon_type(type), axes, normalize, device), b)


def idct(a, b=None, nthread=0, type="DCT-I", axes=(-2, -1), normalize=False, flags=None, *,
		device="cuda"):
	"""The inverse of dct: FFTW's inverse kind, so idct(dct(x)) is the
	product of the logical sizes times x unless normalize."""
	return _out(_r2r(a, _inverse_kind[_canon_type(type)], axes, normalize, device), b)


def dst(a, b=None, nthread=0, type="DST-I", axes=(-2, -1), normalize=False, flags=None, *,
		device="cuda"):
	return dct(a, b, nthread=nthread, type=type, axes=axes, normalize=normalize, device=device)


def idst(a, b=None, nthread=0, type="DST-I", axes=(-2, -1), normalize=False, flags=None, *,
		device="cuda"):
	return idct(a, b, nthread=nthread, type=type, axes=axes, normalize=normalize, device=device)


def fftfreq(n, d=1.0): return np.fft.fftfreq(n, d)
def rfftfreq(n, d=1.0): return np.fft.rfftfreq(n, d)

def ind2freq(n, i, d=1.0):
	"""Fourier bin index -> frequency, wrapped above the Nyquist."""
	i = np.asanyarray(i)
	return ((i + n//2) % n - n//2)/(d*n)

def freq2ind(n, f, d=1.0):
	return (np.asanyarray(f)*d*n) % n


def shift(a, shift, axes=None, nofft=False, deriv=None, *, device="cuda"):
	"""a shifted by a (fractional) number of samples along axes, by a phase
	ramp in Fourier space (pixell_tpu.fft.shift :223); with nofft a is its
	own FFT and the shifted FFT is returned. deriv: the derivative along
	axes[deriv] instead. The ramps are built in float64 on the host (one
	vector an axis)."""
	a = _floating(_tensor(a, device))
	axs = _axes(a, axes)
	ca = a.to(_cdtype(a.dtype)) if nofft else fft(a, axes=axs)
	shifts = np.zeros(len(axs)) + np.asarray(shift)
	for i, ax in enumerate(axs):
		f = np.fft.fftfreq(a.shape[ax])
		phase = np.exp(-2j*np.pi*f*shifts[i])
		if deriv is not None and deriv == i: phase = phase*(2j*np.pi*f)
		sl = [1]*ca.ndim; sl[ax] = -1
		ca = ca*torch.from_numpy(phase).to(ca.device, ca.dtype).reshape(sl)
	if nofft: return ca
	res = ifft(ca, axes=axs, normalize=True)
	return res if a.is_complex() else res.real


def resample_fft(d, n, axes=(-1,), *, device="cuda"):
	"""d resampled to n samples along axes by zero-padding or truncating its
	spectrum (pixell_tpu.fft.resample_fft :283)."""
	d = _floating(_tensor(d, device))
	axs = _axes(d, axes)
	ns = np.zeros(len(axs), int) + np.asarray(n)
	fd = resample(fft(d, axes=axs), ns, axes=axs)
	norm = np.prod([fd.shape[ax] for ax in axs])/np.prod([d.shape[ax] for ax in axs])
	res = ifft(fd, axes=axs, normalize=True)*norm
	return res if d.is_complex() else res.real


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


def shift_interp(fmap, dy, dx, K, w, beta, *, device="cuda"):
	"""fmap [..., ny, nx] interpolated by the ES kernel of width w and shape
	beta at (y + dy[y, x], x + dx[y, x]), both axes periodic
	(pixell_tpu.fft.shift_interp :475): one K10 launch with fmap as its own
	fine grid, each output pixel a point. The reference builds the same sum
	from whole-array rolls and multiply-adds, a form for the TPU's slow
	gathers; K10 reads each point's w x w window itself, so the
	displacement bound K is not needed (it is accepted and ignored), and a
	w outside [2, min(16, ny, nx)] raises. The positions are float64
	whatever fmap's dtype."""
	fmap = _tensor(fmap, device)
	ny, nx = fmap.shape[-2:]
	dy = _tensor(dy, fmap.device).to(fmap.device, torch.float64)
	dx = _tensor(dx, fmap.device).to(fmap.device, torch.float64)
	yy = torch.arange(ny, dtype=torch.float64, device=fmap.device)[:, None] + dy
	xx = torch.arange(nx, dtype=torch.float64, device=fmap.device)[None, :] + dx
	coords = torch.stack(torch.broadcast_tensors(yy, xx), -1).reshape(-1, 2)
	res = nufft_cuda.u2nu_points(fmap.reshape((-1, ny, nx)).contiguous(), coords, (ny, nx), int(w),
		float(beta))
	return res.reshape(fmap.shape)


# ---------------------------------------------------------------------------
# Inverse NUFFTs (pixell_tpu/fft.py:767-877): the uniform coefficients of
# nonuniform samples (iu2nu) or the nonuniform values of a uniform grid
# (inu2u), by conjugate gradients on the normal equations of the u2nu / nu2u
# pair, on the data's device
# ---------------------------------------------------------------------------
def _cg_solve(A, b, epsilon=1e-6, maxiter=100):
	"""x with A(x) = b by ops.solvers.cg_solve from x = 0, to a residual
	norm below epsilon of |b| (pixell_tpu.fft._cg_solve :767); b = 0 gives
	0, as the reference's floored start does."""
	if not bool(b.any()): return torch.zeros_like(b)
	return solvers.cg_solve(A, b, tol=epsilon, maxiter=maxiter)[0]


def _inds_coords(inds, device):
	"""The points of inds ([2, npt], or [npt, 2]) as float64 [npt, 2] on
	device, built once so that the NUFFT calls of a solve share their bins."""
	inds = _tensor(inds, device)
	coords = inds.T if inds.ndim == 2 and inds.shape[0] == 2 else inds
	return _coords64(coords, device)


def iu2nu(a, inds, out=None, oshape=None, axes=None, periodicity=None, epsilon=None, nthread=None,
		normalize=False, forward=False, *, device="cuda"):
	"""The uniform Fourier grid of shape oshape (or out's) whose u2nu at the
	points inds gives the samples a [npt] (pixell_tpu.fft.iu2nu :784): CG on
	the normal equations nu2u(u2nu(g)) = nu2u(a), nu2u with the opposite
	convention being u2nu's adjoint; CG's tolerance is epsilon, else 1e-6."""
	a = _tensor(a, device)
	per = 2*np.pi if periodicity is None else periodicity
	if oshape is None and out is not None: oshape = out.shape
	if oshape is None: raise ValueError("iu2nu needs oshape or out")
	coords = _inds_coords(inds, a.device)
	fwd = lambda g: u2nu(g.reshape(oshape), coords, forward=forward, epsilon=epsilon,
		periodicity=per).reshape(-1)
	adj = lambda v: nu2u(v, coords, oshape=oshape, forward=not forward, epsilon=epsilon,
		periodicity=per).reshape(-1)
	b = adj(a.reshape(-1).to(_cdtype(_floating(a).dtype)))
	x = _cg_solve(lambda g: adj(fwd(g)), b, epsilon=(epsilon or 1e-6))
	return _out(x.reshape(oshape), out)


def inu2u(fa, inds, out=None, axes=None, periodicity=None, epsilon=None, nthread=None,
		normalize=False, forward=False, complex=True, *, device="cuda"):
	"""The nonuniform values at inds whose nu2u onto fa's grid gives fa
	(pixell_tpu.fft.inu2u :811): CG on the normal equations
	u2nu(nu2u(v)) = u2nu(fa)."""
	fa = _tensor(fa, device)
	per = 2*np.pi if periodicity is None else periodicity
	coords = _inds_coords(inds, fa.device)
	fwd = lambda v: nu2u(v, coords, oshape=fa.shape, forward=forward, epsilon=epsilon,
		periodicity=per).reshape(-1)
	adj = lambda g: u2nu(g.reshape(fa.shape), coords, forward=not forward, epsilon=epsilon,
		periodicity=per).reshape(-1)
	b = adj(fa.to(_cdtype(_floating(fa).dtype)))
	return _out(_cg_solve(lambda v: adj(fwd(v)), b, epsilon=(epsilon or 1e-6)), out)


def nufft(a, inds, out=None, oshape=None, axes=None, periodicity=None, epsilon=None, nthread=None,
		normalize=False, flip=False, *, device="cuda"):
	"""Nonuniform samples -> uniform Fourier coefficients: iu2nu with
	forward=flip (pixell_tpu.fft.nufft :834)."""
	return iu2nu(a, inds, out=out, oshape=oshape, axes=axes, periodicity=periodicity, epsilon=epsilon,
		normalize=normalize, forward=flip, device=device)


def inufft(fa, inds, out=None, axes=None, periodicity=None, epsilon=None, nthread=None,
		normalize=False, flip=False, complex=True, op=None, *, device="cuda"):
	"""Uniform Fourier coefficients -> nonuniform samples: u2nu with
	forward=flip, its real part unless complex (pixell_tpu.fft.inufft
	:842); op is accepted and ignored, as in the reference."""
	fa = _tensor(fa, device)
	per = 2*np.pi if periodicity is None else periodicity
	res = u2nu(fa, _inds_coords(inds, fa.device), forward=flip, epsilon=epsilon, periodicity=per)
	if not complex: res = res.real
	return _out(res, out)


def nufft_adjoint(a, inds, out=None, oshape=None, axes=None, periodicity=None, epsilon=None,
		nthread=None, normalize=False, flip=False, *, device="cuda"):
	"""The adjoint NUFFT, gridding of nonuniform samples: nu2u with
	forward=not flip onto oshape (or out's shape) (pixell_tpu.fft.
	nufft_adjoint :857)."""
	a = _tensor(a, device)
	per = 2*np.pi if periodicity is None else periodicity
	if oshape is None and out is not None: oshape = out.shape
	res = nu2u(a, _inds_coords(inds, a.device), oshape=oshape, forward=not flip, epsilon=epsilon,
		periodicity=per)
	return _out(res, out)


def inufft_adjoint(fa, inds, out=None, axes=None, periodicity=None, epsilon=None, nthread=None,
		normalize=False, flip=False, complex=True, *, device="cuda"):
	"""The inverse adjoint NUFFT: inu2u with forward=not flip
	(pixell_tpu.fft.inufft_adjoint :871)."""
	return inu2u(fa, inds, out=out, axes=axes, periodicity=periodicity, epsilon=epsilon,
		normalize=normalize, forward=not flip, complex=complex, device=device)


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


# ---------------------------------------------------------------------------
# Engine shims and small helpers (pixell_tpu/fft.py:661-765): one engine,
# torch.fft, behind the reference's engine interface
# ---------------------------------------------------------------------------
class NumpyEngine:
	"""The reference's engine interface over this module's transforms."""
	def fft(self, a, b=None, axes=(-1,), nthread=0, flags=None):
		return fft(a, b, axes=axes)
	def ifft(self, a, b=None, axes=(-1,), nthread=0, flags=None, normalize=True):
		return ifft(a, b, axes=axes, normalize=normalize)
	def rfft(self, a, b=None, axes=(-1,), nthread=0, flags=None):
		return rfft(a, b, axes=axes)
	def irfft(self, a, b=None, n=None, axes=(-1,), nthread=0, flags=None, normalize=True):
		return irfft(a, b, n=n, axes=axes, normalize=normalize)

_engines = {"numpy": NumpyEngine(), "auto": NumpyEngine(), "torch": NumpyEngine()}

def get_engine(eng):
	"""The fft engine of that name (any name gives the one engine)."""
	if isinstance(eng, str): return _engines.get(eng, _engines["auto"])
	return eng

def numpy_empty_aligned(shape, dtype, n=None):
	return np.empty(shape, dtype)


class numpy_FFTW:
	"""A plan-style wrapper: calling it transforms a into b (a tensor or a
	numpy array), forward or backward."""
	def __init__(self, a, b, axes=(-1,), flags=None, threads=1, direction="FFTW_FORWARD"):
		self.a, self.b = a, b
		self.axes = axes
		self.direction = direction
	def __call__(self, normalise_idft=False):
		if self.direction == "FFTW_FORWARD": return fft(self.a, self.b, axes=self.axes)
		return ifft(self.a, self.b, axes=self.axes, normalize=normalise_idft)

ducc_FFTW = numpy_FFTW


def fft_flat(tod, ft, nthread=1, axes=[-1], flags=None, _direction="FFTW_FORWARD"):
	"""fft of tod into ft (backward: the real part of ifft of ft into tod)."""
	if _direction == "FFTW_FORWARD": return fft(tod, ft, axes=tuple(axes))
	_out(ifft(ft, axes=tuple(axes)).real, tod)
	return ft


def ifft_flat(ft, tod, nthread=1, axes=[-1], flags=None):
	fft_flat(tod, ft, nthread=nthread, axes=axes, _direction="FFTW_BACKWARD")
	return tod


def asfcarray(a):
	"""a as a float or complex numpy array, integers promoted."""
	a = np.asarray(a)
	return np.asarray(a, np.promote_types(a.dtype, np.float32))


def empty(shape, dtype):
	return np.empty(shape, dtype)


def rfft_shape(ishape, axes=[-1]):
	"""The output shape of an rfft over axes."""
	oshape = list(ishape)
	oshape[axes[-1]] = ishape[axes[-1]]//2 + 1
	return tuple(oshape)


def irfft_shape(ishape, n=None, axes=[-1]):
	"""The output shape of an irfft over axes."""
	oshape = list(ishape)
	oshape[axes[-1]] = n if n is not None else 2*(ishape[axes[-1]] - 1)
	return tuple(oshape)


def rfreq2ind(freqs, n):
	"""Real-fft frequency (cycles a sample) -> bin index."""
	return np.asarray(freqs)*n


def int2rfreq(n, i, d=1.0):
	return np.asarray(i)/(n*d)


def measure_shift(a, b, axis=-1, *, device="cuda"):
	"""The (sub-sample) shift of a against b along axis, from the peak of
	their circular cross-correlation refined by a parabola through it and
	its neighbours (pixell_tpu.fft.measure_shift :741)."""
	a = _floating(_tensor(a, device)); b = _floating(_tensor(b, a.device))
	n = a.shape[axis]
	corr = torch.fft.irfft(torch.fft.rfft(a, dim=axis)*torch.conj(torch.fft.rfft(b, dim=axis)),
		n=n, dim=axis)
	i = torch.argmax(corr, axis, keepdim=True)
	at = lambda j: torch.take_along_dim(corr, j, axis).squeeze(axis)
	c0, cm, cp = at(i), at((i - 1) % n), at((i + 1) % n)
	denom = cm - 2*c0 + cp
	frac = torch.where(denom.abs() > 0, 0.5*(cm - cp)/torch.where(denom == 0, 1, denom), 0)
	sh = i.squeeze(axis) + frac
	return torch.where(sh > n/2, sh - n, sh)
