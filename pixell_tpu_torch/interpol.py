"""Spline, convolution and Lanczos interpolation of gridded data
(counterpart of pixell_tpu/interpol.py).

map_coordinates evaluates data [..., ny, nx] at fractional pixel positions
with the reference's weights (:32-119): orders 0 (nearest) to 5, modes
"spline" (B-spline on prefiltered coefficients: interpolating), "conv" (the
same weights on the data: smoothing) and "lanczos" (3 lobes), borders
cyclic / nearest / mirror / zero, the gradient (deriv) and the transpose
(trans). Everything map-sized runs on the data's device:

- the prefilter (spline_filter) divides each axis's FFT by the B-spline's
  response, after padding the axis as its border says (the reference's
  spectral form of the IIR recursion, :121-152): by 48 pixels before, and
  after by 48 or more, up to a length whose factors are 2, 3, 5 and 7 (an
  axis shorter than 48 by its length on each side, as the reference),
  filtered rotated so that the zero border's pad is the FFT's own; the
  response table is host numpy, built once per (length, order) and copied
  to the device once, in the data's real dtype;
- the gather takes one tap of the (order + 1)² at a time for a chunk of
  points (index_select on the flattened grid, then a multiply-add), so the
  temporaries stay bounded by the chunk; on a grid of points (py[Y] x
  px[X], as a separable project gives) it interpolates one axis at a time
  instead: order + 1 row taps, then order + 1 column taps;
- the transposes are written out, not taken by automatic differentiation:
  the gather's transpose is one index_add_ a tap; the prefilter's is the
  same division (a symmetric real response), with the crop's transpose a
  zero pad and each border pad's transpose an index_add_ of the pad back
  onto the pixels it copied.

build and the ip_* interpolators are host numpy, as in the reference.
"""
from __future__ import annotations
import functools
import numpy as np
import torch
from .fft import fft_len

PAD = 48       # the prefilter's least border pad (exact to ~0.27^48 for cubic splines)
ZPAD = 24      # the zero border's pad of the data before the prefilter (:244-252)
CHUNK = 1 << 23   # points gathered at a time


# ---------------------------------------------------------------------------
# Weights (pixell_tpu/interpol.py:32-119), on tensors of offsets t
# ---------------------------------------------------------------------------
def _bspline3_weights(t):
	"""Cubic B-spline weights for taps floor(x)-1 .. floor(x)+2, t in [0, 1)."""
	w0 = (1 - t)**3/6
	w1 = (4 - 6*t**2 + 3*t**3)/6
	w2 = (1 + 3*t + 3*t**2 - 3*t**3)/6
	w3 = t**3/6
	return torch.stack([w0, w1, w2, w3], -1)

def _bspline3_dweights(t):
	w0 = -(1 - t)**2/2
	w1 = (-12*t + 9*t**2)/6
	w2 = (3 + 6*t - 9*t**2)/6
	w3 = t**2/2
	return torch.stack([w0, w1, w2, w3], -1)

def _linear_weights(t):
	return torch.stack([1 - t, t], -1)

def _linear_dweights(t):
	return torch.stack([-torch.ones_like(t), torch.ones_like(t)], -1)

def _lanczos3_weights(t):
	"""Lanczos-3 weights for taps floor(x)-2 .. floor(x)+3, normalized."""
	x = t[..., None] - torch.arange(-2, 4, dtype=t.dtype, device=t.device)
	w = torch.sinc(x)*torch.sinc(x/3)
	return w/torch.sum(w, -1, keepdim=True)

def _bspline_val(n, t):
	"""The centred B-spline of degree n at t by the Cox-de Boor recursion
	(a tensor, or a float for the host response table)."""
	if n == 0:
		inside = (t > -0.5) & (t <= 0.5)
		return inside.to(t.dtype) if isinstance(t, torch.Tensor) else float(inside)
	return ((t + (n + 1)/2)*_bspline_val(n - 1, t + 0.5)
		+ ((n + 1)/2 - t)*_bspline_val(n - 1, t - 0.5))/n

def _bspline_dval(n, t):
	"""B_n'(t) = B_{n-1}(t+1/2) - B_{n-1}(t-1/2)."""
	return _bspline_val(n - 1, t + 0.5) - _bspline_val(n - 1, t - 0.5)

def _make_bspline_weights(order):
	"""(wfun, dwfun, ntap, off) of the degree-order B-spline: odd orders
	anchor at floor(x) (t in [0, 1)), even ones at round(x) (t in
	[-0.5, 0.5))."""
	taps = np.arange(order + 1) - ((order - 1)//2 if order % 2 else order//2)
	def wfun(t): return torch.stack([_bspline_val(order, t - int(j)) for j in taps], -1)
	def dwfun(t): return torch.stack([_bspline_dval(order, t - int(j)) for j in taps], -1)
	return wfun, dwfun, order + 1, -int(taps[0])

_KERNELS = {
	("spline", 3): (_bspline3_weights, _bspline3_dweights, 4, 1),
	("conv", 3):   (_bspline3_weights, _bspline3_dweights, 4, 1),
	("spline", 1): (_linear_weights, _linear_dweights, 2, 0),
	("conv", 1):   (_linear_weights, _linear_dweights, 2, 0),
	("lanczos", 3): (_lanczos3_weights, None, 6, 2),
}
for _o in (2, 4, 5):
	_KERNELS[("spline", _o)] = _KERNELS[("conv", _o)] = _make_bspline_weights(_o)


def _kernel(mode, order):
	"""(wfun, dwfun, ntap, off) of (mode, order) as the reference resolves
	it: Lanczos-3 for "lanczos" at any order, the spline's weights for a
	mode it does not know."""
	if mode == "lanczos": return _KERNELS[("lanczos", 3)]
	return _KERNELS[(mode, order)] if (mode, order) in _KERNELS else _KERNELS[("spline", order)]


def _bspline_response(n, dtype, order=3):
	"""The frequency response [n] of the degree-order B-spline sampled at
	the integers (cubic: (4 + 2 cos w)/6), host numpy."""
	w = 2*np.pi*np.fft.fftfreq(n)
	resp = np.zeros(n)
	half = (order + 1)//2
	for m in range(-half, half + 1):
		bm = _bspline_val(order, float(m))
		if bm != 0: resp = resp + bm*np.cos(m*w)
	return resp.astype(dtype)


@functools.lru_cache(maxsize=64)
def _response_on(n, order, dtype, device):
	"""The first n//2 + 1 entries of the response (the real FFT's bins), in
	dtype on device, built once per (n, order, dtype, device)."""
	return torch.from_numpy(_bspline_response(n, np.float64, order)[:n//2+1]).to(device, dtype)


# ---------------------------------------------------------------------------
# The prefilter (pixell_tpu/interpol.py:121-152) and its transpose
# ---------------------------------------------------------------------------
def _as_tensor(x, device=None):
	x = x.data if hasattr(x, "wcs") else x
	return x if isinstance(x, torch.Tensor) else torch.as_tensor(np.asarray(x), device=device)


def _is_cyclic(border): return border in ("cyclic", "wrap")
def _is_edge(border): return border in ("nearest", "edge")
def _is_mirror(border): return border in ("mirror", "reflect")


def _deconv(x, ax, order, n=None):
	"""Real x, zero-padded at the end to n along axis ax (its length by
	default), divided by the B-spline response there in Fourier space: [n]
	along ax (the response is real and even, so this is its own
	transpose)."""
	if n is None: n = x.shape[ax]
	shape = [1]*x.ndim
	shape[ax] = n//2 + 1
	resp = _response_on(n, order, x.dtype, x.device).reshape(shape)
	return torch.fft.irfft(torch.fft.rfft(x, n=n, dim=ax).div_(resp), n=n, dim=ax)


def _pads(n):
	"""(before, after): the pad of an axis of n pixels for the prefilter.
	At least PAD on each side, and after it as much more as makes the
	padded length a product of 2, 3, 5 and 7, which the FFT takes fastest;
	an axis shorter than PAD by n on each side, as the reference."""
	if n < PAD: return n, n
	return PAD, fft_len(n + 2*PAD, "above") - n - PAD


def _pad_index(n, pads, border, device):
	"""The source pixel of each pixel of an axis of n padded by pads
	(before, after) with border "nearest" (numpy's "edge") or "mirror"
	(numpy's "reflect"), in the order the circular filter can take it: the
	axis, the pad after it, then the pad before it (the padded axis rotated
	by pads[0])."""
	i = torch.arange(-pads[0], n + pads[1], device=device).roll(-pads[0])
	return _norm(i, n, border)[0]


# The filter is a circular convolution, so it commutes with rotations: the
# padded axis is filtered rotated by its pad before, which puts the axis at
# the start and lets the zero border's pads be the FFT's own zero padding.
def _filter_axis(x, ax, order, border):
	n = x.shape[ax]
	if _is_cyclic(border): return _deconv(x, ax, order)
	pads = _pads(n)
	if _is_edge(border) or _is_mirror(border):
		x = x.index_select(ax, _pad_index(n, pads, border, x.device))
	return _deconv(x, ax, order, n + sum(pads)).narrow(ax, 0, n)


def _filter_axis_t(y, ax, order, border):
	"""The transpose of _filter_axis."""
	n = y.shape[ax]
	if _is_cyclic(border): return _deconv(y, ax, order)
	pads = _pads(n)
	ext = _deconv(y, ax, order, n + sum(pads))
	if _is_edge(border) or _is_mirror(border):
		return y.new_zeros(y.shape).index_add_(ax, _pad_index(n, pads, border, y.device), ext)
	return ext.narrow(ax, 0, n)


def spline_filter(data, order=3, axes=None, border="cyclic", trans=False):
	"""The B-spline prefilter of real data: the coefficients c whose spline
	at the integers reproduces data, along axes (all by default); trans
	applies the transpose (pixell_tpu.interpol.spline_filter)."""
	arr = _as_tensor(data)
	if order < 2: return arr
	if axes is None: axes = range(arr.ndim)
	axes = [ax % arr.ndim for ax in axes]
	for ax in (reversed(axes) if trans else axes):
		arr = (_filter_axis_t if trans else _filter_axis)(arr, ax, order, border)
	return arr


# ---------------------------------------------------------------------------
# map_coordinates (pixell_tpu/interpol.py:184-292)
# ---------------------------------------------------------------------------
def _filtered(mode, order, border, prefilter):
	"""(whether the taps read spline coefficients, the pad they keep): with
	the zero border the data is zero-padded by ZPAD before the prefilter and
	the pad kept, since coefficients just outside a map are not zero."""
	on = mode == "spline" and prefilter and order >= 2
	return on, ZPAD if on and border in ("zero", "constant") else 0


def _coefficients(data, mode, order, border, prefilter):
	"""(the grid the taps read: the data or its spline coefficients, its pad)."""
	on, padded = _filtered(mode, order, border, prefilter)
	if not on: return data, 0
	if padded: data = torch.nn.functional.pad(data, (padded,)*4)
	return spline_filter(data, order=order, axes=(-2, -1), border=border), padded


def _norm(i, n, border):
	"""Tap indices i normalized for a border: (indices in [0, n), whether
	each is inside, None where every tap is)."""
	if _is_cyclic(border): return i % n, None
	if _is_edge(border): return i.clamp(0, n-1), None
	if _is_mirror(border):
		period = 2*n - 2 if n > 1 else 1
		i = i % period
		return torch.where(i >= n, period - i, i), None
	return i.clamp(0, n-1), (i >= 0) & (i < n)


def _taps(p, mode, order, ntap, off, padded, n, border):
	"""(tap indices [P, ntap] normalized, their validity or None, offsets
	t [P]) of positions p along an axis of n pixels (padded included)."""
	i0 = torch.floor(p + 0.5) if order % 2 == 0 and mode != "lanczos" else torch.floor(p)
	t = p - i0
	i = i0.long()[:, None] + torch.arange(padded - off, padded + ntap - off, device=p.device)
	return _norm(i, n, border) + (t,)


def _axis(p, n, mode, order, border, padded, deriv, dtype):
	"""(tap indices [P, ntap] normalized, their validity or None, weights
	[P, ntap] in dtype, with deriv their derivatives else None) of positions
	p [P] along an axis of n pixels (padded included)."""
	if order == 0:
		v, g = _norm(torch.round(p).long()[:, None], n, border)
		one = torch.ones_like(p, dtype=dtype)[:, None]
		return v, g, one, 0*one if deriv else None
	wfun, dwfun, ntap, off = _kernel(mode, order)
	v, g, t = _taps(p, mode, order, ntap, off, padded, n, border)
	if deriv and dwfun is None: raise ValueError("no derivative weights for mode %s" % mode)
	return v, g, wfun(t).to(dtype), dwfun(t).to(dtype) if deriv else None


class _Plan:
	"""The taps and weights of a chunk of points (py, px) [P] on a grid of
	shape (ny, nx): per axis, normalized indices, validity and weights (and
	with deriv their derivatives) in dtype."""
	def __init__(self, py, px, shape, mode, order, border, padded, deriv, dtype):
		ny, nx = shape
		self.nx = nx
		self.vy, self.gy, self.wy, self.dwy = _axis(py, ny, mode, order, border, padded, deriv, dtype)
		self.vx, self.gx, self.wx, self.dwx = _axis(px, nx, mode, order, border, padded, deriv, dtype)

	def each(self):
		"""(flat index [P], validity [P] or None, y tap, x tap) of each tap."""
		for j in range(self.vy.shape[1]):
			for k in range(self.vx.shape[1]):
				good = None
				if self.gy is not None: good = self.gy[:, j] & self.gx[:, k]
				yield self.vy[:, j]*self.nx + self.vx[:, k], good, j, k


def _chunks(npt):
	"""Slices of at most CHUNK of npt points (one, empty, for none)."""
	for i in range(0, max(npt, 1), CHUNK): yield slice(i, min(i + CHUNK, npt))


def _gather(coef, py, px, mode, order, border, padded, deriv, cval):
	"""coef [C, ny, nx] at the points (py, px) [P]: [C, P], or with deriv
	[C, 2, P] ({d/dy, d/dx})."""
	C, ny, nx = coef.shape
	flat = coef.reshape(C, ny*nx)
	p = _Plan(py, px, (ny, nx), mode, order, border, padded, deriv, coef.dtype)
	acc = dy = dx = None
	for i, good, j, k in p.each():
		v = flat.index_select(1, i)
		if good is not None: v = torch.where(good, v, cval)
		if not deriv:
			t = v*(p.wy[:, j]*p.wx[:, k])
			acc = t if acc is None else acc.add_(t)
		else:
			a, b = v*(p.dwy[:, j]*p.wx[:, k]), v*(p.wy[:, j]*p.dwx[:, k])
			dy, dx = (a, b) if dy is None else (dy.add_(a), dx.add_(b))
	return acc if not deriv else torch.stack([dy, dx], -2)


def _gather_grid(coef, py, px, mode, order, border, padded, cval):
	"""coef [C, ny, nx] at the grid of points (py[Y], px[X]): [C, Y, X],
	the same sums as _gather one axis at a time. The rows are interpolated
	first (one index_select of whole rows a tap), then the columns; a tap
	outside the zero border weighs 0, and cval comes in with the weight
	those taps had."""
	C, ny, nx = coef.shape
	vy, gy, wy, _ = _axis(py, ny, mode, order, border, padded, False, coef.dtype)
	vx, gx, wx, _ = _axis(px, nx, mode, order, border, padded, False, coef.dtype)
	ay = wy if gy is None else wy*gy
	ax = wx if gx is None else wx*gx
	rows = coef.index_select(1, vy[:, 0])*ay[:, 0, None]
	for j in range(1, vy.shape[1]):
		rows.addcmul_(coef.index_select(1, vy[:, j]), ay[:, j, None])
	res = rows.index_select(2, vx[:, 0])*ax[:, 0]
	for k in range(1, vx.shape[1]):
		res.addcmul_(rows.index_select(2, vx[:, k]), ax[:, k])
	if gy is not None and cval != 0:
		res += cval*(wy.sum(1)[:, None]*wx.sum(1) - ay.sum(1)[:, None]*ax.sum(1))
	return res


def _scatter(out, vals, py, px, mode, order, border, padded, deriv):
	"""The transpose of _gather: add vals [C, P] ([C, 2, P] with deriv) at
	the points into out [C, ny, nx], in place."""
	C, ny, nx = out.shape
	flat = out.view(C, ny*nx)
	p = _Plan(py, px, (ny, nx), mode, order, border, padded, deriv, vals.dtype)
	for i, good, j, k in p.each():
		if not deriv: t = vals*(p.wy[:, j]*p.wx[:, k])
		else: t = vals[:, 0]*(p.dwy[:, j]*p.wx[:, k]) + vals[:, 1]*(p.wy[:, j]*p.dwx[:, k])
		if good is not None: t = torch.where(good, t, 0.0)
		flat.index_add_(1, i, t)
	return out


def map_coordinates(idata, points, odata=None, mode="spline", order=3,
		border="cyclic", trans=False, deriv=False, prefilter=True, cval=0.0):
	"""idata [..., ny, nx] interpolated at the fractional pixel positions
	points [{y, x}, ...] (1d data [..., n] at points [1, ...]); tensors on
	idata's device, host positions copied there in float64
	(pixell_tpu.interpol.map_coordinates).

	mode: "spline" (prefiltered B-spline: interpolating), "conv" (the
	 B-spline's weights on the data: smoothing) or "lanczos" (3 lobes).
	order: 0-5. border: "cyclic" / "wrap", "nearest" / "edge", "mirror" /
	 "reflect", anything else zero (cval outside the map).
	deriv: the gradient [..., {d/dy, d/dx}, ...] instead of the values.
	trans: the transpose: odata [..., pts] (with deriv [..., 2, pts])
	 spread back onto a map of idata's shape."""
	idata = _as_tensor(idata)
	points = _as_tensor(points, idata.device)
	if not points.is_floating_point(): points = points.to(torch.float64)
	points = points.to(idata.device)
	if points.shape[0] == 1:   # 1d data on a 2d grid of one row (data and map alike)
		pts = torch.stack([torch.zeros_like(points[0]), points[0]])
		if trans: odata = idata if odata is None else odata
		res = map_coordinates(idata[..., None, :], pts, odata=odata, mode=mode, order=order,
			border=border, trans=trans, deriv=deriv, prefilter=prefilter, cval=cval)
		return res[..., 0, :] if trans else res
	if points.shape[0] != 2: raise ValueError("only 1d and 2d interpolation are supported")
	pshape = tuple(points.shape[1:])
	py, px = points.reshape(2, -1)
	npt = py.shape[0]
	pre = tuple(idata.shape[:-2])
	if not trans:
		coef, padded = _coefficients(idata.reshape((-1,) + idata.shape[-2:]), mode, order, border, prefilter)
		res = torch.cat([_gather(coef, py[s], px[s], mode, order, border, padded, deriv, cval)
			for s in _chunks(npt)], -1)
		return res.reshape(pre + ((2,) if deriv else ()) + pshape)
	vals = _as_tensor(idata if odata is None else odata, idata.device)
	vals = vals.reshape((-1,) + ((2,) if deriv else ()) + (npt,))
	return _transpose(vals, py, px, idata.shape, mode, order, border, deriv, prefilter).reshape(idata.shape)


def _transpose(vals, py, px, shape, mode, order, border, deriv, prefilter):
	"""map_coordinates' transpose: vals [C, (2,) P] at the points spread
	onto [C, ny, nx] (shape's pixels)."""
	on, padded = _filtered(mode, order, border, prefilter)
	ny, nx = shape[-2] + 2*padded, shape[-1] + 2*padded
	out = vals.new_zeros((vals.shape[0], ny, nx))
	for s in _chunks(py.shape[0]):
		_scatter(out, vals[..., s], py[s], px[s], mode, order, border, padded, deriv)
	if on: out = spline_filter(out, order=order, axes=(-2, -1), border=border, trans=True)
	if padded: out = out[:, padded:-padded, padded:-padded]
	return out


# ---------------------------------------------------------------------------
# The adaptive interpolator (pixell_tpu/interpol.py:295-331): a function
# evaluated on a grid refined until it reproduces itself; host numpy
# ---------------------------------------------------------------------------
def build(func, interpolator, box, errlim, maxsize=None, maxdepth=None,
		return_obj=False, *args, **kwargs):
	"""An interpolator of func over box [{from, to}, ndim] from a grid
	refined until func is reproduced within errlim
	(pixell_tpu.interpol.build)."""
	box = np.asarray(box, float)
	n = np.zeros(box.shape[1], int) + 8
	for depth in range(maxdepth or 10):
		grid = _eval_grid(func, box, n)
		ip = interpolator(box, grid)
		ntest = np.minimum(n*2-1, 64)
		test_grid = _eval_grid(func, box, ntest)
		got = ip(_grid_coords(box, ntest))
		err = np.abs(np.asarray(got).reshape(test_grid.shape) - test_grid)
		if np.max(err) <= np.max(errlim): break
		n = n*2 - 1
		if maxsize and np.prod(n) > maxsize: break
	return (ip, grid) if return_obj else ip

def _grid_coords(box, n):
	axes = [np.linspace(box[0, i], box[1, i], n[i]) for i in range(box.shape[1])]
	return np.stack([m.reshape(-1) for m in np.meshgrid(*axes, indexing="ij")])

def _eval_grid(func, box, n):
	vals = np.asarray(func(_grid_coords(box, n)))
	return vals.reshape(vals.shape[:-1] + tuple(n))


# ---------------------------------------------------------------------------
# Box-mapped interpolators (pixell_tpu/interpol.py:336-423), host numpy
# ---------------------------------------------------------------------------
def get_core(dtype):
	"""The interpolation engine for dtype: map_coordinates for every dtype
	(pixell_tpu.interpol.get_core)."""
	return map_coordinates

def lin_derivs_forward(y, npre=0):
	"""Every combination of 0th and 1st forward differences along the last
	axes: [(2,)*n, ...] with each interpolated axis one shorter."""
	y = np.asarray(y, float)
	nin = y.ndim - npre
	ys = np.zeros((2,)*nin + y.shape)
	ys[(0,)*nin] = y
	whole, start, end = slice(None), slice(0, -1), slice(1, None)
	for i in range(nin):
		target = (whole,)*i + (1,) + (0,)*(nin-i-1)
		source = (whole,)*i + (0,) + (0,)*(nin-i-1)
		cells1 = (whole,)*(npre+i) + (start,) + (whole,)*(nin-i-1)
		cells2 = (whole,)*(npre+i) + (end,) + (whole,)*(nin-i-1)
		ys[target + cells1] = ys[source + cells2] - ys[source + cells1]
	return ys[(whole,)*nin + (whole,)*npre + (start,)*nin]

def grad_forward(y, npre=0):
	"""The forward-difference gradient along the last axes: [n, ...]."""
	y = np.asarray(y, float)
	nin = y.ndim - npre
	dy = np.zeros((nin,) + y.shape)
	whole, start, end = slice(None), slice(0, -1), slice(1, None)
	for i in range(nin):
		cells1 = (whole,)*(npre+i) + (start,) + (whole,)*(nin-i-1)
		cells2 = (whole,)*(npre+i) + (end,) + (whole,)*(nin-i-1)
		dy[(i,) + cells1] = y[cells2] - y[cells1]
	return dy[(whole,) + (slice(None, -1),)*(dy.ndim-1)]

class Interpolator:
	"""A grid y over a coordinate box [{from, to}, ndim]."""
	def __init__(self, box, y, *args, **kwargs):
		self.box, self.y = np.array(box), np.array(y)
		self.args, self.kwargs = args, kwargs

class ip_ndimage(Interpolator):
	"""map_coordinates of the grid at coordinates x [ndim, ...] (on the CPU)."""
	def __call__(self, x):
		x = np.asarray(x)
		px = ((x.reshape(x.shape[0], -1).T - self.box[0])
			/(self.box[1] - self.box[0])*(np.array(self.y.shape[-x.shape[0]:]) - 1)).T
		res = map_coordinates(torch.from_numpy(self.y), torch.from_numpy(np.ascontiguousarray(px)),
			*self.args, **self.kwargs).numpy()
		return res.reshape(res.shape[:-1] + x.shape[1:])

class ip_linear(Interpolator):
	"""Multilinear interpolation from precomputed forward differences."""
	def __init__(self, box, y, *args, **kwargs):
		Interpolator.__init__(self, box, y, *args, **kwargs)
		self.n = self.box.shape[1] if self.box.ndim > 1 else 1
		self.npre = self.y.ndim - self.n
		self.ys = lin_derivs_forward(self.y, self.npre)
	def _cell(self, x):
		flatx = x.reshape(x.shape[0], -1)
		nshape = np.array(self.ys.shape[-self.n:])
		px = ((flatx.T - self.box[0])/(self.box[1] - self.box[0])*nshape).T
		ix = np.maximum(0, np.minimum(nshape[:, None] - 1, np.floor(px).astype(int)))
		return ix, px - ix
	def __call__(self, x):
		x = np.asarray(x)
		ix, fx = self._cell(x)
		res = np.zeros(self.ys.shape[self.n:self.n+self.npre] + fx.shape[1:2])
		for i in range(2**self.n):
			I = np.unravel_index(i, (2,)*self.n)
			w = np.ones(fx.shape[1:])
			for d in range(self.n): w = w*(fx[d]**I[d])
			res += self.ys[I][(slice(None),)*self.npre + tuple(ix)]*w
		return res.reshape(res.shape[:-1] + x.shape[1:])

class ip_grad(ip_linear):
	"""First-order interpolation from the value and gradient of a cell."""
	def __call__(self, x):
		x = np.asarray(x)
		ix, fx = self._cell(x)
		res = self.ys[(0,)*self.n][(slice(None),)*self.npre + tuple(ix)].copy()
		for d in range(self.n):
			I = tuple(1 if k == d else 0 for k in range(self.n))
			res += self.ys[I][(slice(None),)*self.npre + tuple(ix)]*fx[d]
		return res.reshape(res.shape[:-1] + x.shape[1:])
