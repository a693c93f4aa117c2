"""ndmap: a sky map as a torch tensor plus its WCS (counterpart of
pixell_tpu/enmap.py).

Ports the ndmap class (pixell_tpu/enmap.py:33-316: numpy-style arithmetic
keeping the wcs, wcs-aware slicing, an out-of-place at_ updater) with its
constructors and Geometry (:319-412); the pixel <-> sky coordinates, the
extent, area and pixel-size functions and the geometry builders (:418-1135,
:1880-2106), all host numpy as in the reference; the flat-sky Fourier
side (:699-789, :1268-1545, :2012-2249): fft / ifft / dct with their
normalizations and adjoints, map2harm / harm2map with the spin rotation,
the Fourier coordinates, binning, 2d spectra, filters, shifts and
derivatives, and the flat random fields; and the pixel side (:505-984,
:1138-1266, :1546-1575, :1749-1799, :1921-2193): pixel boxes, the extract
family (submap / extract / insert, wrapped in RA), resolution changes,
padding, apodization, and reprojection (project / at) through interpol;
and maps on disk (:1626-1747, :1817-1879, :2277-2389): read_map /
write_map and the FITS, HDF5 and .npy readers and writers, the delayed
proxies, the geometry, dtype and header readers.

Only maps live in tensors, and a function that takes a map computes on its
device and returns there. The functions that make a map from a geometry
(zeros, empty, ones, full, enmap from host data, posmap, pixsizemap,
pixmap, lmap, modlmap, lrmap, modrmap, spec2flat, spec2flat_corr,
queb_rotmat of host data, the rand_* draws, and the readers) put it on
device="cuda" unless told otherwise; with no CUDA device they raise. A read
lands in one host buffer, pinned for a CUDA device, and goes to the device
in one copy; FITS images come through fits_io's native box reader, and a
box, pixbox or geometry read takes only the pieces of the file it keeps. The Fourier side builds
nothing map-sized on the host: the rotation angles, the |l| of each
Fourier pixel and lbin's bin index are computed on the device from the two
multipole axes (laxes), which are copied there once per (shape, wcs,
device). project maps only the two axes on the host where both geometries
are separable, else blocks of rows. Random draws use numpy's
default_rng(seed), as the reference does, so one seed gives the
reference's numbers.
"""
from __future__ import annotations
import functools
import operator
import numpy as np
import torch
from . import utils, wcsutils, interpol
from . import fft as enfft


def get_unit(wcs):
	"""Maps are in radians unless plain (pixell_tpu.enmap.get_unit)."""
	return 1.0 if wcsutils.is_plain(wcs) else utils.degree


def _torch_dtype(dtype):
	"""dtype (numpy or torch) as a torch dtype."""
	if dtype is None or isinstance(dtype, torch.dtype): return dtype
	return torch.from_numpy(np.empty(0, dtype)).dtype


def _tensor(x, device):
	"""x as a tensor: an ndmap's data or a tensor as they are, anything else
	on device."""
	if isinstance(x, ndmap): return x.data
	if isinstance(x, torch.Tensor): return x
	return torch.as_tensor(np.asarray(x), device=device)


# ---------------------------------------------------------------------------
# Indexing with negative steps: torch refuses them, so a negative-step slice
# becomes the positive slice over the same elements and the result is
# flipped along that axis
# ---------------------------------------------------------------------------
def _is_int(s):
	return isinstance(s, (int, np.integer)) and not isinstance(s, bool) or \
		(isinstance(s, torch.Tensor) and s.ndim == 0 and not s.is_floating_point() and s.dtype != torch.bool)


def _positive(sel, shape):
	"""(sel with positive steps only, the result axes to flip, the input
	axes to flip). Where sel has advanced (array) indices the result axes
	cannot be traced, and the input axes are given instead: the caller flips
	the input and indexes with the mirrored slices returned."""
	if not isinstance(sel, tuple): sel = (sel,)
	adv = any(not (s is None or s is Ellipsis or isinstance(s, slice) or _is_int(s)) for s in sel)
	if Ellipsis in sel:
		i = sel.index(Ellipsis)
		nused = sum(1 for s in sel if s is not None and s is not Ellipsis)
		sel = sel[:i] + (slice(None),)*(len(shape) - nused) + sel[i+1:]
	out, rflip, iflip, idim, rdim = [], [], [], 0, 0
	for s in sel:
		if s is None:
			out.append(s); rdim += 1
			continue
		if isinstance(s, slice):
			n = shape[idim]
			start, stop, step = s.indices(n)
			if step < 0:
				k = len(range(start, stop, step))
				if adv:     # the same elements of the input flipped along idim
					s = slice(n-1-start, n-1-start + k*(-step), -step) if k else slice(0, 0)
					iflip.append(idim)
				else:
					s = slice(start + (k-1)*step, start + 1, -step) if k else slice(0, 0)
					rflip.append(rdim)
			out.append(s); idim += 1; rdim += 1
			continue
		out.append(s)
		mask = (isinstance(s, np.ndarray) and s.dtype == bool) or \
			(isinstance(s, torch.Tensor) and s.dtype == torch.bool)
		idim += s.ndim if mask else 1
	return tuple(out), rflip, iflip


def _getitem(data, sel):
	sel, rflip, iflip = _positive(sel, data.shape)
	if iflip: return data.flip(iflip)[sel]
	res = data[sel]
	return res.flip(rflip) if rflip else res


def _setitem(data, sel, val):
	sel, rflip, iflip = _positive(sel, data.shape)
	if iflip: raise IndexError("negative steps beside array indices are not supported in assignment")
	if isinstance(val, torch.Tensor): val = val.to(data.device)
	elif not np.isscalar(val): val = torch.as_tensor(np.asarray(val), device=data.device)
	if rflip and isinstance(val, torch.Tensor): val = val.expand(data[sel].shape).flip(rflip)
	data[sel] = val


def _operand(x, device):
	"""The other operand of an ndmap operator: an ndmap's data, a numpy array
	as a tensor on device, a numpy scalar as a Python number."""
	if isinstance(x, ndmap): return x.data
	if isinstance(x, np.ndarray): return torch.as_tensor(x, device=device)
	if isinstance(x, np.generic): return x.item()
	return x


class ndmap:
	"""A map: a torch tensor ``data`` [..., ny, nx] and its ``wcs``
	(pixell_tpu.enmap.ndmap :33).

	Arithmetic works on ``data`` and keeps the wcs, with ndmaps, tensors,
	numpy arrays and scalars on either side (a numpy array on the left
	reaches the reflected operator; a torch function given an ndmap unwraps
	it and wraps a result that keeps its pixel axes). In-place operators
	write into ``data``. Slicing the pixel axes slices the wcs (negative
	steps too); an integer or None there gives a bare tensor. ``at_`` is an
	out-of-place updater: ``m.at_[sel].set(v)`` returns a new ndmap."""
	__slots__ = ("data", "wcs")
	__array_ufunc__ = None   # numpy defers to the reflected operators

	def __init__(self, arr, wcs, copy=False, dtype=None):
		if isinstance(arr, ndmap): arr = arr.data
		if not isinstance(arr, torch.Tensor): arr = torch.as_tensor(np.asarray(arr))
		if dtype is not None: arr = arr.to(_torch_dtype(dtype))
		if copy: arr = arr.clone()
		self.data = arr
		self.wcs = wcs

	@classmethod
	def __torch_function__(cls, func, types, args=(), kwargs=None):
		ref = []
		def unwrap(x):
			if isinstance(x, ndmap):
				ref.append(x)
				return x.data
			if isinstance(x, (tuple, list)): return type(x)(unwrap(y) for y in x)
			return x
		res = func(*unwrap(args), **{k: unwrap(v) for k, v in (kwargs or {}).items()})
		m = ref[0]
		if isinstance(res, torch.Tensor) and res.ndim >= 2 and tuple(res.shape[-2:]) == m.shape[-2:]:
			return ndmap(res, m.wcs)
		return res

	# ----- introspection -----
	@property
	def shape(self): return tuple(self.data.shape)
	@property
	def ndim(self): return self.data.ndim
	@property
	def dtype(self): return self.data.dtype
	@property
	def device(self): return self.data.device
	@property
	def size(self): return self.data.numel()
	@property
	def nbytes(self): return self.data.numel()*self.data.element_size()
	@property
	def geometry(self): return self.shape, self.wcs
	@property
	def T(self): return ndmap(self.data.permute(*range(self.ndim-1, -1, -1)), self.wcs)
	@property
	def real(self): return ndmap(self.data.real, self.wcs)
	@property
	def imag(self): return ndmap(self.data.imag, self.wcs)
	def __len__(self): return len(self.data)
	def __repr__(self):
		return "ndmap(%r,%s)" % (self.data, wcsutils.describe(self.wcs))
	__str__ = __repr__

	# ----- conversion -----
	def __array__(self, dtype=None, copy=None):
		return np.asarray(self.data.detach().cpu(), dtype=dtype)
	def astype(self, dtype, copy=True):
		return ndmap(self.data.to(_torch_dtype(dtype), copy=copy), self.wcs)
	def copy(self, order=None):
		return ndmap(self.data.clone(), self.wcs)
	def item(self): return self.data.item()

	# ----- array methods (numpy's names and defaults) -----
	def reshape(self, *shape):
		if len(shape) == 1 and isinstance(shape[0], (tuple, list)): shape = tuple(shape[0])
		return ndmap(self.data.reshape(shape), self.wcs)
	def sum(self, *a, **kw): return _sum(self.data, *a, **kw)
	def mean(self, *a, **kw): return _mean(self.data, *a, **kw)
	def std(self, *a, **kw): return _std(self.data, *a, **kw)
	def var(self, *a, **kw): return _var(self.data, *a, **kw)
	def min(self, *a, **kw): return _min(self.data, *a, **kw)
	def max(self, *a, **kw): return _max(self.data, *a, **kw)
	def conj(self): return ndmap(self.data.conj().resolve_conj(), self.wcs)
	def ravel(self, *a, **kw): return self.data.reshape(-1)
	def flatten(self, *a, **kw): return self.data.flatten()
	def fill(self, val):
		self.data.fill_(val)
		return self
	def preflat(self):
		"""The map with all its leading dimensions flattened into one."""
		return self.reshape((-1,) + self.shape[-2:])
	def npix(self): return int(np.prod(self.shape[-2:]))

	# ----- geometry methods (delegate to the module functions) -----
	def box(self, npoint=10, corner=True): return box(self.shape, self.wcs, npoint=npoint, corner=corner)
	def posmap(self, safe=True, corner=False, separable="auto", dtype=np.float64):
		return posmap(self.shape, self.wcs, safe=safe, corner=corner, separable=separable, dtype=dtype,
			device=self.device)
	def posaxes(self, safe=True, corner=False, dtype=np.float64):
		return posaxes(self.shape, self.wcs, safe=safe, corner=corner, dtype=dtype)
	def pixmap(self): return pixmap(self.shape, self.wcs, device=self.device)
	def laxes(self, oversample=1, method="auto"): return laxes(self.shape, self.wcs, oversample=oversample, method=method)
	def lmap(self, oversample=1): return lmap(self.shape, self.wcs, oversample=oversample, device=self.device)
	def modlmap(self, oversample=1, min=0):
		return modlmap(self.shape, self.wcs, oversample=oversample, min=min, device=self.device)
	def modrmap(self, ref="center", safe=True, corner=False):
		return modrmap(self.shape, self.wcs, ref=ref, safe=safe, corner=corner, device=self.device)
	def lform(self): return lform(self)
	def pix2sky(self, pix, safe=True, corner=False): return pix2sky(self.shape, self.wcs, pix, safe, corner)
	def sky2pix(self, coords, safe=True, corner=False): return sky2pix(self.shape, self.wcs, coords, safe, corner)
	def pix2l(self, pix): return pix2l(self.shape, self.wcs, pix)
	def l2pix(self, ls): return l2pix(self.shape, self.wcs, ls)
	def contains(self, pos, unit="coord"): return contains(self.shape, self.wcs, pos, unit=unit)
	def corners(self, npoint=10, corner=True): return corners(self.shape, self.wcs, npoint=npoint, corner=corner)
	def center(self): return center(self.shape, self.wcs)
	def extent(self, method="auto", signed=False): return extent(self.shape, self.wcs, method=method, signed=signed)
	def area(self, method="auto"): return area(self.shape, self.wcs, method=method)
	def pixsize(self): return pixsize(self.shape, self.wcs)
	def pixshape(self, signed=False): return pixshape(self.shape, self.wcs, signed=signed)
	def pixsizemap(self, separable="auto", broadcastable=False):
		return pixsizemap(self.shape, self.wcs, separable=separable, broadcastable=broadcastable,
			device=self.device)
	def pixshapemap(self, separable="auto", signed=False):
		return pixshapemap(self.shape, self.wcs, separable=separable, signed=signed, device=self.device)
	def plain(self):
		"""The same data on a plain coordinate system."""
		return ndmap(self.data, wcsutils.explicit(crpix=[1, 1], crval=[0, 0], cdelt=[1, 1]))
	def lbin(self, bsize=None, brel=1.0, return_nhit=False, lop=None):
		return lbin(self, bsize=bsize, brel=brel, return_nhit=return_nhit, lop=lop)
	def rbin(self, center=[0, 0], bsize=None, brel=1.0, return_nhit=False):
		return rbin(self, center=center, bsize=bsize, brel=brel, return_nhit=return_nhit)
	def lpixsize(self, signed=False, method="auto"):
		return lpixsize(self.shape, self.wcs, signed=signed, method=method)
	def lpixshape(self, signed=False, method="auto"):
		return lpixshape(self.shape, self.wcs, signed=signed, method=method)
	def extract(self, shape, wcs, omap=None, wrap="auto", op=None, cval=0, iwcs=None, reverse=False):
		return extract(self, shape, wcs, omap=omap, wrap=wrap, op=op, cval=cval, iwcs=iwcs, reverse=reverse)
	def extract_pixbox(self, pixbox, omap=None, wrap="auto", op=None, cval=0, iwcs=None, reverse=False):
		return extract_pixbox(self, pixbox, omap=omap, wrap=wrap, op=op, cval=cval, iwcs=iwcs, reverse=reverse)
	def insert(self, imap, wrap="auto", op=None, cval=0, iwcs=None):
		return insert(self, imap, wrap=wrap, op=op, cval=cval, iwcs=iwcs)
	def insert_at(self, pix, imap, wrap="auto", op=None, cval=0, iwcs=None):
		return insert_at(self, pix, imap, wrap=wrap, op=op, cval=cval, iwcs=iwcs)
	def submap(self, box, mode=None, wrap="auto", recenter=False):
		return submap(self, box, mode=mode, wrap=wrap, recenter=recenter)
	def subinds(self, box, mode=None, cap=True, noflip=False, epsilon=1e-4):
		return subinds(self.shape, self.wcs, box, mode=mode, cap=cap, noflip=noflip, epsilon=epsilon)
	def stamps(self, pos, shape, aslist=False): return stamps(self, pos, shape, aslist=aslist)
	def project(self, shape, wcs, order=3, border="constant", cval=0.0, safe=True):
		return project(self, shape, wcs, order=order, border=border, cval=cval, safe=safe)
	def at(self_map, pos, order=3, border="constant", cval=0.0, safe=True, unit="coord"):
		return at(self_map, pos, order=order, border=border, cval=cval, safe=safe, unit=unit)
	def autocrop(self, method="plain", value="auto", margin=0, factors=None, return_info=False):
		return autocrop(self, method=method, value=value, margin=margin, factors=factors, return_info=return_info)
	def apod(self, width, profile="cos", fill="zero"): return apod(self, width, profile=profile, fill=fill)
	def downgrade(self, factor, op=None, ref=None, off=None):
		return downgrade(self, factor, op=op, ref=ref, off=off)
	def upgrade(self, factor, off=None, oshape=None, inclusive=False):
		return upgrade(self, factor, off=off, oshape=oshape, inclusive=inclusive)
	def fillbad(self, val=0, inplace=False): return fillbad(self, val=val, inplace=inplace)
	def to_healpix(self, nside=0, order=3, omap=None, chunk=100000, destroy_input=False):
		return to_healpix(self, nside=nside, order=order)
	def to_flipper(self, omap=None, unpack=True):
		return to_flipper(self, omap=omap, unpack=unpack)
	def distance_from(self, points, omap=None, odomains=None, domains=False, method="auto", rmax=None,
			step=1024):
		return distance_from(self.shape, self.wcs, points, omap=omap, odomains=odomains, domains=domains,
			method=method, rmax=rmax, step=step, device=self.device)
	def distance_transform(self, omap=None, rmax=None, method="auto"):
		return distance_transform(self, omap=omap, rmax=rmax, method=method)
	def labeled_distance_transform(self, omap=None, odomains=None, rmax=None, method="auto"):
		return labeled_distance_transform(self, omap=omap, odomains=odomains, rmax=rmax, method=method)
	def argmax(self, unit="coord"): return argmax(self, unit=unit)
	def argmin(self, unit="coord"): return argmin(self, unit=unit)
	def pixbox_of(self, oshape, owcs): return pixbox_of(self.wcs, oshape, owcs)
	def padslice(self, box, default=np.nan): return padslice(self, box, default=default)
	def resample(self, oshape, off=(0, 0), method="fft", border="wrap", corner=True, order=3):
		return resample(self, oshape, method=method, mode=border, corner=corner, order=order)
	def fft(self, omap=None, nthread=0, normalize=True, adjoint_ifft=False, dct=False):
		return fft(self, omap=omap, nthread=nthread, normalize=normalize, adjoint_ifft=adjoint_ifft, dct=dct)
	def ifft(self, omap=None, nthread=0, normalize=True, adjoint_fft=False, dct=False):
		return ifft(self, omap=omap, nthread=nthread, normalize=normalize, adjoint_fft=adjoint_fft, dct=dct)
	def write(self, fname, fmt=None):
		write_map(fname, self, fmt=fmt)

	# ----- indexing -----
	def __getitem__(self, sel):
		sel1, sel2 = utils.split_slice(sel, [self.ndim-2, 2])
		if len(sel2) > 2: raise IndexError("too many indices")
		if len(sel2) == 0: return ndmap(_getitem(self.data, sel), self.wcs)
		# an integer, None or an array on a pixel axis: no longer a map
		if not all(isinstance(s, slice) for s in sel2): return _getitem(self.data, sel)
		_, wcs = slice_geometry(self.shape[-2:], self.wcs, sel2)
		return ndmap(_getitem(self.data, sel), wcs)

	def __setitem__(self, sel, val):
		_setitem(self.data, sel, _operand(val, self.device))

	@property
	def at_(self): return _NdmapAt(self)

	def __iter__(self):
		for i in range(self.shape[0]): yield self[i]


# the reductions with numpy's parameters (axis, dtype, ddof, keepdims)
def _sum(d, axis=None, dtype=None, keepdims=False):
	return torch.sum(d, dim=axis, keepdim=keepdims, dtype=_torch_dtype(dtype))
def _mean(d, axis=None, dtype=None, keepdims=False):
	return torch.mean(d, dim=axis, keepdim=keepdims, dtype=_torch_dtype(dtype))
def _std(d, axis=None, dtype=None, ddof=0, keepdims=False):
	return torch.std(d, dim=axis, correction=ddof, keepdim=keepdims)
def _var(d, axis=None, dtype=None, ddof=0, keepdims=False):
	return torch.var(d, dim=axis, correction=ddof, keepdim=keepdims)
def _min(d, axis=None, keepdims=False):
	return d.min() if axis is None else torch.amin(d, axis, keepdims)
def _max(d, axis=None, keepdims=False):
	return d.max() if axis is None else torch.amax(d, axis, keepdims)


class _NdmapAt:
	"""m.at_[sel].set(v) (add, multiply, max, min): a new ndmap with the
	update, m unchanged."""
	def __init__(self, m): self.m = m
	def __getitem__(self, sel): return _NdmapAtSel(self.m, sel)

class _NdmapAtSel:
	def __init__(self, m, sel): self.m, self.sel = m, sel
	def _apply(self, op, val):
		data = self.m.data.clone()
		val = _operand(val, data.device)
		if op != "set":
			cur = _getitem(data, self.sel)
			val = {"add": torch.add, "multiply": torch.mul, "max": torch.maximum,
				"min": torch.minimum}[op](cur, torch.as_tensor(val, device=data.device))
		_setitem(data, self.sel, val)
		return ndmap(data, self.m.wcs)
	def set(self, val): return self._apply("set", val)
	def add(self, val): return self._apply("add", val)
	def multiply(self, val): return self._apply("multiply", val)
	def max(self, val): return self._apply("max", val)
	def min(self, val): return self._apply("min", val)


def _binop(name, op, reflected=False):
	def fun(self, other):
		o = _operand(other, self.device)
		try: res = op(o, self.data) if reflected else op(self.data, o)
		except TypeError: return NotImplemented
		return ndmap(res, self.wcs)
	fun.__name__ = name
	return fun

def _ibinop(name, op):
	def fun(self, other):
		self.data = op(self.data, _operand(other, self.device))
		return self
	fun.__name__ = name
	return fun

for _name, _op, _iop in [("add", operator.add, operator.iadd), ("sub", operator.sub, operator.isub),
		("mul", operator.mul, operator.imul), ("truediv", operator.truediv, operator.itruediv),
		("floordiv", operator.floordiv, operator.ifloordiv), ("mod", operator.mod, operator.imod),
		("pow", operator.pow, operator.ipow), ("and", operator.and_, operator.iand),
		("or", operator.or_, operator.ior), ("xor", operator.xor, operator.ixor),
		("lshift", operator.lshift, operator.ilshift), ("rshift", operator.rshift, operator.irshift),
		("matmul", operator.matmul, operator.imatmul)]:
	setattr(ndmap, "__%s__" % _name, _binop("__%s__" % _name, _op))
	setattr(ndmap, "__r%s__" % _name, _binop("__r%s__" % _name, _op, reflected=True))
	setattr(ndmap, "__i%s__" % _name, _ibinop("__i%s__" % _name, _iop))
for _name, _op in [("lt", operator.lt), ("le", operator.le), ("gt", operator.gt),
		("ge", operator.ge), ("eq", operator.eq), ("ne", operator.ne)]:
	setattr(ndmap, "__%s__" % _name, _binop("__%s__" % _name, _op))
ndmap.__neg__ = lambda self: ndmap(-self.data, self.wcs)
ndmap.__pos__ = lambda self: self
ndmap.__abs__ = lambda self: ndmap(abs(self.data), self.wcs)
ndmap.__invert__ = lambda self: ndmap(~self.data, self.wcs)


def samewcs(arr, *args):
	"""arr wrapped in an ndmap with the wcs of the first ndmap among
	(arr,) + args, or arr itself (pixell_tpu.enmap.samewcs)."""
	for a in (arr,) + args:
		if isinstance(a, ndmap):
			return ndmap(arr.data if isinstance(arr, ndmap) else arr, a.wcs)
	return arr


# ---------------------------------------------------------------------------
# Constructors (pixell_tpu/enmap.py:331-412)
# ---------------------------------------------------------------------------
def enmap(arr, wcs=None, dtype=None, copy=True, *, device="cuda"):
	"""An ndmap of arr (pixell_tpu.enmap.enmap :331): a tensor or an ndmap
	stays on its device, host data goes to device. The wcs defaults to
	arr's (or the first map's of a list of maps), else a plain one."""
	if wcs is None:
		if isinstance(arr, ndmap): wcs = arr.wcs
		elif isinstance(arr, (list, tuple)) and len(arr) > 0 and isinstance(arr[0], ndmap): wcs = arr[0].wcs
		else: wcs = wcsutils.WCS(naxis=2)
	if isinstance(arr, (list, tuple)) and len(arr) > 0 and isinstance(arr[0], (ndmap, torch.Tensor)):
		arr = torch.stack([_tensor(a, device) for a in arr])
	elif isinstance(arr, ndmap): arr = arr.data
	elif not isinstance(arr, torch.Tensor): arr = torch.as_tensor(np.asarray(arr), device=device)
	if dtype is not None: arr = arr.to(_torch_dtype(dtype))
	if copy: arr = arr.clone()
	return ndmap(arr, wcs)


def zeros(shape, wcs=None, dtype=torch.float64, *, device="cuda"):
	if wcs is None: wcs = wcsutils.WCS(naxis=2)
	return ndmap(torch.zeros(shape, dtype=_torch_dtype(dtype), device=device), wcs)

def empty(shape, wcs=None, dtype=torch.float64, *, device="cuda"):
	if wcs is None: wcs = wcsutils.WCS(naxis=2)
	return ndmap(torch.empty(shape, dtype=_torch_dtype(dtype), device=device), wcs)

def ones(shape, wcs=None, dtype=None, *, device="cuda"):
	if wcs is None: wcs = wcsutils.WCS(naxis=2)
	return ndmap(torch.ones(shape, dtype=_torch_dtype(dtype) or torch.float64, device=device), wcs)

def full(shape, wcs, val, dtype=None, *, device="cuda"):
	"""A map of val everywhere; the dtype defaults to numpy's for val."""
	dtype = _torch_dtype(np.asarray(val).dtype if dtype is None else dtype)
	return ndmap(torch.full(tuple(shape), val, dtype=dtype, device=device), wcs)


class Geometry:
	"""A (shape, wcs) pair with wcs-aware slicing (pixell_tpu.enmap.Geometry)."""
	def __init__(self, shape, wcs=None):
		if isinstance(shape, Geometry): shape, wcs = shape.shape, shape.wcs
		elif hasattr(shape, "wcs"): shape, wcs = tuple(shape.shape), shape.wcs
		self.shape = tuple(shape)
		self.wcs = wcs
	@property
	def npix(self): return int(np.prod(self.shape[-2:]))
	@property
	def nopre(self): return Geometry(self.shape[-2:], self.wcs)
	def submap(self, box=None, pixbox=None):
		if pixbox is None: pixbox = subinds(self.shape, self.wcs, box, noflip=True)
		return Geometry(*slice_geometry(self.shape, self.wcs, (slice(*pixbox[:, 0]), slice(*pixbox[:, 1]))))
	def scale(self, scale):
		scale = np.zeros(2) + scale
		oshape = self.shape[:-2] + tuple(int(n) for n in utils.nint(np.array(self.shape[-2:])*scale))
		return Geometry(oshape, wcsutils.scale(self.wcs, scale[::-1]))
	def downgrade(self, factor, op=None): return Geometry(*downgrade_geometry(self.shape, self.wcs, factor))
	def copy(self): return Geometry(self.shape, self.wcs.deepcopy())
	def sky2pix(self, coords, safe=True, corner=False): return sky2pix(self.shape, self.wcs, coords, safe, corner)
	def pix2sky(self, pix, safe=True, corner=False): return pix2sky(self.shape, self.wcs, pix, safe, corner)
	def l2pix(self, ls): return l2pix(self.shape, self.wcs, ls)
	def pix2l(self, pix): return pix2l(self.shape, self.wcs, pix)
	def with_pre(self, pre):
		"""The same pixels with the leading dimensions pre."""
		return Geometry(tuple(pre) + self.shape[-2:], self.wcs)
	def __getitem__(self, sel):
		sel1, sel2 = utils.split_slice(sel, [len(self.shape)-2, 2])
		shape, wcs = slice_geometry(self.shape, self.wcs, sel2)
		pre = np.empty(self.shape[:-2])[sel1].shape if len(self.shape) > 2 else ()
		return Geometry(pre + shape[-2:], wcs)
	def __iter__(self):
		yield self.shape
		yield self.wcs
	def __len__(self): return 2
	def __eq__(self, other):
		return tuple(self.shape) == tuple(other.shape) and wcsutils.equal(self.wcs, other.wcs)
	def __repr__(self): return "Geometry(%s,%s)" % (str(self.shape), wcsutils.describe(self.wcs))


def geometry_of(m): return Geometry(m.shape, m.wcs)


# ---------------------------------------------------------------------------
# Pixel <-> sky coordinates (pixell_tpu/enmap.py:418-543); host numpy
# ---------------------------------------------------------------------------
def pix2sky(shape, wcs, pix, safe=True, corner=False, bcheck=False):
	"""Pixel coordinates [{y,x},...] -> sky coordinates [{dec,ra},...] in
	radians, as numpy (pixell_tpu.enmap.pix2sky)."""
	pix = np.asarray(pix).astype(float)
	if corner: pix = pix - 0.5
	y, x = pix[0], pix[1]
	ra, dec = wcsutils.pix2world(wcs, x, y, 0)
	unit = get_unit(wcs)
	coords = np.stack([dec*unit, ra*unit])
	if safe and not wcsutils.is_plain(wcs) and coords[1].ndim > 0:
		coords = np.concatenate([coords[:1],
			utils.unwind(coords[1:2], refmode="middle")], 0)
	return coords


def sky2pix(shape, wcs, coords, safe=True, corner=False, bcheck=False):
	"""Sky coordinates [{dec,ra},...] in radians -> pixel coordinates
	[{y,x},...], as numpy (pixell_tpu.enmap.sky2pix :433). safe puts the
	angle cut as far from the map as possible (safe=2: unwound)."""
	coords = np.asarray(coords)/get_unit(wcs)
	x, y = wcsutils.world2pix(wcs, coords[1], coords[0], 0)
	if corner: x, y = x + 0.5, y + 0.5
	if safe and not wcsutils.is_plain(wcs):
		refx = shape[-1]/2. + (0.5 if corner else 0)
		wn = abs(360./wcs.wcs.cdelt[0])
		if safe == 1: x = utils.rewind(x, refx, wn)
		elif np.ndim(x) > 0: x = utils.unwind(x, period=wn, ref=refx, refmode="middle")
	return np.stack([np.asarray(y), np.asarray(x)])


def posaxes(shape, wcs, safe=True, corner=False, dtype=np.float64, bcheck=False):
	"""(dec[ny], ra[nx]) axes of a separable geometry, in radians
	(pixell_tpu.enmap.posaxes)."""
	y = np.arange(shape[-2], dtype=float)
	x = np.arange(shape[-1], dtype=float)
	dec = pix2sky(shape, wcs, np.array([y, y*0]), safe=safe, corner=corner)[0].astype(dtype, copy=False)
	ra = pix2sky(shape, wcs, np.array([x*0, x]), safe=safe, corner=corner)[1].astype(dtype, copy=False)
	return dec, ra


def _posmap_np(shape, wcs, safe=True, corner=False, separable="auto"):
	"""posmap's [{dec, ra}, ny, nx] as float64 numpy."""
	if separable == "auto": separable = wcsutils.is_separable(wcs)
	if separable:
		dec, ra = posaxes(shape, wcs, safe=safe, corner=corner)
		res = np.empty((2,) + tuple(shape[-2:]))
		res[0] = dec[:, None]
		res[1] = ra[None, :]
		return res
	return np.asarray(pix2sky(shape, wcs, np.mgrid[:shape[-2], :shape[-1]], safe, corner), float)


def posmap(shape, wcs, safe=True, corner=False, separable="auto", dtype=np.float64, bsize=1e6,
		bcheck=False, *, device="cuda"):
	"""The sky coordinates [{dec, ra}, ny, nx] of each pixel, in radians, as
	an ndmap on device (pixell_tpu.enmap.posmap :460): broadcast on the
	device from the two axes where the geometry is separable. bsize and
	bcheck are accepted and ignored."""
	if separable == "auto": separable = wcsutils.is_separable(wcs)
	dt = _torch_dtype(dtype)
	if separable:
		dec, ra = (torch.from_numpy(a).to(device=device, dtype=dt) for a in posaxes(shape, wcs, safe, corner))
		res = torch.stack(torch.broadcast_tensors(dec[:, None], ra[None, :]))
	else:
		res = torch.from_numpy(_posmap_np(shape, wcs, safe, corner, separable)).to(device=device, dtype=dt)
	return ndmap(res, wcs)


def posmap_old(shape, wcs, safe=True, corner=False, *, device="cuda"):
	"""posmap (pixell_tpu.enmap.posmap_old)."""
	return posmap(shape, wcs, safe=safe, corner=corner, device=device)


def posmap_jax(shape, wcs, safe=True, corner=False, dtype=np.float64, *, device="cuda"):
	"""The separable posmap [{dec, ra}, ny, nx] broadcast on device from the
	pixel axes (their coordinates unwound, safe=False, whatever safe says, as
	pixell_tpu.enmap.posmap_jax :479, the form traced under jit there)."""
	dt = _torch_dtype(dtype)
	dec, ra = (torch.from_numpy(np.asarray(a, np.float64)).to(device=device, dtype=dt)
		for a in posaxes(shape, wcs, safe=False, corner=corner))
	return ndmap(torch.stack(torch.broadcast_tensors(dec[:, None], ra[None, :])), wcs)


def pixmap(shape, wcs=None, *, device="cuda"):
	"""The pixel coordinates [{y, x}, ny, nx] of each pixel (int64; an ndmap
	where wcs is given)."""
	res = torch.stack(torch.meshgrid(torch.arange(shape[-2], device=device),
		torch.arange(shape[-1], device=device), indexing="ij"))
	return res if wcs is None else ndmap(res, wcs)


def pix2l(shape, wcs, pix):
	"""Fourier-pixel coordinates [{y,x},...] -> 2d multipole [{ly,lx},...]."""
	pix = np.asanyarray(pix)
	pshape = pixshape(shape, wcs, signed=True)
	ly = enfft.ind2freq(shape[-2], pix[0], pshape[0]/(2*np.pi))
	lx = enfft.ind2freq(shape[-1], pix[1], pshape[1]/(2*np.pi))
	return np.stack([ly, lx])


def l2pix(shape, wcs, ls):
	"""2d multipole [{ly,lx},...] -> Fourier-pixel coordinates [{y,x},...]."""
	ls = np.asanyarray(ls)
	pshape = pixshape(shape, wcs, signed=True)
	py = enfft.freq2ind(shape[-2], ls[0], pshape[0]/(2*np.pi))
	px = enfft.freq2ind(shape[-1], ls[1], pshape[1]/(2*np.pi))
	return np.stack([py, px])


def contains(shape, wcs, pos, unit="coord"):
	"""Whether each point pos[{dec,ra},...] (or pixel, unit="pix") lies in
	the geometry."""
	pix = np.asarray(sky2pix(shape, wcs, pos) if unit == "coord" else pos)
	return np.all((pix >= 0) & (pix.T < shape[-2:]).T, 0)


def corners(shape, wcs, npoint=10, corner=True):
	"""The [{from,to},{dec,ra}] coordinates of the first and last pixel (at
	their outer corners with corner)."""
	pix = np.array([[-0.5, -0.5], [shape[-2]-0.5, shape[-1]-0.5]]).T if corner else \
		np.array([[0, 0], [shape[-2]-1., shape[-1]-1.]]).T
	return np.asarray(pix2sky(shape, wcs, pix)).T


def box(shape, wcs, npoint=10, corner=True):
	"""The bounding box [{from,to},{dec,ra}] of the geometry, from npoint
	points along its diagonal."""
	ys = np.linspace(-0.5 if corner else 0, shape[-2]-(0.5 if corner else 1), npoint)
	xs = np.linspace(-0.5 if corner else 0, shape[-1]-(0.5 if corner else 1), npoint)
	coords = np.asarray(pix2sky(shape, wcs, np.array([ys, xs])))
	return np.array([coords[:, 0], coords[:, -1]])


def center(shape, wcs):
	return np.asarray(pix2sky(shape, wcs, np.array([(shape[-2]-1)/2., (shape[-1]-1)/2.])))


# ---------------------------------------------------------------------------
# Extent, area and pixel sizes (pixell_tpu/enmap.py:549-693, :1950-2010);
# host numpy, the maps copied to the device
# ---------------------------------------------------------------------------
def extent(shape, wcs, nsub=None, signed=False, method="auto"):
	"""The [height, width] of the geometry in radians (pixell_tpu.enmap.extent
	:549): "intermediate" (the flat cdelt extent; plain), "cylindrical"
	(width at the area-weighted mean cos dec; cylindrical) or "subgrid"
	(great-circle lengths along a subgrid; the rest)."""
	if method == "auto":
		if   wcsutils.is_plain(wcs): method = "intermediate"
		elif wcsutils.is_cyl(wcs):   method = "cylindrical"
		else:                        method = "subgrid"
	sgn = np.array([np.sign(wcs.wcs.cdelt[1]), -np.sign(wcs.wcs.cdelt[0])])
	if method in ["inter", "intermediate"]:
		res = np.array([shape[-2]*abs(wcs.wcs.cdelt[1]), shape[-1]*abs(wcs.wcs.cdelt[0])])*get_unit(wcs)
	elif method in ["cyl", "cylindrical"]:
		dec1, dec2 = np.sort([float(pix2sky(shape, wcs, np.array([-0.5, 0]))[0]),
			float(pix2sky(shape, wcs, np.array([shape[-2]-0.5, 0]))[0])])
		dec1, dec2 = max(dec1, -np.pi/2), min(dec2, np.pi/2)
		if abs(dec2-dec1) > 1e-12: mean_cos = (np.sin(dec2) - np.sin(dec1))/(dec2 - dec1)
		else: mean_cos = np.cos(0.5*(dec1+dec2))
		res = np.array([dec2 - dec1, shape[-1]*abs(wcs.wcs.cdelt[0])*utils.degree*mean_cos])
	elif method == "subgrid":
		if nsub is None: nsub = 16
		ys = np.linspace(0, shape[-2]-1, nsub+1)
		xs = np.linspace(0, shape[-1]-1, nsub+1)
		pix = np.array(np.meshgrid(ys, xs, indexing="ij"))
		pos = np.asarray(pix2sky(shape, wcs, pix.reshape(2, -1), safe=False)).reshape(2, nsub+1, nsub+1)
		seg_h = utils.angdist(pos[::-1, :-1, :], pos[::-1, 1:, :], axis=0)
		seg_w = utils.angdist(pos[::-1, :, :-1], pos[::-1, :, 1:], axis=0)
		height = np.mean(np.sum(seg_h, 0))*shape[-2]/(shape[-2]-1) if shape[-2] > 1 else 0
		width = np.mean(np.sum(seg_w, 1))*shape[-1]/(shape[-1]-1) if shape[-1] > 1 else 0
		res = np.array([height, width])
	else:
		raise ValueError("Unrecognized extent method '%s'" % method)
	return res*sgn if signed else res


def extent_intermediate(shape, wcs, signed=False):
	"""The extent in the WCS's intermediate coordinates."""
	res = np.array(wcs.wcs.cdelt[::-1])*shape[-2:]*utils.degree
	return res if signed else np.abs(res)

def extent_cyl(shape, wcs, signed=False):
	return extent(shape, wcs, signed=signed, method="cylindrical")

def extent_subgrid(shape, wcs, nsub=None, safe=True, signed=False):
	return extent(shape, wcs, nsub=nsub, signed=signed, method="subgrid")


def area(shape, wcs, nsamp=1000, method="auto"):
	"""The area of the geometry in steradians: exact on plain and separable
	cylindrical geometries, by the boundary's contour integral otherwise."""
	if wcsutils.is_plain(wcs): return float(np.prod(extent(shape, wcs)))
	if wcsutils.is_separable(wcs): return area_cyl(shape, wcs)
	return area_contour(shape, wcs, nsamp=nsamp)


def area_intermediate(shape, wcs):
	"""The area of a completely flat sky."""
	return np.abs(shape[-2]*shape[-1]*wcs.wcs.cdelt[0]*wcs.wcs.cdelt[1])*utils.degree**2

def area_cyl(shape, wcs):
	"""The exact area of a separable cylindrical geometry."""
	return float(np.sum(pixsizemap_cyl(shape, wcs)[:, 0]))*shape[-1]


def area_contour(shape, wcs, nsamp=1000):
	"""The area by the contour integral of (1 - sin dec) dRA around the
	boundary through the outer pixel edges."""
	ny, nx = shape[-2:]
	t = np.linspace(-0.5, nx - 0.5, nsamp)
	b = np.linspace(-0.5, ny - 0.5, nsamp)
	segs = [np.stack([np.full(nsamp, -0.5), t]), np.stack([b, np.full(nsamp, nx - 0.5)]),
		np.stack([np.full(nsamp, ny - 0.5), t[::-1]]), np.stack([b[::-1], np.full(nsamp, -0.5)])]
	total = 0.0
	for seg in segs:
		pos = np.asarray(pix2sky(shape, wcs, seg))
		msin = 1 - np.sin(np.clip(pos[0], -np.pi/2, np.pi/2))
		dra = utils.rewind(pos[1, 1:] - pos[1, :-1])   # the branch cut may cross the boundary
		total += np.sum(dra*(msin[1:] + msin[:-1])/2)
	return abs(total)


def pixsize(shape, wcs):
	"""The mean pixel area in steradians."""
	return area(shape, wcs)/shape[-2]/shape[-1]

def pixshape(shape, wcs, signed=False):
	"""The mean pixel [height, width] in radians."""
	return extent(shape, wcs, signed=signed)/np.array(shape[-2:])


def _row_decs(shape, wcs, off):
	y = np.arange(shape[-2], dtype=float)
	return np.asarray(pix2sky(shape, wcs, np.array([y + off, y*0]), safe=False))[0]


def pixshapes_cyl(shape, wcs, signed=False):
	"""Each row's pixel [height, width][ny] on a cylindrical geometry: the
	dec extent and dphi cos dec."""
	top = np.clip(_row_decs(shape, wcs, -0.5), -np.pi/2, np.pi/2)
	bot = np.clip(_row_decs(shape, wcs, 0.5), -np.pi/2, np.pi/2)
	widths = abs(wcs.wcs.cdelt[0])*utils.degree*np.cos(np.clip(_row_decs(shape, wcs, 0), -np.pi/2, np.pi/2))
	res = np.array([np.abs(bot - top), widths])
	if signed: res = res*np.array([np.sign(wcs.wcs.cdelt[1]), -np.sign(wcs.wcs.cdelt[0])])[:, None]
	return res


def pixsizemap_cyl(shape, wcs):
	"""The exact pixel areas [ny, 1] of a cylindrical geometry: the sin dec
	difference of each row's edges times the pixel width."""
	top = np.clip(_row_decs(shape, wcs, -0.5), -np.pi/2, np.pi/2)
	bot = np.clip(_row_decs(shape, wcs, 0.5), -np.pi/2, np.pi/2)
	return np.abs(np.sin(bot) - np.sin(top))[:, None]*abs(wcs.wcs.cdelt[0])*utils.degree


def _pixsizemap_np(shape, wcs, separable="auto", broadcastable=False):
	"""pixsizemap's areas as float64 numpy: exact per row on separable
	cylindrical geometries, the constant |cdelt_x cdelt_y| on plain ones,
	else the Jacobian of pix2sky by centred corner differences at the
	pixel centre's dec."""
	if separable == "auto": separable = wcsutils.is_separable(wcs)
	if wcsutils.is_plain(wcs):
		return np.full((1, 1) if broadcastable else tuple(shape[-2:]),
			np.abs(wcs.wcs.cdelt[0]*wcs.wcs.cdelt[1]))
	if separable:
		col = pixsizemap_cyl(shape, wcs)
		return col if broadcastable else np.broadcast_to(col, tuple(shape[-2:])).copy()
	pix = np.mgrid[:shape[-2], :shape[-1]].astype(float)
	p = {d: np.asarray(pix2sky(shape, wcs, pix + np.array(d)[:, None, None], safe=False))
		for d in [(-0.5, -0.5), (0.5, -0.5), (-0.5, 0.5), (0.5, 0.5)]}
	dy = 0.5*((p[0.5, -0.5] + p[0.5, 0.5]) - (p[-0.5, -0.5] + p[-0.5, 0.5]))
	dx = 0.5*((p[-0.5, 0.5] + p[0.5, 0.5]) - (p[-0.5, -0.5] + p[0.5, -0.5]))
	# the longitude branch cut can run through the map: rewind the ra steps
	dy[1] = utils.rewind(dy[1])
	dx[1] = utils.rewind(dx[1])
	cosdec = np.cos(p[-0.5, -0.5][0] + 0.5*(dy[0] + dx[0]))
	return np.abs(dy[0]*dx[1] - dy[1]*dx[0])*cosdec


def pixsizemap(shape, wcs, separable="auto", broadcastable=False, *, device="cuda"):
	"""The area of each pixel in steradians, as a float64 ndmap on device
	(pixell_tpu.enmap.pixsizemap :641); with broadcastable, [ny, 1] (plain:
	[1, 1]) where the geometry is separable."""
	return ndmap(torch.from_numpy(_pixsizemap_np(shape, wcs, separable, broadcastable)).to(device),
		wcs)


def pixsizemap_contour(shape, wcs, bsize=1000, bcheck=False, *, device="cuda"):
	"""Each pixel's area by the contour integral around its four edges (any
	geometry), as a float64 ndmap on device."""
	out = np.zeros(shape[-2:])
	for y1 in range(0, shape[-2], bsize):
		y2 = min(y1 + bsize, shape[-2])
		pixs = np.mgrid[y1:y2+1, :shape[-1]+1] - 0.5
		poss = np.asarray(pix2sky(shape, wcs, pixs.reshape(2, -1))).reshape(pixs.shape)
		ra, msin = poss[1], 1 - np.sin(np.clip(poss[0], -np.pi/2, np.pi/2))
		areas  = (ra[1:, :-1] - ra[:-1, :-1])*(msin[1:, :-1] + msin[:-1, :-1])/2
		areas += (ra[1:, 1:] - ra[1:, :-1])*(msin[1:, 1:] + msin[1:, :-1])/2
		areas += (ra[:-1, 1:] - ra[1:, 1:])*(msin[:-1, 1:] + msin[1:, 1:])/2
		areas += (ra[:-1, :-1] - ra[:-1, 1:])*(msin[:-1, :-1] + msin[:-1, 1:])/2
		out[y1:y2] = np.abs(areas)
	return ndmap(torch.from_numpy(out).to(device), wcs)


def _pixshapemap_np(shape, wcs, separable="auto", signed=False):
	if separable == "auto": separable = wcsutils.is_separable(wcs)
	if separable:
		hw = pixshapes_cyl(shape, wcs, signed=signed)
		return np.broadcast_to(hw[:, :, None], (2,) + tuple(shape[-2:])).copy()
	pix = np.mgrid[:shape[-2], :shape[-1]].astype(float)
	p = {d: np.asarray(pix2sky(shape, wcs, pix + np.array(d)[:, None, None], safe=False))
		for d in [(-0.5, 0), (0.5, 0), (0, -0.5), (0, 0.5)]}
	h = utils.angdist(p[-0.5, 0][::-1], p[0.5, 0][::-1], axis=0)
	w = utils.angdist(p[0, -0.5][::-1], p[0, 0.5][::-1], axis=0)
	return np.array([h, w])


def pixshapemap(shape, wcs, bsize=1000, separable="auto", signed=False, *, device="cuda"):
	"""The [height, width] of each pixel in radians, as a float64 ndmap
	[2, ny, nx] on device."""
	return ndmap(torch.from_numpy(_pixshapemap_np(shape, wcs, separable, signed)).to(device), wcs)


def pixshapebounds(shape, wcs, separable="auto"):
	"""[[min height, min width], [max height, max width]] of the pixels."""
	ps = _pixshapemap_np(shape, wcs, separable)
	return np.array([[ps[0].min(), ps[1].min()], [ps[0].max(), ps[1].max()]])


# ---------------------------------------------------------------------------
# Geometries (pixell_tpu/enmap.py:791-814, :985-1069)
# ---------------------------------------------------------------------------
def slice_geometry(shape, wcs, sel, nowrap=False):
	"""The geometry of map[..., sel[0], sel[1]]: sel is a y slice or a tuple
	of (y, x) slices, with steps if wanted (pixell_tpu.enmap.slice_geometry
	:791). With nowrap the slices are taken as they stand, so starts and
	stops may lie outside the map."""
	wcs = wcs.deepcopy()
	pre, shape = shape[:-2], shape[-2:]
	if not isinstance(sel, tuple): sel = (sel,)
	oshape = list(shape)
	for i, s in enumerate(list(sel)[:2]):   # sel is (y, x); the wcs axes are (x, y)
		if s is None: raise ValueError("newaxis not supported in slice_geometry")
		if nowrap:
			step = s.step if s.step is not None else 1
			start = s.start if s.start is not None else (0 if step > 0 else shape[i] - 1)
			stop = s.stop if s.stop is not None else (shape[i] if step > 0 else -1)
		else:
			start, stop, step = s.indices(shape[i])
		oshape[i] = len(range(start, stop, step))
		# the new 0-based pixel p_new = (p_old - start)/step
		wcs.wcs.crpix[1 - i] = (wcs.wcs.crpix[1 - i] - 1 - start)/step + 1
		wcs.wcs.cdelt[1 - i] = wcs.wcs.cdelt[1 - i]*step
	return tuple(pre) + tuple(oshape), wcs


def geometry(pos, res=None, shape=None, proj="car", variant="cc", deg=False,
		pre=(), force=False, ref=None, **kwargs):
	"""The (shape, wcs) covering pos, a [{from,to},{dec,ra}] box or a
	{dec,ra} centre, at resolution res, in radians unless deg
	(pixell_tpu.enmap.geometry :985). Unless force, the wcs puts the
	reference point (0, 0) on a whole pixel."""
	scale = 1 if deg else 1/utils.degree
	pos = np.asarray(pos)*scale
	if res is not None: res = np.asarray(res)*scale
	try:
		ref = (ref[1]*scale, ref[0]*scale)
	except (TypeError, ValueError):
		pass
	if ref is None and not force: ref = "standard"
	wcs = wcsutils.build(pos, res, shape, rowmajor=True, system=proj, ref=ref, **kwargs)
	if shape is None:
		nearedge = np.array(wcsutils.world2pix(wcs, pos[0, 1], pos[0, 0]))[::-1]
		faredge = np.array(wcsutils.world2pix(wcs, pos[1, 1], pos[1, 0]))[::-1]
		shape = np.round(np.abs(faredge - nearedge)).astype(int)
	return tuple(pre) + tuple(int(n) for n in shape[-2:]), wcs


def fullsky_geometry(res=None, shape=None, dims=(), proj="car", variant="fejer1"):
	"""Full-sky CAR geometry with SHT-exact ring placement
	(pixell_tpu.enmap.fullsky_geometry). "cc" puts pixel centres on the
	poles; "fejer1" offsets them by half a pixel."""
	if proj != "car": raise NotImplementedError("only CAR fullsky geometry is ported")
	if   variant.lower() == "cc":     yo = 1
	elif variant.lower() == "fejer1": yo = 0
	else: raise ValueError("Unrecognized CAR variant '%s'" % str(variant))
	if shape is None:
		res = np.zeros(2) + res
		shape = utils.nint(np.array([1*np.pi, 2*np.pi])/res + np.array([yo, 0]))
	else:
		res = np.array([1*np.pi, 2*np.pi])/(np.array(shape[-2:]) - np.array([yo, 0]))
	ny, nx = shape[-2:]
	if abs(res[0]*(ny-yo) - np.pi) > 1e-8 or abs(res[1]*nx - 2*np.pi) > 1e-8:
		raise ValueError("SHT-exact ring placement needs a whole number of pixels "
			"spanning the sky; got res=%s" % str(res))
	wcs = wcsutils.WCS.from_fields(["RA---CAR", "DEC--CAR"],
		[res[1]/2/utils.degree, 0], [nx//2+0.5, (ny+1)/2], [-360./nx, 180./(ny-yo)])
	return tuple(dims) + (int(ny), int(nx)), wcs


def band_geometry(dec_cut, res=None, shape=None, dims=(), proj="car", variant="fejer1"):
	"""The rows of the full-sky geometry between two declinations (one
	value: +-dec_cut) (pixell_tpu.enmap.band_geometry :1052)."""
	dec_cut = np.atleast_1d(dec_cut)
	if dec_cut.size == 1: lo, hi = -dec_cut[0], dec_cut[0]
	elif dec_cut.size == 2: lo, hi = dec_cut
	else: raise ValueError("dec_cut must have one or two values")
	if not hi > lo: raise ValueError("empty declination band %s" % str(dec_cut))
	ishape, iwcs = fullsky_geometry(res=res, shape=shape, dims=dims, proj=proj, variant=variant)
	start = float(sky2pix(ishape, iwcs, np.array([lo, 0.]))[0])
	stop = float(sky2pix(ishape, iwcs, np.array([hi, 0.]))[0])
	start = max(int(np.round(start)), 0)
	stop = min(int(np.round(stop)), ishape[-2])
	return slice_geometry(ishape, iwcs, (slice(start, stop), slice(None)))


# ---------------------------------------------------------------------------
# Fourier-space coordinates (pixell_tpu/enmap.py:699-753, :2012-2025). The
# axes are host numpy; the maps are built on the device from them
# ---------------------------------------------------------------------------
def laxes(shape, wcs, oversample=1, method="auto", broadcastable=False):
	"""(ly[ny], lx[nx]): the multipole axes of the map's Fourier transform,
	as float64 numpy."""
	oversample = int(oversample)
	step = pixshape(shape, wcs, signed=True)
	ly = np.fft.fftfreq(shape[-2]*oversample, step[0]/(2*np.pi))
	lx = np.fft.fftfreq(shape[-1]*oversample, step[1]/(2*np.pi))
	if oversample > 1:
		ly, lx = np.roll(ly, ly.size//2, 0), np.roll(lx, lx.size//2, 0)
	return ly, lx


@functools.lru_cache(maxsize=32)
def _laxes_np(shape, wcs, oversample):
	"""laxes, computed once per (shape, wcs, oversample) (callers must not
	write into them)."""
	return laxes(shape, wcs, oversample)


@functools.lru_cache(maxsize=32)
def _laxes_on(shape, wcs, oversample, device):
	"""laxes as float64 tensors on device, copied there once per (shape,
	wcs, oversample, device) (callers must not write into them)."""
	return tuple(torch.from_numpy(a).to(device) for a in _laxes_np(shape, wcs, oversample))


def _device(device):
	"""device as a torch.device with its index (raises for CUDA where there
	is none)."""
	d = torch.device(device)
	if d.type == "cuda" and d.index is None: d = torch.device("cuda", torch.cuda.current_device())
	return d


def _axes_on(shape, wcs, device, oversample=1):
	return _laxes_on(tuple(int(n) for n in shape[-2:]), wcs, int(oversample), _device(device))


def _l2(ly, lx):
	"""ly^2 + lx^2 on the [ny, nx] grid, float64 (the reference's rounding)."""
	return (ly*ly)[:, None] + (lx*lx)[None, :]


def lmap(shape, wcs, oversample=1, *, device="cuda"):
	"""The 2d multipole [{ly,lx},ny,nx] of each Fourier pixel, float64 on device."""
	ly, lx = _axes_on(shape, wcs, device, oversample)
	return ndmap(torch.stack(torch.broadcast_tensors(ly[:, None], lx[None, :])), wcs)


def modlmap(shape, wcs, oversample=1, min=0, *, device="cuda"):
	"""|l| of each Fourier pixel, float64 on device."""
	ly, lx = _axes_on(shape, wcs, device, oversample)
	return ndmap(_l2(ly, lx).sqrt_().clamp_(min=min), wcs)


def lrmap(shape, wcs, oversample=1, *, device="cuda"):
	"""lmap on the real FFT's half plane [{ly,lx},ny,nx//2+1]."""
	ly, lx = _axes_on(shape, wcs, device, oversample)
	lx = lx[:shape[-1]//2+1]
	return ndmap(torch.stack(torch.broadcast_tensors(ly[:, None], lx[None, :])), wcs)


def modrmap(shape, wcs, ref="center", safe=True, corner=False, *, device="cuda"):
	"""The angular distance of each pixel from ref [dec, ra] (radians;
	"center": the geometry's centre), float64 on device."""
	pos = posmap(shape, wcs, safe=safe, corner=corner, device=device).data
	if isinstance(ref, str):
		if ref != "center": raise ValueError(ref)
		ref = center(shape, wcs)
	dec0, ra0 = (float(v) for v in np.asarray(ref, float))
	dec, dra = pos[0], pos[1] - ra0
	sd0, cd0 = np.sin(dec0), np.cos(dec0)
	y = torch.hypot(torch.cos(dec)*torch.sin(dra), cd0*torch.sin(dec) - sd0*torch.cos(dec)*torch.cos(dra))
	x = sd0*torch.sin(dec) + cd0*torch.cos(dec)*torch.cos(dra)
	return ndmap(torch.atan2(y, x), wcs)


def lform(map, method="auto"):
	"""The map's Fourier plane with l = 0 in the centre (fftshift)."""
	return fftshift(map)


def lwcs(shape, wcs, method="auto"):
	"""A plain WCS for l-space maps of the geometry."""
	lres = 2*np.pi/extent(shape, wcs, signed=True, method=method)
	ny, nx = shape[-2:]
	return wcsutils.explicit(crpix=[nx//2+1, ny//2+1], crval=[0, 0],
		cdelt=list(np.asarray(lres)[::-1]/utils.degree))

def lpixshape(shape, wcs, signed=False, method="auto"):
	"""The l-space pixel [height, width]."""
	return 2*np.pi/extent(shape, wcs, signed=signed, method=method)

def lpixsize(shape, wcs, signed=False, method="auto"):
	return float(np.prod(lpixshape(shape, wcs, signed=signed, method=method)))


# ---------------------------------------------------------------------------
# Radial binning on the device (pixell_tpu/enmap.py:755-789)
# ---------------------------------------------------------------------------
def _scalar(x, device):
	"""x as a 0-d float64 tensor on device: CUDA divides a tensor by a Python
	number as a product with its reciprocal, which can move a value across
	a bin edge, but by a device tensor exactly, as numpy does."""
	return torch.tensor(x, dtype=torch.float64).to(device)


def _radial_bin(arr, pix, nbin, bsize, return_nhit=False):
	"""arr [..., ny, nx] binned by the flat bin index pix [ny*nx] (int64 on
	arr's device) into nbin bins: the mean of each bin, summed in float64 as
	numpy's bincount does, then cast to arr's dtype. Returns (vals
	[..., nbin], bin centres [nbin]) (and the hit counts) as tensors."""
	pre = arr.shape[:-2]
	flat = arr.reshape(pre + (-1,))
	nhit = torch.bincount(pix, minlength=nbin)
	acc = torch.float64 if not arr.is_complex() else torch.complex128
	vals = torch.zeros(pre + (nbin,), dtype=acc, device=arr.device)
	for I in utils.nditer(pre):
		w = flat[I]
		s = torch.zeros(nbin, dtype=torch.float64, device=arr.device)
		s.index_add_(0, pix, w.real.to(torch.float64) if w.is_complex() else w.to(torch.float64))
		if w.is_complex():
			si = torch.zeros(nbin, dtype=torch.float64, device=arr.device)
			s = torch.complex(s, si.index_add_(0, pix, w.imag.to(torch.float64)))
		vals[I] = s
	vals = (vals/nhit.clamp(min=1)).to(arr.dtype)
	cents = (torch.arange(nbin, dtype=torch.float64, device=arr.device) + 0.5)*bsize
	return (vals, cents, nhit) if return_nhit else (vals, cents)


def lbin(map, bsize=None, brel=1.0, return_nhit=False, lop=None):
	"""The map [..., ny, nx] of a Fourier plane binned in rings of |l| of
	width bsize*brel (bsize defaults to the smaller l step): (vals
	[..., nbin], bin centres[, hit counts]), tensors on the map's device.
	The bin index is computed there from the l axes."""
	shape = map.shape
	ly, lx = _axes_on(shape, map.wcs, map.device)
	if bsize is None:
		hy, hx = _laxes_np(tuple(shape[-2:]), map.wcs, 1)
		bsize = min(abs(hx[1]) if shape[-1] > 1 else 1, abs(hy[1]) if shape[-2] > 1 else 1)
	bsize = bsize*brel
	pix = _l2(ly, lx).sqrt_().div_(_scalar(bsize, ly.device)).long().reshape(-1)
	return _radial_bin(map.data, pix, int(pix.max()) + 1, bsize, return_nhit)


def rbin(map, center=[0, 0], bsize=None, brel=1.0, return_nhit=False):
	"""The map binned in rings of angular distance from center [dec, ra]
	(bsize defaults to the smaller pixel side): as lbin."""
	r = modrmap(map.shape, map.wcs, ref=center, device=map.device).data
	if bsize is None: bsize = float(np.min(pixshape(map.shape, map.wcs)))
	bsize = bsize*brel
	pix = (r/_scalar(bsize, r.device)).long().reshape(-1)
	return _radial_bin(map.data, pix, int(pix.max()) + 1, bsize, return_nhit)


def radial_average(map, center=[0, 0], step=1.0):
	"""rbin around center."""
	return rbin(map, center=center)


# ---------------------------------------------------------------------------
# Shifts (pixell_tpu/enmap.py:1268-1291)
# ---------------------------------------------------------------------------
def shift(map, off, keepwcs=False):
	"""The map cyclically shifted by whole pixels off=[oy, ox]; the wcs
	moves with it unless keepwcs."""
	off = np.atleast_1d(np.asarray(off, int))
	d = map.data if isinstance(map, ndmap) else map
	d = torch.roll(d, tuple(int(o) for o in off), tuple(range(-len(off), 0)))
	if keepwcs or len(off) < 2 or not isinstance(map, ndmap): return samewcs(d, map)
	wcs = map.wcs.deepcopy()
	wcs.wcs.crpix = wcs.wcs.crpix + np.array([off[-1], off[-2]])
	return ndmap(d, wcs)


def fractional_shift(map, off, keepwcs=False, nofft=False):
	"""The map shifted by fractional pixels off=[oy, ox] by a Fourier phase."""
	d = enfft.shift(map.data if isinstance(map, ndmap) else map, off, axes=(-2, -1), nofft=nofft)
	if keepwcs or not isinstance(map, ndmap): return samewcs(d, map)
	off = np.zeros(2) + np.asarray(off)
	wcs = map.wcs.deepcopy()
	wcs.wcs.crpix = wcs.wcs.crpix + np.array([off[1], off[0]])
	return ndmap(d, wcs)


# ---------------------------------------------------------------------------
# FFTs and the flat-sky harmonic transforms (pixell_tpu/enmap.py:1297-1410)
# ---------------------------------------------------------------------------
def _is_phys(normalize):
	return isinstance(normalize, str) and normalize in ["phy", "phys", "physical"]


def _norm(emap, dct, normalize, pix_up):
	"""The scalar the transforms multiply by: 1/sqrt(N) if normalize (N the
	pixels, or the DCTs' logical size), times sqrt(pixsize) ("phys", pix_up)
	or over it ("phys", not pix_up)."""
	norm = 1.0
	if normalize:
		n = np.array(emap.shape[-2:])
		norm /= float(np.prod(n*2-2 if dct else n))**0.5
	if _is_phys(normalize):
		ps = pixsize(emap.shape, emap.wcs)**0.5
		norm = norm*ps if pix_up else norm/ps
	return norm


def fft(emap, omap=None, nthread=0, normalize=True, adjoint_ifft=False, dct=False):
	"""The 2D FFT (or DCT-I) of the map's pixel axes (pixell_tpu.enmap.fft
	:1297): normalize True divides by sqrt(npix), "phys" also multiplies by
	sqrt(pixsize) (adjoint_ifft: divides), False leaves it unnormalized. A
	float32 map gives complex64."""
	arr = emap.data if isinstance(emap, ndmap) else emap
	res = enfft.dct(arr, axes=(-2, -1)) if dct else enfft.fft(arr, axes=(-2, -1))
	norm = _norm(emap, dct, normalize, not adjoint_ifft)
	if norm != 1: res.mul_(norm)
	if omap is not None: res = (omap.data if isinstance(omap, ndmap) else omap).copy_(res)
	return samewcs(res, emap)


def ifft(emap, omap=None, nthread=0, normalize=True, adjoint_fft=False, dct=False):
	"""The inverse of fft with the same normalize (pixell_tpu.enmap.ifft
	:1315); adjoint_fft gives fft's adjoint instead. Complex output."""
	arr = emap.data if isinstance(emap, ndmap) else emap
	res = enfft.idct(arr, axes=(-2, -1)) if dct else enfft.ifft(arr, axes=(-2, -1))
	norm = _norm(emap, dct, normalize, adjoint_fft)
	if norm != 1: res.mul_(norm)
	if omap is not None: res = (omap.data if isinstance(omap, ndmap) else omap).copy_(res)
	return samewcs(res, emap)


def dct(emap, omap=None, nthread=0, normalize=True):
	return fft(emap, omap=omap, nthread=nthread, normalize=normalize, dct=True)

def idct(emap, omap=None, nthread=0, normalize=True):
	return ifft(emap, omap=omap, nthread=nthread, normalize=normalize, dct=True)

def fft_adjoint(emap, omap=None, nthread=0, normalize=True):
	return ifft(emap, omap=omap, nthread=nthread, normalize=normalize, adjoint_fft=True)

def ifft_adjoint(emap, omap=None, nthread=0, normalize=True):
	return fft(emap, omap=omap, nthread=nthread, normalize=normalize, adjoint_ifft=True)

def dct_adjoint(emap, omap=None, nthread=0, normalize=True):
	return idct(emap, omap=omap, normalize=normalize)

def idct_adjoint(emap, omap=None, nthread=0, normalize=True):
	return dct(emap, omap=omap, normalize=normalize)


def _rotation(shape, wcs, spin, iau, inverse, device, dtype):
	"""(cos, sin) [ny, nx] of the QU <-> EB rotation angle spin*atan2(+-lx,
	ly) in dtype, built on the device from the cached l axes (float64)."""
	ly, lx = _axes_on(shape, wcs, device)
	a = torch.atan2((-1 if iau else 1)*lx[None, :], ly[:, None]).mul_(spin)
	c, s = torch.cos(a).to(dtype), torch.sin(a).to(dtype)
	return c, (-s if inverse else s)


def _rotate_spins(data, wcs, spin, iau, inverse):
	"""Rotate data [..., ncomp, ny, nx] in place: each spin != 0 pair of
	components by [[c, -s], [s, c]] (pixell_tpu.enmap.map2harm :1342)."""
	s0 = None
	for s, d1, d2 in spin_helper(spin, data.shape[-3]):
		if s == 0: continue
		if s != s0:
			s0 = s
			c, sn = _rotation(data.shape, wcs, s, iau, inverse, data.device, utils.real_dtype(data.dtype))
		q, u = data[..., d1, :, :], data[..., d1+1, :, :]
		q2, u2 = c*q - sn*u, sn*q + c*u
		q.copy_(q2)
		u.copy_(u2)


def map2harm(emap, nthread=0, normalize=True, iau=False, spin=[0, 2], adjoint_harm2map=False):
	"""Flat-sky map -> harmonic coefficients: fft, then each spin pair of
	components rotated from QU to EB (pixell_tpu.enmap.map2harm :1342)."""
	f = samewcs(fft(emap, normalize=normalize, adjoint_ifft=adjoint_harm2map), emap)
	if f.ndim > 2: _rotate_spins(f.data, f.wcs, spin, iau, inverse=False)
	return f


def harm2map(emap, nthread=0, normalize=True, iau=False, spin=[0, 2], keep_imag=False,
		adjoint_map2harm=False):
	"""The inverse of map2harm: EB -> QU on a copy, then ifft; the real part
	unless keep_imag (pixell_tpu.enmap.harm2map :1354)."""
	if emap.ndim > 2:
		emap = ndmap(emap.data.clone(), emap.wcs)
		_rotate_spins(emap.data, emap.wcs, spin, iau, inverse=True)
	res = samewcs(ifft(emap, normalize=normalize, adjoint_fft=adjoint_map2harm), emap)
	return res if keep_imag else res.real


def map2harm_adjoint(emap, nthread=0, normalize=True, iau=False, spin=[0, 2], keep_imag=False):
	return harm2map(emap, nthread=nthread, normalize=normalize, iau=iau, spin=spin,
		keep_imag=keep_imag, adjoint_map2harm=True)

def harm2map_adjoint(emap, nthread=0, normalize=True, iau=False, spin=[0, 2]):
	return map2harm(emap, nthread=nthread, normalize=normalize, iau=iau, spin=spin,
		adjoint_harm2map=True)


def queb_rotmat(lmap, inverse=False, iau=False, spin=2, *, device="cuda"):
	"""The QU <-> EB rotation matrices [2, 2, ny, nx] of the multipoles
	lmap [{ly, lx}, ny, nx] (float64 on lmap's device; host data goes to
	device)."""
	l = _tensor(lmap, device).to(torch.float64)
	a = spin*torch.atan2((-1 if iau else 1)*l[1], l[0])
	c, s = torch.cos(a), torch.sin(a)
	if inverse: s = -s
	return samewcs(torch.stack([torch.stack([c, -s]), torch.stack([s, c])]), lmap)


def rotate_pol(emap, angle, comps=[-2, -1], spin=2, axis=-3):
	"""The polarization components comps of emap (along axis) rotated by
	angle (a number or a map)."""
	arr = emap.data if isinstance(emap, ndmap) else emap
	if isinstance(angle, (ndmap, torch.Tensor)):
		a = _tensor(angle, arr.device)*spin
		c, s = torch.cos(a), torch.sin(a)
	else:
		c, s = np.cos(spin*np.asarray(angle)), np.sin(spin*np.asarray(angle))
		if np.ndim(c): c, s = (torch.as_tensor(v, device=arr.device) for v in (c, s))
		else: c, s = float(c), float(s)
	arr = arr.movedim(axis, 0)
	q, u = arr[comps[0]], arr[comps[1]]
	res = arr.clone()
	res[comps[0] % arr.shape[0]] = c*q - s*u
	res[comps[1] % arr.shape[0]] = s*q + c*u
	return samewcs(res.movedim(0, axis), emap)


def map_mul(mat, vec):
	"""mat [..., a, b, ny, nx] times vec [..., b, ny, nx], pixel by pixel."""
	m = mat.data if isinstance(mat, ndmap) else mat
	v = vec.data if isinstance(vec, ndmap) else vec
	return samewcs(torch.einsum("...abyx,...byx->...ayx", m, v), vec, mat)


def calc_ps2d(harm, harm2=None):
	"""The 2d (cross-)power spectrum Re(harm conj(harm2)) of harmonic maps."""
	h1 = harm.data if isinstance(harm, ndmap) else harm
	if harm2 is None: ps = h1.real.square() + h1.imag.square() if h1.is_complex() else h1.square()
	else: ps = (h1*torch.conj(harm2.data if isinstance(harm2, ndmap) else harm2)).real
	return samewcs(ps, harm)


def smooth_spectrum(ps, kernel="gauss", weight="mode", width=1.0):
	"""A 1d spectrum smoothed by a kernel with mode weighting (host numpy,
	pixell_tpu.enmap.smooth_spectrum :2059)."""
	ps = np.asanyarray(ps)
	pflat = ps.reshape(-1, ps.shape[-1])
	nspec, nl = pflat.shape
	l = np.arange(nl)
	if isinstance(kernel, str):
		if kernel == "gauss": K = np.exp(-0.5*(l/width)**2)
		elif kernel == "step": K = (l < int(width)).astype(float)
		else: raise ValueError("Unknown kernel type %s" % kernel)
		K = np.broadcast_to(K, (nspec, nl)).copy()
	else:
		K = np.zeros((nspec, nl))
		tmp = np.atleast_2d(kernel)
		K[:, :tmp.shape[-1]] = tmp[:, :nl]
	if isinstance(weight, str):
		if weight == "mode": W = np.broadcast_to((l**2).astype(float), (nspec, nl)).copy()
		elif weight == "uniform": W = np.ones((nspec, nl))
		else: raise ValueError("Unknown weighting scheme %s" % weight)
	else:
		W = np.broadcast_to(np.atleast_2d(weight), (nspec, nl)).copy()
	def sym_conv(arr, ker):   # symmetric convolution, reflected at l = 0
		ext = np.concatenate([arr[:, ::-1], arr, arr[:, ::-1]], -1)
		out = np.empty_like(arr)
		for i in range(nspec):
			out[i] = np.convolve(ext[i], ker[i]/max(ker[i].sum(), 1e-300), mode="same")[nl:2*nl]
		return out
	smoothed = sym_conv(pflat*W, K)/np.maximum(sym_conv(W, K), 1e-300)
	return smoothed.reshape(ps.shape)


def smooth_gauss(emap, sigma):
	"""The map smoothed by a Gaussian of standard deviation sigma (radians),
	in Fourier space; the filter is built on the device from the l axes."""
	if np.all(np.asarray(sigma) == 0): return emap.copy()
	f = map2harm(emap, spin=[0])
	ly, lx = _axes_on(emap.shape, emap.wcs, emap.device)
	f.data.mul_(_l2(ly, lx).mul_(-0.5*sigma**2).exp_().to(utils.real_dtype(f.dtype)))
	res = harm2map(f, spin=[0])
	return res if emap.dtype.is_complex else res.astype(emap.dtype)


def calc_window(shape, order=0, scale=1):
	"""The pixel window's Fourier response (wy[ny], wx[nx]), host numpy."""
	wy = np.sinc(np.fft.fftfreq(shape[-2])*scale)**(order+1)
	wx = np.sinc(np.fft.fftfreq(shape[-1])*scale)**(order+1)
	return wy, wx


def apply_window(emap, pow=1.0, order=0, scale=1, nofft=False):
	"""The map multiplied by the pixel window to the power pow, in Fourier space."""
	wy, wx = calc_window(emap.shape, order=order, scale=scale)
	f = fft(emap, normalize=False)
	rdt = utils.real_dtype(f.dtype)
	wy, wx = (torch.from_numpy(w**pow).to(emap.device, rdt) for w in (wy, wx))
	f.data.mul_(wy[:, None]).mul_(wx[None, :])
	res = ifft(f, normalize=False).real/float(np.prod(emap.shape[-2:]))
	return samewcs(res, emap)


def unapply_window(emap, pow=1.0, order=0, scale=1, nofft=False):
	return apply_window(emap, pow=-pow, order=order, scale=scale, nofft=nofft)


def _fourier_deriv(m):
	"""(fft of m, ly, lx) with the axes in the fft's real dtype."""
	f = fft(m).data
	ly, lx = (a.to(utils.real_dtype(f.dtype)) for a in _axes_on(m.shape, m.wcs, m.device))
	return f, ly, lx


def grad(m):
	"""The gradient [{dy, dx}, ...] of the map by FFT."""
	f, ly, lx = _fourier_deriv(m)
	g = torch.stack([f*ly[:, None], f*lx[None, :]])*1j
	return samewcs(ifft(samewcs(g, m)).data.real, m)


def grad_pix(m):
	"""grad in pixel units."""
	scale = np.array(m.shape[-2:])/np.asarray(extent(m.shape, m.wcs, signed=True))
	g = grad(m)
	return samewcs(g.data*torch.as_tensor(scale, device=m.device,
		dtype=g.dtype).reshape((2,) + (1,)*m.ndim), m)


def div(m):
	"""The divergence of m [{y, x}, ...] by FFT."""
	f, ly, lx = _fourier_deriv(m)
	d = (f[0]*ly[:, None] + f[1]*lx[None, :])*1j
	return samewcs(ifft(samewcs(d, m)).data.real, m)


def laplace(m):
	"""The Laplacian of the map by FFT."""
	f = fft(m).data
	ly, lx = _axes_on(m.shape, m.wcs, m.device)
	f.mul_(_l2(ly, lx).to(utils.real_dtype(f.dtype)))
	return samewcs(-ifft(samewcs(f, m)).data.real, m)


def fftshift(map, inplace=False):
	return samewcs(torch.fft.fftshift(map.data if isinstance(map, ndmap) else map, dim=(-2, -1)), map)

def ifftshift(map, inplace=False):
	return samewcs(torch.fft.ifftshift(map.data if isinstance(map, ndmap) else map, dim=(-2, -1)), map)


def spin_helper(spin, n):
	"""(spin, d1, d2) for consecutive component ranges of n components: a
	spin 0 takes one, any other two; the last spin repeats (a lone last
	component is spin 0)."""
	spins = np.atleast_1d(np.asarray(spin, int))
	i = si = 0
	while i < n:
		s = int(spins[min(si, len(spins)-1)])
		step = 1 if s == 0 else 2
		if i + step > n: step, s = n - i, 0
		yield s, i, i+step
		i += step; si += 1


def spin_pre_helper(spin, pre):
	"""spin_helper over the last of the leading dimensions pre: (spin, index
	tuple) pairs."""
	pre = tuple(pre)
	for I in utils.nditer(pre[:-1]) if len(pre) > 1 else [()]:
		n = pre[-1] if len(pre) > 0 else 1
		for s, d1, d2 in spin_helper(spin, n):
			yield s, I + (slice(d1, d2),)


# ---------------------------------------------------------------------------
# Flat random fields (pixell_tpu/enmap.py:1443-1516)
# ---------------------------------------------------------------------------
def spec2flat(shape, wcs, cov, exp=1.0, mode="constant", border="constant", oversample=1,
		smooth="auto", *, device="cuda"):
	"""The spectrum cov [{ncomp, ncomp}, nl] (or [nl]) on the 2d Fourier
	plane: each pixel takes the entry at int(|l|), zero past the spectrum's
	end with mode "constant", else the last entry; with exp, each matrix to
	that power first. border and smooth are accepted and ignored, as in
	pixell_tpu.enmap.spec2flat. Built on device from the l axes (float64)."""
	cov = np.asarray(cov)
	oned = cov.ndim == 1
	if oned: cov = cov[None, None]
	if exp != 1.0: cov = multi_pow(cov, exp)
	ly, lx = _axes_on(shape, wcs, device, oversample)
	l = _l2(ly, lx).sqrt_()
	nl = cov.shape[-1]
	res = torch.from_numpy(np.ascontiguousarray(cov)).to(device)[..., l.long().clamp_(max=nl-1)]
	if mode == "constant": res = res*(l <= nl-1)
	res = ndmap(res, wcs)
	return res[0, 0] if oned else res


def multi_pow(mat, exp, axes=[0, 1]):
	"""Each positive-semidefinite matrix mat[:, :, ...] to the power exp (host numpy)."""
	return utils.eigpow(np.asarray(mat), exp, axes=axes)


def rand_gauss(shape, wcs, dtype=None, seed=None, *, device="cuda"):
	"""White Gaussian noise, drawn on the host by default_rng(seed)."""
	d = np.random.default_rng(seed).standard_normal(shape)
	return ndmap(torch.from_numpy(d).to(device, _torch_dtype(dtype) or torch.float64), wcs)


def rand_gauss_harm(shape, wcs, seed=None, *, device="cuda"):
	"""Complex white Gaussian noise (unit variance in each part)."""
	rng = np.random.default_rng(seed)
	d = rng.standard_normal(shape) + 1j*rng.standard_normal(shape)
	return ndmap(torch.from_numpy(d).to(device), wcs)


def rand_gauss_iso_harm(shape, wcs, cov, pixel_units=False, seed=None, *, device="cuda"):
	"""A Gaussian random field's Fourier coefficients with spectrum cov:
	the matrix square root of spec2flat times white noise, scaled so that
	map2harm(normalize="phys") gives cov back unless pixel_units."""
	chol = spec2flat(shape, wcs, np.asarray(cov), exp=0.5, mode="constant", device=device).data
	if not pixel_units: chol = chol/pixsize(shape, wcs)**0.5
	noise = rand_gauss_harm(shape, wcs, seed=seed, device=device).data
	if chol.ndim > 2:
		d = torch.einsum("ab...,b...->a...", chol.to(noise.dtype),
			noise.reshape((-1,) + noise.shape[-2:]) if noise.ndim > 2 else noise[None])
		if noise.ndim == 2: d = d[0]
	else:
		d = chol*noise
	return ndmap(d, wcs)


def rand_map(shape, wcs, cov, scalar=False, seed=None, pixel_units=False, iau=False, spin=[0, 2], *,
		device="cuda"):
	"""A Gaussian random field with spectrum cov, in real space
	(pixell_tpu.enmap.rand_map :1496)."""
	harm = rand_gauss_iso_harm(shape, wcs, cov, pixel_units=pixel_units, seed=seed, device=device)
	if scalar or harm.ndim == 2: return ifft(harm).real
	return harm2map(harm, iau=iau, spin=spin)


def massage_spectrum(cov, shape):
	"""cov [n, n, nl] cut or zero-padded to the map's component count."""
	cov = np.asarray(cov)
	if cov.ndim == 1: cov = cov[None, None]
	ncomp = shape[-3] if len(shape) > 2 else 1
	if cov.shape[0] != ncomp:
		ocov = np.zeros((ncomp, ncomp) + cov.shape[2:])
		n = min(ncomp, cov.shape[0])
		ocov[:n, :n] = cov[:n, :n]
		cov = ocov
	return cov


# ---------------------------------------------------------------------------
# Pixel boxes (pixell_tpu/enmap.py:505-520, :816-866, :949-966); host numpy
# ---------------------------------------------------------------------------
def skybox2pixbox(shape, wcs, skybox, npoint=10, corner=False, include_direction=False):
	"""The sky box [{from, to}, {dec, ra}] as a pixel box [{from, to}, {y, x}]
	(with include_direction a third row, the sign of each axis's step),
	from npoint points along its diagonal (pixell_tpu.enmap.skybox2pixbox)."""
	coords = np.array([np.linspace(skybox[0][0], skybox[1][0], num=npoint, endpoint=True),
		np.linspace(skybox[0][1], skybox[1][1], num=npoint, endpoint=True)])
	pix = sky2pix(shape, wcs, coords, corner=corner, safe=2)
	res = np.asarray(pix)[:, [0, -1]].T
	if include_direction: res = np.concatenate([res, np.sign(pix[:, 1] - pix[:, 0])[None]], 0)
	return res


def pixbox2skybox(shape, wcs, pixbox):
	"""The pixel box [{from, to}, {y, x}] as a sky box [{from, to}, {dec, ra}]."""
	return np.asarray(pix2sky(shape, wcs, np.asanyarray(pixbox).T)).T


def subinds(shape, wcs, box, mode=None, cap=True, noflip=False, epsilon=1e-4):
	"""The integer pixel box [{from, to}, {y, x}] of the sky box
	[{from, to}, {dec, ra}], rounded by mode ("floor" by default, "round",
	"ceil", "inclusive", "exclusive"); counting upwards unless noflip
	(pixell_tpu.enmap.subinds)."""
	if mode is None: mode = "floor"
	bpix = skybox2pixbox(shape, wcs, np.asarray(box), include_direction=True)[:2]
	if   mode == "floor": bpix = np.floor(bpix + 0.5 + epsilon).astype(int)
	elif mode == "round": bpix = np.round(bpix).astype(int)
	elif mode == "ceil":  bpix = np.ceil(bpix - 0.5 - epsilon).astype(int)
	elif mode == "inclusive":
		bpix = np.array([np.floor(bpix.min(0) + 0.5 + epsilon), np.ceil(bpix.max(0) + 0.5 - epsilon)]).astype(int)
	elif mode == "exclusive":
		bpix = np.array([np.ceil(bpix.min(0) + 0.5 - epsilon), np.floor(bpix.max(0) + 0.5 + epsilon)]).astype(int)
	else: raise ValueError("Unrecognized mode '%s'" % mode)
	if not noflip:
		for i in range(2):
			if bpix[1, i] < bpix[0, i]: bpix[:, i] = bpix[::-1, i]
	return bpix


def sel2pixbox(shape, sel):
	"""The pixel box [{from, to}, {y, x}] of the slices sel of the pixel axes."""
	pixbox = np.zeros((2, 2), int)
	for i, s in enumerate(sel):
		s = slice(*s.indices(shape[-2+i]))
		pixbox[:, i] = [s.start, s.stop]
	return pixbox


def pixbox_of(iwcs, oshape, owcs):
	"""The integer pixel box, in the pixels of iwcs, of the geometry (oshape,
	owcs), counting upwards (pixell_tpu.enmap.pixbox_of)."""
	pix = np.asarray(sky2pix(oshape, iwcs, np.asarray(corners(oshape, owcs, corner=False)).T, safe=2))
	pixbox = np.array([np.round(pix[:, 0]), np.round(pix[:, -1])+1]).astype(int)
	for i in range(2):
		if pixbox[1, i] < pixbox[0, i]: pixbox[:, i] = [pixbox[1, i]+1, pixbox[0, i]+1]
	return pixbox


def overlap(shape, wcs, shape2_or_pixbox, wcs2=None, wrap="auto"):
	"""The number of pixels [ny, nx] the geometry shares with a pixel box
	(or with the geometry (shape2, wcs2))."""
	pixbox = pixbox_of(wcs, shape2_or_pixbox, wcs2) if wcs2 is not None else np.asarray(shape2_or_pixbox)
	b = np.array([np.maximum([0, 0], pixbox[0]), np.minimum(list(shape[-2:]), pixbox[1])])
	return np.maximum(b[1]-b[0], 0)


def neighborhood_pixboxes(shape, wcs, poss, r):
	"""The pixel boxes [..., {from, to}, {y, x}] of the squares of radius r
	around the positions poss [..., {dec, ra}]."""
	poss = np.asarray(poss)
	res = [subinds(shape, wcs, np.array([p - r, p + r]), mode="inclusive", noflip=True)
		for p in poss.reshape(-1, 2)]
	return np.array(res).reshape(poss.shape[:-1] + (2, 2))


# ---------------------------------------------------------------------------
# The extract family (pixell_tpu/enmap.py:845-984, :1749-1790, :2131-2149):
# host slice boxes, tensor copies on the map's device
# ---------------------------------------------------------------------------
def submap(map, box, mode=None, wrap="auto", recenter=False, iwcs=None):
	"""The part of the map inside the sky box [{from, to}, {dec, ra}],
	wrapped in RA, zero outside the map (pixell_tpu.enmap.submap; recenter
	is accepted and ignored, as there)."""
	pixbox = subinds(map.shape, map.wcs if iwcs is None else iwcs, box, mode=mode, noflip=True)
	return extract_pixbox(map, pixbox, wrap=wrap)


def extract(map, shape, wcs, omap=None, wrap="auto", op=None, cval=0, iwcs=None, reverse=False):
	"""The part of map on the geometry (shape, wcs), which must be of map's
	pixelization; with reverse, omap written into map in place instead
	(pixell_tpu.enmap.extract)."""
	if iwcs is None: iwcs = map.wcs
	res = extract_pixbox(map, pixbox_of(iwcs, shape, wcs), omap=omap, wrap=wrap, op=op, cval=cval,
		iwcs=iwcs, reverse=reverse)
	return res if reverse else ndmap(res.data, wcs)


def _wrap_segments(shape, wcs, pixbox, wrap):
	"""(input slices, output slices) of each piece of the pixel box: the
	sky wraps in RA after nint(360/|cdelt_x|) pixels (not on plain
	geometries), and whatever lies outside the map is no piece."""
	nphi = 0 if wcsutils.is_plain(wcs) else utils.nint(abs(360./wcs.wcs.cdelt[0]))
	wrap = np.array([0, nphi]) if isinstance(wrap, str) and wrap == "auto" else np.zeros(2, int) + np.asarray(wrap)
	sbox = np.stack([pixbox[0], pixbox[1], np.ones(2, int)], -1)
	def sl(b): return (Ellipsis,) + tuple(slice(*(None if v is None else int(v) for v in s)) for s in b)
	return [(sl(ib), sl(ob)) for ib, ob in utils.sbox_wrap(sbox, wrap=wrap, cap=np.array(shape[-2:]))]


def extract_pixbox(map, pixbox, omap=None, wrap="auto", op=None, cval=0, iwcs=None, reverse=False):
	"""The pixels of map in the box [{from, to}, {y, x}], which may reach
	outside it: wrapped in RA, cval beyond the map. omap, where given, is
	written in place (through op(omap's pixels, map's) where op is given).
	With reverse the copy goes the other way: omap's pixels written into
	map in place (through op(map's pixels, omap's)), and map returned
	(pixell_tpu.enmap.extract_pixbox). A map on disk (a proxy of read_map)
	reads only the pieces of the box it holds."""
	if isinstance(map, _MapProxy) and omap is None and op is None and iwcs is None and not reverse:
		return map.extract_pixbox(pixbox, wrap=wrap, cval=cval)
	if iwcs is None: iwcs = map.wcs
	pixbox = np.asarray(pixbox)
	if pixbox.shape[-1] > 2: pixbox = pixbox[..., -2:]
	oshape = tuple(map.shape[:-2]) + tuple(int(n) for n in pixbox[1] - pixbox[0])
	_, owcs = slice_geometry(map.shape[-2:], iwcs,
		(slice(pixbox[0, 0], pixbox[1, 0]), slice(pixbox[0, 1], pixbox[1, 1])), nowrap=True)
	if omap is None and not reverse:
		omap = ndmap(torch.full(oshape, cval, dtype=map.dtype, device=map.device), owcs)
	mdata = map.data if isinstance(map, ndmap) else map
	odata = omap.data if isinstance(omap, ndmap) else omap
	for isel, osel in _wrap_segments(map.shape, iwcs, pixbox, wrap):
		if reverse:
			src = odata[osel]
			mdata[isel] = src if op is None else op(mdata[isel], src)
		else:
			chunk = mdata[isel]
			odata[osel] = chunk if op is None else op(odata[osel], chunk)
	return map if reverse else ndmap(odata, owcs)


def insert(omap, imap, wrap="auto", op=None, cval=0, iwcs=None):
	"""imap written into omap in place where their geometries overlap, by
	their wcs; omap returned (pixell_tpu.enmap.insert)."""
	extract(omap, imap.shape, imap.wcs, omap=imap, wrap=wrap, op=op, cval=cval, reverse=True)
	return omap


def insert_at(omap, pix, imap, wrap="auto", op=None, cval=0, iwcs=None):
	"""imap written into omap in place with its first pixel at pix [y, x]
	(or into the pixel box pix); omap returned (pixell_tpu.enmap.insert_at)."""
	pix = np.asarray(pix)
	pixbox = np.array([pix, pix + np.array(imap.shape[-2:])]) if pix.ndim == 1 else pix
	extract_pixbox(omap, pixbox, omap=imap, wrap=wrap, op=op, cval=cval, reverse=True)
	return omap


def stamps(map, pos, shape, aslist=False):
	"""Stamps of shape pixels centred on the pixel nearest each position
	pos [n, {dec, ra}]: a stacked ndmap (a list with aslist)."""
	shape = np.zeros(2, int) + shape
	res = []
	for p in np.asarray(pos).reshape(-1, 2):
		cpix = np.round(np.asarray(sky2pix(map.shape, map.wcs, p))).astype(int)
		res.append(extract_pixbox(map, np.array([cpix - shape//2, cpix - shape//2 + shape])))
	if aslist: return res
	return ndmap(torch.stack([r.data for r in res]), res[0].wcs)


def padslice(map, box, default=np.nan):
	"""The pixel box [{from, to}, {y, x}] of the map, default outside it
	(no wrapping) (pixell_tpu.enmap.padslice)."""
	box = np.asarray(box, int)
	_, owcs = slice_geometry(map.shape, map.wcs, (slice(box[0, 0], box[1, 0]), slice(box[0, 1], box[1, 1])),
		nowrap=True)
	out = torch.full(tuple(map.shape[:-2]) + tuple(int(n) for n in box[1] - box[0]), default, dtype=map.dtype,
		device=map.device)
	i1 = np.maximum(box[0], 0)
	i2 = np.minimum(box[1], np.array(map.shape[-2:]))
	if np.all(i2 > i1):
		o1 = i1 - box[0]; o2 = o1 + (i2 - i1)
		out[..., o1[0]:o2[0], o1[1]:o2[1]] = map.data[..., i1[0]:i2[0], i1[1]:i2[1]]
	return ndmap(out, owcs)


def padcrop(m, info):
	"""pad(m, info.pad)[info.slice] (pixell_tpu.enmap.padcrop)."""
	return pad(m, info.pad)[info.slice]


class Padtiler:
	"""Overlapping tiles of maps: tshape pixels inside, pad and margin
	pixels more on each side (pixell_tpu.enmap.Padtiler)."""
	def __init__(self, tshape=600, pad=60, margin=60, mode="auto"):
		self.tshape = tuple(int(n) for n in np.zeros(2, int) + tshape)
		self.pad = tuple(int(n) for n in np.zeros(2, int) + pad)
		self.margin = tuple(int(n) for n in np.zeros(2, int) + margin)
		self.mode = mode
	def tiles_for(self, shape):
		"""The number of tiles (ny, nx) of a map of shape."""
		return tuple((shape[i] + self.tshape[i] - 1)//self.tshape[i] for i in (-2, -1))
	def read(self, imap):
		"""Each padded tile of imap, row by row (extract_pixbox: wrapped,
		zero outside)."""
		ny, nx = self.tiles_for(imap.shape)
		e = (self.pad[0] + self.margin[0], self.pad[1] + self.margin[1])
		for ty in range(ny):
			for tx in range(nx):
				y1, x1 = ty*self.tshape[0] - e[0], tx*self.tshape[1] - e[1]
				y2 = min((ty+1)*self.tshape[0], imap.shape[-2]) + e[0]
				x2 = min((tx+1)*self.tshape[1], imap.shape[-1]) + e[1]
				yield extract_pixbox(imap, np.array([[y1, x1], [y2, x2]]))
	def write(self, omap, tiles):
		"""The tiles read() made, less pad and margin, written into omap in place."""
		ny, nx = self.tiles_for(omap.shape)
		it = iter(tiles)
		py, px = self.pad[0] + self.margin[0], self.pad[1] + self.margin[1]
		for ty in range(ny):
			for tx in range(nx):
				tile = next(it)
				insert_at(omap, [ty*self.tshape[0], tx*self.tshape[1]],
					tile[..., py:tile.shape[-2]-py, px:tile.shape[-1]-px])
		return omap


def padtiles(*maps, tshape=600, pad=60, margin=60, mode="auto", start=0, step=1):
	"""The padded tiles of several maps side by side (pixell_tpu.enmap.padtiles)."""
	tiler = Padtiler(tshape=tshape, pad=pad, margin=margin, mode=mode)
	for tiles in zip(*[tiler.read(m) for m in maps]):
		yield tiles if len(tiles) > 1 else tiles[0]


# ---------------------------------------------------------------------------
# Geometry operations (pixell_tpu/enmap.py:1007-1135, :1880-1920,
# :2033-2106); host numpy
# ---------------------------------------------------------------------------
def geometry2(pos=None, res=None, shape=None, proj="car", variant=None, ref=None, pre=()):
	"""The full-sky pixelization of proj at res, cut to the box pos
	[{from, to}, {dec, ra}] or to shape around the centre pos [dec, ra]
	(pixell_tpu.enmap.geometry2)."""
	system, var2 = wcsutils.parse_system(proj)
	if variant is None: variant = var2
	res_deg = None if res is None else np.asarray(res)/utils.degree
	fshape, fwcs = wcsutils.pixelization(wcsutils.projection(system), res=res_deg, variant=variant)
	if pos is None: return tuple(pre) + tuple(fshape), fwcs
	pos = np.asarray(pos)
	if pos.ndim == 1:
		if shape is None: raise ValueError("geometry2 with a centre position needs a shape")
		cpix = np.round(np.asarray(sky2pix(fshape, fwcs, pos))).astype(int)
		half = np.array(shape[-2:])//2
		pixbox = np.array([cpix - half, cpix - half + np.array(shape[-2:])])
	else:
		pixbox = subinds(fshape, fwcs, pos, noflip=True)
	oshape, owcs = slice_geometry(fshape, fwcs, (slice(pixbox[0, 0], pixbox[1, 0]), slice(pixbox[0, 1], pixbox[1, 1])))
	return tuple(pre) + tuple(oshape[-2:]), owcs


def fullsky_geometry2(res=None, shape=None, pre=None, deg=False, proj="car", variant=None, dims=None):
	"""fullsky_geometry with geometry2's arguments (res in degrees with deg)."""
	if deg and res is not None: res = np.asarray(res)*utils.degree
	return fullsky_geometry(res=res, shape=shape, dims=tuple(pre or dims or ()), proj=proj,
		variant=variant or "fejer1")


def band_geometry2(decrange, res=None, shape=None, pre=None, deg=False, proj="car", variant=None, dims=None):
	"""band_geometry with geometry2's arguments."""
	if deg:
		decrange = np.asarray(decrange)*utils.degree
		if res is not None: res = np.asarray(res)*utils.degree
	return band_geometry(decrange, res=res, shape=shape, dims=tuple(pre or dims or ()), proj=proj,
		variant=variant or "fejer1")


def thumbnail_geometry(r=None, res=None, shape=None, dims=(), proj="tan"):
	"""A geometry of an odd number of pixels on each side with the pixel
	(0, 0) in its centre, of radius r and / or resolution res, for stamps
	around objects (pixell_tpu.enmap.thumbnail_geometry)."""
	if res is None:
		if r is None or shape is None: raise ValueError("thumbnail_geometry needs res, or r and shape")
		res = 2*r/(np.zeros(2, int) + np.asarray(shape[-2:]) - 1)
	res = np.zeros(2) + res
	if shape is None:
		if r is None: raise ValueError("thumbnail_geometry needs r or shape")
		n = utils.nint(2*r/res) + 1
	else:
		n = np.zeros(2, int) + np.asarray(shape[-2:])
	n = n//2*2 + 1
	ctype = ["", ""] if proj in ["", "plain"] else ["RA---"+proj.upper(), "DEC--"+proj.upper()]
	wcs = wcsutils.WCS.from_fields(ctype, [0., 0.], np.array([n[1], n[0]], float)//2 + 1,
		[-res[1]/utils.degree, res[0]/utils.degree], lonpole=180.0)
	return tuple(dims) + (int(n[0]), int(n[1])), wcs


def union_geometry(geometries):
	"""The smallest geometry of the first one's pixelization that covers all
	of geometries (pixell_tpu.enmap.union_geometry)."""
	ref_shape, ref_wcs = geometries[0][:2]
	pixboxes = []
	for shape, wcs in [g[:2] for g in geometries]:
		cpix = np.round(np.asarray(sky2pix(ref_shape, ref_wcs, np.asarray(corners(shape, wcs, corner=False)).T,
			safe=2))).astype(int)
		pixboxes.append(np.sort(cpix, 1).T + np.array([[0, 0], [1, 1]]))
	pixboxes = np.array(pixboxes)
	glob = np.array([pixboxes[:, 0].min(0), pixboxes[:, 1].max(0)])
	return slice_geometry(ref_shape, ref_wcs, (slice(glob[0, 0], glob[1, 0]), slice(glob[0, 1], glob[1, 1])),
		nowrap=True)


def recenter_geo(shape, wcs, on=None):
	"""The geometry as it is (pixell_tpu.enmap.recenter_geo)."""
	return shape, wcs


def recenter_cyl(shape, wcs):
	"""The reference point moved along the equator to the middle column."""
	return shape, wcsutils.recenter_cyl_x(wcs, (shape[-1]-1)/2 + 1)


def subgeo(shape, wcs, box=None, pixbox=None, mode=None, noflip=False, recenter=False):
	"""The geometry of the part inside a sky box or a pixel box."""
	ibox = np.asarray(pixbox) if pixbox is not None else subinds(shape, wcs, box, mode=mode, noflip=noflip, cap=False)
	ogeo = slice_geometry(shape, wcs, (slice(*ibox[:, 0]), slice(*ibox[:, 1])), nowrap=True)
	return recenter_geo(*ogeo) if recenter else ogeo


def crop_geometry(shape, wcs, box=None, pixbox=None, oshape=None, recenter=False):
	"""The geometry cut to a sky or pixel box, or oshape pixels around a
	point [dec, ra] or pixel [y, x] (pixell_tpu.enmap.crop_geometry)."""
	if pixbox is None:
		box = np.asarray(box)
		pixbox = subinds(shape, wcs, box, cap=False) if box.ndim == 2 else utils.nint(np.asarray(sky2pix(shape, wcs, box)))
	pixbox = np.asarray(pixbox)
	if pixbox.ndim == 1:
		if oshape is None: raise ValueError("crop_geometry needs an output shape for a point box")
		shp = np.array(oshape[-2:])
		pixbox = np.array([pixbox - shp//2, pixbox - shp//2 + shp])
	oshape2 = tuple(shape[:-2]) + tuple(int(n) for n in np.abs(pixbox[1] - pixbox[0]))
	owcs = wcs.deepcopy()
	owcs.wcs.crpix = np.asarray(owcs.wcs.crpix) - pixbox[0, ::-1]
	if recenter: owcs = wcsutils.recenter_cyl_x(owcs, oshape2[-1]//2)
	return oshape2, owcs


def npix(shape):
	"""The number of pixels of a shape's last two axes."""
	return int(np.prod(shape[-2:]))


def create_wcs(shape, box=None, proj="cea"):
	"""The wcs of shape pixels over box (default 10 x 10 degrees around 0)."""
	if box is None: box = np.array([[-5, -5], [5, 5]])*utils.degree
	return geometry(pos=np.asarray(box), shape=shape[-2:], proj=proj)[1]


def downgrade_geometry(shape, wcs, factor):
	"""The geometry of a map downgraded by whole factors [fy, fx]."""
	factor = np.zeros(2, int) + np.asarray(factor, int)
	return tuple(shape[:-2]) + tuple(int(n) for n in np.array(shape[-2:])//factor), \
		wcsutils.scale(wcs, (1./factor)[::-1])


def upgrade_geometry(shape, wcs, factor):
	"""The geometry of a map upgraded by whole factors [fy, fx]."""
	factor = np.zeros(2, int) + np.asarray(factor, int)
	return tuple(shape[:-2]) + tuple(int(n) for n in np.array(shape[-2:])*factor), \
		wcsutils.scale(wcs, factor.astype(float)[::-1])


def scale_geometry(shape, wcs, scale):
	"""The geometry with its pixel counts scaled by scale [sy, sx]."""
	scale = np.zeros(2) + scale
	return tuple(shape[:-2]) + tuple(int(n) for n in utils.nint(np.array(shape[-2:])*scale)), \
		wcsutils.scale(wcs, scale[::-1])


def get_downgrade_offset(shape, wcs, factor, ref=None):
	"""The pixel offset [oy, ox] that keeps a downgrade aligned with ref
	[dec, ra] (0 without ref)."""
	factor = np.zeros(2, int) + factor
	if ref is None: return np.zeros(2, int)
	return utils.nint(np.asarray(sky2pix(shape, wcs, ref))) % factor


# ---------------------------------------------------------------------------
# Pixel operations (pixell_tpu/enmap.py:1138-1266, :1921-1948, :2107-2130,
# :2193): on the map's device
# ---------------------------------------------------------------------------
def downgrade(map, factor, op=None, ref=None, off=None, inclusive=False):
	"""The map averaged (or reduced by op(array, axis)) over blocks of
	factor [fy, fx] pixels, partial blocks dropped (pixell_tpu.enmap.downgrade;
	ref, off and inclusive are accepted and ignored, as there)."""
	if op is None: op = torch.mean
	factor = np.zeros(2, int) + np.asarray(factor, int)
	d = map.data
	ny, nx = d.shape[-2]//factor[0], d.shape[-1]//factor[1]
	d = d[..., :ny*factor[0], :nx*factor[1]].reshape(d.shape[:-2] + (ny, int(factor[0]), nx, int(factor[1])))
	_, owcs = downgrade_geometry(map.shape, map.wcs, factor)
	return ndmap(op(op(d, -1), -2), owcs)


def upgrade(map, factor, off=None, oshape=None, inclusive=False):
	"""Each pixel repeated factor [fy, fx] times, cut to oshape where given
	(pixell_tpu.enmap.upgrade)."""
	factor = np.zeros(2, int) + np.asarray(factor, int)
	d = map.data.repeat_interleave(int(factor[0]), -2).repeat_interleave(int(factor[1]), -1)
	_, owcs = upgrade_geometry(map.shape, map.wcs, factor)
	if oshape is not None: d = d[..., :oshape[-2], :oshape[-1]]
	return ndmap(d, owcs)


def downgrade_fft(map, factor):
	"""The map Fourier-resampled to its shape over factor."""
	from . import resample as _rs
	factor = np.zeros(2, int) + np.asarray(factor, int)
	return _rs.resample(map, tuple(int(n) for n in np.array(map.shape[-2:])//factor), method="fft")


def upgrade_fft(map, factor):
	"""The map Fourier-resampled to its shape times factor."""
	from . import resample as _rs
	factor = np.zeros(2, int) + np.asarray(factor, int)
	return _rs.resample(map, tuple(int(n) for n in np.array(map.shape[-2:])*factor), method="fft")


def resample_fft(map, oshape, fwcs=None, off=(0, 0), corner=False, norm="pix", op=None, dummy=False):
	"""The map Fourier-resampled to oshape (as resample's factors)."""
	from . import resample as _rs
	return _rs.resample(map, oshape, method="fft")


def resample(map, oshape, off=(0, 0), method="fft", mode="wrap", corner=False, order=3):
	"""resample.resample of the map to oshape (as its factors)."""
	from . import resample as _rs
	return _rs.resample(map, oshape, method=method, mode=mode, corner=corner, order=order)


def _pad_pix(pix):
	"""pix (a number, [y, x] or [{from, to}, {y, x}]) as [{from, to}, {y, x}]."""
	pix = np.asarray(pix, int)
	if pix.ndim == 0: pix = np.full((2, 2), pix)
	if pix.ndim == 1: pix = np.stack([pix, pix])
	return pix.reshape(2, 2)


def pad(emap, pix, return_slice=False, wrap=False, value=0):
	"""The map padded by pix pixels (see _pad_pix) with value, or wrapped
	around with wrap; with return_slice also the slice of the old pixels
	(pixell_tpu.enmap.pad). The wcs moves by the front pad, so the old
	pixels keep their sky positions (the reference wraps the negative slice
	start instead, which shifts the wcs by the map's size less the pad)."""
	pix = _pad_pix(pix)
	(y0, x0), (y1, x1) = pix.tolist()
	ny, nx = emap.shape[-2:]
	_, owcs = slice_geometry(emap.shape[-2:], emap.wcs, (slice(-y0, ny+y1), slice(-x0, nx+x1)), nowrap=True)
	d = emap.data
	if wrap:
		d = d.index_select(-2, torch.from_numpy(np.arange(-y0, ny+y1) % ny).to(d.device))
		d = d.index_select(-1, torch.from_numpy(np.arange(-x0, nx+x1) % nx).to(d.device))
	else:
		d = torch.nn.functional.pad(d, (x0, x1, y0, y1), value=value)
	res = ndmap(d, owcs)
	if return_slice: return res, (Ellipsis, slice(y0, y0+ny), slice(x0, x0+nx))
	return res


def crop(emap, npix):
	"""The map with npix ([ny, nx]) pixels cut from each edge."""
	npix = np.zeros(2, int) + np.asarray(npix, int)
	return emap[..., npix[0]:emap.shape[-2]-npix[0], npix[1]:emap.shape[-1]-npix[1]]


def autocrop(m, method="plain", value="auto", margin=0, factors=None, return_info=False):
	"""The map without its edge rows and columns where every component is
	close to value ("auto": the first pixel's), margin pixels kept; with
	return_info also the slice taken (pixell_tpu.enmap.autocrop)."""
	d = m.data
	flat = d.reshape((-1,) + d.shape[-2:])
	v = flat.reshape(-1)[0] if isinstance(value, str) and value == "auto" else torch.as_tensor(value,
		dtype=d.dtype, device=d.device)
	good = ~torch.isclose(flat, v, equal_nan=True).all(0)
	rows = torch.nonzero(good.any(1)).reshape(-1).tolist()
	cols = torch.nonzero(good.any(0)).reshape(-1).tolist()
	if not rows:
		res, info = m, (slice(None), slice(None))
	else:
		y1, y2 = max(rows[0]-margin, 0), min(rows[-1]+1+margin, m.shape[-2])
		x1, x2 = max(cols[0]-margin, 0), min(cols[-1]+1+margin, m.shape[-1])
		info = (Ellipsis, slice(y1, y2), slice(x1, x2))
		res = m[info]
	return (res, info) if return_info else res


def find_blank_edges(m, value=0):
	"""The blank margins [{front, back}, {y, x}] of the map: rows and
	columns where every component is within 1e-6 of value (a number, one
	per component, "auto": the edges' median that blanks the most, or
	"none") (pixell_tpu.enmap.find_blank_edges)."""
	d = m.data if isinstance(m, ndmap) else torch.as_tensor(m)
	if isinstance(value, str) and value == "auto":
		host = [d[..., :, i] for i in (0, -1)] + [d[..., i, :] for i in (0, -1)]
		bs = [find_blank_edges(m, np.median(e.cpu().numpy(), -1)) for e in host]
		return bs[int(np.argmax([np.prod(np.sum(b, 0)) for b in bs]))]
	if isinstance(value, str) and value == "none": return np.zeros([2, 2], int)
	v = torch.as_tensor(np.asarray(value), dtype=d.dtype, device=d.device)
	v = v.reshape(v.shape + (1, 1))
	hit = torch.isclose(d, v.expand_as(d) if v.ndim else v, rtol=1e-6, atol=0, equal_nan=True)
	hit = hit.reshape((-1,) + d.shape[-2:]).all(0)
	hitrows = torch.nonzero(~hit.all(1)).reshape(-1).tolist()
	hitcols = torch.nonzero(~hit.all(0)).reshape(-1).tolist()
	if not hitrows or not hitcols: return np.array([[0, 0], [0, 0]])
	ny, nx = d.shape[-2:]
	return np.array([[hitrows[0], hitcols[0]], [ny - 1 - hitrows[-1], nx - 1 - hitcols[-1]]])


def apod_profile_lin(x): return x
def apod_profile_cos(x): return 0.5-0.5*np.cos(np.pi*x)


def apod(m, width, profile="cos", fill="zero"):
	"""The map tapered to 0 over width ([wy, wx]) pixels at each edge by a
	cosine ("cos") or linear profile; fill "mean" or "median" tapers to the
	map's mean or median instead (pixell_tpu.enmap.apod)."""
	arr = m.data if isinstance(m, ndmap) else m
	width = np.minimum(np.zeros(2, int) + np.asarray(width, int), np.asarray(arr.shape[-2:]))
	rdt = utils.real_dtype(arr.dtype)
	def win(n, w):
		x = torch.ones(n, dtype=torch.float64)
		if w > 0:
			t = torch.arange(w, dtype=torch.float64)/float(w)
			edge = 0.5 - 0.5*torch.cos(np.pi*t) if profile == "cos" else t
			x[:w] = edge
			x[n-w:] = edge.flip(0)
		return x.to(arr.device, rdt)
	w = win(arr.shape[-2], int(width[0]))[:, None]*win(arr.shape[-1], int(width[1]))[None, :]
	a = arr*w
	if fill == "mean":
		a = a + arr.mean((-2, -1), keepdim=True)*(1 - w)
	elif fill == "median":
		s = arr.reshape(arr.shape[:-2] + (-1,)).sort(-1).values
		n = s.shape[-1]
		med = s[..., n//2] if n % 2 else (s[..., n//2-1] + s[..., n//2])/2
		a = a + med[..., None, None]*(1 - w)
	return samewcs(a, m)


def fillbad(map, val=0, inplace=False):
	"""The map with its non-finite pixels set to val, in place with inplace."""
	d = map.data if isinstance(map, ndmap) else map
	if inplace:
		d.masked_fill_(~torch.isfinite(d), val)
		return map
	return samewcs(torch.where(torch.isfinite(d), d, d.new_tensor(val)), map)


def _argextreme(map, fun, unit):
	d = map.data
	inds = fun(d.reshape(-1, d.shape[-2]*d.shape[-1]), -1).cpu().numpy()
	pix = np.array(np.unravel_index(inds, d.shape[-2:]), float)
	res = pix if unit == "pix" else np.asarray(pix2sky(map.shape, map.wcs, pix))
	return res.T.reshape(tuple(d.shape[:-2]) + (2,))


def argmax(map, unit="coord"):
	"""The position [..., {dec, ra}] (unit "pix": the pixel [..., {y, x}]) of
	each component's largest value (the first of equal ones)."""
	return _argextreme(map, torch.argmax, unit)


def argmin(map, unit="coord"):
	"""argmax's counterpart for the smallest value."""
	return _argextreme(map, torch.argmin, unit)


def map_union(map1, map2):
	"""The two maps on the union of their geometries, summed where they overlap."""
	oshape, owcs = union_geometry([map1.geometry, map2.geometry])
	omap = zeros(map1.shape[:-2] + oshape[-2:], owcs, map1.dtype, device=map1.device)
	insert(omap, map1)
	return insert(omap, map2, op=lambda a, b: a + b)


def tile_maps(maps):
	"""One map of a 2d list of adjacent tiles, with the first tile's wcs."""
	m = torch.cat([torch.cat([t.data if isinstance(t, ndmap) else t for t in row], -1) for row in maps], -2)
	return samewcs(m, maps[0][0])


# ---------------------------------------------------------------------------
# Reprojection (pixell_tpu/enmap.py:1546-1575) through interpol
# ---------------------------------------------------------------------------
def _project_axes(ishape, iwcs, shape, wcs, safe=True, device="cuda"):
	"""(ty [ny], tx [nx]): the input pixel coordinates of the output rows and
	columns of the geometry (shape, wcs), float64 on device, where both
	geometries are separable (cylindrical with the reference point on the
	equator): there the input y depends on the output y alone and x on x
	alone, so the two axes (ny + nx values) are mapped on the host and
	copied once. None where either is not separable."""
	if not (wcsutils.is_separable(wcs) and wcsutils.is_separable(iwcs)): return None
	dec, ra = posaxes(shape, wcs, safe=safe)
	iy = sky2pix(ishape, iwcs, np.stack([dec, np.full_like(dec, ra[0])]), safe=safe)[0]
	ix = sky2pix(ishape, iwcs, np.stack([np.full_like(ra, dec[0]), ra]), safe=safe)[1]
	return tuple(torch.from_numpy(np.ascontiguousarray(a, np.float64)).to(device) for a in (iy, ix))


def _project_points(ishape, iwcs, shape, wcs, safe=True, bsize=1000, device="cuda"):
	"""(y1, y2, py, px) for each block of bsize output rows of the geometry
	(shape, wcs): the input pixel coordinates [P] of each output pixel of
	rows y1:y2, float64 on device, mapped on the host (pix2sky and sky2pix
	row by row, as the reference's posmap and sky2pix) and copied once."""
	ny, nx = shape[-2:]
	for y1 in range(0, ny, bsize):
		y2 = min(y1 + bsize, ny)
		opos = pix2sky(shape, wcs, np.mgrid[y1:y2, :nx], safe)
		ipix = torch.from_numpy(np.ascontiguousarray(sky2pix(ishape, iwcs, opos, safe=safe).reshape(2, -1),
			np.float64)).to(device)
		yield y1, y2, ipix[0], ipix[1]


def project(map, shape, wcs, order=3, border="constant", cval=0.0, force=False,
		safe=True, bsize=1000, context=50, ip=None):
	"""The map interpolated onto the geometry (shape, wcs) by splines of
	order with the border mode, on the map's device
	(pixell_tpu.enmap.project). The spline coefficients are computed once
	for the whole map; the output is made in blocks of bsize rows: where
	both geometries are separable one axis at a time from the two mapped
	axes (_project_axes), else point by point (_project_points). context
	and ip are accepted and ignored."""
	if not force and wcsutils.is_compatible(map.wcs, wcs) and order in [0, 1, 3]:
		if wcsutils.equal(map.wcs, wcs) and tuple(map.shape[-2:]) == tuple(shape[-2:]):
			return map.copy()
	data = map.data.reshape((-1,) + map.shape[-2:])
	coef, padded = interpol._coefficients(data, "spline", order, border, True)
	out = data.new_empty((data.shape[0],) + tuple(shape[-2:]))
	axes = _project_axes(map.shape, map.wcs, shape, wcs, safe, map.device)
	if axes is not None:
		ty, tx = axes
		for y1 in range(0, shape[-2], bsize):
			y2 = min(y1 + bsize, shape[-2])
			out[:, y1:y2] = interpol._gather_grid(coef, ty[y1:y2], tx, "spline", order, border, padded, cval)
	else:
		for y1, y2, py, px in _project_points(map.shape, map.wcs, shape, wcs, safe, bsize, map.device):
			out[:, y1:y2] = interpol._gather(coef, py, px, "spline", order, border, padded, False,
				cval).reshape(out.shape[0], y2-y1, -1)
	return ndmap(out.reshape(tuple(map.shape[:-2]) + tuple(shape[-2:])), wcs)


def at(map, pos, order=3, border="constant", cval=0.0, safe=True, unit="coord", ip=None):
	"""The map interpolated at the positions pos [{dec, ra}, ...] (unit
	"pix": pixel coordinates [{y, x}, ...]), [..., pos...] on the map's
	device (pixell_tpu.enmap.at). Sky positions given as a tensor on the
	map's device are mapped to pixels there where the geometry is a
	separable CAR, CEA or MER (_sky2pix_on); others are mapped on the host,
	as numpy, and the pixels copied once."""
	if unit == "coord" and _sky2pix_on_device(map, pos, safe):
		pix = _sky2pix_on(map.shape, map.wcs, pos)
	elif unit == "coord":
		pos = pos.detach().cpu().numpy() if isinstance(pos, torch.Tensor) else np.asarray(pos)
		pix = torch.from_numpy(np.ascontiguousarray(sky2pix(map.shape, map.wcs, pos, safe=safe), np.float64))
	else:
		pix = pos if isinstance(pos, torch.Tensor) else torch.from_numpy(np.asarray(pos, np.float64))
	pix = pix.to(map.device)
	res = interpol.map_coordinates(map.data.reshape((-1,) + map.shape[-2:]), pix, order=order, border=border,
		cval=cval)
	return res.reshape(tuple(map.shape[:-2]) + tuple(pix.shape[1:]))


def _sky2pix_on_device(map, pos, safe):
	"""Whether at maps pos to pixels on the device: a tensor on the map's
	device, a separable CAR / CEA / MER geometry, and safe=True (safe=2
	unwinds, on the host)."""
	return isinstance(pos, torch.Tensor) and pos.device == map.device and safe == 1 \
		and wcsutils.is_separable(map.wcs) and wcsutils.get_proj(map.wcs) in ("car", "cea", "mer")


def _sky2pix_on(shape, wcs, pos, safe=True):
	"""sky2pix(shape, wcs, pos, safe=1) of a tensor pos [{dec, ra}, ...] on
	its device, in float64, for a separable CAR / CEA / MER geometry: the
	host version's arithmetic (wcsutils.world2pix with the pole at its
	place, then the rewind of x about the map's centre; with safe=False
	no rewind)."""
	unit = get_unit(wcs)
	pos = pos.to(torch.float64)
	lon, lat = pos[1]/unit, pos[0]/unit
	u = lon - float(wcs.wcs.crval[0])
	proj = wcsutils.get_proj(wcs)
	if proj == "car": v = lat
	elif proj == "cea": v = torch.sin(lat*wcsutils.deg2rad)*wcsutils.rad2deg/wcs.wcs._pv.get((2, 1), 1.0)
	else: v = torch.log(torch.tan((45 + lat/2)*wcsutils.deg2rad))*wcsutils.rad2deg
	x = u/float(wcs.wcs.cdelt[0]) + float(wcs.wcs.crpix[0]) - 1
	y = v/float(wcs.wcs.cdelt[1]) + float(wcs.wcs.crpix[1]) - 1
	if safe: x = utils.rewind(x, shape[-1]/2., abs(360./wcs.wcs.cdelt[0]))
	return torch.stack([y, x])


# ---------------------------------------------------------------------------
# flipper interop (pixell_tpu/enmap.py:2200-2218), small helpers (:930, :2239)
# ---------------------------------------------------------------------------
def to_flipper(imap, omap=None, unpack=True):
	"""The map as flipper liteMaps, one per field (pixell_tpu.enmap.
	to_flipper); needs the flipper package, and raises ImportError without
	it. The fields are copied to the host."""
	import flipper.liteMap
	arr = imap.data.detach().cpu().numpy() if isinstance(imap, ndmap) else np.asarray(imap)
	res = []
	for sub in arr.reshape((-1,) + arr.shape[-2:]):
		res.append(flipper.liteMap.liteMapFromDataAndWCS(sub, imap.wcs))
	res = np.array(res, object).reshape(arr.shape[:-2])
	return res if unpack and res.ndim else res.reshape(-1)[0]

def from_flipper(imap, omap=None, *, device="cuda"):
	"""A map on device from flipper liteMap(s): their data stacked, the
	first one's wcs (pixell_tpu.enmap.from_flipper)."""
	imap = np.asarray(imap, object)
	first = imap.reshape(-1)[0]
	data = np.array([np.asarray(m.data) for m in imap.reshape(-1)])
	data = data.reshape(imap.shape + data.shape[-2:])
	return ndmap(torch.as_tensor(data, device=device), first.wcs)

def wrapsutils_is_plain(wcs):
	return wcsutils.is_plain(wcs)

def fix_python3(s):
	"""bytes decoded to str; anything else as it is."""
	return s.decode() if isinstance(s, bytes) else s


# ---------------------------------------------------------------------------
# HEALPix interop (pixell_tpu/enmap.py:1616-1622, :2390-2440)
# ---------------------------------------------------------------------------
def to_healpix(imap, omap=None, nside=0, order=3, chunk=100000, destroy_input=False):
	"""reproject.map2healpix(imap, nside, order=order) (pixell_tpu.enmap.
	to_healpix); omap, chunk and destroy_input are accepted and ignored."""
	from . import reproject
	return reproject.map2healpix(imap, nside=nside, order=order)

def from_healpix(hmap, shape, wcs, order=3, rot=None, *, device="cuda"):
	"""reproject.healpix2map(hmap, shape, wcs, order=order, rot=rot)
	(pixell_tpu.enmap.from_healpix)."""
	from . import reproject
	return reproject.healpix2map(hmap, shape, wcs, order=order, rot=rot, device=device)

def distance_from_healpix(nside, points, omap=None, odomains=None, domains=False, rmax=None,
		method="bubble", *, device="cuda"):
	"""The distance from each HEALPix RING pixel to the nearest of
	points[{dec, ra}, npoint] and with domains that point's index
	(pixell_tpu.enmap.distance_from_healpix :2390): the largest dot product
	of the unit vectors by a blocked matrix product on device (torch.matmul)
	and its arccos. omap and method are accepted and ignored, as there."""
	from . import healpix as hpx
	device = torch.device(device)
	theta, phi = hpx.positions(nside)
	v = torch.from_numpy(utils.ang2rect(np.stack([phi, np.pi/2 - theta]), axis=0)).to(device)
	points = _host_array(points).astype(float).reshape(2, -1)
	vp = torch.from_numpy(utils.ang2rect(np.stack([points[1], points[0]]), axis=0)).to(device)
	best, dom = [], []
	for i0 in range(0, v.shape[1], 1 << 20):
		dots = v[:, i0:i0 + (1 << 20)].T @ vp
		j = torch.argmax(dots, -1)
		best.append(torch.arccos(torch.clamp(torch.gather(dots, 1, j[:, None])[:, 0], -1, 1)))
		dom.append(j.to(torch.int32))
	best, dom = torch.cat(best), torch.cat(dom)
	if rmax is not None: best = torch.clamp(best, max=rmax)
	if domains or odomains is not None: return best, dom
	return best

def distance_transform_healpix(mask, omap=None, rmax=None, method="heap", *, device="cuda"):
	"""The distance to the nearest False pixel of a boolean HEALPix map
	(pixell_tpu.enmap.distance_transform_healpix)."""
	from . import healpix as hpx
	mask = _host_array(mask).astype(bool)
	npixtot = mask.size
	nside = int(np.sqrt(npixtot/12))
	bad = np.nonzero(~mask)[0]
	if len(bad) == 0:
		return torch.full((npixtot,), rmax if rmax is not None else np.pi, dtype=torch.float64, device=device)
	theta, phi = hpx.positions(nside)
	return distance_from_healpix(nside, np.stack([np.pi/2 - theta[bad], phi[bad]]), rmax=rmax, device=device)

def labeled_distance_transform_healpix(labels, omap=None, odomains=None, rmax=None, method="heap", *,
		device="cuda"):
	"""The distance to and the label of the nearest labeled HEALPix pixel
	(pixell_tpu.enmap.labeled_distance_transform_healpix)."""
	from . import healpix as hpx
	labels = _host_array(labels)
	nside = int(np.sqrt(labels.size/12))
	src = np.nonzero(labels != 0)[0]
	theta, phi = hpx.positions(nside)
	dists, dom = distance_from_healpix(nside, np.stack([np.pi/2 - theta[src], phi[src]]), domains=True,
		rmax=rmax, device=device)
	return dists, torch.from_numpy(labels[src]).to(dists.device)[dom.to(torch.int64)]

def _host_array(x):
	"""x (an ndmap, a tensor or anything numpy takes) as numpy: a tensor is
	copied from its device."""
	if isinstance(x, ndmap): x = x.data
	return x.detach().resolve_conj().cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


# ---------------------------------------------------------------------------
# Distance transforms and masks (pixell_tpu/enmap.py:1575-1610, :1801-1815,
# :2175-2188), through pixell_tpu_torch.distances on the map's device
# ---------------------------------------------------------------------------
def distance_transform(mask, omap=None, rmax=None, method="auto"):
	"""The angular distance of each pixel to the nearest False pixel of
	mask (pixell_tpu.enmap.distance_transform). omap and method are
	accepted and ignored, as there."""
	from . import distances
	return distances.distance_transform(mask, rmax=rmax)

def labeled_distance_transform(labels, omap=None, odomains=None, rmax=None, method="auto"):
	"""(distance, label) of the nearest nonzero-labeled pixel
	(pixell_tpu.enmap.labeled_distance_transform)."""
	from . import distances
	return distances.labeled_distance_transform(labels, rmax=rmax)

def distance_from(shape, wcs, points, omap=None, odomains=None, domains=False, method="auto", rmax=None,
		step=1024, *, device="cuda"):
	"""The distance of each pixel from the nearest of points[{dec, ra},
	npoint] (pixell_tpu.enmap.distance_from): K14 up to 1024 points, else
	the flood (K13)."""
	from . import distances
	return distances.distance_from_points(shape, wcs, points, rmax=rmax, domains=domains, device=device)

def grow_mask(mask, r):
	"""The True region of mask grown by r radians."""
	m = _tensor(mask, "cpu")
	d = distance_transform(ndmap(~m if m.dtype == torch.bool else m == 0, mask.wcs))
	return ndmap(d.data <= r, mask.wcs)

def shrink_mask(mask, r):
	"""The True region of mask shrunk by r radians."""
	res = distance_transform(mask).data > r
	return ndmap(res, mask.wcs) if isinstance(mask, ndmap) else res

def mask_from(mask): return mask

def inpaint(map, mask, method="nearest"):
	"""The map with its masked (True) pixels set to the value of the
	nearest unmasked pixel, from distance_transform's indices (K13; kept
	raveled, int32).
	pixell_tpu.enmap.inpaint floods from the masked pixels instead (it
	passes ~mask, whose False pixels are the masked ones), so every masked
	pixel finds itself and its map comes back unchanged; this is the fill
	its docstring describes (ROADMAP Queue 3)."""
	from . import distances
	arr = _tensor(map, "cpu")
	m = _tensor(mask, arr.device) != 0
	if method != "nearest": raise NotImplementedError(method)
	wcs = map.wcs if isinstance(map, ndmap) else wcsutils.WCS(naxis=2)
	src = distances._transform(ndmap(m, wcs))[1][m].to(torch.int64)
	out = arr.clone()
	out[..., m] = arr.reshape(arr.shape[:-2] + (-1,))[..., src]
	return samewcs(out, map)

def _apod_profile_on(profile):
	"""profile as a function of a tensor: the two named profiles by torch,
	any other called as it is."""
	if profile is apod_profile_cos: return lambda x: 0.5 - 0.5*torch.cos(np.pi*x)
	return profile

def apod_mask(mask, width=1*utils.degree, edge=True, profile=apod_profile_cos):
	"""A 0/1 mask apodized over width radians from its False pixels (and,
	with edge, from the map's edges), on its device
	(pixell_tpu.enmap.apod_mask)."""
	arr = _tensor(mask, "cpu").to(torch.bool)
	if edge:
		arr = arr.clone()
		arr[..., 0, :] = False; arr[..., -1, :] = False
		arr[..., :, 0] = False; arr[..., :, -1] = False
	r = distance_transform(ndmap(arr, mask.wcs), rmax=width)
	x = torch.clamp(r.data/width, 0, 1)
	return samewcs(_apod_profile_on(profile)(x), mask)


def spec2flat_corr(shape, wcs, cov, exp=1.0, border="constant", *, device="cuda"):
	"""The spectrum cov on the 2d Fourier plane through its correlation
	function: the curvature-aware counterpart of spec2flat. The correlation
	function at the angular distance of each pixel from the map's centre
	(linear interpolation), rolled to put the centre at pixel 0, then its
	FFT (pixell_tpu.enmap.spec2flat_corr, whose distance computation
	raises; this is the computation it describes). border is accepted and
	ignored, as there."""
	from . import powspec
	cov = np.asarray(cov)
	if cov.ndim == 1: cov = cov[None, None]
	if exp != 1.0: cov = np.moveaxis(utils.eigpow(np.moveaxis(cov, -1, 0), exp), 0, -1)
	cov = np.nan_to_num(cov)
	ext = np.asarray(extent(shape, wcs))
	rmax = np.sum(ext**2)**0.5
	nr = int(rmax/np.max(ext/np.array(shape[-2:])))
	corrfun = torch.from_numpy(np.ascontiguousarray(powspec.spec2corr(cov, np.arange(nr)*rmax/nr))).to(device)
	dpos = posmap(shape, wcs, device=device).data
	dpos = dpos - dpos[:, shape[-2]//2, shape[-1]//2][:, None, None]
	ipos = torch.arccos(torch.clamp(torch.cos(dpos[0])*torch.cos(dpos[1]), -1, 1))*(nr/rmax)
	corr2d = interpol.map_coordinates(corrfun, ipos.reshape(1, -1), order=1, border="nearest")
	corr2d = corr2d.reshape(corrfun.shape[:-1] + ipos.shape)
	corr2d = torch.roll(corr2d, (-corr2d.shape[-2]//2, -corr2d.shape[-1]//2), (-2, -1))
	return fft(ndmap(corr2d, wcs)).real*np.prod(shape[-2:])**0.5


# ---------------------------------------------------------------------------
# Maps on disk (pixell_tpu/enmap.py:1626-1747, :1817-1879, :2277-2389): FITS
# through fits_io's native box reader, HDF5 through h5py, .npy. A read goes
# into one host buffer (pinned where the map goes to a CUDA device) and to
# the device in one copy; a box, pixbox or geometry read takes only the
# pieces of the file it needs
# ---------------------------------------------------------------------------
def _map_format(fname, fmt):
	if fmt is not None: return fmt
	if fname.endswith(".hdf") or fname.endswith(".h5"): return "hdf"
	if fname.endswith(".npy"): return "npy"
	return "fits"


def _host_buffer(shape, dtype, device):
	"""An empty host tensor of the numpy dtype to read into: pinned where
	the data go to a CUDA device (which raises where there is none)."""
	return torch.empty(tuple(shape), dtype=_torch_dtype(np.dtype(dtype)),
		pin_memory=torch.device(device).type == "cuda")


def _to_device(host, device):
	"""The host tensor on device, in one copy, asynchronous from pinned memory."""
	return host.to(device, non_blocking=torch.device(device).type == "cuda")


class _MapProxy:
	"""A map on disk that reads only what it is asked for: shape, wcs, dtype
	(the torch dtype of the map it reads into), and slicing, extract_pixbox
	(so submap and extract) and read, each returning its pixels on the
	proxy's device. Each kind of file gives _box, the pixel box of every
	plane into a host buffer, and may scale what it reads (_scaled)."""
	@property
	def ndim(self): return len(self.shape)
	@property
	def geometry(self): return self.shape, self.wcs
	def _scaled(self): return False
	def _load(self, pieces, oshape, cval=0):
		"""The pieces [((y slice, x slice) of the file, (y slice, x slice) of
		the output)] of every plane in one host buffer of oshape, cval
		elsewhere, on the device in one copy."""
		host = _host_buffer(oshape, self._np_dtype, self.device)
		arr = host.numpy()
		covered = sum((ys.stop - ys.start)*(xs.stop - xs.start) for (ys, xs), _ in pieces)
		if covered < int(np.prod(oshape[-2:])): arr[...] = cval
		for (ys, xs), (oys, oxs) in pieces:
			self._box(ys.start, ys.stop, xs.start, xs.stop, arr[..., oys, oxs])
		if self._scaled(): return torch.from_numpy(self._scale(arr)).to(self.device)
		return _to_device(host, self.device)
	def __getitem__(self, sel):
		if not isinstance(sel, tuple): sel = (sel,)
		if Ellipsis in sel:
			i = sel.index(Ellipsis)
			sel = sel[:i] + (slice(None),)*(self.ndim - len(sel) + 1) + sel[i+1:]
		if any(s is None or not (isinstance(s, slice) or _is_int(s)) for s in sel):
			return self.read()[sel]   # new axes and array indices on the map read whole
		full = tuple(sel) + (slice(None),)*(self.ndim - len(sel))
		from .fits_io import _axis_box
		(y1, y2, yrest), (x1, x2, xrest) = [_axis_box(s, n) for s, n in zip(full[-2:], self.shape[-2:])]
		data = self._load([((slice(y1, y2), slice(x1, x2)), (slice(None), slice(None)))],
			tuple(self.shape[:-2]) + (y2 - y1, x2 - x1))
		data = _getitem(data, full[:-2] + (yrest, xrest))
		if all(isinstance(s, slice) for s in full[-2:]):
			return ndmap(data, slice_geometry(self.shape[-2:], self.wcs, full[-2:])[1])
		return data
	def read(self): return self[:]
	def extract_pixbox(self, pixbox, wrap="auto", cval=0):
		"""extract_pixbox of the map, reading only the pieces it needs."""
		pixbox = np.asarray(pixbox)
		if pixbox.shape[-1] > 2: pixbox = pixbox[..., -2:]
		oshape = tuple(self.shape[:-2]) + tuple(int(n) for n in pixbox[1] - pixbox[0])
		_, owcs = slice_geometry(self.shape[-2:], self.wcs,
			(slice(pixbox[0, 0], pixbox[1, 0]), slice(pixbox[0, 1], pixbox[1, 1])), nowrap=True)
		pieces = [(isel[1:], osel[1:]) for isel, osel in _wrap_segments(self.shape, self.wcs, pixbox, wrap)]
		if any(s.step not in (None, 1) for p in pieces for s in p[0] + p[1]):
			return extract_pixbox(self.read(), pixbox, wrap=wrap, cval=cval)
		return ndmap(self._load(pieces, oshape, cval), owcs)
	@property
	def preflat(self):
		"""A view with the leading dimensions flattened into one."""
		return _preflat_proxy(self)


class ndmap_proxy_fits(_MapProxy):
	"""A FITS map read when sliced, through fits_io's native box reader
	(pixell_tpu.enmap.ndmap_proxy_fits). The image is HDU hdu's, or the
	first with data from it on (from the first HDU where hdu is None), as
	read_fits reads."""
	def __init__(self, fname, hdu=None, wcs=None, *, device="cuda"):
		from . import fits_io
		self.proxy = fits_io.open_proxy(fname, hdu=fits_io._data_hdu(fname, hdu or 0))
		self.fname = fname
		self.wcs = wcsutils.WCS(header=self.proxy.header) if wcs is None else wcs
		self.device = device
	@property
	def shape(self): return self.proxy.shape
	@property
	def _np_dtype(self): return self.proxy.dtype
	@property
	def dtype(self):
		from . import fits_io
		return _torch_dtype(fits_io._scale(np.zeros(1, self.proxy.dtype), self.proxy.header).dtype)
	def _box(self, y1, y2, x1, x2, out): self.proxy.read_box(y1, y2, x1, x2, out=out)
	def _scaled(self): return self.proxy.scaled
	def _scale(self, arr):
		from . import fits_io
		return fits_io._scale(arr, self.proxy.header)

ndmap_proxy = ndmap_proxy_fits


class ndmap_proxy_hdf(_MapProxy):
	"""An HDF5 map read when sliced, its "data" dataset through h5py
	(pixell_tpu.enmap.ndmap_proxy_hdf)."""
	def __init__(self, fname, address=None, wcs=None, *, device="cuda"):
		self.fname = fname
		self.address = address
		shape, w = read_map_geometry(fname, fmt="hdf", address=address)
		self.shape = shape
		self.wcs = wcs if wcs is not None else w
		self._np_dtype = np.dtype(read_hdf_dtype(fname, address=address))
		self.device = device
	@property
	def dtype(self): return _torch_dtype(self._np_dtype)
	def _box(self, y1, y2, x1, x2, out):
		import h5py
		with h5py.File(self.fname, "r") as f:
			out[...] = (f[self.address] if self.address else f)["data"][..., y1:y2, x1:x2]


class _preflat_proxy(_MapProxy):
	"""A proxy with its leading dimensions flattened into one
	(pixell_tpu.enmap._preflat_proxy)."""
	def __init__(self, proxy):
		self.proxy = proxy
		self.shape = (int(np.prod(proxy.shape[:-2])),) + tuple(proxy.shape[-2:])
		self.wcs = proxy.wcs
		self.device = proxy.device
	@property
	def dtype(self): return self.proxy.dtype
	@property
	def _np_dtype(self): return self.proxy._np_dtype
	def _box(self, y1, y2, x1, x2, out):
		self.proxy._box(y1, y2, x1, x2, out.reshape(tuple(self.proxy.shape[:-2]) + out.shape[-2:]))
	def _scaled(self): return self.proxy._scaled()
	def _scale(self, arr): return self.proxy._scale(arr)


def read_helper(data, sel=None, box=None, pixbox=None, geometry=None, wrap="auto", mode=None, delayed=False,
		recenter=False):
	"""The read-time selection of a map or proxy: sel, then the sky box
	(submap), the pixel box and the geometry (extract), each reading only
	the part of a proxy it needs; a proxy left is read unless delayed
	(pixell_tpu.enmap.read_helper; mode and recenter are accepted and
	ignored, as there)."""
	res = data
	if sel is not None: res = res[sel]
	if box is not None: res = submap(res, box, wrap=wrap)
	if pixbox is not None: res = extract_pixbox(res, pixbox, wrap=wrap)
	if geometry is not None: res = extract(res, geometry[0], geometry[1], wrap=wrap)
	if not delayed and isinstance(res, _MapProxy): res = res.read()
	return res


def read_map(fname, fmt=None, sel=None, box=None, pixbox=None, geometry=None, wrap="auto", mode=None,
		sel_threshold=10e6, wcs=None, hdu=None, delayed=False, verbose=False, address=None, *, device="cuda"):
	"""A map from a FITS, HDF5 or .npy file, on device (pixell_tpu.enmap.
	read_map). The file name may end in a slice, as 'file.fits:[0,:100]';
	sel, box, pixbox and geometry select as read_helper does, and read only
	what they keep. With delayed, a FITS map not yet selected down comes
	back as its proxy (ndmap_proxy_fits). mode, sel_threshold and verbose
	are accepted and ignored, as there."""
	toks = fname.split(":")
	fname = toks[0]
	fsel = utils.parse_slice(":".join(toks[1:])) if len(toks) > 1 else None
	fmt = _map_format(fname, fmt)
	if fmt == "fits": res = ndmap_proxy_fits(fname, hdu=hdu, wcs=wcs, device=device)
	elif fmt == "hdf": res = ndmap_proxy_hdf(fname, address=address, wcs=wcs, device=device)
	elif fmt == "npy": res = read_npy(fname, wcs=wcs, device=device)
	else: raise ValueError("Unrecognized format '%s'" % fmt)
	if fsel is not None: res = res[fsel]
	return read_helper(res, sel=sel, box=box, pixbox=pixbox, geometry=geometry, wrap=wrap,
		delayed=delayed and fmt == "fits")


def write_map(fname, emap, fmt=None, address=None, extra={}, allow_modify=False):
	"""A map to a FITS, HDF5 or .npy file by its extension (FITS where it has
	none of them; pixell_tpu.enmap.write_map)."""
	fmt = _map_format(fname, fmt)
	if   fmt == "fits": write_fits(fname, emap, extra=extra)
	elif fmt == "hdf":  write_hdf(fname, emap, address=address, extra=extra)
	elif fmt == "npy":  write_npy(fname, emap, extra=extra)
	else: raise ValueError("Unrecognized format '%s'" % fmt)


def read_map_geometry(fname, fmt=None, hdu=None, address=None):
	"""(shape, wcs) of a map file, without its data."""
	fname = fname.split(":")[0]
	fmt = _map_format(fname, fmt)
	if fmt == "fits": return read_fits_geometry(fname, hdu=hdu)
	if fmt == "hdf":
		import h5py
		with h5py.File(fname, "r") as f:
			grp = f[address] if address else f
			return tuple(grp["data"].shape), _wcs_from_hdf(grp)
	raise ValueError("Unrecognized format '%s'" % fmt)


def read_map_dtype(fname, fmt=None, hdu=None, address=None):
	"""The numpy dtype of a map file's data."""
	if _map_format(fname.split(":")[0], fmt) == "hdf": return read_hdf_dtype(fname, address=address)
	return read_fits_dtype(fname, hdu=hdu)


def write_fits(fname, emap, extra={}):
	hdr = emap.wcs.to_header() if isinstance(emap, ndmap) else {}
	hdr.update(extra)
	from . import fits_io
	fits_io.write_map(fname, _host_array(emap), hdr)


def read_fits(fname, hdu=None, wcs=None, *, device="cuda"):
	return ndmap_proxy_fits(fname, hdu=hdu, wcs=wcs, device=device).read()


def write_hdf(fname, emap, address=None, extra={}):
	"""A map to HDF5: its data as "data", its wcs as "wcs_" attributes."""
	import h5py
	with h5py.File(fname, "w") as f:
		grp = f.create_group(address) if address else f
		grp["data"] = _host_array(emap)
		if isinstance(emap, ndmap):
			for k, v in emap.wcs.to_header().items():
				grp.attrs["wcs_" + k] = v
		for k, v in extra.items(): grp[k] = v


def _wcs_from_hdf(grp):
	hdr = {k[4:]: (v.decode() if isinstance(v, bytes) else v) for k, v in grp.attrs.items()
		if k.startswith("wcs_")}
	return wcsutils.WCS(header=hdr)


def read_hdf(fname, address=None, wcs=None, *, device="cuda"):
	return ndmap_proxy_hdf(fname, address=address, wcs=wcs, device=device).read()


def write_npy(fname, emap, extra={}):
	np.save(fname, _host_array(emap))


def _npy_header(f):
	"""(shape, fortran order, dtype) of an open .npy file, left at its data."""
	version = np.lib.format.read_magic(f)
	read = np.lib.format.read_array_header_1_0 if version == (1, 0) else np.lib.format.read_array_header_2_0
	return read(f)


def read_npy(fname, wcs=None, *, device="cuda"):
	"""A .npy map, read into one host buffer and copied to device (a plain
	wcs unless given)."""
	if wcs is None: wcs = wcsutils.WCS(naxis=2)
	with open(fname, "rb") as f:
		shape, fortran, dtype = _npy_header(f)
		if fortran or dtype.hasobject:
			return ndmap(torch.from_numpy(np.ascontiguousarray(np.load(fname))).to(device), wcs)
		host = _host_buffer(shape, dtype.newbyteorder("="), device)
		arr = host.numpy()
		if arr.nbytes and f.readinto(memoryview(arr.reshape(-1)).cast("B")) != arr.nbytes:
			raise IOError("%s: truncated data" % fname)
	if not dtype.isnative: arr.byteswap(inplace=True)
	return ndmap(_to_device(host, device), wcs)


def fix_endian(map):
	"""map in native byte order: a numpy array converted where it is not
	(a tensor always is)."""
	if isinstance(map, np.ndarray) and not map.dtype.isnative:
		return map.astype(map.dtype.newbyteorder("="))
	return map


def get_stokes_flips(hdr):
	"""The component axis to sign-flip for the IAU / HEALPix polarization
	convention: none, -1, as pixell_tpu.enmap.get_stokes_flips gives."""
	return -1


def read_fits_header(fname, hdu=None, quick=True):
	"""The header dict of the map's HDU."""
	from . import fits_io
	return fits_io.read_header(fname, hdu=hdu or 0)[1]


def read_fits_geometry(fname, hdu=None, quick=True):
	"""(shape, wcs) of a FITS map, from its header."""
	from . import fits_io
	shape, hdr = fits_io.read_header(fname, hdu=hdu or 0)
	return shape, wcsutils.WCS(header=hdr)


def read_fits_dtype(fname, hdu=None, quick=True):
	"""The numpy type of a FITS map's data (by its BITPIX)."""
	return {8: np.uint8, 16: np.int16, 32: np.int32, 64: np.int64, -32: np.float32,
		-64: np.float64}[int(read_fits_header(fname, hdu=hdu)["BITPIX"])]


def read_hdf_geometry(fname, address=None):
	"""(shape, wcs) of an HDF5 map, from its "wcs_" attributes as write_hdf
	stores them. (pixell_tpu.enmap.read_hdf_geometry reads a "wcs" group
	its write_hdf does not write, and gives a plain wcs: ROADMAP Queue 3.)"""
	return read_map_geometry(fname, fmt="hdf", address=address)


def read_hdf_dtype(fname, address=None):
	import h5py
	with h5py.File(fname, "r") as f:
		return (f[address] if address else f)["data"].dtype


def write_fits_geometry(fname, shape, wcs):
	"""A FITS header of the geometry with no data, which
	read_fits_geometry and read_map_geometry read. (pixell_tpu.enmap.
	write_fits_geometry passes an argument its writer does not take and
	raises TypeError: ROADMAP Queue 3.)"""
	from . import fits_io
	fits_io.write_header(fname, shape, wcs.to_header())


def write_map_geometry(fname, shape, wcs, fmt=None):
	if fmt is None: fmt = "fits"
	if fmt != "fits": raise NotImplementedError("Only fits geometry output supported")
	write_fits_geometry(fname, shape, wcs)


def parse_slice(s):
	"""A slice written as a string, like '[0,:10,::2]', as a tuple of ints
	and slices (pixell_tpu.enmap.parse_slice)."""
	s = s.strip()
	if not (s.startswith("[") and s.endswith("]")):
		raise ValueError("Invalid slice format")
	if "None" in s or "..." in s or "newaxis" in s:
		raise NotImplementedError
	out = []
	for part in (s[1:-1].split(",") if s[1:-1] else []):
		part = part.strip()
		if ":" in part: out.append(slice(*[int(x) if x else None for x in part.split(":")]))
		elif part: out.append(int(part))
		else: out.append(slice(None))
	return tuple(out)
