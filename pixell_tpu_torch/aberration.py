"""Relativistic aberration and Doppler modulation of sky maps (counterpart
of pixell_tpu/aberration.py).

The observer's velocity beta towards dir deflects photon directions towards
the apex (cos t' = (cos t + beta)/(1 + beta cos t) for the angle t from
it) and modulates the observed temperature by the Doppler factor. An
Aberrator builds, once per geometry and boost, the source position of each
pixel and the polarization angle the deflection turns it by, on the map's
device in float64 (deflect: the reference's rotations and arccos in closed
form, and its finite-offset angle without the cancellation); aberrate
interpolates the map
there (interpol.map_coordinates, order 3, plain torch) and rotates Q, U. A
Modulator builds the modulation field A on the device. Operators are kept
per (geometry, boost, device) in a small cache, as the reference keeps
them.

A float32 map reads the pixel positions and the rotation as float32, as
in the reference (:97). Where the reference rotates components 1 and 2 of
the map (:122-123), the port rotates the last two, as enmap.rotate_pol
does: the same for IQU maps, not for maps with more components (a fault of
the reference, ROADMAP Queue 3). fully tests the full-sky coverage it
means; the reference's reads attributes its analyse_geometry does not set
and is always False (Queue 3).

Functions that take arrays put numpy input on device="cuda" unless told
otherwise; tensors and maps stay where they are.
"""
from __future__ import annotations
import numpy as np
import torch
from . import enmap, curvedsky, utils, coordinates, wcsutils, interpol
from . import fft as enfft

# the default direction of our motion against the CMB (the dipole), equatorial
beta = 0.001235
dir_equ = np.array([167.919, -6.936])*utils.degree   # ra, dec
dir_ecl = np.array([171.640, -11.154])*utils.degree
freq_ref = 150e9

_OPERATOR_CACHE = {}
_OPERATOR_CACHE_MAX = 8


def _xp(x):
	return torch if isinstance(x, torch.Tensor) else np


def _stack(rows):
	return torch.stack(rows) if isinstance(rows[0], torch.Tensor) else np.array(rows)


def _cached_operator(cls, key, make):
	"""The cls instance for key, made once (pixell_tpu.aberration.
	_cached_operator :28): construction is per geometry and boost, and the
	fields it holds on the device are reused by every map of that geometry.
	A bounded FIFO cache of _OPERATOR_CACHE_MAX operators."""
	full = (cls.__name__,) + key
	hit = _OPERATOR_CACHE.get(full)
	if hit is None:
		if len(_OPERATOR_CACHE) >= _OPERATOR_CACHE_MAX:
			_OPERATOR_CACHE.pop(next(iter(_OPERATOR_CACHE)))
		hit = _OPERATOR_CACHE[full] = make()
	return hit


def _map_data(imap):
	return imap.data if isinstance(imap, enmap.ndmap) else imap


def boost_map(imap, dir=None, beta=beta, pol=None, modulation="thermo", T0=utils.T_cmb, freq=freq_ref,
		boundary="wrap", order=3, recenter=False, dipole=False, aberrate=True, modulate=True, map2=None,
		return_modulation=False):
	"""imap aberrated and modulated by the velocity beta towards dir [{ra,
	dec}] (pixell_tpu.aberration.boost_map :44): with return_modulation
	also the modulation field A (None without modulate). The Aberrator and
	Modulator are cached per geometry, boost and device. recenter and map2
	are accepted and ignored, as in the reference."""
	if dir is None: dir = dir_equ
	data = _map_data(imap)
	gkey = (tuple(data.shape[-2:]), imap.wcs.deepcopy(), tuple(np.asarray(dir, float).ravel()), float(beta),
		str(data.device))
	res = imap
	A = None
	if aberrate:
		ab = _cached_operator(Aberrator, gkey + (pol, boundary, order, tuple(data.shape)),
			lambda: Aberrator(data.shape, imap.wcs, dir=dir, beta=beta, pol=pol, boundary=boundary,
				order=order, device=data.device))
		res = ab.aberrate(res)
	if modulate:
		mod = _cached_operator(Modulator, gkey + (modulation, float(T0), float(freq), bool(dipole)),
			lambda: Modulator(data.shape, imap.wcs, dir=dir, beta=beta, modulation=modulation, T0=T0,
				freq=freq, dipole=dipole, device=data.device))
		res = mod.modulate(res)
		A = mod.A
	if return_modulation: return res, A
	return res


def _pix_of(shape, wcs, pos):
	"""enmap.sky2pix(shape, wcs, pos, safe=False) of the float64 tensor pos
	[{dec, ra}, ...]: on its device for separable CAR, CEA and MER, else
	through the host."""
	if wcsutils.is_separable(wcs) and wcsutils.get_proj(wcs) in ("car", "cea", "mer"):
		return enmap._sky2pix_on(shape, wcs, pos, safe=False)
	pix = enmap.sky2pix(shape, wcs, pos.cpu().numpy(), safe=False)
	return torch.from_numpy(np.asarray(pix, np.float64)).to(pos.device)


class Aberrator:
	"""The aberration of maps of one geometry (pixell_tpu.aberration.
	Aberrator :73): each observed pixel's source position (deflect with
	-beta) and polarization angle, built on device in float64."""
	def __init__(self, shape, wcs, dir=None, beta=beta, pol=None, boundary="wrap", order=3, nofft=False, *,
			device="cuda"):
		if dir is None: dir = dir_equ
		self.shape, self.wcs = tuple(shape[-2:]), wcs
		self.beta = beta
		self.dir = np.asarray(dir)
		self.order = order
		self.boundary = boundary
		self.pol = pol
		pos = enmap.posmap(self.shape, wcs, safe=False, device=device).data
		sdec, sra, gamma = deflect(pos[0].reshape(-1), pos[1].reshape(-1), self.dir, -beta, return_rot=True)
		del pos
		self.ipos = torch.stack([sdec, sra])
		self.gamma = gamma.reshape(self.shape)
		self._pix = _pix_of(self.shape, wcs, self.ipos).reshape((2,) + self.shape)
		self._fields = {}

	def _cached(self, dtype):
		"""(pixel positions, cos 2 gamma, sin 2 gamma) for a map of dtype:
		float32 for a float32 map, float64 otherwise, made once each."""
		rdt = torch.float32 if dtype == torch.float32 else torch.float64
		if rdt not in self._fields:
			self._fields[rdt] = (self._pix.to(rdt), torch.cos(2*self.gamma).to(rdt),
				torch.sin(2*self.gamma).to(rdt))
		return self._fields[rdt]

	def aberrate(self, imap):
		"""imap [..., ny, nx] interpolated at the source positions, Q and U
		(the last two components) rotated by 2 gamma where pol (by default
		for three or more components)."""
		arr = _map_data(imap)
		pix, c2, s2 = self._cached(arr.dtype)
		if not (tuple(arr.shape[-2:]) == self.shape and imap.wcs == self.wcs):
			pix = _pix_of(arr.shape, imap.wcs, self.ipos).to(pix.dtype).reshape((2,) + self.shape)
		res = interpol.map_coordinates(arr, pix, order=self.order,
			border="cyclic" if self.boundary == "wrap" else self.boundary)
		pol = (arr.ndim >= 3 and arr.shape[-3] >= 3) if self.pol is None else self.pol
		if pol:
			# the last two components, as enmap.rotate_pol; the reference
			# rotates components 1 and 2 (pixell_tpu/aberration.py:122-123)
			q, u = res[..., -2, :, :], res[..., -1, :, :]
			res[..., -2, :, :], res[..., -1, :, :] = c2*q - s2*u, s2*q + c2*u
		return enmap.ndmap(res, imap.wcs)

	def __call__(self, imap): return self.aberrate(imap)


class Modulator:
	"""The Doppler modulation of maps of one geometry (pixell_tpu.
	aberration.Modulator :136): A = 1/(gamma (1 - beta cos t)) at the
	observed pixels, t their angle from dir, built on device in float64."""
	def __init__(self, shape, wcs, dir=None, beta=beta, modulation="thermo", T0=utils.T_cmb, freq=freq_ref,
			dipole=False, *, device="cuda"):
		if dir is None: dir = dir_equ
		self.shape, self.wcs = tuple(shape[-2:]), wcs
		self.T0, self.freq = T0, freq
		self.dipole = dipole
		self.modulation = modulation
		pos = enmap.posmap(self.shape, wcs, safe=False, device=device).data
		cost = _cos_from_dir(pos[0], pos[1], np.asarray(dir))
		gamma_l = 1/np.sqrt(1 - beta**2)
		self.A = enmap.ndmap(1.0/(gamma_l*(1 - beta*cost)), wcs)
		self._A32 = None

	def modulate(self, imap, return_dipole=None):
		"""imap times A, plus T0 (A - 1) with dipole (A as float32 for a
		float32 map)."""
		arr = _map_data(imap)
		if arr.dtype == torch.float32:
			if self._A32 is None: self._A32 = self.A.data.to(torch.float32)
			A = self._A32
		else:
			A = self.A.data
		if self.modulation in ["thermo", "freq"]:
			# the reference computes f for "freq" and never uses it (:164-165);
			# kept, so that the results are the reference's
			x = utils.h*self.freq/(utils.k*self.T0)
			f = x*(np.exp(x) + 1)/(np.exp(x) - 1) - 4 if self.modulation == "freq" else 0
		res = arr*A
		if self.dipole: res = res + self.T0*(A - 1)
		return enmap.samewcs(res, imap)

	def __call__(self, imap): return self.modulate(imap)


_META_OFFSET = 5e-7   # coordinates.transform_meta's offset, the reference's angle's


def _rotate(R, v):
	"""The 3 x 3 matrix R (numpy) times the vector v (three tensors)."""
	return [R[i, 0]*v[0] + R[i, 1]*v[1] + R[i, 2]*v[2] for i in range(3)]


def deflect(dec, ra, dir, beta, return_rot=False):
	"""The positions (dec, ra) deflected towards the apex dir [{ra, dec}]
	by cos t' = (cos t + beta)/(1 + beta cos t) (pixell_tpu.aberration.
	deflect :176); -beta inverts it. (dec', ra'), with return_rot also the
	angle the deflection turns the local east by (transform_meta's: the
	direction from the deflected point to the deflected point 5e-7 rad
	further in ra). Tensors stay on their device; numpy gives numpy; float64.

	In the frame with the apex at the north pole (coordinates.recenter's
	rotation) the deflected unit vector is (x, y, z + beta)/(1 + beta z)
	with x, y scaled by sqrt(1 - beta^2): the reference's arccos and
	decenter in closed form. The angle takes the offset point's deflected
	vector less the point's from the exact offset vector and the
	differences of the closed form's factors, and their ra and dec
	differences by the atan2 subtraction identities, so nothing cancels:
	the reference subtracts two deflected positions 5e-7 apart and loses
	~1e-9 rad, enough to make two devices disagree."""
	host = not isinstance(dec, torch.Tensor)
	dec = torch.from_numpy(np.asarray(dec, np.float64)) if host else dec.to(torch.float64)
	ra = (torch.from_numpy(np.asarray(ra, np.float64)) if host else ra.to(torch.float64)).to(dec.device)
	center = np.array([float(dir[0]), float(dir[1])])
	R = coordinates.euler_mat(coordinates._recenter_angles(center))
	Rb = coordinates.euler_mat(coordinates._decenter_angles(center))
	cd = torch.cos(dec)
	x, y, z = _rotate(R, [cd*torch.cos(ra), cd*torch.sin(ra), torch.sin(dec)])
	sb = np.sqrt(1 - beta**2)
	den = 1 + beta*z
	u = _rotate(Rb, [x*sb/den, y*sb/den, (z + beta)/den])
	r = torch.sqrt(u[0]*u[0] + u[1]*u[1])
	out = [torch.atan2(u[2], r), torch.atan2(u[1], u[0])]
	if return_rot:
		h = _META_OFFSET/2
		c = 2*np.sin(h)*cd
		dx, dy, dz = _rotate(R, [-c*torch.sin(ra + h), c*torch.cos(ra + h), torch.zeros_like(ra)])
		den1 = 1 + beta*(z + dz)
		dq = -beta*dz*sb/(den*den1)
		du = _rotate(Rb, [dx*sb/den1 + x*dq, dy*sb/den1 + y*dq, dz*(1 - beta**2)/(den*den1)])
		x2, y2 = u[0] + du[0], u[1] + du[1]
		r2 = torch.sqrt(x2*x2 + y2*y2)
		dr = (2*(u[0]*du[0] + u[1]*du[1]) + du[0]*du[0] + du[1]*du[1])/(r + r2)
		dra = torch.atan2(u[0]*du[1] - u[1]*du[0], u[0]*x2 + u[1]*y2)
		ddec = torch.atan2(du[2]*r - u[2]*dr, r*r2 + u[2]*(u[2] + du[2]))
		out.append(torch.atan2(ddec, dra*(r/torch.sqrt(r*r + u[2]*u[2]))))
	return tuple(o.numpy() for o in out) if host else tuple(out)


def calc_boost_1d(z, beta):
	"""(z_obs, A): the observed cos(theta) and the modulation for the rest
	frame's z = cos(theta) (pixell_tpu.aberration.calc_boost_1d :205);
	-beta inverts it. Host numpy."""
	z = np.asarray(z, float)
	gamma = (1 - beta**2)**-0.5
	z_obs = np.clip((z + beta)/(1 + z*beta), -1, 1)
	return z_obs, 1/(gamma*(1 - z_obs*beta))


def beta2lmax(beta, lmax0):
	"""The lmax an aberrated map of lmax0 needs (pixell_tpu.aberration.
	beta2lmax :215)."""
	return int(np.ceil(lmax0*(1 + abs(beta))*1.05))


def _cos_from_dir(dec, ra, dir):
	"""cos of the angle between (dec, ra) and the apex dir [{ra, dec}]."""
	xp = _xp(dec)
	return xp.sin(dec)*np.sin(dir[1]) + xp.cos(dec)*np.cos(dir[1])*xp.cos(ra - dir[0])


# ---------------------------------------------------------------------------
# The reference's named operations (pixell_tpu/aberration.py:230-371)
# ---------------------------------------------------------------------------
def aberrate_map(map, dir=dir_equ, beta=beta, spin=[0, 2], nthread=None, coord_dtype=None, boundary="auto"):
	"""The aberration alone (pixell_tpu.aberration.aberrate_map :230)."""
	return boost_map(map, dir=dir, beta=beta, aberrate=True, modulate=False)


def deaberrate_map(map, dir=dir_equ, beta=beta, spin=[0, 2], nthread=None, coord_dtype=None,
		boundary="auto"):
	"""aberrate_map with -beta (pixell_tpu.aberration.deaberrate_map :235)."""
	return boost_map(map, dir=dir, beta=-beta, aberrate=True, modulate=False)


def modulate_map(map, dir=dir_equ, beta=beta, modulation="T2lin", T0=utils.T_cmb, freq=150e9,
		return_modulation=False, dipole=False, map_unit=1e-6, spin=[0, 2], nthread=None):
	"""The modulation alone (pixell_tpu.aberration.modulate_map :239)."""
	return boost_map(map, dir=dir, beta=beta, aberrate=False, modulate=True, modulation=modulation, T0=T0,
		freq=freq, dipole=dipole, return_modulation=return_modulation)


def demodulate_map(map, dir=dir_equ, beta=beta, modulation="lin2T", T0=utils.T_cmb, freq=150e9,
		return_modulation=False, dipole=False, map_unit=1e-6, spin=[0, 2], nthread=None):
	"""modulate_map with -beta (pixell_tpu.aberration.demodulate_map :247)."""
	return boost_map(map, dir=dir, beta=-beta, aberrate=False, modulate=True, modulation=modulation, T0=T0,
		freq=freq, dipole=dipole, return_modulation=return_modulation)


def deboost_map(map, dir=dir_equ, beta=beta, modulation="lin2T", T0=utils.T_cmb, freq=150e9,
		return_modulation=False, dipole=False, map_unit=1e-6, spin=[0, 2], aberrate=True, modulate=True,
		nthread=None, coord_dtype=None, boundary="auto"):
	"""boost_map with -beta (pixell_tpu.aberration.deboost_map :254)."""
	return boost_map(map, dir=dir, beta=-beta, aberrate=aberrate, modulate=modulate, modulation=modulation,
		T0=T0, freq=freq, dipole=dipole, return_modulation=return_modulation)


def fully(shape, wcs, tol=0.1):
	"""Whether the geometry is a quadrature ("2d") ring set covering all
	but tol of the sky's rings in y (pixell_tpu.aberration.fully :263). The
	reference reads nphi_full and ny_full, which its analyse_geometry does
	not set, and so always answers False; the port counts the rings of the
	full grid as the map's plus its ypad."""
	minfo = curvedsky.analyse_geometry(shape, wcs)
	if minfo.case != "2d": return False
	ny_full = shape[-2] + sum(minfo.ypad)
	return abs(shape[-2]/ny_full) > 1 - tol


def calc_boost_field(beta, dir, lmax=None, nthread=None, modulation=False, mod_exp=1, *, device="cuda"):
	"""The spin-1 alm of the aberration's deflection field, and with
	modulation the spin-0 alm of A^mod_exp (pixell_tpu.aberration.
	calc_boost_field :275), by curvedsky.prof2alm on device."""
	if lmax is None: lmax = beta2lmax(beta, 1000)
	n = lmax + 2
	itheta = np.arange(n)*np.pi/(n - 1)
	oz, A = calc_boost_1d(np.cos(itheta), beta)
	dpos = np.zeros([2, n])
	dpos[0] = np.arccos(oz) - itheta
	alm = curvedsky.prof2alm(dpos, dir=dir, spin=1, device=device)
	if modulation: return alm, curvedsky.prof2alm(A**mod_exp, dir=dir, spin=0, device=device)
	return alm


def interpol_map(imap, pixs, epsilon=None, nthread=None, ydouble=False, *, device="cuda"):
	"""imap [..., ny, nx] at the fractional pixels pixs [{y, x}, ...] by the
	NUFFT (fft.interpol_nufft: K10), with ydouble the map extended by its
	mirror over the poles (rows reversed, turned by pi) for full-sky
	boundary conditions (pixell_tpu.aberration.interpol_map :294)."""
	arr = enmap._tensor(imap, device)
	if ydouble:
		mirror = torch.roll(arr.flip(-2), arr.shape[-1]//2, -1)
		arr = torch.cat([arr, mirror], -2)
	return enfft.interpol_nufft(arr, enmap._tensor(pixs, arr.device), epsilon=epsilon)


def rotate_pol(pmap, gamma, spin=2):
	"""pmap [{Q, U}, ...] rotated by gamma (pixell_tpu.aberration.rotate_pol
	:307): a list for a list, else stacked."""
	if spin == 0: return pmap
	q, u = pmap[0], pmap[1]
	xp = _xp(q)
	c, s = xp.cos(spin*gamma), xp.sin(spin*gamma)
	res = [q*c + u*s, -q*s + u*c]
	return type(pmap)(res) if isinstance(pmap, list) else _stack(res)


def apply_modulation(map, A, T0=utils.T_cmb, freq=150e9, map_unit=1e-6, mode="T2lin", dipole=False,
		spin=[0, 2]):
	"""map modulated by the field A (pixell_tpu.aberration.apply_modulation
	:317): "plain" / "T2T" multiply; "T2lin", "lin2T" and "lin2lin" convert
	between thermodynamic and linearized units at freq with the quadratic
	correction; dipole adds (A - 1) T0/map_unit to T; None / "none" return
	map."""
	if mode in [None, "none"]: return map
	arr = _map_data(map)
	Aj = enmap._tensor(A, arr.device).to(arr.device)
	if mode in ["plain", "T2T"]:
		res = arr*Aj
	elif mode in ["T2lin", "lin2T", "lin2lin"]:
		x = utils.h*freq/(utils.k*T0)
		fnl = x*(np.exp(x) + 1)/(np.exp(x) - 1) - 4
		T = arr*map_unit/T0
		if mode == "T2lin":
			# the reference's dead first value (:341), kept: the result is the next line's
			res = Aj*T
			res = Aj*T*(1 + fnl*(Aj - 1))
		elif mode == "lin2T":
			res = Aj*T*(1 - fnl*(Aj - 1))
		else:
			res = T
		res = res*T0/map_unit
	else:
		raise ValueError("Unrecognized modulation mode '%s'" % mode)
	if dipole:
		if arr.ndim >= 3: res[..., 0, :, :] += (Aj - 1)*(T0/map_unit)
		else: res = res + (Aj - 1)*(T0/map_unit)
	return enmap.samewcs(res, map) if hasattr(map, "wcs") else res


def fast_rewind(arr, period, ref=None):
	"""arr rewound by one period towards ref (period/2 by default), in
	place (pixell_tpu.aberration.fast_rewind :356)."""
	if ref is None: ref = period/2
	off = arr - ref
	# a tensor's mask in arr's dtype: torch takes float times bool as float32
	flt = (lambda m: m.to(arr.dtype)) if isinstance(arr, torch.Tensor) else (lambda m: m)
	arr -= period*flt(off >= period/2)
	arr += period*flt(off < -period/2)
	return arr


def sky2pix(shape, wcs, pos):
	"""Sky [{dec, ra}, ...] -> pixel positions, by a plain linear map for
	CAR with crval_dec = 0, else enmap.sky2pix (pixell_tpu.aberration.
	sky2pix :364). Tensors stay on their device (float64); numpy gives
	numpy."""
	typ = wcs.wcs.ctype[0][-3:]
	if typ == "CAR" and wcs.wcs.crval[1] == 0:
		return _stack([
			(pos[0] - wcs.wcs.crval[1]*utils.degree)/(wcs.wcs.cdelt[1]*utils.degree) + (wcs.wcs.crpix[1] - 1),
			(pos[1] - wcs.wcs.crval[0]*utils.degree)/(wcs.wcs.cdelt[0]*utils.degree) + (wcs.wcs.crpix[0] - 1)])
	if isinstance(pos, torch.Tensor):
		return torch.from_numpy(np.asarray(enmap.sky2pix(shape, wcs, pos.cpu().numpy()), np.float64)
			).to(pos.device)
	return np.asarray(enmap.sky2pix(shape, wcs, pos))
