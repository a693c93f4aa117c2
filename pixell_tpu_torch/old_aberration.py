"""The deprecated aberration interface (counterpart of
pixell_tpu/old_aberration.py): aliases of aberration's operations and the
legacy closed-form helpers remap, distortion, aber_angle, mod_amplitude,
aber_deriv, planck and inv_planck. The position transforms run on the
port's coordinates.transform (a tensor of positions stays on its device in
float64); the helpers take numpy arrays or tensors alike.

apply_aberration reads remap's rows as [ra, dec(, angle)] and looks the
pixels up at [dec, ra], as enmap.sky2pix takes them; the reference passes
[ra, dec] to sky2pix (:77), which reads them as [dec, ra] (ROADMAP Queue 3).
"""
import numpy as np
import torch
from .aberration import *  # noqa: F401,F403 (the reference re-exports aberration's names)
from .aberration import aberrate_map, deaberrate_map, beta, dir_equ, _xp
from . import coordinates, utils, enmap, interpol


def aberrate(imap, dir=None, beta=beta, **kw):
	"""The legacy name of aberrate_map (pixell_tpu.old_aberration.aberrate :12)."""
	return aberrate_map(imap, dir=dir if dir is not None else dir_equ, beta=beta)


def deaberrate(imap, dir=None, beta=beta, **kw):
	return deaberrate_map(imap, dir=dir if dir is not None else dir_equ, beta=beta)


def aber_angle(theta, beta):
	"""The zenith angle of a point of the deflected sky for the zenith angle
	theta of the undeflected one (pixell_tpu.old_aberration.aber_angle :20)."""
	xp = _xp(theta)
	c = xp.cos(theta)
	gamma = (1 - beta**2)**-0.5
	c = (c + (gamma - 1)*c + gamma*beta)/(gamma*(1 + c*beta))
	return xp.arccos(xp.clip(c, -1, 1))


def mod_amplitude(theta, beta):
	"""The Doppler modulation at zenith angle theta (pixell_tpu.
	old_aberration.mod_amplitude :28)."""
	c = _xp(theta).cos(theta)
	gamma = (1 - beta**2)**-0.5
	return 1/(gamma*(1 - c*beta))


def aber_deriv(theta, beta):
	"""The derivative of the aberration displacement (pixell_tpu.
	old_aberration.aber_deriv :35)."""
	B = 1 - beta**2
	C = 1 - beta*_xp(theta).cos(theta)
	return B**0.5/C


def _positions(pos):
	"""pos [{ra, dec}, ...] as float64: a tensor on its device, else numpy."""
	if isinstance(pos, torch.Tensor): return pos.to(torch.float64)
	return np.asarray(pos, float)


def _array(x):
	return x.clone() if isinstance(x, torch.Tensor) else np.array(x)


def remap(pos, dir, beta, pol=True, modulation=True, recenter=False):
	"""The aberration-deflected positions of pos [{ra, dec}, ...] for the
	boost beta towards dir: [{ra, dec}], with pol a row of the polarization
	rotation, with modulation a last row of the modulation (pixell_tpu.
	old_aberration.remap :43)."""
	pos = _array(coordinates.transform("equ", ["equ", [dir, False]], _positions(pos), pol=pol))
	xp = _xp(pos)
	if recenter: before = xp.mean(pos[1, ::10])
	# -beta: the original position from the deflected one
	pos[1] = np.pi/2 - aber_angle(np.pi/2 - pos[1], -beta)
	if recenter:
		after = xp.mean(pos[1, ::10])
		pos[1] -= after - before
	res = coordinates.transform(["equ", [dir, False]], "equ", pos, pol=pol)
	if modulation:
		amp = mod_amplitude(np.pi/2 - pos[1], beta)
		res = torch.cat([res, amp[None]]) if xp is torch else np.concatenate([res, [amp]])
	return res


def distortion(pos, dir, beta):
	"""The local distortion of the aberration (pixell_tpu.old_aberration.
	distortion :63)."""
	pos = coordinates.transform("equ", ["equ", [dir, False]], _positions(pos), pol=True)
	return aber_deriv(np.pi/2 - pos[1], -beta) - 1


def apply_aberration(imap, ipos, boundary="wrap", order=3):
	"""imap interpolated at the remapped positions ipos [{ra, dec}(, angle),
	...] (remap's rows), and with an angle row and three or more components
	Q, U (the last two) rotated by it (pixell_tpu.old_aberration.
	apply_aberration :71). The pixels are looked up at [dec, ra]."""
	pos = ipos.cpu().numpy() if isinstance(ipos, torch.Tensor) else np.asarray(ipos, float)
	pix = enmap.sky2pix(imap.shape, imap.wcs, pos[1::-1])
	arr = imap.data
	vals = interpol.map_coordinates(arr, torch.from_numpy(np.ascontiguousarray(pix)).to(arr.device), order=order,
		border=boundary)
	if pos.shape[0] > 2 and vals.ndim > 2 and vals.shape[-3] >= 3:
		ang = torch.from_numpy(np.ascontiguousarray(pos[2])).to(arr.device)
		c, s = torch.cos(2*ang), torch.sin(2*ang)
		q, u = vals[..., -2, :, :], vals[..., -1, :, :]
		vals[..., -2, :, :], vals[..., -1, :, :] = c*q + s*u, -s*q + c*u
	return enmap.samewcs(vals, imap)


def calc_boost(pos, dir, beta, pol=True, recenter=False):
	"""remap without the modulation row (pixell_tpu.old_aberration.
	calc_boost :91)."""
	return remap(pos, dir, beta, pol=pol, modulation=False, recenter=recenter)


def planck(nu, T, deriv=False):
	"""The Planck spectrum at frequency nu and temperature T, with deriv its
	derivative by T (pixell_tpu.old_aberration.planck :96)."""
	xp = _xp(T) if isinstance(T, torch.Tensor) else _xp(nu)
	a = utils.h*nu/(utils.k*T)
	I = 2*utils.h*nu**3/utils.c**2/(xp.exp(a) - 1)
	if deriv: return I*a*xp.exp(a)/(xp.exp(a) - 1)/T
	return I


def inv_planck(nu, I, T0=utils.T_cmb, niter=5):
	"""The temperature of the intensity I at nu by niter Newton steps from
	T0 (pixell_tpu.old_aberration.inv_planck :104)."""
	T = T0*(torch.ones_like(I, dtype=torch.float64) if isinstance(I, torch.Tensor) else
		np.ones_like(np.asarray(I, float)))
	for _ in range(niter):
		T = T - (planck(nu, T) - I)/planck(nu, T, deriv=True)
	return T
