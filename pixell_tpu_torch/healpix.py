"""HEALPix geometry in RING ordering (counterpart of pixell_tpu/healpix.py).

The ring structure, pix <-> ang and the pixel centres are host numpy, bit
for bit the reference's. ang2pix is its nearest-ring approximation, not
healpy's exact assignment. positions and get_interpol also have a device
form, for the spline reprojection: positions(nside, device=...) builds the
pixel centres on the device, and get_interpol given tensors computes the
weights on their device, so that no map-sized host array is made per call.
"""
from __future__ import annotations
import functools
import numpy as np
import torch


def npix(nside): return 12*nside*nside

def nside2npix(nside): return npix(nside)

def npix2nside(n):
	res = int(round((n/12)**0.5))
	if 12*res*res != n: raise ValueError("Invalid healpix pixel count %d" % n)
	return res

@functools.lru_cache(maxsize=16)
def ring_info(nside):
	"""Per-ring structure: a dict of arrays over the 4*nside-1 rings: theta
	(colatitude of the ring), nphi (pixels in the ring), phi0 (phi of its
	first pixel centre), start (index of its first pixel), and nring
	(pixell_tpu.healpix.ring_info). Cached: callers must not write into it."""
	n = int(nside)
	nring = 4*n - 1
	i = np.arange(1, nring+1)
	theta = np.empty(nring)
	nphi = np.empty(nring, int)
	phi0 = np.empty(nring)
	# north polar cap: i = 1..n-1
	cap = i < n
	icap = i[cap]
	theta[cap] = np.arccos(1 - icap**2/(3.0*n*n))
	nphi[cap] = 4*icap
	phi0[cap] = np.pi/(4*icap)
	# equatorial belt: n <= i <= 3n, phi = pi/(2n) (j + s/2) with s = (i - n + 1) mod 2
	belt = (i >= n) & (i <= 3*n)
	ibelt = i[belt]
	theta[belt] = np.arccos(4.0/3 - 2.0*ibelt/(3*n))
	nphi[belt] = 4*n
	s = (ibelt - n + 1) % 2
	phi0[belt] = np.pi/(2.0*n)*(s*0.5)
	# south polar cap
	south = i > 3*n
	isouth = 4*n - i[south]
	theta[south] = np.pi - np.arccos(1 - isouth**2/(3.0*n*n))
	nphi[south] = 4*isouth
	phi0[south] = np.pi/(4*isouth)
	start = np.concatenate([[0], np.cumsum(nphi)[:-1]])
	return dict(theta=theta, nphi=nphi, phi0=phi0, start=start, nring=nring)

def pix2ang(nside, ipix):
	"""RING pixel index -> (theta, phi)."""
	info = ring_info(nside)
	ipix = np.asarray(ipix)
	ring = np.searchsorted(info["start"], ipix, side="right") - 1
	j = ipix - info["start"][ring]
	theta = info["theta"][ring]
	phi = info["phi0"][ring] + j*2*np.pi/info["nphi"][ring]
	return theta, phi

def ang2pix(nside, theta, phi):
	"""(theta, phi) -> RING pixel index: the nearest ring, then the nearest
	pixel centre on it (the reference's approximation, adequate for
	nearest-pixel lookups; not healpy's exact pixel boundaries)."""
	info = ring_info(nside)
	theta = np.asarray(theta); phi = np.asarray(phi) % (2*np.pi)
	ring = np.searchsorted(info["theta"], theta)
	ring = np.clip(ring, 0, info["nring"]-1)
	prev = np.clip(ring-1, 0, info["nring"]-1)
	closer_prev = np.abs(info["theta"][prev]-theta) < np.abs(info["theta"][ring]-theta)
	ring = np.where(closer_prev, prev, ring)
	nphi = info["nphi"][ring]
	j = np.round((phi - info["phi0"][ring])/(2*np.pi)*nphi).astype(int) % nphi
	return info["start"][ring] + j

def positions(nside, *, device=None):
	"""(theta[npix], phi[npix]) of all pixel centres in RING order: numpy
	(the reference's), or float64 tensors built on device when one is
	given."""
	if device is not None: return _positions_on(int(nside), torch.device(device))
	info = ring_info(nside)
	theta = np.repeat(info["theta"], info["nphi"])
	j = np.concatenate([np.arange(n) for n in info["nphi"]])
	phi = np.repeat(info["phi0"], info["nphi"]) + j*2*np.pi/np.repeat(info["nphi"], info["nphi"])
	return theta, phi

@functools.lru_cache(maxsize=2)
def _positions_on(nside, device):
	"""positions(nside) built on device with the host's arithmetic, so bit
	for bit equal to it; cached for the last two (callers must not write
	into them)."""
	info = ring_info(nside)
	ring = _ring_tables(nside, device)
	r = torch.repeat_interleave(torch.arange(info["nring"], device=device), ring.nphi)
	nphi = ring.nphi[r]
	j = torch.arange(npix(nside), device=device) - ring.start[r]
	return ring.theta[r], ring.phi0[r] + (j*2).to(torch.float64)*np.pi/nphi

class _Rings:
	"""ring_info's arrays as tensors on one device."""
	def __init__(self, nside, device):
		info = ring_info(nside)
		for k in ("theta", "phi0"):
			setattr(self, k, torch.from_numpy(info[k]).to(device))
		for k in ("nphi", "start"):
			setattr(self, k, torch.from_numpy(info[k].astype(np.int64)).to(device))
		self.nring = info["nring"]

@functools.lru_cache(maxsize=4)
def _ring_tables(nside, device):
	return _Rings(nside, device)

def pixsize(nside):
	return 4*np.pi/npix(nside)

def get_interpol(nside, theta, phi):
	"""Bilinear interpolation weights on the healpix grid: (pix[4, n],
	weights[4, n]) like healpy.get_interp_weights (ring scheme), from the
	two rings around each point and two pixels on each. Numpy as the
	reference; given tensors, int64 / float64 tensors on their device."""
	if isinstance(theta, torch.Tensor): return _get_interpol_on(nside, theta, phi)
	info = ring_info(nside)
	theta = np.atleast_1d(theta); phi = np.atleast_1d(phi) % (2*np.pi)
	th = info["theta"]
	r1 = np.clip(np.searchsorted(th, theta) - 1, 0, info["nring"]-1)
	r2 = np.clip(r1 + 1, 0, info["nring"]-1)
	t1, t2 = th[r1], th[r2]
	wy = np.where(r2 != r1, (theta - t1)/np.where(t2 != t1, t2 - t1, 1), 0.0)
	wy = np.clip(wy, 0, 1)
	pixs = np.empty((4, len(theta)), int)
	wts = np.empty((4, len(theta)))
	for k, (ring, wrow) in enumerate([(r1, 1-wy), (r2, wy)]):
		nphi = info["nphi"][ring]
		x = (phi - info["phi0"][ring])/(2*np.pi)*nphi
		j1 = np.floor(x).astype(int)
		fx = x - j1
		pixs[2*k]   = info["start"][ring] + (j1 % nphi)
		pixs[2*k+1] = info["start"][ring] + ((j1+1) % nphi)
		wts[2*k]    = wrow*(1-fx)
		wts[2*k+1]  = wrow*fx
	return pixs, wts

def _get_interpol_on(nside, theta, phi):
	"""get_interpol of float64 tensors, on their device, with the host
	version's arithmetic."""
	ring = _ring_tables(int(nside), theta.device)
	theta = theta.to(torch.float64).reshape(-1)
	phi = torch.remainder(phi.to(torch.float64).reshape(-1), 2*np.pi)
	th = ring.theta
	r1 = (torch.searchsorted(th, theta) - 1).clamp_(0, ring.nring-1)
	r2 = (r1 + 1).clamp_(0, ring.nring-1)
	t1, t2 = th[r1], th[r2]
	wy = torch.where(r2 != r1, (theta - t1)/torch.where(t2 != t1, t2 - t1, 1.0), 0.0).clamp_(0, 1)
	pixs, wts = [], []
	for r, wrow in ((r1, 1 - wy), (r2, wy)):
		nphi = ring.nphi[r]
		x = (phi - ring.phi0[r])/(2*np.pi)*nphi
		j1 = torch.floor(x)
		fx = x - j1
		j1 = j1.to(torch.int64)
		pixs += [ring.start[r] + torch.remainder(j1, nphi), ring.start[r] + torch.remainder(j1 + 1, nphi)]
		wts += [wrow*(1 - fx), wrow*fx]
	return torch.stack(pixs), torch.stack(wts)
