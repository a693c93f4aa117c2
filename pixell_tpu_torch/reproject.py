"""Reprojection between pixelizations: CAR <-> HEALPix, thumbnails and
rotations (counterpart of pixell_tpu/reproject.py).

The HEALPix synthesis (alm2map_healpix, method "ring") runs on the ring
structure: the Legendre stage (sht.synthesis_phase, the hand-written K1 /
K3 kernels on the card) gives each of the 4 nside - 1 rings' phases
G[m, ring]; the belt rings (4 nside pixels, first pixel at phi 0 or
pi/(4 nside)) are then sampled exactly by sht.ring_synthesis, one call per
offset; the polar-cap rings (4 i pixels, a ragged set) by one batched
irfft of G times the ES correction onto N = 4 nside k columns, the phi
wrap pad, and a w-tap 1D ES interpolation at each cap pixel (w 7 in
float32, 11 in float64: epsilon 1e-6 / 1e-10), a gather and a multiply-add
a tap in plain torch. k is the least for which the band's oversampling
N/(2 mmax + 1) is at least SIGMA_MIN: the reference's k = ceil((mmax +
1)/(2 nside)) only makes N cover the band, and below an oversampling of
~1.5 the ES interpolation loses its epsilon (1e-5 of the largest value at
lmax = 2 nside - 1 in float64). Where the reference's N reaches SIGMA_MIN
the two are the same. The reference takes the phases from the rfft of a
synthesized [N]-column grid and chunks the gather through lax.map;
neither is ported. Its
transpose (_healpix_ring_adjoint, which the reference takes by jax.vjp)
is written out stage by stage: the gather's transpose by index_add_, the
wrap pad folded back, the correction and the rings' rfft, the belt's
ring_analysis, then sht.adjoint_synthesis_phase (K2 / K4). Method
"general" runs through curvedsky.synthesis_general and
adjoint_synthesis_general (K10, K11).

Everything that returns a map or alm is a tensor on the input's device
(numpy inputs go to device="cuda" unless told otherwise); the ring tables
are cached on the device per (nside, mmax, w, dtype). thumbnails recenters
every object's stamp in one batched float64 rotation on the device and
interpolates them all in one enmap.at call. rot= turns the alm through
curvedsky.rotate_alm ("harm") or the positions through
coordinates.transform ("spline").
"""
from __future__ import annotations
import functools
import numpy as np
import torch
from . import enmap, curvedsky, utils, coordinates, healpix, sht
from . import fft as enfft
from .bunch import Bunch
from .ops.nufft_core import es_kernel


def map2healpix(imap, nside=0, lmax=None, out=None, rot=None, spin=[0, 2],
		method="harm", order=3, extensive=False, bsize=100000, nside_mode="pow2",
		boundary="constant", verbose=False, niter=0):
	"""Project an ndmap onto a HEALPix map (RING), [..., npix] on the map's
	device (pixell_tpu.reproject.map2healpix). method "harm": map2alm, the
	alm rotated by rot ("isys,osys"), then alm2map_healpix's ring synthesis;
	method "spline": the map interpolated (order, boundary) at the HEALPix
	pixel centres, transformed by rot, all on the device. out, bsize and
	verbose are accepted and ignored, as in the reference."""
	if nside in [0, None]:
		res = min(np.abs(np.asarray(imap.wcs.wcs.cdelt)))*utils.degree
		nside_raw = int(np.ceil((np.pi/3)**0.5/res))
		nside = 1 << int(np.ceil(np.log2(max(nside_raw, 1)))) if nside_mode == "pow2" else nside_raw
		nside = restrict_nside(nside, imap.shape, imap.wcs)
	nside = int(nside)
	if method == "harm":
		if lmax is None: lmax = min(3*nside - 1, curvedsky.get_lmax_from_map(imap))
		alm = curvedsky.map2alm(imap, lmax=lmax, spin=spin, niter=niter)
		if rot is not None:
			alm = _rotate_alm_sys(alm, rot, spin=spin)
		res = _alm2map_healpix_ring(alm, nside, lmax=lmax, mmax=lmax, spin=spin)
	else:
		theta, phi = healpix.positions(nside, device=imap.device)
		pos = torch.stack([np.pi/2 - theta, phi])
		if rot is not None:
			isys, osys = _parse_rot(rot)
			pos = coordinates.transform(osys, isys, pos.flip(0)).flip(0)
		res = enmap.at(imap, pos, order=order, border=boundary)
	if extensive:
		res = res*(healpix.pixsize(nside)/enmap.pixsize(imap.shape, imap.wcs))
	return res

def healpix2map(ihealmap, shape=None, wcs=None, lmax=None, out=None, rot=None,
		spin=[0, 2], method="harm", order=3, extensive=False, bsize=100000,
		verbose=False, niter=0, *, device="cuda"):
	"""Project a HEALPix map [..., npix] onto an ndmap of geometry (shape,
	wcs) (pixell_tpu.reproject.healpix2map). method "harm": map2alm_healpix,
	rot, then curvedsky.alm2map onto a map of the HEALPix map's dtype;
	method "spline": bilinear interpolation (healpix.get_interpol's 4 taps,
	float64 weights) at the geometry's pixel centres transformed by rot, on
	the device. order, out, bsize and verbose are accepted and ignored."""
	ihealmap = enmap._tensor(ihealmap, device)
	flat = ihealmap.reshape(-1, ihealmap.shape[-1])
	nside = healpix.npix2nside(flat.shape[-1])
	oshape = tuple(ihealmap.shape[:-1]) + tuple(shape[-2:])
	if method == "harm":
		if lmax is None: lmax = 3*nside - 1
		alm = map2alm_healpix(ihealmap, lmax=lmax, spin=spin, niter=niter)
		if rot is not None:
			alm = _rotate_alm_sys(alm, rot, spin=spin)
		omap = enmap.zeros(oshape, wcs, ihealmap.dtype, device=ihealmap.device)
		res = curvedsky.alm2map(alm, omap, spin=spin)
	else:
		pos = enmap.posmap(shape, wcs, safe=False, device=ihealmap.device).data
		dec, ra = pos[0].reshape(-1), pos[1].reshape(-1)
		if rot is not None:
			isys, osys = _parse_rot(rot)
			ra, dec = coordinates.transform(osys, isys, torch.stack([ra, dec]))
		pix, w = healpix.get_interpol(nside, np.pi/2 - dec, torch.remainder(ra, 2*np.pi))
		vals = flat.index_select(1, pix[0])*w[0]
		for k in range(1, 4): vals += flat.index_select(1, pix[k])*w[k]
		res = enmap.ndmap(vals.reshape(oshape), wcs)
	if extensive:
		res = res*(enmap.pixsize(shape, wcs)/healpix.pixsize(nside))
	return res

def alm2map_healpix(alm, healmap=None, nside=None, spin=[0, 2], deriv=False,
		ainfo=None, method="ring", *, device="cuda"):
	"""Synthesize alm [..., nalm] onto a HEALPix RING map [..., npix] (deriv:
	[2, npix], d/dtheta and d/dphi) on the alm's device
	(pixell_tpu.reproject.alm2map_healpix); healmap, if given, only says the
	nside. method "ring" (default) runs on the HEALPix ring structure (see
	the module's docstring), "general" through curvedsky.synthesis_general
	at the pixel centres."""
	alm = enmap._tensor(alm, device)
	if ainfo is None: ainfo = curvedsky.alm_info(nalm=alm.shape[-1])
	if nside is None: nside = healpix.npix2nside(healmap.shape[-1])
	if method == "ring":
		return _alm2map_healpix_ring(alm, int(nside), lmax=ainfo.lmax, mmax=ainfo.mmax, spin=spin,
			deriv=deriv)
	return curvedsky.synthesis_general(alm, _healpix_loc(int(nside), alm.device), lmax=ainfo.lmax,
		spin=spin, deriv=deriv)

def _healpix_loc(nside, device):
	"""The pixel centres (theta, phi) [npix, 2], float64 on device."""
	return torch.stack(healpix.positions(nside, device=device), -1)


# ---------------------------------------------------------------------------
# Ring-structured HEALPix synthesis and its transpose
# ---------------------------------------------------------------------------
def _hpix_ring_geom(nside, mmax, w, ndt, device):
	"""The ring synthesis's tables for (nside, mmax, w, numpy real dtype) on device,
	cached (callers must not write into them): N, k, the ring colatitudes,
	the belt's rows by first-pixel offset, and per cap pixel (in HEALPix
	order, north cap then south) the flat index of its first tap in the
	padded cap rows [ncap, N + w] and its fine-grid fraction."""
	return _hpix_ring_geom_cached(int(nside), int(mmax), int(w), ndt, torch.device(device))

SIGMA_MIN = 1.55   # least oversampling N/(2 mmax + 1) of the caps' fine rows

@functools.lru_cache(maxsize=4)
def _hpix_ring_geom_cached(n, mmax, w, ndt, device):
	info = healpix.ring_info(n)
	nring = 4*n - 1
	# N: a multiple of 4n, oversampling the band -mmax .. mmax by SIGMA_MIN or
	# more (the ES kernel of _es_params holds its epsilon from ~1.55 up)
	k = max(int(np.ceil(SIGMA_MIN*(2*mmax + 1)/(4.0*n))), 1)
	N = 4*n*k
	belt = info["nphi"] == 4*n
	brow0 = int(np.nonzero(belt)[0][0])
	nbelt = int(belt.sum())
	brows = np.arange(brow0, brow0 + nbelt)
	belt_groups = [(float(phi0), torch.from_numpy(np.nonzero(info["phi0"][brows] == phi0)[0]).to(device))
		for phi0 in np.unique(info["phi0"][brows])]
	crow = np.nonzero(~belt)[0]
	nph = info["nphi"][crow]
	row = np.repeat(np.arange(len(crow)), nph)
	j = np.arange(int(nph.sum())) - np.repeat(np.cumsum(nph) - nph, nph)
	x = (np.repeat(info["phi0"][crow], nph) + 2*np.pi*j/np.repeat(nph, nph))*N/(2*np.pi)
	ixb = np.floor(x)
	fx = torch.from_numpy((x - ixb).astype(ndt)).to(device)
	t = torch.floor(fx - w/2.0)
	ix0 = torch.remainder(torch.from_numpy(ixb.astype(np.int64)).to(device) + t.to(torch.int64) + 1, N)
	return Bunch(N=N, k=k, nring=nring, theta=info["theta"], npix=int(info["nphi"].sum()),
		brow0=brow0, nbelt=nbelt, belt_groups=belt_groups, crow=torch.from_numpy(crow).to(device),
		ncap=len(crow), npt_north=int(info["nphi"][:brow0].sum()),
		start=torch.from_numpy(row).to(device)*(N + w) + ix0, fx=fx)

def _es_taps(geom, w, beta):
	"""The cap pixels' ES weights [w, npt], in the tables' dtype, with the
	reference's arithmetic."""
	fx = geom.fx
	hw = w/2.0
	t = torch.floor(fx - hw)
	offs = torch.arange(w, dtype=fx.dtype, device=fx.device)[:, None]
	return es_kernel((fx[None] - (t[None] + 1 + offs))/hw, beta)

def _ring_params(cdt):
	"""(real dtype, numpy real dtype, w, beta) of a complex dtype: the ES
	kernel of epsilon 1e-6 in float32, 1e-10 in float64."""
	rdt = torch.float32 if cdt == torch.complex64 else torch.float64
	w, beta = enfft._es_params(1e-6 if rdt == torch.float32 else 1e-10)
	return rdt, (np.float32 if rdt == torch.float32 else np.float64), w, beta

def _belt_synthesis(G, geom, n):
	"""The belt rings' pixels [B, nbelt*4n] from the phases G [B, nm, nring]:
	sht.ring_synthesis per first-pixel offset, exact."""
	belt = G.real.new_empty((G.shape[0], geom.nbelt, 4*n))
	for phi0, rows in geom.belt_groups:
		belt[:, rows] = sht.ring_synthesis(G[..., geom.brow0 + rows], phi0, 4*n)
	return belt.reshape(G.shape[0], -1)

def _cap_fine(G, geom, corr, w):
	"""The cap rings' fine rows, deconvolved by the ES correction and wrap
	padded: [B, ncap*(N + w)] from the phases G [B, nm, nring]."""
	fine = sht.ring_synthesis(G[..., geom.crow]*corr[:, None], 0.0, geom.N)
	return torch.cat([fine, fine[..., :w]], -1).reshape(G.shape[0], -1)

def _cap_gather(fine, geom, wx):
	"""The cap pixels' values [B, npt]: sum_j fine[start + j] wx[j]."""
	out = fine.index_select(1, geom.start)*wx[0]
	for j in range(1, wx.shape[0]):
		out.addcmul_(fine.index_select(1, geom.start + j), wx[j])
	return out

def _cap_gather_t(capv, geom, wx):
	"""The transpose of _cap_gather: capv [B, npt] spread onto the padded
	fine rows [B, ncap*(N + w)] by index_add_."""
	fine = capv.new_zeros((capv.shape[0], geom.ncap*(geom.N + wx.shape[0])))
	for j in range(wx.shape[0]):
		fine.index_add_(1, geom.start + j, capv*wx[j])
	return fine

def _phases(alm, lmax, mmax, spin, deriv, geom):
	"""The Legendre stage: the rings' phases [B, nm, nring] and the output's
	leading shape."""
	alm2 = alm if (deriv or alm.ndim > 1) else alm[None]
	G = sht.synthesis_phase(alm2, geom.theta, lmax, mmax, spin=spin if not deriv else (0,), deriv=deriv)
	return G.reshape((-1,) + tuple(G.shape[-2:])), tuple(G.shape[:-2])

def _alm2map_healpix_ring(alm, nside, lmax, mmax, spin, deriv=False):
	"""The ring-structured HEALPix synthesis (see the module's docstring):
	alm [..., nalm] -> [..., npix]; deriv: [nalm] -> [2, npix]."""
	rdt, ndt, w, beta = _ring_params(alm.dtype)
	geom = _hpix_ring_geom(nside, mmax, w, ndt, alm.device)
	G, pre = _phases(alm, lmax, mmax, spin, deriv, geom)
	corr = enfft._correction_on(geom.N, w, beta, rdt, alm.device)[:mmax+1]
	belt = _belt_synthesis(G, geom, nside)
	capv = _cap_gather(_cap_fine(G, geom, corr, w), geom, _es_taps(geom, w, beta))
	del G
	nn = geom.npt_north
	out = torch.cat([capv[:, :nn], belt, capv[:, nn:]], -1).reshape(pre + (geom.npix,))
	return out[0] if alm.ndim == 1 and not deriv else out

def _healpix_ring_adjoint(vals, nside, lmax, mmax, spin):
	"""The exact transpose of _alm2map_healpix_ring over the real and
	imaginary parts of the alm (the reference's jax.vjp), written out:
	vals [..., npix] -> alm [..., nalm], with the real-map m > 0 doubling."""
	rdt = vals.dtype
	_, ndt, w, beta = _ring_params(sht._CDTYPE[rdt])
	geom = _hpix_ring_geom(nside, mmax, w, ndt, vals.device)
	nm, n, nn = mmax + 1, int(nside), geom.npt_north
	pre = tuple(vals.shape[:-1])
	v = vals.reshape(-1, vals.shape[-1])
	nb = geom.nbelt*4*n
	capv = torch.cat([v[:, :nn], v[:, nn+nb:]], -1)
	pad = _cap_gather_t(capv, geom, _es_taps(geom, w, beta)).view(-1, geom.ncap, geom.N + w)
	fine = pad[..., :geom.N].clone()
	fine[..., :w] += pad[..., geom.N:]
	del pad
	corr = enfft._correction_on(geom.N, w, beta, rdt, vals.device)[:nm]
	F = torch.zeros((v.shape[0], nm, geom.nring), dtype=sht._CDTYPE[rdt], device=vals.device)
	F[..., geom.crow] = sht.ring_analysis(fine, 0.0, nm)*corr[:, None]
	del fine
	belt = v[:, nn:nn+nb].reshape(-1, geom.nbelt, 4*n)
	for phi0, rows in geom.belt_groups:
		F[..., geom.brow0 + rows] = sht.ring_analysis(belt[:, rows], phi0, nm)
	alm = sht.adjoint_synthesis_phase(F.reshape((pre or (1,)) + (nm, geom.nring)), geom.theta, lmax, mmax,
		spin=spin)
	return alm if pre else alm[0]

def map2alm_healpix(healmap, alm=None, lmax=None, spin=[0, 2], niter=0,
		ainfo=None, method="ring", *, device="cuda"):
	"""Analyse a HEALPix RING map [..., npix] into alm [..., nalm] on its
	device, with uniform pixel-area weights and niter Jacobi steps
	(pixell_tpu.reproject.map2alm_healpix): the exact transpose of the
	matching synthesis (method "ring" or "general"), its m > 0 doubling
	undone. alm is accepted and ignored, as in the reference."""
	healmap = enmap._tensor(healmap, device)
	nside = healpix.npix2nside(healmap.shape[-1])
	if lmax is None: lmax = 3*nside - 1
	if ainfo is None: ainfo = curvedsky.alm_info(lmax=lmax)
	w = healpix.pixsize(nside)
	spin = tuple(np.atleast_1d(spin))
	if method == "ring":
		def analyse(m):
			a = _healpix_ring_adjoint(m*w, nside, lmax=ainfo.lmax, mmax=ainfo.mmax, spin=spin)
			return sht._undo_m_degeneracy(a, ainfo.lmax, ainfo.mmax)
	else:
		loc = _healpix_loc(nside, healmap.device)
		def analyse(m):
			a = curvedsky.adjoint_synthesis_general(m*w, loc, lmax=ainfo.lmax, mmax=ainfo.mmax, spin=spin)
			return sht._undo_m_degeneracy(a, ainfo.lmax, ainfo.mmax)
	res = analyse(healmap)
	for it in range(niter):
		resid = healmap - alm2map_healpix(res, nside=nside, spin=spin, ainfo=ainfo, method=method)
		res = res + analyse(resid)
	return res


# ---------------------------------------------------------------------------
# Rotations between coordinate systems
# ---------------------------------------------------------------------------
def _parse_rot(rot):
	if rot is None: return None, None
	toks = rot.split(",")
	return toks[0], toks[1]

def _rotate_alm_sys(alm, rot, spin=[0, 2]):
	"""Rotate alm between coordinate systems given as 'isys,osys'."""
	isys, osys = _parse_rot(rot)
	R = coordinates._get_mat(coordinates.getsys(isys), coordinates.getsys(osys))
	# the zyz Euler angles of R
	beta = np.arccos(np.clip(R[2, 2], -1, 1))
	if abs(np.sin(beta)) > 1e-12:
		alpha = np.arctan2(R[1, 2], R[0, 2])
		gamma = np.arctan2(R[2, 1], -R[2, 0])
	else:
		alpha = np.arctan2(R[1, 0], R[0, 0]); gamma = 0.0
	# field rotation by R: g(n) = f(R^-1 n) with R = Rz(alpha) Ry(beta) Rz(gamma)
	return curvedsky.rotate_alm(alm, gamma, beta, alpha)

def rot2euler(rot):
	return _parse_rot(rot)

def restrict_nside(nside, shape, wcs, bound=4):
	"""Cap nside so healpix pixels aren't absurdly smaller than map pixels
	(pixell_tpu.reproject.restrict_nside)."""
	res = min(np.abs(np.asarray(wcs.wcs.cdelt)))*utils.degree
	max_nside = int((np.pi/3)**0.5/res*bound)
	p = 1
	while p*2 <= max_nside: p *= 2
	return min(nside, p)


# ---------------------------------------------------------------------------
# Thumbnails
# ---------------------------------------------------------------------------
_META_OFFSET = 5e-7   # coordinates.transform_meta's finite offset in ra

def _recentered(coords, opos, pol, device):
	"""The stamp positions opos [{dec, ra}, npix] recentered on each object
	coords [nobj, {dec, ra}]: [{dec, ra}, nobj, npix] float64 on device,
	and with pol the polarization angle [nobj, npix]. Each object's
	rotation is coordinates.recenter's to [0, 0, ra0, dec0] (Rz(ra0)
	Ry(-dec0)), applied to all objects at once element by element, so an
	object's result does not depend on the batch. The angle is
	coordinates.transform_meta's: the direction from each rotated point to
	the rotated point 5e-7 rad further in ra; the two points' difference is
	taken without cancellation (the offset's exact vector, rotated, and the
	differences of ra and dec by the atan2 subtraction identities), so that
	it holds to the last bits where the reference's subtraction of two
	rotated positions loses ~1e-10 rad."""
	R = torch.from_numpy(coordinates.euler_mat([coords[:, 1], 0.0 - coords[:, 0], -np.zeros(len(coords))])
		).to(device)[:, :, :, None]   # [nobj, 3, 3, 1]
	def rotate(v):
		v = torch.from_numpy(v).to(device)   # [3, npix]
		return [R[:, i, 0]*v[0] + R[:, i, 1]*v[1] + R[:, i, 2]*v[2] for i in range(3)]
	ra, dec = opos[1], opos[0]
	x, y, z = rotate(utils.ang2rect(np.stack([ra, dec])))
	r = torch.sqrt(x*x + y*y)
	oang = None
	if pol:
		h = _META_OFFSET/2
		c = 2*np.sin(h)*np.cos(dec)
		dx, dy, dz = rotate(np.stack([-c*np.sin(ra + h), c*np.cos(ra + h), 0*ra]))
		x2, y2 = x + dx, y + dy
		r2 = torch.sqrt(x2*x2 + y2*y2)
		dr = (2*(x*dx + y*dy) + dx*dx + dy*dy)/(r + r2)
		dra = torch.atan2(x*dy - y*dx, x*x2 + y*y2)
		ddec = torch.atan2(dz*r - z*dr, r*r2 + z*(z + dz))
		oang = torch.atan2(ddec, dra*(r/torch.sqrt(r*r + z*z)))
	return torch.stack([torch.atan2(z, r), torch.atan2(y, x)]), oang

def thumbnails(imap, coords, r=5*utils.arcmin, res=None, proj="tan", apod=2*utils.arcmin,
		order=3, oversample=4, pol=None, oshape=None, owcs=None, extensive=False,
		verbose=False, filter=None, pixwin=False, pixwin_order=0):
	"""Re-centered postage stamps [nobj, ..., ny, nx] of imap around
	coords [nobj, {dec, ra}] (pixell_tpu.reproject.thumbnails): each stamp
	a tangent-plane map (or oshape, owcs) centred on its object, the map
	interpolated (order) at the stamps' positions rotated onto the object,
	and for IQU maps (or pol) Q, U rotated by the parallel-transport angle.
	All objects are recentered in one batched float64 rotation on the
	device and interpolated in one enmap.at call. As in the reference, apod,
	oversample, filter, pixwin and pixwin_order are accepted and ignored,
	and so is verbose."""
	coords = np.asarray(coords, float)
	if coords.ndim == 1: coords = coords[None]
	if res is None: res = min(np.abs(np.asarray(imap.wcs.wcs.cdelt)))*utils.degree/2
	if oshape is None:
		oshape, owcs = enmap.thumbnail_geometry(r=r, res=res, proj=proj)
	opos = enmap._posmap_np(oshape, owcs, safe=False).reshape(2, -1)
	pol = (imap.ndim >= 3 and imap.shape[-3] == 3) if pol is None else pol
	nobj = len(coords)
	ny, nx = oshape[-2:]
	pos, ang = _recentered(coords, opos, pol, imap.device)
	vals = enmap.at(imap, pos.reshape(2, -1), order=order)
	vals = vals.reshape(tuple(imap.shape[:-2]) + (nobj, ny, nx)).movedim(-3, 0)
	if pol:
		vals = enmap.rotate_pol(vals, -ang.reshape(nobj, ny, nx))
	res = enmap.ndmap(vals, owcs)
	if extensive:
		res = res*(enmap.pixsize(oshape, owcs)/enmap.pixsize(imap.shape, imap.wcs))
	return res

def thumbnails_healpix(imap, coords, **kw):
	raise NotImplementedError

def postage_stamp(inmap, ra_deg, dec_deg, width_arcmin, res_arcmin, proj="gnomonic", **kwargs):
	"""Legacy API (pixell_tpu.reproject.postage_stamp)."""
	r = width_arcmin/2*utils.arcmin
	return thumbnails(inmap, np.array([[dec_deg*utils.degree, ra_deg*utils.degree]]),
		r=r, res=res_arcmin*utils.arcmin, proj="tan", **kwargs)[0]

def centered_map(imap, res, box=None, pixbox=None, proj="tan", rpix=None, width=None,
		height=None, width_multiplier=1, **kwargs):
	"""Legacy recentered-map API: raises, as in the reference."""
	raise NotImplementedError("use thumbnails")

def rotate_map(imap, shape=None, wcs=None, pix_target=None, **kwargs):
	if shape is None: shape, wcs = imap.shape, imap.wcs
	return imap.project(shape, wcs, **kwargs)

def thumbnails_ivar(imap, coords, r=5*utils.arcmin, res=None, proj=None,
		oshape=None, owcs=None, order=1, extensive=True, verbose=False):
	"""Thumbnails for positive, local quantities like hitcounts / ivars
	(pixell_tpu.reproject.thumbnails_ivar)."""
	return thumbnails(imap, coords, r=r, res=res, proj=proj or "tan", oshape=oshape,
		owcs=owcs, order=order, oversample=1, pol=False,
		extensive=extensive, verbose=verbose, pixwin=False)

def inv_euler(euler):
	return [-euler[2], -euler[1], -euler[0]]

def distribute(N, nmax):
	"""Split N into cells no larger than nmax, as evenly as possible
	(pixell_tpu.reproject.distribute)."""
	actual_max = int(2.0*(nmax + 1)/3.0)
	numcells = max(int(round(N*1.0/actual_max)), 1)
	each_cell = [actual_max]*(numcells - 1)
	rem = N - sum(each_cell)
	if rem > 0: each_cell.append(rem)
	if sum(each_cell) != N: raise ValueError("cannot split %d into cells of at most %d" % (N, nmax))
	return each_cell

def populate(shape, wcs, ofunc, maxpixy=400, maxpixx=400, *, device="cuda"):
	"""A float64 map of geometry (shape, wcs) on device filled tile by tile
	with ofunc(oshape, owcs) (pixell_tpu.reproject.populate)."""
	out = torch.zeros(tuple(shape), dtype=torch.float64, device=device)
	Ny, Nx = shape[-2:]
	sny = 0
	for ny in distribute(Ny, maxpixy):
		eny = sny + ny
		snx = 0
		for nx in distribute(Nx, maxpixx):
			enx = snx + nx
			oshape, owcs = enmap.slice_geometry(shape, wcs, (slice(sny, eny), slice(snx, enx)))
			out[..., sny:eny, snx:enx] = enmap._tensor(ofunc(oshape, owcs), device)
			snx = enx
		sny = eny
	return enmap.ndmap(out, wcs)

# Removed in the reference too; kept as the same redirects
def healpix_from_enmap(imap, lmax, nside):
	raise RuntimeError("This function has been removed. Use reproject.map2healpix(...method='harm').")

def healpix_from_enmap_interp(imap, **kwargs):
	raise RuntimeError("This function has been removed. Use reproject.map2healpix(...method='spline').")

def enmap_from_healpix(hp_map, shape, wcs, ncomp=1, unit=1, lmax=0,
		rot="gal,equ", first=0, is_alm=False, return_alm=False, f_ell=None):
	raise RuntimeError("This function has been removed. Use reproject.healpix2map(...method='harm').")

def enmap_from_healpix_interp(hp_map, shape, wcs, rot="gal,equ", interpolate=False):
	raise RuntimeError("This function has been removed. Use reproject.healpix2map(...method='spline').")

def ivar_hp_to_cyl(hmap, shape, wcs, rot=False, do_mask=True, extensive=True):
	raise NotImplementedError("This function has been removed.")

def gnomonic_pole_wcs(shape, res):
	raise NotImplementedError("This function has been removed.")

def gnomonic_pole_geometry(width, res, height=None):
	raise NotImplementedError("This function has been removed.")

def get_rotated_pixels(shape_source, wcs_source, shape_target, wcs_target,
		inverse=False, pos_target=None, center_target=None, center_source=None):
	raise NotImplementedError("This function has been removed.")

def cutout(imap, width=None, ra=None, dec=None, pad=1, corner=False, res=None,
		npix=None, return_slice=False, sindex=None):
	raise NotImplementedError("This function has been removed.")

def rect_box(width, center=(0.0, 0.0), height=None):
	raise NotImplementedError("This function has been removed.")

def get_pixsize_rect(shape, wcs):
	raise NotImplementedError("This function has been removed.")

def rect_geometry(width, res, height=None, center=(0.0, 0.0), proj="car"):
	raise NotImplementedError("This function has been removed.")
