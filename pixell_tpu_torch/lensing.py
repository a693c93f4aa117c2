"""Gravitational lensing of CMB maps (counterpart of pixell_tpu/lensing.py).

The flat sky: displace_map, lens_map and delens_map interpolate the map at
its pixels moved by the deflection field (interpol.map_coordinates), the
pixel positions built on the map's device; grad_phi_flat takes the
potential's gradient by enmap.fft / ifft with the l map on the device;
phi_to_kappa and kappa_to_phi filter alm.

The curved sky: lens_map_curved keeps the reference's structure. One
deriv=True alm2map gives the deflection field on the map's geometry (and
one alm2map each the outputs "p", "k" and "u"); one curvedsky.SynthesisPlan
builds the torus's fine grid once; then the point stage runs in dec bands
of delta_theta, the reference's band sizes with the tail band overlapping
the one before (so banded and unbanded results are the same). In each
band the pixel positions (the posaxes broadcast where the geometry is
separable, else its posmap rows), the geodesic offset and the
parallel-transport cos 2 gamma, sin 2 gamma are computed on the device in
float64, whatever the map's dtype, and SynthesisPlan.eval takes them as
(colat, ra): the binning's keys (K12) and the point evaluation (K10) read
float64 coordinates and split them into a fine-grid base and a fraction
themselves. Only the separable geometry's two axes come from the host; a
non-separable one's posmap rows are computed there.

Not ported, TPU workarounds: _lens_band_core's fused jit (:138) and its
host split of each position into an int32 fine-pixel base and a float32
fraction (:305-311, :394-411), which K10 makes in float64; the gather-free
_lens_band_rowband (:188) with fft._u2nu_rowband_core and ROWBAND_MAX_NXS
(:216), written because the TPU's gathers were slow (K10 reads each
point's window from the fine grid): point_eval "auto", "gather" and
"rowband" all run K10; the utils.cached_jit keys (:262-266). mesh= (a
DeviceMesh, parallel.mesh) runs the SHTs over the mesh (curvedsky.alm2map
(mesh=)) and splits each band's point work over the ranks by rows, the
fine grid replicated, as the reference's _lens_band_core (:151-170): each
rank runs K12 / K10 on its own rows, and an all-gather puts the band
together.

Functions that take arrays put numpy input on device="cuda" unless told
otherwise; tensors and maps stay where they are.
"""
from __future__ import annotations
import numpy as np
import torch
from . import enmap, curvedsky, interpol, utils, wcsutils
from .parallel import mesh as pmesh, sht_dist

POINT_EVALS = ("auto", "gather", "rowband")   # lens_map_curved's point_eval: all run K10


def _as_torch(x):
	"""(x as a tensor, whether it was host data): ndmaps give their data."""
	if isinstance(x, enmap.ndmap): return x.data, False
	if isinstance(x, torch.Tensor): return x, False
	return torch.from_numpy(np.asarray(x, np.float64)), True


def _back(x, host):
	return x.cpu().numpy() if host else x


# ---------------------------------------------------------------------------
# The flat sky (pixell_tpu/lensing.py:22-80)
# ---------------------------------------------------------------------------
def displace_map(imap, pix, order=3, trans=False, deriv=False, border="cyclic"):
	"""imap evaluated at the pixel positions pix [2, ...] by an order
	spline (pixell_tpu.lensing.displace_map :22); with deriv its gradient
	[..., 2, ...], with trans the transpose."""
	arr = imap.data if isinstance(imap, enmap.ndmap) else imap
	pix = enmap._tensor(pix, arr.device).to(arr.device)
	res = interpol.map_coordinates(arr, pix.reshape(2, -1), order=order, border=border, trans=trans,
		deriv=deriv)
	if not trans: res = res.reshape(res.shape[:-1] + tuple(pix.shape[1:]))
	return enmap.samewcs(res, imap)


def _pixshape(shape, wcs, device):
	"""pixshapemap(signed=True) [2, ny, nx] on device: broadcast from the
	host's [2, ny] where the geometry is separable."""
	if wcsutils.is_separable(wcs):
		hw = torch.from_numpy(enmap.pixshapes_cyl(shape, wcs, signed=True)).to(device)
		return hw[:, :, None].expand((2,) + tuple(shape[-2:]))
	return enmap.pixshapemap(shape, wcs, signed=True, device=device).data


def _pixels(shape, wcs, grad):
	"""The map's pixel positions moved by grad [2, ny, nx] (radians)."""
	pix = enmap.pixmap(shape[-2:], device=grad.device).to(torch.float64)
	return pix + grad/_pixshape(shape, wcs, grad.device)


def lens_map(imap, grad_phi, order=3, trans=False, deriv=False, border="cyclic"):
	"""imap lensed by the deflection field grad_phi [2, ny, nx] in radians
	(pixell_tpu.lensing.lens_map :33)."""
	grad = enmap._tensor(grad_phi, imap.device).to(imap.device)
	return displace_map(imap, _pixels(imap.shape, imap.wcs, grad), order=order, trans=trans,
		deriv=deriv, border=border)


def delens_map(imap, grad_phi, nstep=3, order=3, border="cyclic"):
	"""The inverse of lens_map: the displacement grad0 with grad0(x) =
	grad(x + grad0(x)) by nstep fixed-point steps, then lens_map by
	-grad0 (pixell_tpu.lensing.delens_map :41)."""
	grad = enmap._tensor(grad_phi, imap.device).to(imap.device, torch.float64)
	grad0 = grad
	for _ in range(nstep):
		pix = _pixels(imap.shape, imap.wcs, grad0)
		grad0 = interpol.map_coordinates(grad, pix.reshape(2, -1), order=order, border=border
			).reshape(grad.shape)
	return lens_map(imap, -grad0, order=order, border=border)


def grad_phi_flat(phi_map):
	"""The gradient [{d/dy, d/dx}, ny, nx] of a flat-sky potential by FFT
	(pixell_tpu.lensing.grad_phi_flat :54)."""
	f = enmap.fft(phi_map).data
	l = enmap.lmap(phi_map.shape, phi_map.wcs, device=f.device).data
	gy = enmap.ifft(enmap.samewcs(f*(1j*l[0]), phi_map)).data.real
	gx = enmap.ifft(enmap.samewcs(f*(1j*l[1]), phi_map)).data.real
	return enmap.ndmap(torch.stack([gy, gx]), phi_map.wcs)


def lens_map_flat(cmb_map, phi_map, order=3):
	"""A flat-sky map lensed by the potential phi (pixell_tpu.lensing.
	lens_map_flat :62)."""
	return lens_map(cmb_map, grad_phi_flat(phi_map), order=order)


def phi_to_kappa(phi_alm, phi_ainfo=None, *, device="cuda"):
	"""kappa_lm = l (l + 1)/2 phi_lm (pixell_tpu.lensing.phi_to_kappa :67)."""
	alm = enmap._tensor(phi_alm, device)
	if phi_ainfo is None: phi_ainfo = curvedsky.alm_info(nalm=alm.shape[-1])
	l = np.arange(phi_ainfo.lmax+1, dtype=float)
	return curvedsky.almxfl(alm, l*(l+1)/2, ainfo=phi_ainfo)


def kappa_to_phi(kappa_alm, ainfo=None, *, device="cuda"):
	"""phi_lm = 2 kappa_lm/(l (l + 1)), 0 at l = 0 (pixell_tpu.lensing.
	kappa_to_phi :74)."""
	alm = enmap._tensor(kappa_alm, device)
	if ainfo is None: ainfo = curvedsky.alm_info(nalm=alm.shape[-1])
	l = np.arange(ainfo.lmax+1, dtype=float)
	with np.errstate(divide="ignore"):
		fl = np.where(l > 0, 2/(l*(l+1)), 0)
	return curvedsky.almxfl(alm, fl, ainfo=ainfo)


def delens_grad(grad_phi, nstep=3, order=3, mode="spline", border="cyclic"):
	"""The undisplaced gradient of a self-displaced one by nstep fixed-point
	steps (pixell_tpu.lensing.delens_grad :449); mode is accepted and
	ignored, as in the reference."""
	alpha = grad_phi
	for _ in range(nstep):
		alpha = lens_map(grad_phi, -alpha, order=order, border=border)
	return alpha


# ---------------------------------------------------------------------------
# The curved sky (pixell_tpu/lensing.py:86-136, :220-491)
# ---------------------------------------------------------------------------
def offset_by_grad(ipos, grad, pol=None, geodesic=True):
	"""Positions ipos [{dec, ra}, ...] moved along the gradient field grad
	[{d/ddec, d/dra}, ...] by its length, along the geodesic unless not
	geodesic (pixell_tpu.lensing.offset_by_grad :86): [{dec, ra}, ...], with
	pol [{dec, ra, cos 2 gamma, sin 2 gamma}, ...], gamma the rotation of
	the local north by parallel transport. Tensors stay on their device (in
	their dtype); numpy gives numpy."""
	(pos, host), (g, _) = _as_torch(ipos), _as_torch(grad)
	g = g.to(pos.device, pos.dtype)
	dec, ra = pos[0], pos[1]
	cosdec = torch.cos(dec)
	# grad is (d/ddec, d/dra): the physical east component is d/dra / cos dec
	dn = g[0]
	de = g[1]/torch.clamp(cosdec.abs(), min=1e-15)*torch.sign(cosdec + 1e-300)
	alpha = torch.sqrt(dn*dn + de*de)
	small = alpha < 1e-15
	alpha_s = torch.where(small, 1e-15, alpha)
	# bearing from north, clockwise towards east
	cb = dn/alpha_s
	sb = de/alpha_s
	if geodesic:
		sdec, cdec = torch.sin(dec), cosdec
		sa, ca = torch.sin(alpha_s), torch.cos(alpha_s)
		dec2 = torch.arcsin(torch.clamp(sdec*ca + cdec*sa*cb, -1, 1))
		ra2 = ra + torch.arctan2(sb*sa, ca*cdec - sa*sdec*cb)
	else:
		dec2 = dec + dn
		ra2 = ra + g[1]/torch.clamp(cosdec, min=1e-15)
	dec2 = torch.where(small, dec, dec2)
	ra2 = torch.where(small, ra, ra2)
	if not pol: return _back(torch.stack([dec2, ra2]), host)
	# the bearing at the destination back towards the start against the
	# departure bearing: their mismatch (less the U-turn pi) rotates the
	# local north axis
	sdec1, cdec1 = torch.sin(dec), cosdec
	sdec2, cdec2 = torch.sin(dec2), torch.cos(dec2)
	dra2 = ra2 - ra
	b_back = torch.arctan2(-torch.sin(dra2)*cdec1, cdec2*sdec1 - sdec2*cdec1*torch.cos(dra2))
	b_fwd = torch.arctan2(de, dn)
	gamma = torch.where(small, 0.0, (np.pi + b_back) - b_fwd)
	return _back(torch.stack([dec2, ra2, torch.cos(2*gamma), torch.sin(2*gamma)]), host)


def offset_by_grad_helper(ipos, grad, pol):
	"""Geodesic offset of positions ipos [{theta, phi}, n] by the gradient
	grad [2, n], with pol also the parallel-transport rotation's (cos,
	sin) (pixell_tpu.lensing.offset_by_grad_helper :457): (positions, rot
	or None). Tensors stay on their device; numpy gives numpy."""
	(pos, host), (g, _) = _as_torch(ipos), _as_torch(grad)
	g = g.to(pos.device, pos.dtype).clone()
	g[:, (g == 0).all(0)] = 1e-20
	d = torch.sqrt(torch.sum(g*g, 0))
	g = g/d
	cosd, sind = torch.cos(d), torch.sin(d)
	cost, sint = torch.cos(pos[0]), torch.sin(pos[0])
	ocost = cosd*cost - sind*sint*g[0]
	osint = torch.sqrt(1 - ocost*ocost)
	ophi = pos[1] + torch.arcsin(sind*g[1]/torch.clamp(osint, min=1e-300))
	opos = torch.stack([torch.arccos(torch.clamp(ocost, -1, 1)), ophi])
	if not pol: return _back(opos, host), None
	A = torch.nan_to_num(g[1]/(sind*cost/torch.clamp(sint, min=1e-300) + g[0]*cosd))
	nom1 = g[0] + g[1]*A
	denom = 1 + A*A
	rot = torch.stack([2*nom1*nom1/denom - 1, 2*nom1*(g[1] - g[0]*A)/denom])
	return _back(opos, host), _back(rot, host)


def pole_wrap(pos):
	"""Latitudes beyond a pole mirrored back over it, the longitude turned
	by pi (pixell_tpu.lensing.pole_wrap :481); a copy, numpy or tensor as
	pos is."""
	p, host = _as_torch(pos)
	p = p.clone()
	for lim in (np.pi/2, -np.pi/2):
		bad = p[0] > lim if lim > 0 else p[0] < lim
		p[0] = torch.where(bad, 2*lim - p[0], p[0])
		p[1] = torch.where(bad, p[1] + np.pi, p[1])
	return _back(p, host)


def _alm(a, ctype, device):
	"""alm as a tensor of ctype: a tensor on its device, host data on device."""
	return enmap._tensor(a, device).to(ctype)


def _band_size(ny, wcs, delta_theta):
	"""Rows of a dec band: delta_theta's, made so that no tiny band is left
	at the end (pixell_tpu/lensing.py:287-293)."""
	if delta_theta is None: return ny
	bsize = max(1, int(utils.nint(abs(delta_theta/utils.degree/wcs.wcs.cdelt[1]))))
	nblock = max(ny//bsize, 1)
	return min(max(int(ny/(nblock + 0.5)), 1), ny)


def _band_points(grad, pos, pol, geodesic):
	"""(loc [npt, 2] = (colat, ra), offset_by_grad's rows) of the positions
	pos [{dec, ra}, nb, nx] (float64) moved by grad [2, nb, nx]."""
	opos = offset_by_grad(pos, grad.to(torch.float64), pol=pol, geodesic=geodesic)
	return torch.stack([np.pi/2 - opos[0], opos[1]], -1).reshape(-1, 2), opos


def _rotate_band(band, opos):
	"""Q, U (components 1 and 2) of band [..., ncomp, nb, nx] rotated by the
	parallel transport's cos 2 gamma, sin 2 gamma (opos[2], opos[3]), in place."""
	c2, s2 = opos[2].to(band.dtype), opos[3].to(band.dtype)
	q, u = band[..., 1, :, :], band[..., 2, :, :]
	band[..., 1, :, :], band[..., 2, :, :] = c2*q - s2*u, s2*q + c2*u
	return band


def _band_positions(wcs, shape, i1, i2, device, axes=None):
	"""The pixel positions [{dec, ra}, i2 - i1, nx] of rows i1:i2, float64 on
	device: axes = (dec, ra) broadcast where the geometry is separable,
	else the rows' posmap."""
	if axes is not None: return torch.stack(torch.broadcast_tensors(axes[0][i1:i2, None], axes[1][None, :]))
	lshape, lwcs = enmap.slice_geometry(tuple(shape), wcs, (slice(i1, i2), slice(None)))
	return enmap.posmap(lshape, lwcs, safe=False, device=device).data


def _bands(ny, bsize):
	"""(i1, i2, first new row) of each band: the tail band starts early,
	overlapping rows already done, so that every band has bsize rows."""
	done = 0
	while done < ny:
		i1 = done if done + bsize <= ny else max(ny - bsize, 0)
		i2 = min(i1 + bsize, ny)
		yield i1, i2, done - i1
		done = i2


def _pos_axes(shape, wcs, device):
	"""(dec [ny], ra [nx]) float64 on device where the geometry is
	separable, else None."""
	if not wcsutils.is_separable(wcs): return None
	return tuple(torch.from_numpy(np.asarray(a, np.float64)).to(device)
		for a in enmap.posaxes(tuple(shape), wcs, safe=False))


def _lens_bands(splan, grad, wcs, bsize, pol, geodesic, polrot, rdt, verbose=False, mesh=None,
		pre=()):
	"""The point stage of lens_map_curved: the lensed map [..., ny, nx] of
	rdt, band by band (_bands): positions moved by grad [2, ny, nx] on the
	device, splan's values there (K12, K10), Q and U rotated where polrot.
	With mesh, each rank takes its block of each band's rows (the mesh's
	first axis) and the band's rows [*pre, nb, nx] are gathered."""
	shape = tuple(grad.shape[-2:])
	axes = _pos_axes(shape, wcs, grad.device)
	parts = []
	for i1, i2, skip in _bands(shape[0], bsize):
		j1, j2 = i1, i2
		if mesh is not None:
			r0, r1 = pmesh.block(i2 - i1, *pmesh.axis_size(mesh, mesh.mesh_dim_names[0]))
			j1, j2 = i1 + r0, i1 + r1
		if j2 > j1:
			pos = _band_positions(wcs, shape, j1, j2, grad.device, axes)
			loc, opos = _band_points(grad[:, j1:j2, :], pos, pol, geodesic)
			vals = splan.eval(loc)
			band = vals.reshape(vals.shape[:-1] + tuple(pos.shape[-2:]))
			if polrot: band = _rotate_band(band, opos)
			band = band.to(rdt)
		else:
			band = torch.zeros(tuple(pre) + (0, shape[1]), dtype=rdt, device=grad.device)
		if mesh is not None:
			band = sht_dist._dtensor(band.contiguous(), mesh, {mesh.mesh_dim_names[0]: band.ndim - 2},
				band.shape[:-2] + (i2 - i1, shape[1])).full_tensor()
		parts.append(band[..., skip:, :])
		if verbose: print("lens band %d / %d" % (i2, shape[0]))
	return torch.cat(parts, -2) if len(parts) > 1 else parts[0]


def lens_map_curved(shape=None, wcs=None, phi_alm=None, cmb_alm=None, phi_ainfo=None, maplmax=None,
		dtype=np.float64, oversample=2.0, spin=[0, 2], output="l", geodesic=True, verbose=False,
		delta_theta=None, epsilon=None, pol=None, mesh=None, point_eval="auto", *, device="cuda"):
	"""cmb_alm lensed by the potential phi_alm onto the geometry (shape,
	wcs) (pixell_tpu.lensing.lens_map_curved :220). output, a string of
	"l" (lensed), "u" (unlensed), "p" (phi), "k" (convergence) and "a" (the
	deflection field [2, ny, nx]): the maps in that order, one alone. dtype
	sets the maps' precision (the alm are cast to its complex type).
	delta_theta: the height of the dec bands of the point stage; epsilon:
	the NUFFT's accuracy (SynthesisPlan's default by dtype); pol: rotate Q
	and U by the parallel transport (by default where cmb_alm has more than
	one component; done where it has at least three). maplmax and
	oversample are accepted and ignored, as in the reference. mesh, a
	DeviceMesh: the SHTs over the mesh, the point work split by rows
	(_lens_bands); every rank gets the whole maps."""
	mesh = pmesh.check(mesh)
	if point_eval not in POINT_EVALS:
		raise ValueError("point_eval must be one of %s, not %r" % (POINT_EVALS, point_eval))
	rdt = enmap._torch_dtype(dtype)
	ctype = torch.complex64 if rdt == torch.float32 else torch.complex128
	phi_alm = _alm(phi_alm, ctype, device)
	cmb_alm = _alm(cmb_alm, ctype, phi_alm.device)
	dev = phi_alm.device
	if phi_ainfo is None: phi_ainfo = curvedsky.alm_info(nalm=phi_alm.shape[-1])
	cmb_ainfo = curvedsky.alm_info(nalm=cmb_alm.shape[-1])
	ncomp = cmb_alm.shape[0] if cmb_alm.ndim > 1 else 1
	pol = ncomp > 1 if pol is None else pol
	pre = () if cmb_alm.ndim == 1 else (ncomp,)
	ny, nx = int(shape[-2]), int(shape[-1])
	want = set(output)
	maps = {}
	def synth(a, ainfo, pshape, **kw):
		return curvedsky.alm2map(a, enmap.zeros(tuple(pshape) + (ny, nx), wcs, rdt, device=dev),
			ainfo=ainfo, mesh=mesh, **kw).data
	grad = None
	if "l" in want or "a" in want:
		grad = synth(phi_alm, phi_ainfo, (2,), deriv=True)
		if verbose: print("lens: gradient SHT done")
	if "a" in want: maps["a"] = enmap.ndmap(grad, wcs)
	if "p" in want: maps["p"] = enmap.ndmap(synth(phi_alm, phi_ainfo, ()), wcs)
	if "k" in want:
		maps["k"] = enmap.ndmap(synth(phi_to_kappa(phi_alm, phi_ainfo=phi_ainfo), phi_ainfo, ()), wcs)
	if "u" in want: maps["u"] = enmap.ndmap(synth(cmb_alm, cmb_ainfo, pre, spin=spin), wcs)
	if "l" in want:
		# the torus's fine grid, built once for every band
		splan = curvedsky.SynthesisPlan(cmb_alm, lmax=cmb_ainfo.lmax, spin=spin, epsilon=epsilon)
		if verbose: print("lens: synthesis plan built")
		lmap = _lens_bands(splan, grad, wcs, _band_size(ny, wcs, delta_theta), bool(pol), bool(geodesic),
			bool(pol) and ncomp >= 3, rdt, verbose, mesh, pre)
		del splan
		maps["l"] = enmap.ndmap(lmap, wcs)
	res = [maps[c] for c in output if c in maps]
	return res[0] if len(res) == 1 else tuple(res)


def rand_alm(ps_lensinput, lmax=None, dtype=np.float64, seed=None, phi_seed=None, verbose=False,
		ps_mask=None, *, device="cuda"):
	"""(phi_alm, cmb_alm) drawn from the joint [phi, T, E, B] spectrum
	ps_lensinput (pixell_tpu.lensing.rand_alm :425): one draw of all four
	with seed, or phi from phi_seed and the CMB from seed. curvedsky.rand_alm
	draws the reference's numpy numbers (and returns complex128 for either
	dtype, as the reference's does)."""
	ps = np.asarray(ps_lensinput)
	ctype = torch.complex64 if enmap._torch_dtype(dtype) == torch.float32 else torch.complex128
	if phi_seed is None:
		alm = curvedsky.rand_alm(ps, lmax=lmax, seed=seed, dtype=ctype, device=device)
		return alm[0], alm[1:]
	phi_alm = curvedsky.rand_alm(ps[0, 0], lmax=lmax, seed=phi_seed, dtype=ctype, device=device)
	cmb_alm = curvedsky.rand_alm(ps[1:, 1:], lmax=lmax, seed=seed, dtype=ctype, device=device)
	return phi_alm, cmb_alm


def rand_map(shape, wcs, ps_lensinput, lmax=None, maplmax=None, dtype=np.float64, seed=None,
		phi_seed=None, oversample=2.0, spin=[0, 2], output="l", geodesic=True, verbose=False,
		delta_theta=None, *, device="cuda"):
	"""A lensed CMB simulation, rand_alm then lens_map_curved
	(pixell_tpu.lensing.rand_map :438)."""
	phi_alm, cmb_alm = rand_alm(ps_lensinput, lmax=lmax, dtype=dtype, seed=seed, phi_seed=phi_seed,
		device=device)
	return lens_map_curved(shape=shape, wcs=wcs, phi_alm=phi_alm, cmb_alm=cmb_alm, maplmax=maplmax,
		dtype=dtype, oversample=oversample, spin=spin, output=output, geodesic=geodesic,
		verbose=verbose, delta_theta=delta_theta)
