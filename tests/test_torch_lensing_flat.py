"""The flat-sky half of pixell_tpu_torch.lensing (displace_map, lens_map,
delens_map, grad_phi_flat, lens_map_flat, delens_grad) and phi_to_kappa /
kappa_to_phi against pixell_tpu on the CPU, with inputs made from a numpy
seed, on a 10 x 10 degree CAR patch and at lmax 24:

- float64 within 1e-12 of the largest reference value (the same spline
  sums and FFTs in another order);
- float32 (lens_map, delens_map) by the float32 rule: the port's and the
  reference's float32 results each against the reference's float64, the
  port's error within twice the reference's plus 2e-5;
- displace_map(trans=True), which raises in the reference (it flattens
  the positions, then reads the map as values of that shape), against the
  reference's map_coordinates transpose at the same positions (ROADMAP
  Queue 3).
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
import torch_threads  # noqa: F401  (one torch thread per xdist worker)

import jax.numpy as jnp
from pixell_tpu import lensing as jlensing, enmap as jenmap, interpol as jinterpol, curvedsky as jcurvedsky
from pixell_tpu_torch import lensing, enmap, curvedsky

BOX = np.array([[-5, 5], [5, -5]])*np.pi/180
SHAPE = (40, 48)
LMAX = 24
F32_TOL = 2e-5


def rel(got, want):
	got, want = np.asarray(got), np.asarray(want)
	assert got.shape == want.shape
	return np.abs(got - want).max()/np.abs(want).max()


def maps(seed, ncomp=3, dtype=np.float64):
	"""(reference map, port map, reference grad, port grad): a smooth random
	map and a deflection of a few pixels."""
	jshape, jwcs = jenmap.geometry(pos=BOX, shape=SHAPE, proj="car")
	shape, wcs = enmap.geometry(pos=BOX, shape=SHAPE, proj="car")
	rng = np.random.default_rng(seed)
	ky, kx = np.meshgrid(np.fft.fftfreq(SHAPE[0]), np.fft.fftfreq(SHAPE[1]), indexing="ij")
	smooth = lambda x: np.fft.ifft2(np.fft.fft2(x)*np.exp(-(ky**2 + kx**2)*200)).real
	m = np.array([smooth(rng.standard_normal(SHAPE)) for _ in range(ncomp)])
	m = (m/m.std()).astype(dtype)
	pix = np.abs(wcs.wcs.cdelt[0])*np.pi/180
	grad = np.array([smooth(rng.standard_normal(SHAPE)) for _ in range(2)])
	grad = 2*pix*grad/np.abs(grad).max()
	return (jenmap.ndmap(m, jwcs), enmap.ndmap(torch.from_numpy(m.copy()), wcs),
		jenmap.ndmap(grad, jwcs), enmap.ndmap(torch.from_numpy(grad.copy()), wcs))


@pytest.mark.parametrize("order,border", [(3, "cyclic"), (1, "cyclic"), (3, "nearest")])
def test_lens_map(order, border):
	jm, m, jg, g = maps(0)
	want = np.asarray(jlensing.lens_map(jm, jg, order=order, border=border))
	got = lensing.lens_map(m, g, order=order, border=border)
	assert isinstance(got, enmap.ndmap) and got.wcs == m.wcs
	assert rel(got.data, want) < 1e-12
	# displace_map at explicit pixel positions, and its transpose
	pix = np.asarray(jenmap.pixmap(jm.shape)) + np.array([[[0.3]], [[-1.7]]])
	want = np.asarray(jlensing.displace_map(jm, pix, order=order, border=border))
	assert rel(lensing.displace_map(m, torch.from_numpy(pix), order=order, border=border).data, want) < 1e-12
	# the transpose: the reference's displace_map flattens the positions and
	# then reads the map as values of that shape, and raises; it is held to
	# the reference's map_coordinates transpose at the unflattened positions
	with pytest.raises(TypeError):
		jlensing.displace_map(jm, pix, order=order, border=border, trans=True)
	want = np.asarray(jinterpol.map_coordinates(jm, pix, odata=jm, order=order, border=border, trans=True))
	got = lensing.displace_map(m, torch.from_numpy(pix), order=order, border=border, trans=True)
	assert rel(got.data, want) < 1e-12


def test_displace_map_deriv():
	"""With deriv, the gradient at each position [..., 2, ny, nx] (the
	reference reshapes it as a map and raises)."""
	jm, m, jg, g = maps(1, ncomp=1)
	pix = torch.from_numpy(np.asarray(jenmap.pixmap(jm.shape), float) + 0.25)
	got = lensing.displace_map(m[0], pix, deriv=True)
	assert tuple(got.shape) == (2,) + SHAPE
	with pytest.raises(TypeError):
		jlensing.displace_map(jm[0], pix.numpy(), deriv=True)
	from pixell_tpu_torch import interpol
	want = interpol.map_coordinates(m[0].data, pix, deriv=True)
	assert rel(got.data, want) == 0


def test_delens():
	jm, m, jg, g = maps(2)
	for nstep in (1, 3):
		want = np.asarray(jlensing.delens_map(jm, jg, nstep=nstep))
		assert rel(lensing.delens_map(m, g, nstep=nstep).data, want) < 1e-12
	want = np.asarray(jlensing.delens_grad(jg, nstep=2))
	assert rel(lensing.delens_grad(g, nstep=2).data, want) < 1e-12


def test_float32():
	jm, m, jg, g = maps(3)
	jm32, m32 = jenmap.ndmap(np.asarray(jm).astype(np.float32), jm.wcs), enmap.ndmap(m.data.float(), m.wcs)
	for name, jfun, fun in [("lens_map", lambda a: jlensing.lens_map(a, jg), lambda a: lensing.lens_map(a, g)),
			("delens_map", lambda a: jlensing.delens_map(a, jg), lambda a: lensing.delens_map(a, g))]:
		want = np.asarray(jfun(jm))
		eport = rel(fun(m32).data.double(), want)
		eref = rel(np.asarray(jfun(jm32)).astype(np.float64), want)
		assert eport <= 2*eref + F32_TOL, (name, eport, eref)


def test_grad_phi_flat_and_lens_map_flat():
	jm, m, _, _ = maps(4)
	rng = np.random.default_rng(5)
	phi = 1e-4*rng.standard_normal(SHAPE)
	jphi, tphi = jenmap.ndmap(phi, jm.wcs), enmap.ndmap(torch.from_numpy(phi), m.wcs)
	want = np.asarray(jlensing.grad_phi_flat(jphi))
	got = lensing.grad_phi_flat(tphi)
	assert rel(got.data, want) < 1e-12
	want = np.asarray(jlensing.lens_map_flat(jm, jphi))
	assert rel(lensing.lens_map_flat(m, tphi).data, want) < 1e-12


def test_phi_kappa():
	ps = 1/(1 + np.arange(LMAX + 1.0))**2
	alm = np.asarray(jcurvedsky.rand_alm(ps, lmax=LMAX, seed=6))
	ta = torch.from_numpy(alm.copy())
	kappa = lensing.phi_to_kappa(ta)
	assert rel(kappa, np.asarray(jlensing.phi_to_kappa(jnp.asarray(alm)))) < 1e-12
	back = lensing.kappa_to_phi(kappa, curvedsky.alm_info(lmax=LMAX))
	assert rel(back, np.asarray(jlensing.kappa_to_phi(jlensing.phi_to_kappa(jnp.asarray(alm))))) < 1e-12
	# l = 0 is dropped, the rest comes back
	keep = np.ones(alm.shape, bool); keep[0] = False
	assert np.abs(back.numpy()[keep] - alm[keep]).max() < 1e-12*np.abs(alm).max()
	# host alm go to device= (here the CPU)
	assert lensing.phi_to_kappa(alm, device="cpu").device.type == "cpu"
