"""The four adjoint entries of pixell_tpu_torch.curvedsky against
pixell_tpu.curvedsky's map2alm_adjoint (its jax.vjp) and alm2map_adjoint on
geometries tests/test_torch_adjoint.py does not hold against the
reference: a "cyl" geometry (rings off every quadrature grid) in IQU, a
band with y padding, and a grid of 16 pixels a ring at lmax 12, so that
mmax >= nphi/2: the ring FFTs keep the Nyquist bin and the ring synthesis
aliases (tests/test_torch_adjoint_deriv.py: deriv and a Clenshaw-Curtis
grid). Float64, within 1e-10 of the largest reference value.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
import torch_threads  # noqa: F401  (one torch thread per xdist worker)

from pixell_tpu import enmap as jenmap, curvedsky as jcurvedsky
from pixell_tpu_torch import enmap, curvedsky
from test_torch_adjoint import LMAX, SPINS, geometry, inputs, rel, cpu_map, port_wcs

CASES = [("cyl", "IQU", False), ("band", "spin0", False), ("nyquist", "spin0", False)]


def reference_geometry(name):
	if name == "nyquist":
		shape, jwcs = jenmap.fullsky_geometry(shape=(10, 16), variant="fejer1")
		return shape, jwcs, port_wcs(jwcs)
	return geometry(name)


def check_entries(geom, spins, deriv):
	"""The four entries against the reference's two on one geometry."""
	shape, jwcs, wcs = reference_geometry(geom)
	spin, ncomp = SPINS[spins]
	m, a = inputs(shape, spin, ncomp, deriv, seed=21)
	ainfo = curvedsky.alm_info(lmax=LMAX)
	if geom == "nyquist": assert ainfo.mmax >= shape[-1]//2
	jm = np.asarray(jcurvedsky.map2alm_adjoint(a, jenmap.zeros(m.shape, jwcs), spin=spin, deriv=deriv))
	ja = np.asarray(jcurvedsky.alm2map_adjoint(jenmap.ndmap(m, jwcs), spin=spin, deriv=deriv,
		ainfo=ainfo))
	tm, ta = cpu_map(m, wcs), torch.from_numpy(a)
	got = curvedsky.map2alm_adjoint(ta, enmap.zeros(m.shape, wcs, device="cpu"), spin=spin,
		deriv=deriv)
	assert rel(got.data, jm) <= 1e-10
	got = curvedsky.map2alm(enmap.zeros(m.shape, wcs, device="cpu"), ta, spin=spin, deriv=deriv,
		adjoint=True)
	assert rel(got.data, jm) <= 1e-10
	assert rel(curvedsky.alm2map_adjoint(tm, spin=spin, deriv=deriv, ainfo=ainfo), ja) <= 1e-10
	assert rel(curvedsky.alm2map(torch.zeros_like(ta), tm, spin=spin, deriv=deriv, adjoint=True),
		ja) <= 1e-10


@pytest.mark.parametrize("geom,spins,deriv", CASES)
def test_entries_match_reference(geom, spins, deriv):
	check_entries(geom, spins, deriv)
