"""The four adjoint entries of pixell_tpu_torch.curvedsky against
pixell_tpu.curvedsky's map2alm_adjoint (its jax.vjp) and alm2map_adjoint
with deriv (a gradient map [2, ny, nx] and one alm) on the full-sky
Fejer-1 grid and on a "cyl" geometry, and in spin 0 on a Clenshaw-Curtis
grid, whose pole rings the torus shares. Float64, within 1e-10 of the
largest reference value.
"""
import pytest

pytest.importorskip("torch")
import torch_threads  # noqa: F401  (one torch thread per xdist worker)

from test_torch_adjoint_geometries import check_entries


@pytest.mark.parametrize("geom,spins,deriv", [("F1", "spin0", True), ("cyl", "spin0", True),
	("CC", "spin0", False)])
def test_entries_match_reference(geom, spins, deriv):
	check_entries(geom, spins, deriv)
