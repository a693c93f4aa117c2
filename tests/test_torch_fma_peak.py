"""K9, the FMA-peak kernel's wrapper (pixell_tpu_torch.ops.fma_peak) on the
CPU, where it runs the plain PyTorch chain. The kernel itself runs only on
a GPU; chip_smoke.py holds it against this chain there."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
import torch_threads  # noqa: F401  (one torch thread per xdist worker)

from pixell_tpu_torch.ops import fma_peak


@pytest.mark.parametrize("c,d", [(0.999, 1e-3), (-0.5, 0.25), (1.0, -0.125)])
def test_plain_chain_matches_closed_form(c, d):
	"""iters steps of x = x*c + d in float64 against the closed form
	c^n x + d (1 + c + ... + c^(n-1)). Tolerance 4 n eps of the largest
	magnitude: each step rounds twice, and |c| <= 1 keeps the errors from
	growing."""
	n = 200
	x = torch.from_numpy(np.random.default_rng(0).uniform(-2, 2, 1000))
	got = fma_peak.fma_peak(x, c, d, n)
	geo = n if c == 1.0 else (1 - c**n)/(1 - c)
	want = c**n*x.numpy() + d*geo
	scale = max(np.abs(want).max(), np.abs(x.numpy()).max(), abs(d)*n)
	assert np.abs(got.numpy() - want).max() <= 4*n*np.finfo(np.float64).eps*scale
	assert torch.equal(got, fma_peak.plain(x, c, d, n))
	assert fma_peak.operations(x, n) == 2*1000*n
	assert fma_peak.LAUNCHES["fma_peak"] == 0       # the plain chain is not a launch


def test_wrapper_checks():
	x = torch.ones(8)
	assert torch.equal(fma_peak.fma_peak(x, 2.0, 1.0, 0), x)
	with pytest.raises(TypeError):
		fma_peak.fma_peak(torch.ones(8, dtype=torch.int32), 1.0, 0.0, 1)
	with pytest.raises(ValueError):
		fma_peak.fma_peak(torch.ones(2, 4), 1.0, 0.0, 1)
	with pytest.raises(ValueError):
		fma_peak.fma_peak(torch.ones(8)[::2], 1.0, 0.0, 1)
	with pytest.raises(ValueError):
		fma_peak.fma_peak(x, 1.0, 0.0, -1)
	with pytest.raises(RuntimeError, match="no fma_peak kernel"):
		fma_peak.fma_peak(torch.ones(8, device="meta"), 1.0, 0.0, 1)
