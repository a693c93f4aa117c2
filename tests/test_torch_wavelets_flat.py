"""pixell_tpu_torch.wavelets against pixell_tpu.wavelets on the flat sky,
on the CPU, with inputs made from a numpy seed, float64: map2wave per
scale and wave2map within 1e-10 of the largest reference value for
ButterTrim and CosineNeedlet on a 4 x 4 degree CAR patch at 0.125 degrees
(the scales downgraded by powers of two and resampled by order-3 splines).
The curved sky is in test_torch_wavelets.py and
test_torch_wavelets_needlet.py.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
import torch_threads  # noqa: F401  (one torch thread per xdist worker)

from test_torch_wavelets import WTOL, rel
from pixell_tpu import wavelets as jwavelets, enmap as jenmap
from pixell_tpu_torch import wavelets, enmap, utils


def flat_geometry(mod):
	return mod.geometry(pos=np.array([[-2, 2], [2, -2]])*utils.degree, res=0.125*utils.degree, proj="car")


@pytest.mark.parametrize("basis", ["ButterTrim", "CosineNeedlet"])
def test_flat(basis):
	(js, jw), (ps, pw) = flat_geometry(jenmap), flat_geometry(enmap)
	jt = jwavelets.WaveletTransform((js, jw), basis=getattr(jwavelets, basis)())
	pt = wavelets.WaveletTransform((ps, pw), basis=getattr(wavelets, basis)(), device="cpu")
	assert pt.uht.mode == jt.uht.mode == "flat" and pt.nlevel == jt.nlevel
	d = np.random.default_rng(6).standard_normal(tuple(js[-2:]))
	jwv = jt.map2wave(jenmap.ndmap(d, jw))
	pwv = pt.map2wave(enmap.ndmap(torch.from_numpy(d), pw))
	assert [m.shape for m in pwv.maps] == [tuple(m.shape) for m in jwv.maps]
	for a, b in zip(jwv.maps, pwv.maps): assert rel(b, a) <= WTOL
	assert rel(pt.wave2map(pwv), jt.wave2map(jwv)) <= WTOL
