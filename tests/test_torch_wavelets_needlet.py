"""pixell_tpu_torch.wavelets' CosineNeedlet on the curved sky against
pixell_tpu.wavelets on the CPU, with inputs made from a numpy seed,
float64: map2wave per scale and wave2map within 1e-10 of the largest
reference value, on BASELINE config 5's geometry rule at lmax 32 (the 35 x
70 F1 map). ButterTrim's is in test_torch_wavelets.py.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
import torch_threads  # noqa: F401  (one torch thread per xdist worker)

from test_torch_wavelets import LMAX, WTOL, rel, c5_geometry
from pixell_tpu import wavelets as jwavelets, uharm as juharm, enmap as jenmap
from pixell_tpu_torch import wavelets, uharm, enmap


def test_curved_needlet():
	(js, jw), (ps, pw) = c5_geometry(jenmap), c5_geometry(enmap)
	jt = jwavelets.WaveletTransform(juharm.UHT(js, jw, mode="curved", lmax=LMAX), basis=jwavelets.CosineNeedlet())
	pt = wavelets.WaveletTransform(uharm.UHT(ps, pw, mode="curved", lmax=LMAX, device="cpu"),
		basis=wavelets.CosineNeedlet())
	d = np.random.default_rng(5).standard_normal(tuple(js[-2:]))
	jwv, pwv = jt.map2wave(jenmap.ndmap(d, jw)), pt.map2wave(enmap.ndmap(torch.from_numpy(d), pw))
	assert pwv.nmap == jwv.nmap == pt.nlevel
	for a, b in zip(jwv.maps, pwv.maps): assert rel(b, a) <= WTOL
	assert rel(pt.wave2map(pwv), jt.wave2map(jwv)) <= WTOL
