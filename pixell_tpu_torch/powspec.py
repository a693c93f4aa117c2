"""Power spectrum packing (counterpart of pixell_tpu/powspec.py).

Only sym_expand (pixell_tpu/powspec.py:18) and the order it reads,
compressed_order (:33), which curvedsky.prepare_ps needs. Host numpy.
"""
from __future__ import annotations
import numpy as np


def sym_expand(mat, which=None, ncomp=None, scheme=None, axis=0):
	"""The unique components of a symmetric matrix spectrum [m, nl] ->
	[n, n, nl] (pixell_tpu.powspec.sym_expand)."""
	mat = np.moveaxis(np.asarray(mat), axis, 0)
	if which is None: which = compressed_order(mat.shape[0], scheme)
	if ncomp is None: ncomp = int(np.max([max(w) for w in which]))+1
	res = np.zeros((ncomp, ncomp) + mat.shape[1:], mat.dtype)
	for i, w in enumerate(which):
		res[w[0], w[1]] = mat[i]
		res[w[1], w[0]] = mat[i]
	return res


def compressed_order(n, scheme=None):
	"""The (i, j) of each of n compressed entries: "diag" diagonal-major
	(00, 11, 22, 01, 12, 02), else row-major upper triangle (00, 01, 02, 11,
	12, 22) (pixell_tpu.powspec.compressed_order)."""
	ncomp = int((-1+(1+8*n)**0.5)/2)
	if scheme == "diag":
		res = [(i, i+d) for d in range(ncomp) for i in range(ncomp-d)]
	else:
		res = [(i, j) for i in range(ncomp) for j in range(i, ncomp)]
	return res[:n]
