"""The SHT's byte-bounded table cache (pixell_tpu_torch.ops.tablecache):
eviction by bytes in least-recently-used order across the caches that
share the budget, each tensor storage counted once, cache_info /
cache_clear as functools.lru_cache has them, and transforms that give the
same alm whether their tables stay cached or are evicted at every insert
(held against pixell_tpu at the same time, 1e-12 of the largest value).
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
import torch_threads  # noqa: F401  (one torch thread per xdist worker)

from pixell_tpu_torch.ops import tablecache


@pytest.fixture
def small_budget(monkeypatch):
	monkeypatch.setattr(tablecache, "_budget", 3000)
	tablecache.clear()
	yield
	tablecache.clear()


def test_evicts_least_recently_used_by_bytes(small_budget):
	calls = []
	@tablecache.cached
	def table(n):
		calls.append(n)
		return torch.zeros(n, dtype=torch.uint8)
	@tablecache.cached
	def other(n):
		return torch.zeros(n, dtype=torch.uint8)
	table(1000); other(1000)
	table(1000)                 # a hit: other(1000) is now the oldest
	assert table.cache_info().hits == 1 and table.cache_info().misses == 1
	table(1500)                 # 3500 bytes: the oldest entry goes
	assert other.cache_info().currsize == 0 and table.cache_info().currsize == 2
	assert tablecache.held() == 2500
	table(1000)
	assert calls == [1000, 1500]
	table(4000)                 # larger than the budget: kept alone
	assert table.cache_info().currsize == 1 and tablecache.held() == 4000


def test_storage_counted_once_and_clear_is_per_function(small_budget):
	@tablecache.cached
	def views(n):
		t = torch.zeros(n, dtype=torch.uint8)
		return t, t[:10], (t[5:],)
	@tablecache.cached
	def plain(n):
		return np.zeros(n, np.uint8)
	views(800); plain(700)
	assert tablecache.held() == 1500
	views.cache_clear()
	assert views.cache_info() == (0, 0, None, 0)
	assert plain.cache_info().currsize == 1 and tablecache.held() == 700


def test_transforms_agree_when_every_table_is_evicted(monkeypatch):
	"""map2alm and alm2map with their tables cached, and with a budget of
	one byte (each insert evicts every earlier table), give the same
	result, bit for bit, and match pixell_tpu."""
	import jax
	jax.config.update("jax_enable_x64", True)
	from pixell_tpu import enmap as jenmap, curvedsky as jcurvedsky
	from pixell_tpu_torch import enmap, curvedsky
	lmax = 24
	shape, wcs = enmap.fullsky_geometry(shape=(30, 60), variant="fejer1")
	m = np.random.default_rng(3).standard_normal(shape)
	tm = enmap.ndmap(torch.from_numpy(m), wcs)
	cached = curvedsky.map2alm(tm, lmax=lmax, spin=0)
	back = curvedsky.alm2map(cached, enmap.zeros(shape, wcs, device="cpu"), spin=0).data
	monkeypatch.setattr(tablecache, "_budget", 1)
	tablecache.clear()
	evicted = curvedsky.map2alm(tm, lmax=lmax, spin=0)
	assert tablecache.held() > 1   # the last table stays, alone
	assert torch.equal(evicted, cached)
	assert torch.equal(curvedsky.alm2map(evicted, enmap.zeros(shape, wcs, device="cpu"), spin=0).data, back)
	jshape, jwcs = jenmap.fullsky_geometry(shape=(30, 60), variant="fejer1")
	ref = np.asarray(jcurvedsky.map2alm(jenmap.ndmap(m, jwcs), lmax=lmax, spin=0))
	assert np.abs(evicted.numpy() - ref).max() <= 1e-12*np.abs(ref).max()
