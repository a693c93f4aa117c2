"""The port's runtime modules on the CPU, against pixell_tpu's where both
compute the same thing:

- device: get_device("cpu") and get_device("auto") without CUDA (a
  DeviceCpu), put / get of tensors, numpy arrays and ndmaps, synchronize /
  time / garbage_collect, memuse of the process and of the workspaces,
  Workspace (ensure reuses its tensor in place, take / give / peek / drop),
  anypy, DeviceTpu bound to DeviceGpu;
- memory: the /proc figures and MemUse against the reference's, the
  device's (0, 0) without CUDA;
- config: default / get / set, override scopes, ArgumentParser flags,
  to_str / from_str, save / load / init from files, against the
  reference's module fed the same calls;
- sqlite: SQL on a file and in memory (tables, columns, rows, show,
  derive, attach, backup, the array round trip), format_result and info
  against the reference's;
- warray: WatchArray reports each write, as the reference's;
- checkpoint: save_pytree / load_pytree of nested dicts, lists and tuples
  of tensors, numpy arrays, numbers, strings and ndmaps (exactly, placed
  like a given tree), save_map / load_map, and utils.CG stopped, saved,
  resumed in a new solver and stepped on to the same iterates as a run
  never stopped (float64, 1e-14), its first iterates against the
  reference's CG on the same numbers (1e-12).
"""
import io
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import torch_threads  # noqa: F401  (one torch thread per xdist worker)

from pixell_tpu import memory as jmemory, config as jconfig, sqlite as jsqlite, warray as jwarray, \
	utils as jutils, enmap as jenmap
from pixell_tpu_torch import device, memory, config, sqlite, warray, checkpoint, utils, enmap


def test_device_cpu(monkeypatch):
	dev = device.get_device("cpu")
	assert isinstance(dev, device.DeviceCpu) and dev.kind == "cpu" and dev.dev == torch.device("cpu")
	monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
	assert isinstance(device.get_device(), device.DeviceCpu)
	with pytest.raises(ValueError): device.get_device("fpga")
	assert device.DeviceTpu is device.DeviceGpu and device.DeviceGpu.kind == "gpu"
	a = np.arange(6.0).reshape(2, 3)
	t = dev.put(a)
	assert isinstance(t, torch.Tensor) and t.device.type == "cpu" and np.array_equal(dev.get(t), a)
	shape, wcs = enmap.fullsky_geometry(res=30*utils.degree)
	m = enmap.zeros(shape, wcs, device="cpu") + 1
	pm = dev.put(m)
	assert isinstance(pm, enmap.ndmap) and pm.wcs is m.wcs and isinstance(dev.get(pm), np.ndarray)
	dev.synchronize(); dev.garbage_collect()
	t0 = dev.time(); assert dev.time() >= t0
	assert dev.memuse() > 0 and dev.memuse("peak") >= dev.memuse()
	ws = dev.workspace("cg")
	assert dev.workspace("cg") is ws and dev.memuse("workspaces") == 0
	x = ws.ensure("x", (4, 5), np.float64)
	x += 3
	y = ws.ensure("x", (4, 5), np.float64)
	assert y.data_ptr() == x.data_ptr() and bool((y == 0).all()) and y.dtype == torch.float64
	assert ws.ensure("x", (2, 5), torch.float32).shape == (2, 5) and dev.memuse("workspaces") == 40
	ws.give("r", torch.ones(3))
	assert "r" in ws and ws.names() == ["r", "x"] and ws.peek("r").sum() == 3 and ws.nbytes == 52
	assert ws.take("r").shape == (3,) and "r" not in ws and ws.take("r", 7) == 7
	ws.drop("x"); assert ws.nbytes == 0 and repr(ws) == "Workspace(0 bytes: )"
	ws.give("z", torch.zeros(2)); ws.clear(); assert ws.names() == []
	assert device.anypy(t) is torch and device.anypy(m) is torch and device.anypy(a) is np
	assert dev.np is torch and repr(dev) == "DeviceCpu(cpu)"


def test_memory():
	for name in ("current", "resident", "max", "max_resident", "linux_current", "linux_resident", "linux_max"):
		got, want = getattr(memory, name)(), getattr(jmemory, name)()
		assert got > 0 and abs(got - want) <= 0.5*want, name
	assert memory.max() >= memory.current() and memory.max_resident() >= memory.resident()
	if not torch.cuda.is_available(): assert memory.device_memory() == (0, 0)
	assert memory.fallback([lambda: 1/0, lambda: 5]) == 5 == jmemory.fallback([lambda: 1/0, lambda: 5])
	assert memory.fallback([lambda: 1/0]) == 0
	with pytest.raises(OSError): memory.get_mac_taskinfo()
	assert memory.mac_current() > 0 and memory.mac_resident() > 0
	out = io.StringIO()
	old, sys.stdout = sys.stdout, out
	try:
		with memory.MemUse("block") as mu:
			buf = np.ones(1 << 20)
	finally:
		sys.stdout = old
	assert out.getvalue().startswith("memuse block:") and mu.stop >= mu.start - (1 << 22) and buf.sum() > 0
	err = io.StringIO()
	old, sys.stderr = sys.stderr, err
	try: memory.trace("here")
	finally: sys.stderr = old
	assert err.getvalue().startswith("mem ") and "here" in err.getvalue()


@pytest.mark.parametrize("mod", [config, jconfig], ids=["port", "reference"])
def test_config(mod, tmp_path):
	"""The same calls on the port's module and the reference's give the
	same values (parameter names unique to this test)."""
	assert mod.default("tsup_n", 3, "a count") == 3 and mod.default("tsup_n", 9) == 3
	mod.default("tsup_x", 1.5); mod.default("tsup_flag", False); mod.default("tsup_name", "a")
	assert mod.get("tsup_n") == 3 and mod.get("tsup_missing", 7) == 7
	with mod.override("tsup_n", 5):
		assert mod.get("tsup_n") == 5
		with mod.override("tsup_n", 6): assert mod.get("tsup_n") == 6
		assert mod.get("tsup_n") == 5
	assert mod.get("tsup_n") == 3
	ap = mod.ArgumentParser()
	args = ap.parse_args(["--tsup-x", "2.5", "--tsup-flag", "yes"])
	assert args.tsup_x == 2.5 and mod.get("tsup_x") == 2.5 and mod.get("tsup_flag") is True
	mod.from_str("tsup_name = 'b'\n# a comment\n")
	assert mod.get("tsup_name") in ("b", "'b'")
	assert "tsup_x = 2.5" in mod.to_str()
	with pytest.raises(ValueError): mod.from_str("a = b = c")
	f = str(tmp_path/"rc")
	mod.save(f)
	(tmp_path/"rc2").write_text("tsup_n = 11\n")
	mod.load(str(tmp_path/"rc2"))
	assert mod.get("tsup_n") == 11
	mod.init(fname=str(tmp_path/"none"))
	with pytest.raises(IOError): mod.init(fname=str(tmp_path/"none"), must_exist=True)
	mod.set("tsup_n", 3)
	assert mod.get("tsup_n") == 3
	assert "tsup_n = 3" in open(f).read()


def test_config_same_values():
	for mod in (config, jconfig):
		mod.default("tsup_same", 2)
		mod.from_str("tsup_same = 4")
	assert config.get("tsup_same") == jconfig.get("tsup_same") == 4
	assert config.to_str().count("\n") >= 1 and config.__name__ == "pixell_tpu_torch.config"


def test_sqlite(tmp_path):
	f = str(tmp_path/"db.sqlite")
	outs = []
	for mod in (sqlite, jsqlite):
		db = mod.SQL(f + mod.__name__.split(".")[0], mode="rwc")
		db.execute("create table cat (id integer, ra real, name text)")
		db.executemany("insert into cat values (?, ?, ?)", [(i, 0.5*i, "s%d" % i) for i in range(12)])
		db.commit()
		arr = np.random.default_rng(1).standard_normal((5, 2))
		db.write_array("arr", arr, names=["a", "b"])
		assert np.array_equal(db.read_array("arr"), arr)
		assert db.tables() == ["cat", "arr"] and db.columns("cat") == ["id", "ra", "name"] and db.nrow("cat") == 12
		assert mod.tables(db) == db.tables() and mod.rows(db, "cat") == 12 and mod.columns(db, "arr") == ["a", "b"]
		d = db.derive("select id, ra from cat where id < 3")
		assert d.query("select * from result") == [(0, 0.0), (1, 0.5), (2, 1.0)]
		with db.attach(mod.get_fname(db), name="o") as a:
			assert a.query("select count(*) from o.cat") == [(12,)]
		mem = mod.open(":memory:")
		db.backup(mem)
		assert mem.tables() == ["cat", "arr"]
		out = io.StringIO()
		old, sys.stdout = sys.stdout, out
		try: db.show("cat", limit=3); mod.show(db, "select id from cat where id = 2")
		finally: sys.stdout = old
		outs.append((out.getvalue(), mod.format_result(db.query("select * from cat"), limit=4),
			mod.info(db, "Cat").replace(f + mod.__name__.split(".")[0], "F"), repr(d)))
		db.close()
	assert outs[0] == outs[1]
	assert sqlite.format_result([]) == "<empty>"


def test_warray():
	logs = []
	for mod in (warray, jwarray):
		buf = io.StringIO()
		w = mod.WatchArray(np.zeros(4), name="w", file=buf)
		w[1] = 3; w.fill(2)
		v = mod.watch(np.ones(2), "v")
		assert isinstance(w.copy(), np.ndarray) and not isinstance(w.copy(), mod.WatchArray) and v.name == "v"
		lines = [l for l in buf.getvalue().splitlines() if l.startswith("WatchArray")]
		logs.append(lines)
		assert np.array_equal(np.asarray(w), [2, 2, 2, 2])
	assert logs[0] == logs[1] == ["WatchArray w: __setitem__ 1", "WatchArray w: fill 2"]


def test_pytree(tmp_path):
	shape, wcs = enmap.fullsky_geometry(res=20*utils.degree)
	m = enmap.enmap(np.random.default_rng(0).standard_normal((3,) + shape), wcs, device="cpu")
	tree = {"x": torch.arange(5, dtype=torch.float32), "nest": [torch.ones(2, 2), (np.arange(3), 4.5, "s")],
		"map": m, "alm": torch.randn(7, dtype=torch.complex128), "n": np.int64(3)}
	f = str(tmp_path/"state.pt")
	checkpoint.save_pytree(f, tree)
	with pytest.raises(FileExistsError): checkpoint.save_pytree(f, tree, force=False)
	back = checkpoint.load_pytree(f, device="cpu")
	assert torch.equal(back["x"], tree["x"]) and torch.equal(back["nest"][0], torch.ones(2, 2))
	assert isinstance(back["nest"][1], tuple) and torch.equal(back["nest"][1][0], torch.arange(3))
	assert back["nest"][1][1:] == (4.5, "s") and back["n"] == 3 and torch.equal(back["alm"], tree["alm"])
	assert isinstance(back["map"], enmap.ndmap) and torch.equal(back["map"].data, m.data)
	assert back["map"].wcs.to_header() == m.wcs.to_header()
	like = {"x": torch.zeros(5, dtype=torch.float64), "nest": [torch.zeros(2, 2, dtype=torch.float16),
		(torch.zeros(3, dtype=torch.float32), 0, "")], "map": m.astype(np.float32), "alm": tree["alm"], "n": 0}
	placed = checkpoint.load_pytree(f, like)
	assert placed["x"].dtype == torch.float64 and placed["nest"][0].dtype == torch.float16
	assert placed["nest"][1][0].dtype == torch.float32 and placed["map"].dtype == torch.float32
	checkpoint.save_map(str(tmp_path/"m.fits"), m)
	got = checkpoint.load_map(str(tmp_path/"m.fits"), device="cpu")
	assert torch.equal(got.data, m.data) and got.wcs.to_header() == m.wcs.to_header()
	assert np.array_equal(np.asarray(jenmap.read_map(str(tmp_path/"m.fits"))), m.data.numpy())


def problem(n=40, seed=2):
	rng = np.random.default_rng(seed)
	q = rng.standard_normal((n, n))
	A = q @ q.T + n*np.eye(n)
	b = rng.standard_normal(n)
	return A, b


def test_cg_resume(tmp_path):
	"""CG stopped after 4 steps, saved, loaded into a new solver and stepped
	on: the iterates of a run never stopped (float64)."""
	A, b = problem()
	At, bt = torch.from_numpy(A), torch.from_numpy(b)
	op = lambda x: At @ x
	M = lambda x: x/torch.from_numpy(np.diag(A).copy())
	whole = utils.CG(op, bt, M=M)
	xs = [whole.step().clone() for _ in range(10)]
	ref = jutils.CG(lambda x: A @ x, b, M=lambda x: x/np.diag(A))
	for i in range(4):
		assert np.abs(ref.step() - xs[i].numpy()).max() <= 1e-12*np.abs(xs[i].numpy()).max()
	part = utils.CG(op, bt, M=M)
	for _ in range(4): part.step()
	f = str(tmp_path/"cg.hdf")
	checkpoint.save_solver(f, part)
	resumed = checkpoint.load_solver(f, utils.CG(op, bt, M=M))
	assert resumed.i == 4 and isinstance(resumed.x, torch.Tensor) and resumed.x.dtype == torch.float64
	for i in range(4, 10):
		x = resumed.step()
		assert (x - xs[i]).abs().max() <= 1e-14*xs[i].abs().max(), i
	assert resumed.err == whole.err and whole.err < 1e-6
	# the reference's solver reads the port's file, and the other way round
	jr = jutils.CG(lambda x: A @ x, b, M=lambda x: x/np.diag(A))
	jr.load(f)
	assert jr.i == 4 and np.array_equal(jr.x, part.x.numpy())
	# numpy vectors stay numpy; x0 given
	npcg = utils.CG(lambda x: A @ x, b, x0=np.zeros_like(b))
	assert isinstance(npcg.step(), np.ndarray)
