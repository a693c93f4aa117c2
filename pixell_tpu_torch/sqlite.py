"""sqlite conveniences (counterpart of pixell_tpu/sqlite.py, whole).

One wrapper class, `SQL`, around an sqlite3 connection: schema inventory,
tabular pretty-printing, backup/attach/derive across databases, plus numpy
array round-trips (write_array/read_array, absorbed from the former
sqlite_util module). Reference API names are kept (SQL, tables, columns,
rows, show, format_result, backup, attach, derive) but the logic is
class-centric: the module-level helpers are thin forwards to SQL methods
instead of the other way around.
"""
from __future__ import annotations
import contextlib
import sqlite3
import numpy as np

_LIST_TABLES = "select name from sqlite_master where type='table'"


def _raw(obj):
	"""The underlying sqlite3 connection of an SQL, a connection, or None."""
	if isinstance(obj, SQL): return obj.conn
	if isinstance(obj, sqlite3.Connection): return obj
	return None


class SQL:
	"""An sqlite database handle. fname can be a path, ":memory:", a
	file: URI, another SQL object or a raw connection. mode: "ro"
	(default), "rw", "rwc", or None for sqlite's own defaults."""
	def __init__(self, fname=":memory:", mode="ro"):
		conn = _raw(fname)
		if conn is not None:
			self.conn = conn
			self.fname = self.path()
			self.own = False
			return
		if not isinstance(fname, str):
			raise ValueError("SQL needs a path, an SQL object or a connection")
		uri = fname
		if mode is not None and not (fname == ":memory:" or
				fname.startswith("file:")):
			uri = "file:%s?mode=%s" % (fname, mode)
		try:
			self.conn = sqlite3.connect(uri, uri=uri.startswith("file:"))
		except sqlite3.OperationalError as e:
			raise sqlite3.OperationalError("%s (%s)" % (e, fname))
		self.fname = fname
		self.own = True
	# --- core ---
	def execute(self, command, args=()):
		return self.conn.execute(command, args)
	def executemany(self, command, args=()):
		return self.conn.executemany(command, args)
	def query(self, command, args=()):
		return self.conn.execute(command, args).fetchall()
	def commit(self):
		self.conn.commit()
	def close(self):
		if self.own:
			self.conn.close()
	def path(self):
		"""File behind the main database ('' for memory databases)."""
		return self.query("pragma database_list")[0][2]
	# --- schema ---
	def tables(self):
		return [name for (name,) in self.query(_LIST_TABLES)]
	def columns(self, tname):
		return [row[1] for row in self.query("pragma table_info(%r)" % tname)]
	def nrow(self, tname):
		return self.query("select count(*) from %s" % tname)[0][0]
	# --- display ---
	def show(self, what, limit=10):
		"""Print a table (pass its name) or the result of a full query."""
		q = what if len(what.split()) > 1 else "select * from " + what
		if "limit" not in q.lower().split():
			q += " limit %d" % (limit + 1)
		else:
			limit = None
		print(format_result(self.query(q), limit=limit))
	# --- cross-database ---
	def backup(self, target):
		self.conn.backup(_raw(target) if _raw(target) is not None else target)
	@contextlib.contextmanager
	def attach(self, other, name="other", mode="r"):
		"""Temporarily attach another database under the given name."""
		src = other if isinstance(other, str) else SQL(other).path()
		self.execute("attach database ? as %s" % name, (src,))
		try:
			yield self
		finally:
			self.execute("detach database %s" % name)
	def derive(self, query, tname="result", aname="_src"):
		"""New memory database holding table tname = this query's result."""
		out = SQL(":memory:", mode=None)
		src = self.path()
		if src:
			with out.attach(src, name=aname):
				out.execute("create table %s as %s" % (tname, query))
		else:
			# memory db: can't attach by path; copy rows through python
			data = self.query(query)
			if data:
				ncol = len(data[0])
				cols = ",".join("c%d" % i for i in range(ncol))
				out.execute("create table %s (%s)" % (tname, cols))
				out.executemany("insert into %s values (%s)" % (
					tname, ",".join("?"*ncol)), data)
		return out
	# --- numpy round trips (formerly sqlite_util) ---
	def write_array(self, table, arr, names=None):
		arr = np.asarray(arr)
		if arr.ndim == 1: arr = arr[:, None]
		ncol = arr.shape[1]
		if names is None: names = ["c%d" % i for i in range(ncol)]
		self.execute("create table if not exists %s (%s)" % (
			table, ",".join("%s real" % c for c in names)))
		self.executemany("insert into %s values (%s)" % (
			table, ",".join("?"*ncol)),
			[tuple(float(v) for v in row) for row in arr])
		self.commit()
	def read_array(self, table):
		return np.array(self.query("select * from %s" % table))
	# --- protocol ---
	def __enter__(self):
		return self
	def __exit__(self, *exc):
		self.close()
	def __repr__(self):
		descs = ["%s[%s]x%d" % (t, ",".join(self.columns(t)), self.nrow(t))
			for t in self.tables()]
		return "SQL(fname=%r, own=%s, tables={%s})" % (
			self.fname, self.own, "; ".join(descs))


def open(fname=":memory:", mode=None):
	return SQL(fname, mode=mode)

# Module-level forwards, pixell's module-level API
def tables(conn):  return SQL(conn).tables()
def columns(conn, tname): return SQL(conn).columns(tname)
def rows(conn, tname): return SQL(conn).nrow(tname)
def get_fname(conn):
	return conn if isinstance(conn, str) else SQL(conn).path()
def backup(source, target): SQL(source).backup(target)
def attach(conn_base, conn_other, name="other", mode="r"):
	return SQL(conn_base).attach(conn_other, name=name, mode=mode)
def derive(conn, query, tname="result", aname="_src"):
	return SQL(conn).derive(query, tname=tname, aname=aname)
def show(conn, table, limit=10): SQL(conn).show(table, limit=limit)
def info(conn, name="Connection", extra=()):
	db = SQL(conn)
	body = repr(db)
	return "%s(%s)" % (name, ", ".join([body] + list(extra)))


def format_result(result, limit=None):
	"""Rows -> aligned text table; appends '...' when truncated to limit."""
	result = list(result)
	if not result:
		return "<empty>"
	shown = result if limit is None else result[:limit]
	cells = [[str(v) for v in row] for row in shown]
	widths = [max(len(row[i]) for row in cells)
		for i in range(len(cells[0]))]
	lines = ["  ".join(c.rjust(w) for c, w in zip(row, widths))
		for row in cells]
	if len(shown) < len(result):
		lines.append("...")
	return "\n".join(lines)
