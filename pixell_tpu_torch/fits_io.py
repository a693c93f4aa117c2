"""FITS image and binary-table IO in pure Python, with a native box reader
(counterpart of pixell_tpu/fits_io.py).

The subset of FITS sky maps and catalogues need: primary and extension image
HDUs with the standard 2880-byte blocking, big-endian data, BZERO / BSCALE,
.gz files, and BINTABLE catalogues. Host numpy throughout: enmap moves what
it reads to the device.

Images are read by the native reader (cpp/fitsio_core.cpp, the port's own
copy of the reference's cpp/fitsio_core.cpp), built with the host C++
compiler at first use into build/ (ops/_build.py, load_host): it parses the
headers and reads a pixel box of every plane straight off disk with
OpenMP-threaded preads, converting from big endian on the way, into a given
buffer (a pinned one, for the copy to the card). There is no quiet fallback:
a failed build or load raises. Only .gz files take the Python reader, as in
the reference; read_map, the Python reader, stays as the native reader's
plain twin. The writer puts the reference's bytes in the file (no date),
streaming the data in chunks instead of converting the whole map at once.
"""
from __future__ import annotations
import ctypes as _ct
import gzip
import io as _io
import numpy as np

BLOCK = 2880
CARD  = 80
# bytes of data converted to big endian and written at a time
_WRITE_CHUNK = 1 << 26

_bitpix2dtype = {8: np.uint8, 16: ">i2", 32: ">i4", 64: ">i8",
	-32: ">f4", -64: ">f8"}
_dtype2bitpix = {"uint8": 8, "int16": 16, "int32": 32, "int64": 64,
	"float32": -32, "float64": -64}


def _format_card(key, value, comment=None):
	if key == "END": return "END".ljust(CARD)
	if key in ["COMMENT", "HISTORY"]:
		return ("%-8s%s" % (key, value))[:CARD].ljust(CARD)
	if isinstance(value, bool):
		vs = "T" if value else "F"
		card = "%-8s= %20s" % (key, vs)
	elif isinstance(value, (int, np.integer)):
		card = "%-8s= %20d" % (key, value)
	elif isinstance(value, (float, np.floating)):
		card = "%-8s= %20s" % (key, _ffmt(value))
	else:
		vs = "'%-8s'" % str(value).replace("'", "''")
		card = "%-8s= %-20s" % (key, vs)
	if comment:
		card += " / " + comment
	return card[:CARD].ljust(CARD)

def _ffmt(v):
	s = repr(float(v))
	if "e" in s or "E" in s or "." in s or "nan" in s or "inf" in s:
		return s.upper().replace("INF", "9E99")
	return s + ".0"

def _parse_value(raw):
	raw = raw.strip()
	if raw.startswith("'"):   # a quote inside the string is doubled (the reference keeps it doubled)
		end = raw.rfind("'")
		return raw[1:end].replace("''", "'").rstrip()
	if raw in ["T", "F"]: return raw == "T"
	try: return int(raw)
	except ValueError: pass
	try: return float(raw.replace("D", "E").replace("d", "e"))
	except ValueError: return raw

def _parse_header(f):
	"""The next header's cards from the file object, as a dict (None at
	the end of the file)."""
	hdr = {}
	done = False
	while not done:
		block = f.read(BLOCK)
		if len(block) < BLOCK:
			if not hdr: return None
			raise IOError("Unexpected end of FITS header")
		for i in range(0, BLOCK, CARD):
			card = block[i:i+CARD].decode("ascii", "replace")
			key = card[:8].strip()
			if key == "END":
				done = True
				break
			if not key or card[8:10] != "= ":
				if key in ["COMMENT", "HISTORY"]:
					hdr.setdefault(key, []); hdr[key].append(card[8:].strip())
				continue
			rest = card[10:]
			slash = _find_comment(rest)
			hdr[key] = _parse_value(rest[:slash])
	return hdr

def _find_comment(s):
	instr = False
	for i, c in enumerate(s):
		if c == "'": instr = not instr
		elif c == "/" and not instr: return i
	return len(s)

def _open(fname, mode="rb"):
	if fname.endswith(".gz"): return gzip.open(fname, mode)
	return open(fname, mode)


def read_header(fname, hdu=0):
	"""(shape, header dict) of the given HDU."""
	with _open(fname) as f:
		h = _skip_to_hdu(f, hdu)
		shape = _hdr_shape(h)
		return shape, h

def _hdr_shape(h):
	naxis = int(h.get("NAXIS", 0))
	return tuple(int(h["NAXIS%d" % i]) for i in range(naxis, 0, -1))

def _data_size(h):
	shape = _hdr_shape(h)
	bitpix = int(h["BITPIX"])
	n = int(abs(bitpix)//8*np.prod(shape)) if shape else 0
	return (n + BLOCK - 1)//BLOCK*BLOCK

def _skip_to_hdu(f, hdu):
	i = 0
	while True:
		h = _parse_header(f)
		if h is None: raise IOError("HDU %d not found" % hdu)
		if i == hdu: return h
		f.seek(_data_size(h), 1)
		i += 1

def _data_hdu(fname, hdu=0):
	"""The index of the first HDU from hdu on whose image holds data, as
	read_map picks it."""
	with _open(fname) as f:
		i = 0
		while True:
			h = _parse_header(f)
			if h is None: raise IOError("No image HDU with data found in %s" % fname)
			shape = _hdr_shape(h)
			if i >= hdu and shape and np.prod(shape) > 0: return i
			f.seek(_data_size(h), 1)
			i += 1

def _scale(data, h):
	bscale = h.get("BSCALE", 1); bzero = h.get("BZERO", 0)
	if bscale != 1 or bzero != 0:
		data = data*bscale + bzero
	return data

def read_map(fname, hdu=0):
	"""Image data and header of a FITS file, as (array, header), by the
	Python reader. If HDU hdu has no data, the first HDU after it with data."""
	with _open(fname) as f:
		i = 0
		while True:
			h = _parse_header(f)
			if h is None: raise IOError("No image HDU with data found in %s" % fname)
			shape = _hdr_shape(h)
			if i >= hdu and shape and np.prod(shape) > 0:
				break
			f.seek(_data_size(h), 1)
			i += 1
		bitpix = int(h["BITPIX"])
		dtype = np.dtype(_bitpix2dtype[bitpix])
		count = int(np.prod(shape))
		data = np.frombuffer(f.read(count*dtype.itemsize), dtype=dtype, count=count)
		data = data.reshape(shape)
		data = data.astype(data.dtype.newbyteorder("="))
		return _scale(data, h), h

def _header_text(cards):
	htext = "".join(cards)
	return (htext + " "*((-len(htext)) % BLOCK)).encode("ascii")

def write_map(fname, data, header=None, dtype=None):
	"""An image array to a FITS file, with the given extra header cards
	(e.g. from wcs.to_header())."""
	data = np.asarray(data)
	if dtype is not None: data = data.astype(dtype)
	if data.dtype == np.float16: data = data.astype(np.float32)
	if str(data.dtype) not in _dtype2bitpix:
		data = data.astype(np.float64)
	bitpix = _dtype2bitpix[str(data.dtype)]
	cards = []
	cards.append(_format_card("SIMPLE", True, "pixell_tpu"))
	cards.append(_format_card("BITPIX", bitpix))
	cards.append(_format_card("NAXIS", data.ndim))
	for i in range(data.ndim):
		cards.append(_format_card("NAXIS%d" % (i+1), data.shape[data.ndim-1-i]))
	if header:
		for k, v in header.items():
			if k in ["SIMPLE", "BITPIX", "NAXIS"] or k.startswith("NAXIS"): continue
			cards.append(_format_card(k, v))
	cards.append(_format_card("END", None))
	fdtype = np.dtype(_bitpix2dtype[bitpix])
	flat = data.reshape(-1)
	step = max(_WRITE_CHUNK//fdtype.itemsize, 1)
	with _open(fname, "wb") as f:
		f.write(_header_text(cards))
		for i in range(0, flat.size, step):
			f.write(memoryview(np.ascontiguousarray(flat[i:i+step], fdtype)).cast("B"))
		f.write(b"\x00"*((-flat.size*fdtype.itemsize) % BLOCK))

def write_header(fname, shape, header=None, bitpix=-64):
	"""A header of an image of the given shape with no data after it: a
	geometry-only file, which read_header reads."""
	cards = [_format_card("SIMPLE", True, "pixell_tpu"), _format_card("BITPIX", bitpix),
		_format_card("NAXIS", len(shape))]
	for i, n in enumerate(shape[::-1]):
		cards.append(_format_card("NAXIS%d" % (i+1), int(n)))
	for k, v in (header or {}).items():
		if k in ["SIMPLE", "BITPIX", "NAXIS"] or k.startswith("NAXIS"): continue
		cards.append(_format_card(k, v))
	cards.append(_format_card("END", None))
	with _open(fname, "wb") as f:
		f.write(_header_text(cards))


# ---------------------------------------------------------------------------
# The native reader (cpp/fitsio_core.cpp through ctypes): header parsing and
# threaded pixel-box reads without loading the whole image -- the
# counterpart of pixell's ndmap_proxy delayed reads
# ---------------------------------------------------------------------------
_core = None
def _get_core():
	"""The native reader's library, built at first use; raises where it
	cannot be built or loaded."""
	global _core
	if _core is None:
		from .ops import _build
		lib = _build.load_host("fitsio_core")
		lib.fits_open_info.restype = _ct.c_int
		lib.fits_open_info.argtypes = [_ct.c_char_p, _ct.c_int, _ct.POINTER(_ct.c_long),
			_ct.POINTER(_ct.c_int), _ct.POINTER(_ct.c_int), _ct.POINTER(_ct.c_long), _ct.c_char_p,
			_ct.c_long, _ct.POINTER(_ct.c_long)]
		lib.fits_read_box_strided.restype = _ct.c_int
		lib.fits_read_box_strided.argtypes = [_ct.c_char_p, _ct.c_long, _ct.c_int] + [_ct.c_long]*7 \
			+ [_ct.c_void_p, _ct.c_long, _ct.c_long]
		_core = lib
	return _core

_HEADER_CAP = 1 << 20


def _axis_box(s, n):
	"""(first, end, what is left to apply) of the index or slice s of an
	axis of length n: the rows (or columns) [first, end) hold every element
	s takes, and s on the full axis is what is left on those rows."""
	if isinstance(s, slice):
		r = range(*s.indices(n))
		if len(r) == 0: return 0, 0, slice(0, 0)
		lo, hi = min(r[0], r[-1]), max(r[0], r[-1]) + 1
		stop = r.stop - lo
		return lo, hi, slice(r.start - lo, stop if stop >= 0 else None, r.step)
	i = int(s)
	if i < 0: i += n
	if not 0 <= i < n: raise IndexError("index %d out of range for an axis of %d" % (int(s), n))
	return i, i + 1, 0


class FitsProxy:
	"""A delayed-read handle on a FITS image: slicing reads only the pixel
	box it needs from disk, by the native reader (.gz files: the Python
	reader, whole, then sliced)."""
	def __init__(self, fname, hdu=0):
		self.fname = fname
		self.hdu = hdu
		if fname.endswith(".gz"):
			self.native = False
			self.shape, self.header = read_header(fname, hdu=hdu)
			self.bitpix = int(self.header["BITPIX"])
			return
		core = _get_core()
		doff = _ct.c_long(); bp = _ct.c_int(); nax = _ct.c_int()
		dims = (_ct.c_long*8)()
		hbuf = _ct.create_string_buffer(_HEADER_CAP)
		hlen = _ct.c_long()
		err = core.fits_open_info(fname.encode(), hdu, _ct.byref(doff), _ct.byref(bp), _ct.byref(nax), dims,
			hbuf, _HEADER_CAP, _ct.byref(hlen))
		if err != 0: raise IOError("%s: HDU %d cannot be read (native reader: %d)" % (fname, hdu, err))
		self.native = True
		self.data_offset = doff.value
		self.bitpix = bp.value
		self.shape = tuple(dims[i] for i in range(nax.value))[::-1]
		self.header = _parse_header(_io.BytesIO(hbuf.raw[:hlen.value] + b" "*((-hlen.value) % BLOCK)))
	@property
	def dtype(self):
		return np.dtype(_bitpix2dtype[self.bitpix]).newbyteorder("=")
	@property
	def ndim(self): return len(self.shape)
	@property
	def scaled(self):
		"""Whether the data are stored scaled (BSCALE / BZERO)."""
		return self.header.get("BSCALE", 1) != 1 or self.header.get("BZERO", 0) != 0
	def read_box(self, y1, y2, x1, x2, out=None):
		"""Rows [y1, y2) and columns [x1, x2) of every plane, unscaled, as
		[*pre, y2-y1, x2-x1] in native byte order, into out where given (of
		the file's dtype; its last axis with unit stride, as a piece of a
		larger buffer may be). Returns out."""
		ny, nx = self.shape[-2:]
		if not (0 <= y1 <= y2 <= ny and 0 <= x1 <= x2 <= nx):
			raise IndexError("box [%d:%d, %d:%d] outside the image %s" % (y1, y2, x1, x2, self.shape))
		oshape = tuple(self.shape[:-2]) + (y2 - y1, x2 - x1)
		if out is None: out = np.empty(oshape, self.dtype)
		if out.shape != oshape or out.dtype != self.dtype:
			raise ValueError("out is %s %s, not %s %s" % (out.shape, out.dtype, oshape, self.dtype))
		if not self.native:
			data, _ = read_map(self.fname, hdu=self.hdu)
			out[...] = data[..., y1:y2, x1:x2]
			return out
		if out.size == 0: return out
		npre, isz = int(np.prod(self.shape[:-2])), out.itemsize
		# the planes' stride, where the leading axes merge into one
		pstride = [s for s, n in zip(out.strides[:-2], out.shape[:-2]) if n > 1]
		if out.strides[-1] != isz or any(a != b*n for a, b, n in zip(out.strides[:-3], out.strides[1:-2],
				out.shape[1:-2]) if n > 1):
			raise ValueError("out's columns must be contiguous, and its planes evenly spaced")
		err = _get_core().fits_read_box_strided(self.fname.encode(), self.data_offset, self.bitpix, npre, ny, nx,
			y1, y2, x1, x2, out.ctypes.data, out.strides[-2]//isz, (pstride[-1] if pstride else 0)//isz)
		if err != 0: raise IOError("%s: native box read failed (%d)" % (self.fname, err))
		return out
	def __getitem__(self, sel):
		"""Basic slicing; reads only the rows and columns it needs from disk."""
		if not isinstance(sel, tuple): sel = (sel,)
		if Ellipsis in sel:
			i = sel.index(Ellipsis)
			sel = sel[:i] + (slice(None),)*(self.ndim - len(sel) + 1) + sel[i+1:]
		full = list(sel) + [slice(None)]*(self.ndim - len(sel))
		y1, y2, yrest = _axis_box(full[-2], self.shape[-2]) if self.ndim >= 2 else (0, 1, slice(None))
		x1, x2, xrest = _axis_box(full[-1], self.shape[-1])
		data = self.read_box(y1, y2, x1, x2)
		data = _scale(data, self.header)
		return data[tuple(full[:-2]) + (yrest, xrest)]

def open_proxy(fname, hdu=0):
	return FitsProxy(fname, hdu=hdu)


# ---------------------------------------------------------------------------
# Binary tables (BINTABLE), for catalogues
# ---------------------------------------------------------------------------
_tform2dtype = {"L": "?", "B": "u1", "I": ">i2", "J": ">i4", "K": ">i8",
	"E": ">f4", "D": ">f8", "C": ">c8", "M": ">c16", "A": "S"}

def _parse_tform(tform):
	"""'1E', '16A', 'D' -> (count, dtype char)."""
	tform = tform.strip()
	i = 0
	while i < len(tform) and tform[i].isdigit(): i += 1
	count = int(tform[:i]) if i > 0 else 1
	code = tform[i]
	return count, code

def read_table(fname, hdu=None):
	"""The first BINTABLE HDU (or the given one) as a dict of numpy column
	arrays keyed by TTYPE name, and its header under "_header"."""
	with _open(fname) as f:
		i = 0
		while True:
			h = _parse_header(f)
			if h is None: raise IOError("No binary table HDU found in %s" % fname)
			is_table = str(h.get("XTENSION", "")).strip().upper().startswith("BINTABLE")
			if is_table and (hdu is None or i == hdu):
				break
			f.seek(_data_size_table(h), 1)
			i += 1
		nrow = int(h["NAXIS2"])
		rowbytes = int(h["NAXIS1"])
		ncol = int(h["TFIELDS"])
		names, dtypes = [], []
		for c in range(1, ncol+1):
			name = str(h.get("TTYPE%d" % c, "col%d" % c)).strip()
			count, code = _parse_tform(str(h["TFORM%d" % c]))
			if code == "A":
				names.append(name); dtypes.append((name, "S%d" % count))
			else:
				dt = _tform2dtype[code]
				names.append(name)
				dtypes.append((name, dt, (count,)) if count > 1 else (name, dt))
		rec = np.dtype(dtypes)
		if rec.itemsize != rowbytes:
			# columns not understood: padding
			dtypes.append(("_pad", "V%d" % (rowbytes - rec.itemsize)))
			rec = np.dtype(dtypes)
		raw = f.read(nrow*rowbytes)
		data = np.frombuffer(raw, dtype=rec, count=nrow)
		out = {}
		for ci, name in enumerate(names):
			col = data[name]
			if col.dtype.kind in "iufc":
				col = col.astype(col.dtype.newbyteorder("="))
			elif col.dtype.kind == "S":
				col = np.char.decode(col, "ascii")
			tdim = h.get("TDIM%d" % (ci+1))
			if tdim:
				sub = tuple(int(t) for t in str(tdim).strip("() ").split(","))[::-1]
				col = col.reshape((nrow,) + sub)
			out[name] = col
		out["_header"] = h
		return out

def _data_size_table(h):
	naxis = int(h.get("NAXIS", 0))
	if naxis == 0: return 0
	size = abs(int(h.get("BITPIX", 8)))//8
	for i in range(1, naxis+1):
		size *= int(h["NAXIS%d" % i])
	size += int(h.get("PCOUNT", 0))
	return (size + BLOCK - 1)//BLOCK*BLOCK

def write_table_fits(fname, columns, header=None):
	"""A dict of numpy columns (1d, or [nrow, ...] per-row arrays) as a
	BINTABLE extension after an empty primary HDU."""
	names = [k for k in columns if not k.startswith("_")]
	dtypes = []
	fits_cols = []
	# (the reference's table has no "b1", numpy's bool, and raises KeyError on one)
	code_map = {"?": "L", "b1": "L", "u1": "B", "i2": "I", "i4": "J", "i8": "K",
		"f4": "E", "f8": "D", "c8": "C", "c16": "M"}
	for name in names:
		col = np.asarray(columns[name])
		sub = col.shape[1:]
		count = int(np.prod(sub)) if sub else 1
		if col.dtype.kind == "U":
			w = max(int(col.dtype.itemsize//4), 1)
			dtypes.append((name, "S%d" % w)); fits_cols.append((name, "%dA" % w))
		else:
			key = col.dtype.str.lstrip("<>=|")
			code = code_map[key]
			dt = (name, ">" + key, sub) if sub else (name, ">" + key)
			dtypes.append(dt)
			fits_cols.append((name, ("%d%s" % (count, code)) if count > 1 else code))
	rec = np.dtype(dtypes)
	data = np.zeros(len(np.asarray(columns[names[0]])), rec)
	for name in names:
		col = np.asarray(columns[name])
		data[name] = col.astype(rec[name].base if rec[name].subdtype else rec[name]) \
			if col.dtype.kind != "U" else col.astype("S")
	prim = [_format_card("SIMPLE", True), _format_card("BITPIX", 8),
		_format_card("NAXIS", 0), _format_card("END", None)]
	tcards = [
		_format_card("XTENSION", "BINTABLE"), _format_card("BITPIX", 8),
		_format_card("NAXIS", 2), _format_card("NAXIS1", rec.itemsize),
		_format_card("NAXIS2", len(data)), _format_card("PCOUNT", 0),
		_format_card("GCOUNT", 1), _format_card("TFIELDS", len(names))]
	for i, (name, code) in enumerate(fits_cols):
		tcards.append(_format_card("TTYPE%d" % (i+1), name))
		tcards.append(_format_card("TFORM%d" % (i+1), code))
		sub = np.asarray(columns[name]).shape[1:]
		if len(sub) > 1:
			tcards.append(_format_card("TDIM%d" % (i+1),
				"(" + ",".join(str(n) for n in sub[::-1]) + ")"))
	if header:
		for k, v in header.items(): tcards.append(_format_card(k, v))
	tcards.append(_format_card("END", None))
	raw = data.tobytes()
	with _open(fname, "wb") as f:
		f.write(_header_text(prim))
		f.write(_header_text(tcards))
		f.write(raw)
		f.write(b"\x00"*((-len(raw)) % BLOCK))
