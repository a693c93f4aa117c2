"""Declare-before-use configuration registry with file and command-line
overrides (counterpart of pixell_tpu/config.py, whole: plain Python).
Priority: default < config file < command line."""
from __future__ import annotations
import argparse
import os

_params = {}
_overrides = {}
_file_vals = {}


def default(name, value, desc=None):
	"""Register a parameter with its default value."""
	if name not in _params:
		_params[name] = dict(default=value, desc=desc, type=type(value))
	return _params[name]["default"]

def get(name, default_val=None):
	"""Current value of a parameter."""
	if name in _overrides: return _overrides[name]
	if name in _file_vals:
		return _cast(_file_vals[name], _params[name]["type"] if name in _params else None)
	if name in _params: return _params[name]["default"]
	return default_val

def set(name, value):
	"""Set (override) a parameter value."""
	_overrides[name] = value

def save(fname):
	with open(fname, "w") as f:
		for name in sorted(_params):
			f.write("%s = %s\n" % (name, repr(get(name))))

def load(fname):
	with open(fname) as f:
		for line in f:
			line = line.split("#")[0].strip()
			if not line: continue
			key, _, val = line.partition("=")
			_file_vals[key.strip()] = val.strip()

def _cast(val, typ):
	if typ is None: return val
	if typ is bool: return str(val).lower() in ["1", "true", "yes", "t"]
	try: return typ(eval(val, {}, {}))
	except Exception: return val

class override:
	"""Context manager scoping a parameter override."""
	def __init__(self, name, value):
		self.name, self.value = name, value
	def __enter__(self):
		self.old = _overrides.get(self.name, _MISSING)
		_overrides[self.name] = self.value
		return self
	def __exit__(self, *args):
		if self.old is _MISSING: _overrides.pop(self.name, None)
		else: _overrides[self.name] = self.old
class _Missing: pass
_MISSING = _Missing()

class ArgumentParser(argparse.ArgumentParser):
	"""argparse.ArgumentParser that auto-registers config parameters as
	--flags."""
	def parse_args(self, args=None, namespace=None):
		for name, info in _params.items():
			flag = "--" + name.replace("_", "-")
			try:
				if info["type"] is bool:
					self.add_argument(flag, type=str, default=None)
				else:
					self.add_argument(flag, type=info["type"], default=None)
			except argparse.ArgumentError:
				pass
		res = super().parse_args(args, namespace)
		for name in _params:
			val = getattr(res, name.replace("-", "_"), None)
			if val is not None:
				set(name, _cast(val, _params[name]["type"]) if isinstance(val, str) else val)
		return res

def to_str():
	return "\n".join("%s = %s" % (k, repr(get(k))) for k in sorted(_params))

def from_str(string):
	"""Update the configuration from a key = value string
	."""
	for line in string.split("\n"):
		line = line.split("#")[0].strip()
		if not line: continue
		toks = line.split("=")
		if len(toks) != 2:
			raise ValueError("Invalid format in config: %s" % line)
		key, val = toks[0].strip(), toks[1].strip()
		_file_vals[key] = val

def init(name=None, fname=None, must_exist=False):
	"""Load settings from a config file. If fname
	is not given, it is inferred from $<NAME>RC or defaults to ~/.<name>rc."""
	if fname is None:
		if name is None: return
		envname = name.upper() + "RC"
		fname = os.environ.get(envname,
			os.path.expandvars("$HOME/.%src" % name))
	if not os.path.exists(fname):
		if must_exist:
			raise IOError("Config file %s does not exist" % fname)
		return
	load(fname)
