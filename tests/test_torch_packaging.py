"""The port's packaging in pyproject.toml: every package of
pixell_tpu_torch (each directory with an __init__.py) is listed, its
package data covers every kernel and host source the build compiles at run
time (csrc/*.cu, cpp/*.cpp), and the port's console script names a function
that exists."""
import fnmatch
import importlib
import os
import tomllib

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PKG = os.path.join(ROOT, "pixell_tpu_torch")


def pyproject():
	with open(os.path.join(ROOT, "pyproject.toml"), "rb") as f:
		return tomllib.load(f)


def port_packages():
	"""The dotted names of pixell_tpu_torch and its subpackages on disk."""
	out = set()
	for d, dirs, files in os.walk(PKG):
		dirs[:] = [x for x in dirs if x != "__pycache__"]
		if "__init__.py" in files:
			out.add(os.path.relpath(d, ROOT).replace(os.sep, "."))
	return out


def test_every_package_listed():
	listed = set(pyproject()["tool"]["setuptools"]["packages"])
	assert {"pixell_tpu_torch", "pixell_tpu_torch.ops", "pixell_tpu_torch.parallel"} <= port_packages()
	assert port_packages() - listed == set()


@pytest.mark.parametrize("ext", [".cu", ".cpp"])
def test_package_data_covers_the_sources(ext):
	"""Every source the port builds at first use (nvcc for csrc/*.cu, g++
	for cpp/*.cpp) is package data, so an installed port can build it."""
	pats = pyproject()["tool"]["setuptools"]["package-data"]["pixell_tpu_torch"]
	srcs = [os.path.relpath(os.path.join(d, f), PKG).replace(os.sep, "/")
		for d, _, files in os.walk(PKG) for f in files if f.endswith(ext)]
	assert srcs
	assert [s for s in srcs if not any(fnmatch.fnmatch(s, p) for p in pats)] == []


def test_console_script():
	scripts = pyproject()["project"]["scripts"]
	target = scripts["benchmark-pixell-tpu-torch"]
	mod, _, fun = target.partition(":")
	assert mod == "pixell_tpu_torch.scripts"
	assert callable(getattr(importlib.import_module(mod), fun))
