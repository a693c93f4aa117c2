"""Observatory site database (counterpart of pixell_tpu/sites.py)."""
from .bunch import Bunch

sites = Bunch(
	act = Bunch(lat=-22.9585,  lon=-67.7876,  alt=5188.0, weather="toco"),
	lat = Bunch(lat=-22.96096, lon=-67.78769, alt=5188.0, weather="toco"),
	sat1 = Bunch(lat=-22.96011, lon=-67.78836, alt=5188.0, weather="toco"),
	sat2 = Bunch(lat=-22.96010, lon=-67.78813, alt=5188.0, weather="toco"),
	sat3 = Bunch(lat=-22.95999, lon=-67.78793, alt=5188.0, weather="toco"),
	alma = Bunch(lat=-23.0290,  lon=-67.7550,  alt=5058.7, weather="toco"),
	spt  = Bunch(lat=-89.9911,  lon=-44.6500,  alt=2835.0, weather="toco"),
	bicep = Bunch(lat=-89.9911, lon=-44.6500,  alt=2835.0, weather="toco"),
	planck = Bunch(lat=0.0, lon=0.0, alt=1.5e9, weather="toco"),
)
sites.so      = sites.lat
sites.toco    = sites.lat
sites.default = sites.toco

default_site = sites.default

weathers = Bunch(
	toco = Bunch(temperature=0, humidity=0.2, pressure=550),
)
weathers.default = weathers.toco

default_weather = weathers.default


def get(name):
	"""Look up a site by name."""
	return sites[name.lower()]

def expand_site(site):
	"""Resolve a site name to its Bunch (pixell_tpu.sites.expand_site)."""
	if isinstance(site, str):
		if site in sites: return sites[site]
		raise ValueError("Unknown site '%s'" % str(site))
	return site

def expand_weather(weather, site=None):
	"""Resolve a weather name, defaulting to the site's typical weather
	(pixell_tpu.sites.expand_weather)."""
	if weather is None or weather == "typical":
		weather = site.weather
	if isinstance(weather, str):
		if weather in weathers: return weathers[weather]
		raise ValueError("Unknown weather '%s'" % str(weather))
	return weather
