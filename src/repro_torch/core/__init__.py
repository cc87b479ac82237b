"""Synopsis kinds (port of ``repro/core/__init__.py``).

The port registers CountMin, HyperLogLog, Bloom, FM, RHP and DFT so far,
under the reference's names; building any other kind (AMS among them)
answers ok=False through the registry's KeyError
(``synopsis.make_kind``).
"""
from . import hashing  # noqa: F401
from .synopsis import (Synopsis, register_kind, make_kind, known_kinds,
                       kind_params)  # noqa: F401
from .countmin import CountMin
from .hll import HyperLogLog
from .bloom import BloomFilter
from .fm import FMSketch
from .rhp import RHP
from .dft import DFT
from . import batched  # noqa: F401

for _name, _factory in {
    "countmin": CountMin,
    "hyperloglog": HyperLogLog,
    "bloom": BloomFilter,
    "fm": FMSketch,
    "rhp": RHP,
    "dft": DFT,
}.items():
    register_kind(_name, _factory)

__all__ = ["Synopsis", "register_kind", "make_kind", "known_kinds",
           "kind_params", "CountMin", "HyperLogLog", "BloomFilter", "FMSketch",
           "RHP", "DFT", "batched"]
