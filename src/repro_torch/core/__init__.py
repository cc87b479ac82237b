"""Synopsis kinds (port of ``repro/core/__init__.py``).

The port registers CountMin, AMS, HyperLogLog, Bloom, FM, RHP, DFT, Lossy
Counting, the chain sampler, Sticky Sampling and GK quantiles so far,
under the reference's names; building any other kind (CoreSetTree, the
last scan-path kind, among them) answers ok=False through the registry's
KeyError (``synopsis.make_kind``).
"""
from . import hashing  # noqa: F401
from .synopsis import (Synopsis, register_kind, make_kind, known_kinds,
                       kind_params)  # noqa: F401
from .countmin import CountMin
from .ams import AMS
from .hll import HyperLogLog
from .bloom import BloomFilter
from .fm import FMSketch
from .rhp import RHP
from .dft import DFT
from .lossy import LossyCounting
from .sampler import ReservoirSampler
from .sticky import StickySampling
from .gk import GKQuantiles
from . import batched  # noqa: F401

for _name, _factory in {
    "countmin": CountMin,
    "ams": AMS,
    "hyperloglog": HyperLogLog,
    "bloom": BloomFilter,
    "fm": FMSketch,
    "rhp": RHP,
    "dft": DFT,
    "lossy_counting": LossyCounting,
    "sticky_sampling": StickySampling,
    "chain_sampler": ReservoirSampler,
    "gk_quantiles": GKQuantiles,
}.items():
    register_kind(_name, _factory)

__all__ = ["Synopsis", "register_kind", "make_kind", "known_kinds",
           "kind_params", "CountMin", "AMS", "HyperLogLog", "BloomFilter",
           "FMSketch", "RHP", "DFT", "LossyCounting", "StickySampling",
           "ReservoirSampler", "GKQuantiles", "batched"]
