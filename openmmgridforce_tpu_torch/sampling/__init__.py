"""BPMF sampling: BAT coordinates, replica exchange and genetic MC."""

from .bat import bat_to_xyz, build_zmatrix, xyz_to_bat
from .sampler import (Sampler, SamplerConfig, exchange_sweep,
                      temperature_ladder)

__all__ = ["Sampler", "SamplerConfig", "bat_to_xyz", "build_zmatrix",
           "exchange_sweep", "temperature_ladder", "xyz_to_bat"]
