from .types import OpticalProps1scl, OpticalProps2str, SourceFuncLW
from .gas_concs import GasConcs
from .kdist import KDist, MinorSpec
from .cloud_lut import CloudLUT
from .aerosol_lut import AerosolLUT
from .radiation import RadiationSolverLW, RadiationSolverSW

__all__ = [
    "OpticalProps1scl", "OpticalProps2str", "SourceFuncLW",
    "GasConcs", "KDist", "MinorSpec", "CloudLUT", "AerosolLUT",
    "RadiationSolverLW", "RadiationSolverSW",
]
