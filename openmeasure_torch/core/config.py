"""Dataclass configs (copy of ``openmeasure_tpu.core.config``).

A config object overrides the individual keyword arguments of the call it
is passed to: ``ROM.fit(config=FitConfig(...))``,
``SPR.optimal_placement(config=PlacementConfig(...))``.  The solver, GP and
co-kriging configs are carried over unchanged for the slices that use them.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Sequence, Union


@dataclasses.dataclass
class FitConfig:
    """ROM/SPR/GPR fit knobs."""
    scale_type: str = "std"
    axis_cnt: Optional[int] = 1
    select_modes: str = "variance"   # 'variance' | 'number'
    n_modes: Union[int, float] = 99


@dataclasses.dataclass
class PlacementConfig:
    """Sensor placement knobs."""
    calc_type: str = "qr"            # 'qr' | 'gem'
    n_sensors: int = 10
    d_min: float = 0.0
    verbose: bool = False


@dataclasses.dataclass
class SolverConfig:
    """ADMM box-QP solver knobs."""
    max_iter: int = 4000
    tol: float = 1e-9
    over_relax: float = 1.6


@dataclasses.dataclass
class GPTrainConfig:
    """GP hyperparameter training knobs."""
    max_iter: int = 1000
    rel_error: float = 1e-5
    lr: float = 0.1
    verbose: bool = False
    engine: str = "device"


@dataclasses.dataclass
class CoKrigingConfig:
    """Multifidelity knobs."""
    scale_type: str = "std"
    regr_type: str = "linear"
    rho_regr: str = "constant"
    normalize: bool = True
    theta: Optional[Sequence[float]] = None
    theta0: Optional[Sequence[float]] = None
    thetaL: Optional[Sequence[float]] = None
    thetaU: Optional[Sequence[float]] = None
    initial_range: float = 0.3
    tol: float = 1e-6
    engine: str = "device"
