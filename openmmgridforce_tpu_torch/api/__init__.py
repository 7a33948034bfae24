"""Reference-compatible stateful API, on the CUDA card.

The port of the JAX package's ``api``: code written against the
reference's SWIG module, or against ``openmmgridforce_tpu.api``, runs
with its import line changed:

    import openmmgridforce_tpu_torch.api as gfp
    grid = gfp.GridForce()
    grid.loadFromFile("charge.grid")
    grid.setInterpolationMethod(1)
    system = gfp.create_system("ligand.prmtop")
    system.addForce(grid)
    ctx = gfp.Context(system, gfp.LangevinIntegrator(300, 1.0, 0.002))
    ctx.setPositions(x)
    e = ctx.getState(getEnergy=True).getPotentialEnergy()

``create_system``, ``Context`` and ``Simulation`` run on the card unless
given ``device="cpu"``.
"""

from .context import (ApiSystem, Context, HarmonicAngleForce,  # noqa: F401
                      HarmonicBondForce, LangevinIntegrator,
                      LangevinMiddleIntegrator, NonbondedForce,
                      PeriodicTorsionForce, Platform, Simulation, State,
                      VerletIntegrator, clearGridCache, create_system)
from .gridforce import (Force, GridData, GridForce,  # noqa: F401
                        InvPowerMode_NONE, InvPowerMode_RUNTIME,
                        InvPowerMode_STORED, ParticleGroup,
                        castToGridForce)
from .isolated import IsolatedNonbondedForce  # noqa: F401
