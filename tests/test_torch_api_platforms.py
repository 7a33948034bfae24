"""Port compat API vs the JAX package: ``getState`` energies (1e-10
relative) and forces (1e-9 of max|F|) of every force group, for the four
interpolation methods on the default, Reference and Common platforms, on
the CPU in float64 (Compensated: ``test_torch_api_compensated.py``). The
grids are each package's own, auto-generated through a receptor Context
(``test_torch_api.py``'s helpers)."""

import numpy as np
import pytest

from test_torch_api import (assert_states_match, jgfp, ligand_context,
                            tgfp, world)  # noqa: F401

PLATFORMS = ("CUDA", "Reference", "Common")


@pytest.mark.parametrize("platform", PLATFORMS)
@pytest.mark.parametrize("method", [0, 1, 2, 3])
def test_get_state_matches_jax(world, method, platform):
    """Energies (1e-10 relative) and forces (1e-9 of max|F|) of every
    force group. The common platform compiles no Hermite branch: both
    packages refuse it."""
    if platform == "Common" and method >= 2:
        for g in (tgfp, jgfp):
            ctx = ligand_context(g, world, method, platform)
            with pytest.raises(ValueError, match="trilinear and B-spline"):
                ctx.getState(getEnergy=True)
        return
    tctx = ligand_context(tgfp, world, method, platform)
    jctx = ligand_context(jgfp, world, method, platform)
    assert_states_match(jctx, tctx)
    st = tctx.getState(getEnergy=True, getPositions=True)
    np.testing.assert_array_equal(st.getPositions(), world["x"])
    assert st.getKineticEnergy() is None
