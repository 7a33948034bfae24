"""Port compat API vs the JAX package on Platform("Compensated"), the
double-float32 accuracy tier: ``getState`` energies (1e-10 relative) and
forces (1e-9 of max|F|) of every force group for the four interpolation
methods, on the CPU. The JAX compensated functions run under
``jax.disable_jit()``: XLA:CPU takes minutes to compile them. Helpers and
grids: ``test_torch_api.py``."""

import jax
import numpy as np
import pytest

from test_torch_api import (assert_states_match, jgfp, ligand_context,
                            tgfp, world)  # noqa: F401


@pytest.mark.parametrize("method", [0, 1, 2, 3])
def test_compensated_state_matches_jax(world, method):
    """The packs are built once per binding and dropped by
    updateParametersInContext."""
    tctx = ligand_context(tgfp, world, method, "Compensated")
    jctx = ligand_context(jgfp, world, method, "Compensated")
    with jax.disable_jit():
        assert_states_match(jctx, tctx, groups=(None, {0}, {1}, {2}))
    assert len(tctx._terms.comp_packs) == 3
    tctx.system.getForces()[4].updateParametersInContext(tctx)
    assert len(tctx._terms.comp_packs) == 0
    st = tctx.getState(getEnergy=True, getPositions=True)
    np.testing.assert_array_equal(st.getPositions(), world["x"])
