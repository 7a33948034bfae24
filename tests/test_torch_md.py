"""Port classic Langevin integration and replica initialisation vs the JAX
package (float64, CPU). JAX draws its noise from per-replica threefry keys,
which torch cannot reproduce, so the tests rebuild that noise from the same
key splits and hand it to the port's ``noise=`` input."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke
from openmmgridforce_tpu.mm import integrators as jint
from openmmgridforce_tpu.mm import system as jsystem
from openmmgridforce_tpu.parallel import replicas as jrep
from openmmgridforce_tpu_torch import convert
from openmmgridforce_tpu_torch.mm import integrators, system
from openmmgridforce_tpu_torch.parallel import replicas
from openmmgridforce_tpu_torch.units import BOLTZ

torch.set_num_threads(1)


@pytest.fixture(scope="module")
def ligand():
    lig, x, _, _ = chip_smoke.synthetic_complex(11, n_ligand=17,
                                                n_receptor=10)
    js = jsystem.system_from_amber(lig, dtype=jnp.float64, hydrogen_mass=4.0)
    ts = system.system_from_amber(lig, dtype=torch.float64,
                                  hydrogen_mass=4.0, device="cpu")
    return x, js, ts


def jax_noise(keys, n_steps, shape):
    """[n_steps, R, *shape] normals, drawn as the JAX step draws them:
    per replica, key, sub = split(key) then normal(sub) every step."""
    out = np.zeros((n_steps, len(keys)) + shape)
    for r, key in enumerate(keys):
        for s in range(n_steps):
            key, sub = jax.random.split(key)
            out[s, r] = np.asarray(jax.random.normal(sub, shape,
                                                     dtype=jnp.float64))
    return out


@pytest.mark.parametrize("friction", [5.0, 0.0])
def test_langevin_step_matches_jax(ligand, friction):
    x, js, ts = ligand
    key = jax.random.PRNGKey(3)
    jstate = jint.initialize_state(key, jnp.asarray(x), js.masses, 300.0)

    def jforce(p):
        return jsystem.energy_and_forces(js, [], p)[1]

    jstep = jint.make_langevin_step(jforce, js.masses, 0.001, friction,
                                    300.0)
    ref = jax.jit(jstep)(jstate)
    noise = jax_noise([jstate.key], 1, x.shape)[0, 0]

    tstate = convert.states_from_arrays(np.asarray(jstate.positions),
                                        np.asarray(jstate.velocities),
                                        seed=0, device="cpu")
    tstep = integrators.make_langevin_step(
        lambda p: system.energy_and_forces(ts, [], p)[1], ts.masses, 0.001,
        friction, 300.0)
    got = tstep(tstate, torch.from_numpy(noise))
    np.testing.assert_allclose(got.positions.numpy(),
                               np.asarray(ref.positions), rtol=0, atol=1e-12)
    np.testing.assert_allclose(got.velocities.numpy(),
                               np.asarray(ref.velocities), rtol=1e-12,
                               atol=1e-12)


def test_md_runner_matches_jax(ligand):
    """20 steps of 4 replicas on a temperature ladder."""
    x, js, ts = ligand
    R, n_steps = 4, 20
    temps = np.array([280.0, 300.0, 320.0, 340.0])
    jstates = jrep.init_replica_states(jax.random.PRNGKey(9),
                                       jnp.asarray(x), js.masses,
                                       jnp.asarray(temps), R)
    ref = jsystem.make_md_runner(n_steps, 0.001, 5.0)(
        jstates, js, [], jnp.asarray(temps))
    noise = jax_noise(list(jstates.key), n_steps, x.shape)

    tstates = convert.states_from_arrays(np.asarray(jstates.positions),
                                         np.asarray(jstates.velocities),
                                         seed=1, device="cpu")
    run = system.make_md_runner(n_steps, 0.001, 5.0, device="cpu")
    got = run(tstates, ts, [], torch.from_numpy(temps),
              noise=torch.from_numpy(noise))
    np.testing.assert_allclose(got.positions.numpy(),
                               np.asarray(ref.positions), rtol=0, atol=1e-8)
    np.testing.assert_allclose(
        replicas.replica_temperatures(got, ts.masses).numpy(),
        np.asarray(jrep.replica_temperatures(ref, js.masses)), rtol=1e-6)


def test_runner_draws_its_own_noise(ligand):
    """Without ``noise`` the runner draws from the states' generator: the
    same seed gives the same trajectory, another seed another one."""
    x, _, ts = ligand

    def go(seed):
        gen = torch.Generator().manual_seed(seed)
        s = replicas.init_replica_states(gen, x, ts.masses, 300.0, 3,
                                         device="cpu")
        run = system.make_md_runner(5, 0.001, 5.0, device="cpu")
        return run(s, ts, [], 300.0).positions

    a, b, c = go(1), go(1), go(2)
    assert torch.equal(a, b) and not torch.equal(a, c)
    with pytest.raises(ValueError, match="noise"):
        system.make_md_runner(5, 0.001, 5.0, device="cpu")(
            replicas.init_replica_states(torch.Generator(), x, ts.masses,
                                         300.0, 3, device="cpu"),
            ts, [], 300.0, noise=torch.zeros(4, 3, len(x), 3,
                                             dtype=torch.float64))


def test_init_replica_states_maxwell_boltzmann(ligand):
    x, _, ts = ligand
    R = 3000
    temps = torch.where(torch.arange(R) % 2 == 0, 250.0, 400.0).to(
        torch.float64)
    gen = torch.Generator().manual_seed(123)
    s = replicas.init_replica_states(gen, x, ts.masses, temps, R,
                                     device="cpu")
    assert s.positions.shape == (R,) + x.shape
    assert torch.equal(s.positions[R - 1], torch.from_numpy(x))
    # m v^2 / kT is chi-square(1) per component: mean 1, sd sqrt(2/n)
    z = (ts.masses[:, None] * s.velocities ** 2
         / (BOLTZ * temps[:, None, None]))
    for half in (z[0::2], z[1::2]):
        n = half.numel()
        assert abs(float(half.mean()) - 1.0) < 5.0 * np.sqrt(2.0 / n)
    t_inst = replicas.replica_temperatures(s, ts.masses)
    assert abs(float(t_inst[0::2].mean()) - 250.0) < 3.0
    assert abs(float(t_inst[1::2].mean()) - 400.0) < 5.0



# ----------------------------------------------------------------------
# The other schemes and constraints: 20 steps of 3 replicas each, the
# JAX steps vmapped over per-replica keys, their noise replayed
# ----------------------------------------------------------------------

N_STEPS = 20


@pytest.fixture(scope="module")
def constrained():
    lig, x, _, _ = chip_smoke.synthetic_complex(11, n_ligand=19,
                                                n_receptor=10)
    js = jsystem.system_from_amber(lig, dtype=jnp.float64, hydrogen_mass=4.0,
                                   constraints="HBonds")
    ts = system.system_from_amber(lig, dtype=torch.float64,
                                  hydrogen_mass=4.0, constraints="HBonds",
                                  device="cpu")
    jstates = jrep.init_replica_states(jax.random.PRNGKey(21),
                                       jnp.asarray(x), js.masses, 300.0, 3)
    return js, ts, jstates


def _forces(js, ts):
    return (lambda p: jsystem.energy_and_forces(js, [], p)[1],
            lambda p: system.energy_and_forces(ts, [], p)[1])


def _port_states(jstates):
    return convert.states_from_arrays(np.asarray(jstates.positions),
                                      np.asarray(jstates.velocities),
                                      seed=0, device="cpu")


def _close(got, ref, atol=1e-10):
    np.testing.assert_allclose(got.positions.numpy(),
                               np.asarray(ref.positions), rtol=0, atol=atol)
    np.testing.assert_allclose(got.velocities.numpy(),
                               np.asarray(ref.velocities), rtol=0,
                               atol=1e3 * atol)


@pytest.mark.parametrize("scheme,constrain", [
    ("classic", True), ("middle", False), ("middle", True)])
def test_langevin_schemes_match_jax(constrained, scheme, constrain):
    js, ts, jstates = constrained
    jf, tf = _forces(js, ts)
    dt = 0.002 if constrain else 0.001
    jstep = jint.make_langevin_step(
        jf, js.masses, dt, 5.0, 300.0, scheme=scheme,
        constraints=js.constraints if constrain else None)
    ref = jax.jit(jax.vmap(lambda s: jint.run_segment(jstep, s, N_STEPS)))(
        jstates)
    noise = jax_noise(list(jstates.key), N_STEPS,
                      jstates.positions.shape[1:])
    tstep = integrators.make_langevin_step(
        tf, ts.masses, dt, 5.0, 300.0, scheme=scheme,
        constraints=ts.constraints if constrain else None)
    got = integrators.run_segment(tstep, _port_states(jstates), N_STEPS,
                                  noise=torch.from_numpy(noise))
    _close(got, ref)
    if constrain:
        idx = ts.constraints.idx
        d = got.positions[:, idx[:, 0]] - got.positions[:, idx[:, 1]]
        rel = (d.norm(dim=-1) / ts.constraints.length - 1.0).abs()
        assert float(rel.max()) < 1e-4


def test_md_runner_takes_the_system_constraints(constrained):
    """make_md_runner(scheme=) passes the System's constraints to the
    step, as the JAX runner does."""
    js, ts, jstates = constrained
    temps = np.array([300.0, 330.0, 360.0])
    ref = jsystem.make_md_runner(N_STEPS, 0.002, 5.0, scheme="middle")(
        jstates, js, [], jnp.asarray(temps))
    noise = jax_noise(list(jstates.key), N_STEPS,
                      jstates.positions.shape[1:])
    run = system.make_md_runner(N_STEPS, 0.002, 5.0, scheme="middle",
                                device="cpu")
    got = run(_port_states(jstates), ts, [], torch.from_numpy(temps),
              noise=torch.from_numpy(noise))
    _close(got, ref)


@pytest.mark.parametrize("constrain", [False, True])
def test_verlet_matches_jax(constrained, constrain):
    js, ts, jstates = constrained
    jf, tf = _forces(js, ts)
    jstep = jint.make_verlet_step(
        jf, js.masses, 0.001, constraints=js.constraints if constrain
        else None)
    ref = jax.jit(jax.vmap(lambda s: jint.run_segment(jstep, s, N_STEPS)))(
        jstates)
    tstep = integrators.make_verlet_step(
        tf, ts.masses, 0.001, constraints=ts.constraints if constrain
        else None)
    got = integrators.run_segment(tstep, _port_states(jstates), N_STEPS)
    _close(got, ref)


def test_respa_matches_jax(constrained):
    """Slow force: the intra-ligand pairs; fast: the bonded terms. 5 outer
    steps of 4 inner classic steps, constrained."""
    from openmmgridforce_tpu.mm import forcefield as jff
    from openmmgridforce_tpu.ops import pairwise as jpairwise
    from openmmgridforce_tpu_torch.mm import forcefield
    from openmmgridforce_tpu_torch.ops import pairwise

    js, ts, jstates = constrained
    n_outer, n_inner = 5, 4

    def jslow(p):
        return jpairwise.pair_energy_forces(js.pairs, p)[1]

    def jfast(p):
        return jff.bonded_energy_forces(p, js)[1]

    jstep = jint.make_respa_langevin_step(jslow, jfast, js.masses, 0.002,
                                          n_inner, 5.0, 300.0,
                                          constraints=js.constraints)
    ref = jax.jit(jax.vmap(lambda s: jint.run_respa_segment(
        jstep, jslow, s, n_outer)))(jstates)
    noise = jax_noise(list(jstates.key), n_outer * n_inner,
                      jstates.positions.shape[1:])
    noise = noise.reshape((n_outer, n_inner) + noise.shape[1:])

    def tslow(p):
        return pairwise.pair_energy_forces(ts.pairs, p)[1]

    def tfast(p):
        return forcefield.bonded_energy_forces(p, ts)[1]

    tstep = integrators.make_respa_langevin_step(
        tslow, tfast, ts.masses, 0.002, n_inner, 5.0, 300.0,
        constraints=ts.constraints)
    got = integrators.run_respa_segment(tstep, tslow, _port_states(jstates),
                                        n_outer,
                                        noise=torch.from_numpy(noise))
    _close(got, ref)


@pytest.mark.parametrize("n_steps,every", [(12, 4), (10, 4)])
def test_run_trajectory_matches_jax(constrained, n_steps, every):
    js, ts, jstates = constrained
    jf, tf = _forces(js, ts)
    jstep = jint.make_verlet_step(jf, js.masses, 0.001)
    tstep = integrators.make_verlet_step(tf, ts.masses, 0.001)
    if n_steps % every:
        for run in (lambda: jint.run_trajectory(
                        jstep, jax.tree.map(lambda a: a[0], jstates),
                        n_steps, every),
                    lambda: integrators.run_trajectory(
                        tstep, _port_states(jstates), n_steps, every)):
            with pytest.raises(ValueError, match="not a multiple"):
                run()
        return
    ref_final, ref_traj = jax.vmap(
        lambda s: jint.run_trajectory(jstep, s, n_steps, every))(jstates)
    final, traj = integrators.run_trajectory(tstep, _port_states(jstates),
                                             n_steps, every)
    assert traj.shape == (n_steps // every,) + tuple(
        jstates.positions.shape)
    np.testing.assert_allclose(traj.numpy(),
                               np.moveaxis(np.asarray(ref_traj), 1, 0),
                               rtol=0, atol=1e-10)
    _close(final, ref_final)
