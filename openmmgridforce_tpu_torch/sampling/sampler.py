"""BPMF sampler: temperature replica exchange + genetic Monte Carlo.

The whole temperature ladder is one batched MDState [R, N, 3] advanced by
one Langevin segment (per-replica thermostat temperatures), and replica
energies for the Monte Carlo steps come from one batched evaluation.

Monte Carlo moves follow the reference workflow (example/sampler.py):
  * replica exchange: random pair (i, j), Metropolis on
    log_ratio = (beta_i - beta_j)(E_i - E_j), positions swapped on
    acceptance;
  * genetic mutation: pick a (low, high) pair of rungs and copy ONE torsion
    of the high-T replica into the low-T one (in BAT space), Metropolis on
    -beta_low (E_new - E_low);
  * genetic crossover: splice the torsion tail [icut:] of the high-T
    replica into the low-T one, same acceptance.

A genetic move's log_ratio = -beta_low (E_new - E_low) is accepted where
0 <= log_ratio < 30 (crossover) or 50 (mutation), rejected at or above
that window (and where it is not a number), and below 0 accepted where a
uniform u from the host rng is below exp(log_ratio); u is drawn only
there.

Random numbers: moves chosen on the host come from
``np.random.default_rng(seed + 1)``, as in the JAX package, so both pick
the same moves for one seed; draws on the device (velocities, Langevin
noise, exchange pairs) come from the sampler's ``torch.Generator``.

Spans (``utils/observe.py``): ``omgf.sampler.exchange``,
``omgf.sampler.gmc`` (``omgf.sampler.gmc.propose`` around each batch of
proposals) and ``omgf.sampler.md`` around the sweeps and the MD segment;
``omgf.sync.exchange`` and ``omgf.sync.gmc`` around their host reads.
``n_gmc_batches`` counts the genetic sweeps' proposal batches (a re-batch
after a stale move is one more). ``last_exchange`` and ``last_gmc`` keep
what the last sweep of each kind read, drew and decided (references to
what it made; no copy, no synchronisation), so that a check can hold the
decisions against a plain Metropolis of its own.

With a mesh (``parallel.Mesh``) the rungs split over its ``dp`` axis and
each rank advances its rows. The Monte Carlo sweeps need every rung: the
positions are all-gathered, and every rank runs the same sweep on the
whole ladder from the same host rng and generator (seeded alike on every
rank) and keeps its rows. Every draw is of the whole ladder, so a run on
dp ranks repeats the one-rank run.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Sequence

import numpy as np
import torch

from ..device import resolve_device
from ..mm.integrators import MDState
from ..mm.system import GridBinding, System, energy_and_forces, make_md_runner
from ..parallel.replicas import (redraw_hot_velocities, replica_noise,
                                 replica_rows)
from ..units import BOLTZ
from ..utils.observe import trace
from . import bat


@dataclasses.dataclass
class SamplerConfig:
    """Mirrors the reference's input.json knobs (example/input.json)."""

    n_states: int = 21
    t_high: float = 600.0
    t_min: float = 300.0
    dt: float = 0.002            # ps
    friction: float = 1.0        # 1/ps
    md_steps_per_trial: int = 100
    hydrogen_mass: Optional[float] = 4.0
    seed: int = 0


def temperature_ladder(t_min, t_high, n_states):
    """Geometric temperature ladder (equal beta-ratio spacing)."""
    return t_min * (t_high / t_min) ** (np.arange(n_states)
                                        / max(n_states - 1, 1))


def exchange_sweep(energies, betas, i, j, u):
    """Metropolis exchange attempts on a replica permutation, in order.

    ``energies`` [R] of the replicas as they stand, ``betas`` [R] of the
    rungs, and per attempt the draws ``i``, ``j`` [n] (integers in [0, R);
    where they coincide ``j`` moves to a neighbour of ``i``) and ``u`` [n]
    (uniform in [0, 1)). Attempt k compares the replicas now on rungs i_k
    and j_k and swaps them if log_ratio = (beta_i - beta_j)(E_i - E_j) >= 0
    or u_k < exp(log_ratio). Runs on the inputs' device.

    Returns (perm [R]: rung r now holds the replica that stood on rung
    perm[r], n_accepted).
    """
    R = energies.shape[0]
    j = torch.where(i == j, torch.where(i + 1 < R, i + 1, i - 1), j)
    perm = torch.arange(R, device=energies.device)
    n_acc = torch.zeros((), dtype=torch.int64, device=energies.device)
    for k in range(i.shape[0]):
        a, b = i[k:k + 1], j[k:k + 1]
        pa, pb = perm[a], perm[b]
        log_ratio = (betas[a] - betas[b]) * (energies[pa] - energies[pb])
        accept = (log_ratio >= 0) | (u[k:k + 1] < torch.exp(log_ratio))
        perm = perm.index_copy(0, a, torch.where(accept, pb, pa))
        perm = perm.index_copy(0, b, torch.where(accept, pa, pb))
        n_acc = n_acc + accept.sum()
    return perm, n_acc


class Sampler:
    """Replica ladder with MD and Monte Carlo on ``device`` and the move
    bookkeeping on the host."""

    def __init__(self, system: System, grids: Sequence[GridBinding],
                 positions, config: SamplerConfig, bonds=None, mesh=None,
                 mesh_axis: str = "dp", device=None):
        """``positions`` [N, 3] start every rung; ``bonds`` (pairs of atom
        indices) enable genetic MC. ``system`` and ``grids`` must live on
        ``device`` (default: the mesh's).

        ``mesh``: the rungs split over its ``mesh_axis``; ``n_states`` must
        divide by the axis size. If the mesh also has an ``sp`` axis of
        more than one rank, the grids must be one packed binding (any
        type ``parallel.shard_packed_grid`` takes, or a ShardedPackedGrid
        already split over sp, as ``pack_sharded`` makes it), else
        ``ValueError``: its table splits over sp."""
        self.mesh, self._mesh_axis = mesh, mesh_axis
        if mesh is not None:
            n_dev = mesh.size(mesh_axis)
            if config.n_states % n_dev:
                raise ValueError(
                    f"n_states={config.n_states} must be divisible by the "
                    f"'{mesh_axis}' axis size {n_dev}")
            device = mesh.device if device is None else device
        self.device = resolve_device(device)
        if system.masses.device != self.device:
            raise ValueError(f"the system is on {system.masses.device}, the "
                             f"sampler on {self.device}")
        self.system = system
        self.grids = list(grids)
        self.config = config
        self.temperatures = temperature_ladder(config.t_min, config.t_high,
                                               config.n_states)
        self.betas = 1.0 / (BOLTZ * self.temperatures)
        self.generator = torch.Generator(device=self.device)
        self.generator.manual_seed(config.seed)
        self._rng = np.random.default_rng(config.seed + 1)

        dtype = system.masses.dtype
        x0 = torch.as_tensor(positions, dtype=dtype, device=self.device)
        n = config.n_states
        self._rows = (slice(0, n) if mesh is None
                      else replica_rows(mesh, n, mesh_axis))
        n_local = self._rows.stop - self._rows.start
        self.states = MDState(x0.expand(n_local, *x0.shape).clone(),
                              torch.zeros((n_local,) + tuple(x0.shape),
                                          dtype=dtype, device=self.device),
                              self.generator)
        self._temps = torch.as_tensor(self.temperatures, dtype=dtype,
                                      device=self.device)
        self._betas = torch.as_tensor(self.betas, device=self.device)
        if (mesh is not None and "sp" in mesh.axis_names
                and mesh.size("sp") > 1):
            self.grids = [self._shard_grid()]

        # BAT machinery for genetic MC
        self._zmatrix = None
        self._primary = None
        if bonds is not None:
            self._zmatrix, self._primary = bat.build_zmatrix(
                system.masses.cpu().numpy(), bonds)
            self._build_gmc_kernels()

        # MC statistics
        self.n_exchange_accepted = 0
        self.n_exchange_attempted = 0
        self.n_gmc_accepted = 0
        self.n_gmc_attempted = 0
        self.n_gmc_batches = 0
        # the last sweeps' inputs and decisions (class docstring)
        self.last_exchange = None
        self.last_gmc = None

    # ------------------------------------------------------------------
    def _shard_grid(self) -> GridBinding:
        """The one packed binding with its table split over the mesh's sp
        axis."""
        from ..ops.packed import (HermitePackedGrid, MultiHermitePackedGrid,
                                  MultiPackedGrid, PackedGrid)
        from ..parallel.sharded_grid import (ShardedPackedGrid,
                                             shard_packed_grid)

        n_sp = self.mesh.size("sp")
        if len(self.grids) != 1:
            raise ValueError(
                f"an sp axis of {n_sp} ranks splits one packed table; got "
                f"{len(self.grids)} grid bindings (fuse them: "
                f"pack_grids_fused, or pack_sharded from slabs)")
        binding = self.grids[0]
        grid = binding.grid
        if isinstance(grid, (PackedGrid, MultiPackedGrid, HermitePackedGrid,
                             MultiHermitePackedGrid)):
            grid = shard_packed_grid(grid, self.mesh, axis="sp")
        elif not (isinstance(grid, ShardedPackedGrid)
                  and grid.mesh is self.mesh and grid.axis == "sp"):
            raise ValueError(
                f"an sp axis of {n_sp} ranks splits a packed table; got a "
                f"{type(grid).__name__} (pack it: pack_grid, "
                f"pack_grids_fused, pack_sharded)")
        return GridBinding(grid=grid, scaling=binding.scaling)

    def _energies(self, positions):
        """Potential energies [B] of conformations [B, N, 3] (a collective
        when the table is split over sp)."""
        return energy_and_forces(self.system, self.grids, positions)[0]

    def positions(self):
        """Every rung's positions [R, N, 3] (all-gathered over the mesh: a
        collective)."""
        x = self.states.positions
        if self.mesh is None:
            return x
        return self.mesh.all_gather(x, self._mesh_axis)

    def global_states(self) -> MDState:
        """Every rung's positions and velocities (a collective under a
        mesh), with the sampler's generator."""
        v = self.states.velocities
        if self.mesh is not None:
            v = self.mesh.all_gather(v, self._mesh_axis)
        return MDState(self.positions(), v, self.generator)

    def _ladder_draw(self):
        """Fresh normals [R, N, 3] of the whole ladder; this rank's rows."""
        x = self.states.positions
        shape = (self.config.n_states,) + tuple(x.shape[1:])
        return torch.randn(shape, generator=self.generator, dtype=x.dtype,
                           device=x.device)[self._rows]

    def run_md(self, n_steps: Optional[int] = None, *, velocities=None,
               noise=None):
        """Advance every rung by ``n_steps`` (default: the config's per
        trial) of Langevin MD, from fresh Maxwell-Boltzmann velocities at
        each rung's temperature (the reference's MD_with_step).

        ``velocities`` [R, N, 3] and ``noise`` [n_steps, R, N, 3] replace
        the generator's draws (the tests replay the JAX package's)."""
        with trace("omgf.sampler.md"):
            self._run_md(n_steps, velocities, noise)

    def _run_md(self, n_steps, velocities, noise):
        n = int(n_steps or self.config.md_steps_per_trial)
        x = self.states.positions
        temps = self._temps[self._rows]
        if velocities is None:
            sigma_v = torch.sqrt(BOLTZ * temps[:, None]
                                 / self.system.masses)[..., None]
            velocities = sigma_v * self._ladder_draw()
        state = MDState(x, velocities, self.generator)
        if noise is None and self.mesh is not None:
            noise = replica_noise(self.generator, n, x.shape, x.dtype,
                                  self.mesh, self._mesh_axis,
                                  blocks=x.is_cuda)
        run = make_md_runner(n, self.config.dt, self.config.friction,
                             device=self.device)
        self.states = run(state, self.system, self.grids, temps, noise=noise)

    def potential_energies(self) -> np.ndarray:
        """Every rung's potential energy (a collective under a mesh)."""
        return self._energies(self.positions()).cpu().numpy().astype(
            np.float64)

    def drain_trapped(self, threshold_factor: float = 5.0) -> int:
        """Re-thermalize fusion-trapped rungs.

        A rung whose instantaneous temperature exceeds ``threshold_factor``
        times its ladder temperature gets fresh Maxwell-Boltzmann
        velocities at the ladder temperature; every other rung keeps
        bitwise-identical velocities. The standard equilibration remedy
        for the capped-grid fusion orbits (call it between equilibration
        segments, not during production sampling). Returns the number
        re-drawn.
        """
        states, n = redraw_hot_velocities(
            self.global_states(), self.system.masses, self._temps,
            threshold_factor * self._temps)
        self.states = MDState(states.positions[self._rows],
                              states.velocities[self._rows], self.generator)
        return n

    # ------------------------------------------------------------------
    def _pick_pair(self):
        n = self.config.n_states
        isel, jsel = self._rng.integers(n, size=2)
        if isel == jsel:
            jsel = isel + 1 if isel + 1 < n else isel - 1
        return int(isel), int(jsel)

    def _set_positions(self, positions):
        """Every rung's new positions [R, N, 3]; this rank keeps its rows."""
        self.states = self.states._replace(positions=positions[self._rows])

    def replica_exchange(self) -> int:
        """One temperature-exchange attempt (reference selection rule,
        host draws)."""
        isel, jsel = self._pick_pair()
        energies = self.potential_energies()
        log_ratio = (self.betas[isel] - self.betas[jsel]) * (
            energies[isel] - energies[jsel])

        self.n_exchange_attempted += 1
        accept = (log_ratio >= 0
                  or self._rng.random() < np.exp(log_ratio))
        if accept:
            self.n_exchange_accepted += 1
            perm = np.arange(self.config.n_states)
            perm[[isel, jsel]] = perm[[jsel, isel]]
            self._set_positions(self.positions()[
                torch.as_tensor(perm, device=self.device)])
        return int(accept)

    def replica_exchange_sweep(self, n_attempts: int) -> int:
        """``n_attempts`` Metropolis exchange attempts on the device (same
        selection rule as replica_exchange; the generator's draws).
        ``last_exchange`` keeps the ladder's energies, the draws ``i``,
        ``j`` and ``u`` as ``exchange_sweep`` takes them and the
        permutation it returned."""
        with trace("omgf.sampler.exchange"):
            return self._exchange_sweep(n_attempts)

    def _exchange_sweep(self, n_attempts):
        R = self.config.n_states
        positions = self.positions()
        energies = self._energies(positions)
        i = torch.randint(0, R, (n_attempts,), generator=self.generator,
                          device=self.device)
        j = torch.randint(0, R, (n_attempts,), generator=self.generator,
                          device=self.device)
        u = torch.rand(n_attempts, generator=self.generator,
                       dtype=self._betas.dtype, device=self.device)
        perm, n_acc = exchange_sweep(energies, self._betas, i, j, u)
        self._set_positions(positions[perm])
        self.last_exchange = {"energies": energies, "i": i, "j": j, "u": u,
                              "perm": perm}
        with trace("omgf.sync.exchange"):
            n_acc = int(n_acc)
        self.n_exchange_attempted += n_attempts
        self.n_exchange_accepted += n_acc
        return n_acc

    # ------------------------------------------------------------------
    def _build_gmc_kernels(self):
        """The batched BAT converters of the ligand's z-matrix, for
        genetic-MC proposal batches on the device."""
        self._x2b, self._b2x = bat.make_torch_converters(self._zmatrix,
                                                         self._primary)

    def _gmc_propose(self, positions, splice, isel, jsel, icut):
        """Candidates [M, N, 3] and their energies (numpy [M]) of M moves:
        move k replaces torsion icut[k] of rung isel[k] (the tail from it
        where splice[k]) by rung jsel[k]'s, in one batch."""
        def dev(a):
            return torch.as_tensor(np.asarray(a), device=self.device)

        splice, isel, jsel, icut = map(dev, (splice, isel, jsel, icut))
        bi = self._x2b(positions[isel])
        bj = self._x2b(positions[jsel])
        n_t = len(self._zmatrix)
        kk = torch.arange(n_t, device=self.device)
        tmask = torch.where(splice[:, None], kk[None] >= icut[:, None],
                            kk[None] == icut[:, None])
        fmask = torch.cat([torch.zeros((len(icut), 9 + 2 * n_t),
                                       dtype=torch.bool, device=self.device),
                           tmask], 1)
        cands = self._b2x(torch.where(fmask, bj, bi))
        return cands, self._candidate_energies(cands)

    def _candidate_energies(self, cands) -> np.ndarray:
        """Energies (numpy [M]) of M candidate conformations [M, N, 3] in
        one batched evaluation."""
        energies = self._energies(cands)
        with trace("omgf.sync.gmc"):
            return energies.cpu().numpy().astype(np.float64)

    def _pick_low_high(self):
        isel, jsel = self._pick_pair()
        return (isel, jsel) if isel < jsel else (jsel, isel)

    @staticmethod
    def _gmc_decide(rng, log_ratio, splice):
        """(accepted, u) of a genetic move (the window and the draw of
        the class docstring; u None where none was drawn)."""
        if not log_ratio < 0:
            return bool(0 <= log_ratio < (30 if splice else 50)), None
        u = rng.random()
        return bool(u < np.exp(log_ratio)), u

    def _genetic_trial(self, splice: bool, energies=None) -> int:
        if self._zmatrix is None:
            raise RuntimeError("genetic MC needs bonds= at construction")
        isel, jsel = self._pick_low_high()
        positions = self.positions()
        pos = positions.cpu().numpy()
        if energies is None:
            energies = self.potential_energies()

        bat_i = bat.xyz_to_bat(pos[isel], self._zmatrix, self._primary)
        bat_j = bat.xyz_to_bat(pos[jsel], self._zmatrix, self._primary)
        off = 9 + 2 * len(self._zmatrix)
        icut = int(self._rng.integers(len(self._zmatrix)))
        if splice:
            bat_i[off + icut:] = bat_j[off + icut:]
        else:
            bat_i[off + icut] = bat_j[off + icut]
        new_xyz = torch.as_tensor(
            bat.bat_to_xyz(bat_i, self._zmatrix, self._primary),
            dtype=positions.dtype, device=self.device)[None]

        e_new = float(self._energies(new_xyz)[0])
        log_ratio = -self.betas[isel] * (e_new - energies[isel])
        self.n_gmc_attempted += 1
        accept, _ = self._gmc_decide(self._rng, log_ratio, splice)
        if accept:
            self.n_gmc_accepted += 1
            energies[isel] = e_new
            self._set_positions(positions.index_copy(
                0, torch.tensor([isel], device=self.device), new_xyz))
        return int(accept)

    def genetic_mutation(self, energies=None) -> int:
        return self._genetic_trial(splice=False, energies=energies)

    def genetic_crossover(self, energies=None) -> int:
        return self._genetic_trial(splice=True, energies=energies)

    def genetic_sweep(self, n_pairs: int, energies=None) -> int:
        """``n_pairs`` (crossover, mutation) genetic-MC pairs, every
        proposal (BAT round trips, torsion splices, candidate energies)
        computed in one batch on the device and the Metropolis decisions
        taken on the host in order.

        A move whose source or donor rung was already changed by an
        earlier acceptance in the same sweep is stale: processing stops
        there and the remaining moves are proposed again as one batch from
        the updated ladder, which keeps the serial algorithm's semantics at
        one batch per chain of invalidations.

        ``last_gmc`` keeps the ladder's energies at the start, the moves
        (splice, low, high, icut), each batch of proposals as (first move,
        candidates, their energies) and each decision as (move,
        log_ratio, u, accepted)."""
        with trace("omgf.sampler.gmc"):
            return self._genetic_sweep(n_pairs, energies)

    def _genetic_sweep(self, n_pairs, energies):
        if self._zmatrix is None:
            raise RuntimeError("genetic MC needs bonds= at construction")
        pos = self.positions()
        if energies is None:
            at_start = self._energies(pos)
            with trace("omgf.sync.gmc"):
                energies = at_start.cpu().numpy()
        energies = np.array(energies, dtype=float)
        n_t = len(self._zmatrix)

        moves = []
        for _ in range(int(n_pairs)):
            for splice in (True, False):   # crossover, then mutation
                isel, jsel = self._pick_low_high()
                icut = int(self._rng.integers(n_t))
                moves.append((splice, isel, jsel, icut))
        columns = [np.asarray(c) for c in zip(*moves)]
        record = self.last_gmc = {"energies": energies.copy(),
                                  "moves": moves, "proposals": [],
                                  "decisions": []}

        n_acc = 0
        k = 0
        while k < len(moves):
            # the full move list every time (moves before k are ignored)
            with trace("omgf.sampler.gmc.propose"):
                cands, e_new = self._gmc_propose(pos, *columns)
            self.n_gmc_batches += 1
            record["proposals"].append((k, cands, e_new))
            touched: set = set()
            while k < len(moves):
                splice, isel, jsel, icut = moves[k]
                if isel in touched or jsel in touched:
                    break     # stale: re-batch from the updated ladder
                self.n_gmc_attempted += 1
                e_k = float(e_new[k])
                log_ratio = -self.betas[isel] * (e_k - energies[isel])
                accepted, u = self._gmc_decide(self._rng, log_ratio, splice)
                record["decisions"].append((k, float(log_ratio), u,
                                            accepted))
                if accepted:
                    n_acc += 1
                    self.n_gmc_accepted += 1
                    pos = pos.index_copy(
                        0, torch.tensor([isel], device=self.device),
                        cands[k:k + 1])
                    energies[isel] = e_k
                    touched.add(isel)
                k += 1
        if n_acc:
            self._set_positions(pos)
        return n_acc

    # ------------------------------------------------------------------
    def run(self, n_trials: int, n_exchange_per_trial: int = 5,
            n_gmc_per_trial: int = 0, md_steps: Optional[int] = None,
            callback=None):
        """Production loop: per trial an exchange sweep, a genetic-MC
        sweep, an MD segment, then ``callback(trial, sampler)``."""
        for trial in range(n_trials):
            if n_exchange_per_trial > 0:
                self.replica_exchange_sweep(n_exchange_per_trial)
            if n_gmc_per_trial > 0:
                self.genetic_sweep(n_gmc_per_trial)
            self.run_md(md_steps)
            if callback is not None:
                callback(trial, self)
