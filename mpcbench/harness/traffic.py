"""The one generator every traffic mix goes through: the chains' start
states and the sample of ticks and rows that the reference checks, both
drawn from ``--seed``.

A mix (``traffic/<name>.json``) gives:

- ``batch`` B, ``t0_ms`` the mission time of each chain's first tick,
  ``plant_dt_ms`` the plant's period (the time a tick advances),
  ``convergence_init`` the solver's first homotopy tolerance;
- ``chain_ticks``: ticks in a chain; every chain starts from a fresh state;
- ``host_hop``: ``tick`` (x0 copied up, one replay, u0 and the plant state
  fetched, every tick: a robot's controller) or ``chain`` (the chain's
  replays back to back, costs, feasible flags and iterations fetched once
  at its end: a batch study);
- ``start``: ``cold`` (x0 tiled, hover thrust) or ``warm`` (a depth
  ``warm_depth`` fixed solve from the cold start, once in set-up);
  ``starts_per_chain``: a new x0 for each chain, or one for all;
- ``noise_sd``, ``noise_skip``: x0 is the offline reference's state at t0
  plus normal noise of that deviation, zero on the columns
  ``noise_skip[0]:noise_skip[1]`` (the quaternion); ``draw_seed``: null
  (the noise drawn from ``--seed``) or a fixed seed: then every run
  solves the same set of scenarios and ``--seed`` only orders the rows,
  so a route whose work depends on the data does the same work each run;
- ``route``: ``graph`` (the tick captured in one CUDA graph and replayed;
  a failed capture ends the run) or ``eager`` (the solve's fixed route
  called at every tick, which reads the host between iterations);
- ``sample``: ``ticks`` snapshots compared, ``rows`` rows of each (one
  drawn from each of as many equal strata of the batch), ``start_tick``
  whether every chain's first tick (a cold start) is compared;
- ``trace``: the traced stretch, ``chains`` whole chains or ``ticks``
  ticks of one chain.

The window snapshots ``ceil(ticks / MIN_CHAINS)`` ticks drawn in each
chain (and each chain's first tick where ``start_tick``), and does not
close before ``ticks`` snapshots are taken; the compared ticks are every
chain's first tick so taken, and the rest drawn from the seed.
"""

from __future__ import annotations

from typing import Dict, List, NamedTuple, Optional, Set, Tuple

import numpy as np

#: chain starts drawn ahead; a longer window reuses them in turn
MAX_CHAINS = 4096
#: the compared ticks are spread over at least this many chains
MIN_CHAINS = 4


def chain_starts(traffic: Dict, seed: int, x_t0: np.ndarray) -> np.ndarray:
    """x0 of each chain, (MAX_CHAINS or 1, B, nx) float64."""
    fixed = traffic["draw_seed"]
    rng = np.random.default_rng(seed if fixed is None else fixed)
    n, B = MAX_CHAINS if traffic["starts_per_chain"] else 1, traffic["batch"]
    noise = rng.normal(size=(n, B, x_t0.shape[0]))
    noise *= traffic["noise_sd"]
    a, b = traffic["noise_skip"]
    noise[..., a:b] = 0.0
    if fixed is not None:
        noise = noise[:, np.random.default_rng(seed).permutation(B)]
    return x_t0[None, None] + noise


class Plan(NamedTuple):
    """Which ticks are snapshotted, and which of them are compared."""

    snaps: Set[Tuple[int, int]]   # (chain, tick) pairs to snapshot
    first: Optional[Tuple[int, int]]  # the pair always compared
    starts: bool                  # every snapshotted chain start is compared
    rows: np.ndarray              # rows of each snapshot compared
    n_compared: int
    seed: int

    def complete(self, taken) -> bool:
        """Whether the snapshots ``taken`` hold the whole sample."""
        return self.first in taken and len(taken) >= self.n_compared

    def choose(self, taken: List[Tuple[int, int]]) -> List[Tuple[int, int]]:
        """The compared pairs among those snapshotted: ``first``, the chain
        starts where ``starts``, and the rest drawn from the seed."""
        taken = sorted(taken)
        must = [self.first] + [p for p in taken if self.starts and p[1] == 0
                               and p != self.first]
        must = must[:self.n_compared]
        rest = [p for p in taken if p not in must]
        k = min(self.n_compared - len(must), len(rest))
        rng = np.random.default_rng([self.seed, 2])
        pick = rng.choice(len(rest), size=k, replace=False) if k > 0 else []
        return sorted(must + [rest[i] for i in pick])


def plan(traffic: Dict, seed: int, ticks_per_chain: int,
         n_chains: int = MAX_CHAINS) -> Plan:
    """The sample of ``n_chains`` chains of ``ticks_per_chain`` ticks."""
    s = traffic["sample"]
    rng = np.random.default_rng([seed, 1])
    per_chain = min(-(-s["ticks"] // MIN_CHAINS), ticks_per_chain)
    snaps = set()
    for c in range(n_chains):
        ks = rng.choice(ticks_per_chain, size=per_chain, replace=False)
        snaps.update((c, int(k)) for k in ks)
        if s["start_tick"]:
            snaps.add((c, 0))
    first = (0, min(k for c, k in snaps if c == 0))
    B, R = traffic["batch"], s["rows"]
    edges = np.linspace(0, B, R + 1).astype(int)
    rows = np.array([rng.integers(edges[i], edges[i + 1]) for i in range(R)])
    return Plan(snaps=snaps, first=first, starts=bool(s["start_tick"]),
                rows=rows, n_compared=s["ticks"], seed=seed)


def nothing(seed: int) -> Plan:
    """A plan that snapshots nothing (the untimed and traced stretches)."""
    return Plan(snaps=set(), first=None, starts=False,
                rows=np.zeros(0, int), n_compared=0, seed=seed)
