"""Population simulator: very large simulated client fleets against one
server.

Port of ``repro/scenario/population.py``: the same numpy fold-ins, so
both packages materialize the same clients and draw the same cohorts.

The paper's experiments run 100-ish clients; a production split-learning
service sees orders of magnitude more, most of them tiny.  This module
makes that regime cheap to simulate:

* :class:`PopulationSpec` + :class:`PopulationFed` — N (100k+) synthetic
  clients whose data is **lazily materialized**: a client's few samples
  are generated from a fold-in of ``(seed, client_id)`` the first time a
  cohort touches it, so building a 100 000-client federation costs
  nothing and a whole run only ever materializes the clients that
  actually attended.  The API is exactly :class:`FederatedDataset`
  (``clients[c].sample_batch``, ``test_arrays``), so the unmodified
  Engine drives it.
* :func:`build_population` — the ``(task, fed, metric_key)`` triple:
  a small MLP split task over the virtual federation.
* :func:`run_population` — one scenario run: population + scenario
  config -> Engine -> final eval + churn telemetry + the fleet facts.
  It runs on the card unless the caller passes ``device="cpu"``.

Scale notes: the per-round cost is set by the cohort capacity (the
[C, b, ...] stacks), NOT by N — the fleet only enters through cohort
sampling (O(C) uniform, O(N) weighted) and the lazily-touched client
cache.  Global-client algorithms (cyclesfl/sflv1/...) hold ONE shared
θ_C regardless of N and are the default here; per-client-store
algorithms (psl family) allocate an [N, ...] stack.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import numpy as np

from repro_torch.core.split import make_stage_task
from repro_torch.data.federated import ClientData, FederatedDataset
from repro_torch.models.cnn import mlp
from repro_torch.scenario.profiles import ScenarioConfig

_CLIENT_SALT = 0x9091
_TEST_SALT = 0x9092


@dataclass(frozen=True)
class PopulationSpec:
    """A synthetic client population: class-prototype Gaussians with
    per-client style shift + Dirichlet label skew (the same failure
    modes as :mod:`repro_torch.data.synthetic`, minus the stored arrays)."""

    n_clients: int = 100_000
    d_in: int = 32
    n_classes: int = 8
    samples_per_client: int = 16      # tiny on purpose: fleet, not corpus
    alpha: float = 0.5                # Dirichlet label-skew strength
    style_scale: float = 0.5
    noise: float = 0.3
    test_size: int = 2048             # pooled sample-wise test set
    seed: int = 0


class _LazyClients:
    """Sequence view over the virtual fleet: ``clients[c]`` materializes
    (and caches) that one client's :class:`ClientData`."""

    def __init__(self, fed: "PopulationFed"):
        self._fed = fed

    def __len__(self) -> int:
        return self._fed.spec.n_clients

    def __getitem__(self, c: int) -> ClientData:
        return self._fed.materialize(int(c))

    def __iter__(self):
        for c in range(len(self)):
            yield self[c]


class PopulationFed(FederatedDataset):
    """A :class:`FederatedDataset` whose clients exist only on demand.

    Every client's samples are a pure function of ``(spec.seed, id)``:
    ``x = proto[label] + style[id] + noise``, labels Dirichlet-skewed per
    client.  ``test_arrays`` returns one pooled population-level test
    set (size capped at ``spec.test_size``) drawn from held-out per-id
    streams, so the Engine's global eval path never concatenates N
    client test shards.
    """

    def __init__(self, spec: PopulationSpec):
        self.spec = spec
        self.clients = _LazyClients(self)
        self._cache: dict[int, ClientData] = {}
        self._test: Optional[tuple[np.ndarray, np.ndarray]] = None
        rng = np.random.default_rng([spec.seed & 0xFFFFFFFF, _CLIENT_SALT])
        protos = rng.normal(size=(spec.n_classes, spec.d_in))
        protos /= np.linalg.norm(protos, axis=1, keepdims=True)
        self._protos = (protos * np.sqrt(spec.d_in) * 0.5).astype(np.float32)

    # ------------------------------------------------------------- fleet
    @property
    def n_clients(self) -> int:
        return self.spec.n_clients

    @property
    def materialized(self) -> int:
        """How many clients a run actually touched (cache size)."""
        return len(self._cache)

    def _generate(self, c: int, rng: np.random.Generator, n: int
                  ) -> tuple[np.ndarray, np.ndarray]:
        spec = self.spec
        probs = rng.dirichlet(np.full(spec.n_classes, spec.alpha))
        labels = rng.choice(spec.n_classes, size=n, p=probs)
        style = (rng.normal(size=spec.d_in) * spec.style_scale
                 ).astype(np.float32)
        x = (self._protos[labels] + style
             + spec.noise * rng.normal(size=(n, spec.d_in))
             ).astype(np.float32)
        return x, labels.astype(np.int64)

    def materialize(self, c: int) -> ClientData:
        got = self._cache.get(c)
        if got is not None:
            return got
        spec = self.spec
        if not 0 <= c < spec.n_clients:
            raise IndexError(f"client {c} out of range [0, {spec.n_clients})")
        rng = np.random.default_rng([spec.seed & 0xFFFFFFFF,
                                     _CLIENT_SALT, c])
        n = spec.samples_per_client
        n_test = max(1, n // 10)                 # paper's 90/10 split
        x, y = self._generate(c, rng, n)
        data = ClientData(x[n_test:], y[n_test:], x[:n_test], y[:n_test])
        self._cache[c] = data
        return data

    def test_arrays(self) -> tuple[np.ndarray, np.ndarray]:
        if self._test is None:
            spec = self.spec
            rng = np.random.default_rng([spec.seed & 0xFFFFFFFF, _TEST_SALT])
            ids = rng.choice(spec.n_clients,
                             size=min(spec.test_size, spec.n_clients),
                             replace=spec.test_size > spec.n_clients)
            xs, ys = [], []
            for c in np.unique(ids):
                # held-out stream per sampled id (disjoint salt from the
                # train stream by construction: extra draw count)
                r = np.random.default_rng([spec.seed & 0xFFFFFFFF,
                                           _TEST_SALT, int(c)])
                k = int((ids == c).sum())
                x, y = self._generate(int(c), r, k)
                xs.append(x)
                ys.append(y)
            self._test = (np.concatenate(xs), np.concatenate(ys))
        return self._test


# ---------------------------------------------------------------- builders
def build_population(spec: PopulationSpec, width: int = 32, cut: int = 1):
    """(task, fed, metric_key) for a population run: a small MLP split at
    ``cut`` over the lazy federation."""
    model = mlp(spec.d_in, [width], spec.n_classes)
    task = make_stage_task(model, cut=cut, kind="xent")
    return task, PopulationFed(spec), "accuracy"


def population_config(spec: PopulationSpec, scenario: ScenarioConfig,
                      cohort: int = 32, rounds: int = 10, batch: int = 8,
                      **overrides):
    """An ExperimentConfig sized for the fleet: attendance is derived
    from the target cohort so capacity stays accelerator-friendly while
    N scales to hundreds of thousands."""
    from repro_torch.api.config import ExperimentConfig
    return ExperimentConfig(
        algo=overrides.pop("algo", "cyclesfl"),
        n_clients=spec.n_clients,
        attendance=cohort / spec.n_clients,
        min_cohort=min(2, cohort), batch=batch, rounds=rounds,
        seed=spec.seed, eval_every=max(rounds, 1),
        collect_timing=True, scenario=scenario, **overrides)


def run_population(spec: PopulationSpec, scenario: ScenarioConfig,
                   cohort: int = 32, rounds: int = 10, batch: int = 8,
                   width: int = 32, log=lambda *a, **k: None, device=None,
                   **overrides) -> dict:
    """One population-scale scenario run on ``device`` (None: the card);
    returns the Engine result plus the population facts.

    The JAX package's record also holds ``trace_count``, the jit traces
    of the round; the port's rounds run eagerly and trace nothing, so
    ``res["population"]`` has no such key.
    """
    from repro_torch.api.engine import Engine
    task, fed, mk = build_population(spec, width=width)
    cfg = population_config(spec, scenario, cohort=cohort, rounds=rounds,
                            batch=batch, **overrides)
    eng = Engine(cfg, device=device, task=task, fed=fed, metric_key=mk,
                 log=log)
    res = eng.run()
    res["population"] = {
        "n_clients": spec.n_clients,
        "cohort_capacity": eng.cohort_capacity,
        "clients_materialized": fed.materialized,
        "scenario": scenario.to_dict(),
    }
    return res
