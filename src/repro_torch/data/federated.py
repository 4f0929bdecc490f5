"""Federated dataset container + cohort (partial-attendance) sampling:
a numpy copy of ``repro/data/federated.py``, so both packages draw the
same cohorts and batches from one generator.

Implements the paper's experimental protocol: sample-wise 90/10
train/test split per client (§4.1) and a 5% attendance rate per round.
"""
from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np


@dataclass
class ClientData:
    x_train: np.ndarray
    y_train: np.ndarray
    x_test: np.ndarray
    y_test: np.ndarray

    def sample_indices(self, rng: np.random.Generator, batch: int):
        """The one RNG draw behind a batch — exposed so a resumed run can
        fast-forward the sampling stream without materializing arrays."""
        return rng.choice(len(self.x_train), size=batch,
                          replace=len(self.x_train) < batch)

    def sample_batch(self, rng: np.random.Generator, batch: int):
        idx = self.sample_indices(rng, batch)
        return self.x_train[idx], self.y_train[idx]


@dataclass
class FederatedDataset:
    clients: list[ClientData] = field(default_factory=list)

    @classmethod
    def from_arrays(cls, x, y, client_indices, test_frac: float = 0.1,
                    min_train: int = 2, seed: int = 0) -> "FederatedDataset":
        """Sample-wise split per client (paper §4.1).  Clients that cannot
        fill a batch are kept but may resample with replacement."""
        rng = np.random.default_rng(seed)
        clients = []
        for idx in client_indices:
            idx = np.asarray(idx)
            rng.shuffle(idx)
            n_test = max(1, int(len(idx) * test_frac))
            if len(idx) - n_test < min_train:
                n_test = max(0, len(idx) - min_train)
            te, tr = idx[:n_test], idx[n_test:]
            clients.append(ClientData(x[tr], y[tr], x[te], y[te]))
        return cls(clients)

    @property
    def n_clients(self) -> int:
        return len(self.clients)

    def test_arrays(self):
        xs = np.concatenate([c.x_test for c in self.clients if len(c.x_test)])
        ys = np.concatenate([c.y_test for c in self.clients if len(c.y_test)])
        return xs, ys


def sample_cohort(n_clients: int, attendance: float,
                  rng: np.random.Generator, min_cohort: int = 1,
                  variable: bool = False,
                  max_cohort: int | None = None,
                  weights: np.ndarray | None = None) -> np.ndarray:
    """Partial participation: sample distinct attending clients.

    ``variable=False`` (the paper's protocol) fixes the cohort size at
    ``round(attendance * N)``.  ``variable=True`` models realistic
    availability: each client attends i.i.d. with probability
    ``attendance``, so the per-round size is Binomial(N, attendance) —
    clipped to ``[min_cohort, max_cohort]`` so padded execution has a
    static capacity to pad to.

    ``weights`` (optional, length N, need not be normalized) biases the
    draw toward more-available clients — scenario streams with
    time-varying availability (diurnal churn) feed their per-round
    profile weights here.  ``None`` keeps the uniform draw path:
    ``rng.choice`` uses a DIFFERENT algorithm when ``p=`` is given, so
    uniform scenarios must pass ``None`` (not a flat array) to stay
    bit-for-bit with the scenario-free sampler.
    """
    if variable:
        k = int(rng.binomial(n_clients, attendance))
    else:
        k = int(round(attendance * n_clients))
    k = max(min_cohort, k)
    if max_cohort is not None:
        k = min(k, max_cohort)
    if weights is not None:
        p = np.asarray(weights, np.float64)
        p = p / p.sum()
        return rng.choice(n_clients, size=min(k, n_clients), replace=False,
                          p=p)
    return rng.choice(n_clients, size=min(k, n_clients), replace=False)
