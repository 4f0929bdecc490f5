"""Non-iid partitioning (paper §4.1, Appendix I): a numpy copy of
``repro/data/partition.py``'s ``dirichlet_partition``, so both packages
draw the same partition from one generator.

* ``dirichlet_partition`` — FL-bench-style Dirichlet(alpha) label skew:
  smaller alpha => stronger heterogeneity (paper CIFAR-100 setup).
"""
from __future__ import annotations

import numpy as np


def dirichlet_partition(labels: np.ndarray, n_clients: int, alpha: float,
                        rng: np.random.Generator,
                        min_per_client: int = 2) -> list[np.ndarray]:
    """Split sample indices across clients with Dirichlet(alpha) label skew.

    Returns a list of index arrays, one per client.  alpha=inf -> iid.
    """
    n_classes = int(labels.max()) + 1
    idx_by_class = [np.flatnonzero(labels == c) for c in range(n_classes)]
    for idx in idx_by_class:
        rng.shuffle(idx)
    client_idx: list[list[int]] = [[] for _ in range(n_clients)]
    for c, idx in enumerate(idx_by_class):
        if np.isinf(alpha):
            props = np.full(n_clients, 1.0 / n_clients)
        else:
            props = rng.dirichlet(np.full(n_clients, alpha))
        cuts = (np.cumsum(props) * len(idx)).astype(int)[:-1]
        for i, part in enumerate(np.split(idx, cuts)):
            client_idx[i].extend(part.tolist())
    out = []
    for i in range(n_clients):
        arr = np.asarray(client_idx[i], dtype=np.int64)
        rng.shuffle(arr)
        out.append(arr)
    # re-seat clients that got starved (keeps every client usable)
    pool = np.concatenate(out) if out else np.arange(len(labels))
    for i in range(n_clients):
        if len(out[i]) < min_per_client:
            take = rng.choice(pool, size=min_per_client, replace=False)
            out[i] = np.asarray(take, dtype=np.int64)
    return out
