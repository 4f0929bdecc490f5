"""The synthetic image task (offline stand-in for LEAF FEMNIST): a numpy
copy of ``repro/data/synthetic.py``'s ``SyntheticImageTask``, so both
packages build identical arrays from one seed.

The image task draws class prototypes and *client-conditioned* styles:
each sample is ``prototype[label] + client_style[client] + noise``, so a
client's feature distribution is shifted (feature heterogeneity) on top
of Dirichlet label skew — exactly the client-drift regime CycleSL
targets.  Learnable on CPU in a few hundred SL rounds.
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from repro_torch.data.partition import dirichlet_partition


@dataclass
class SyntheticImageTask:
    """K-class image-like classification, client-conditioned Gaussians."""

    n_classes: int = 10
    img: int = 16
    channels: int = 3
    n_clients: int = 100
    samples_per_client: int = 64
    alpha: float = 0.5              # Dirichlet label skew (inf = iid)
    style_scale: float = 0.6        # client feature-shift strength
    noise: float = 0.35
    seed: int = 0

    def _smooth_patterns(self, rng, n: int, scale: float) -> np.ndarray:
        """Low-frequency spatial patterns (coarse grid, bilinear-upsampled)
        — conv-learnable class signal, unlike white-noise prototypes."""
        coarse = rng.normal(size=(n, 4, 4, self.channels)).astype(np.float32)
        # bilinear upsample 4x4 -> img x img
        xs = np.linspace(0, 3, self.img)
        x0 = np.clip(xs.astype(int), 0, 2)
        fx = (xs - x0)[None, :, None, None]
        up = (coarse[:, x0] * (1 - fx) + coarse[:, x0 + 1] * fx)
        up = np.swapaxes(up, 1, 2)
        up = (up[:, x0] * (1 - fx) + up[:, x0 + 1] * fx)
        up = np.swapaxes(up, 1, 2)
        flat = up.reshape(n, -1)
        flat /= np.linalg.norm(flat, axis=1, keepdims=True) / scale
        return flat

    def build(self):
        rng = np.random.default_rng(self.seed)
        d = self.img * self.img * self.channels
        protos = self._smooth_patterns(rng, self.n_classes,
                                       scale=np.sqrt(d) * 0.5)
        styles = self._smooth_patterns(rng, self.n_clients,
                                       scale=np.sqrt(d) * self.style_scale)

        total = self.n_clients * self.samples_per_client
        labels = rng.integers(0, self.n_classes, size=total).astype(np.int64)
        parts = dirichlet_partition(labels, self.n_clients, self.alpha, rng)

        xs, ys, owner = [], [], []
        for ci, idx in enumerate(parts):
            lab = labels[idx]
            x = (protos[lab]
                 + styles[ci]
                 + self.noise * rng.normal(size=(len(idx), d)).astype(np.float32))
            xs.append(x.astype(np.float32))
            ys.append(lab)
            owner.append(np.full(len(idx), ci, np.int64))
        x = np.concatenate(xs).reshape(-1, self.img, self.img, self.channels)
        y = np.concatenate(ys)
        o = np.concatenate(owner)
        client_indices = []
        offs = 0
        for idx in parts:
            client_indices.append(np.arange(offs, offs + len(idx)))
            offs += len(idx)
        return x, y, o, client_indices
