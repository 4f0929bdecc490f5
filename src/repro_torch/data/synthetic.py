"""Synthetic tasks (offline stand-ins for LEAF FEMNIST, CIFAR-100,
Shakespeare and OpenEDS2020 gaze): a numpy copy of
``repro/data/synthetic.py``, draw for draw, so both packages build
identical arrays from one seed.

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


@dataclass
class SyntheticCharLMTask:
    """Char-LM stand-in for Shakespeare: client-specific Markov chains."""

    vocab: int = 80
    seq_len: int = 20
    n_clients: int = 50
    samples_per_client: int = 128
    heterogeneity: float = 0.7      # mix weight of the client's own chain
    seed: int = 0

    def build(self):
        rng = np.random.default_rng(self.seed)
        base = rng.dirichlet(np.ones(self.vocab) * 0.3, size=self.vocab)
        xs, ys, client_indices = [], [], []
        offs = 0
        for ci in range(self.n_clients):
            own = rng.dirichlet(np.ones(self.vocab) * 0.3, size=self.vocab)
            trans = (self.heterogeneity * own
                     + (1 - self.heterogeneity) * base)
            seqs = np.empty((self.samples_per_client, self.seq_len + 1), np.int64)
            state = rng.integers(0, self.vocab, self.samples_per_client)
            seqs[:, 0] = state
            for t in range(1, self.seq_len + 1):
                cdf = np.cumsum(trans[state], axis=1)
                u = rng.random((self.samples_per_client, 1))
                state = (u > cdf).sum(axis=1).clip(0, self.vocab - 1)
                seqs[:, t] = state
            xs.append(seqs[:, :-1])
            ys.append(seqs[:, -1])      # next-char prediction target
            client_indices.append(np.arange(offs, offs + self.samples_per_client))
            offs += self.samples_per_client
        return (np.concatenate(xs), np.concatenate(ys),
                np.repeat(np.arange(self.n_clients), self.samples_per_client),
                client_indices)


@dataclass
class SyntheticRegressionTask:
    """Gaze-estimation stand-in (OpenEDS2020): per-client bias regression."""

    d_in: int = 64
    d_out: int = 2                 # gaze direction (yaw, pitch)
    n_clients: int = 40
    samples_per_client: int = 96
    client_bias: float = 0.4
    noise: float = 0.1
    seed: int = 0

    def build(self):
        rng = np.random.default_rng(self.seed)
        w = rng.normal(size=(self.d_in, self.d_out)).astype(np.float32) * 0.3
        xs, ys, client_indices = [], [], []
        offs = 0
        for ci in range(self.n_clients):
            bias = rng.normal(size=(1, self.d_out)).astype(np.float32) * self.client_bias
            x = rng.normal(size=(self.samples_per_client, self.d_in)).astype(np.float32)
            y = np.tanh(x @ w) + bias + self.noise * rng.normal(
                size=(self.samples_per_client, self.d_out)).astype(np.float32)
            xs.append(x)
            ys.append(y.astype(np.float32))
            client_indices.append(np.arange(offs, offs + self.samples_per_client))
            offs += self.samples_per_client
        return (np.concatenate(xs), np.concatenate(ys),
                np.repeat(np.arange(self.n_clients), self.samples_per_client),
                client_indices)
