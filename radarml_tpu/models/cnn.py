"""Multi-view CNN classifier ("DNN" family).

JAX/flax re-design of the reference's Keras classifier (dnn.py:45-91):
three convolutional branches — one per radar projection (xz, yz, xy),
each Conv 64→32, 3×3, stride 2, SAME, ReLU — concatenated, flattened,
then Dense(64)+Dropout(0.5) twice and a softmax head. Optimizer is
Adam(2e-4, β1=0.5) with sparse categorical cross-entropy and class
weights (dnn.py:89-90, 373-381).

Each branch has its own independent 64/32 filter banks, so the XLA
formulation is three convolutions over (B, H, W, 1) channel slices of
the stacked input; XLA fuses the elementwise chains and maps the convs
onto the matrix units. Inputs are expected in [-1, 1] at RESCALE (80×80)
resolution — see data/preprocess.py.
"""

from __future__ import annotations

from typing import Tuple

import flax.linen as nn
import jax
import jax.numpy as jnp

RESCALE: Tuple[int, int] = (80, 80)  # reference dnn.py:33


class ViewBranch(nn.Module):
    """Conv trunk for one projection (dnn.py:45-52)."""

    @nn.compact
    def __call__(self, x: jax.Array) -> jax.Array:
        x = nn.Conv(64, (3, 3), strides=(2, 2), padding="SAME")(x)
        x = nn.relu(x)
        x = nn.Conv(32, (3, 3), strides=(2, 2), padding="SAME")(x)
        x = nn.relu(x)
        return x


class MultiViewCNN(nn.Module):
    """Three-branch projection classifier (dnn.py:55-91)."""

    n_classes: int = 3
    dense_width: int = 64
    dropout_rate: float = 0.5

    @nn.compact
    def __call__(
        self, views: jax.Array, train: bool = False
    ) -> jax.Array:
        """views: (B, H, W, 3) stack with channels (xz, yz, xy).

        Returns (B, n_classes) logits (softmax applied by the loss /
        caller, keeping the head reusable for the SGAN discriminator).
        """
        branches = []
        for v in range(3):
            branches.append(ViewBranch(name=f"branch_{'xz yz xy'.split()[v]}")(
                views[..., v : v + 1]
            ))
        x = jnp.concatenate(branches, axis=-1)
        x = x.reshape(x.shape[0], -1)
        x = nn.relu(nn.Dense(self.dense_width)(x))
        x = nn.Dropout(self.dropout_rate, deterministic=not train)(x)
        x = nn.relu(nn.Dense(self.dense_width)(x))
        x = nn.Dropout(self.dropout_rate, deterministic=not train)(x)
        return nn.Dense(self.n_classes)(x)


def init_cnn(
    key: jax.Array, n_classes: int, rescale: Tuple[int, int] = RESCALE
):
    """(model, params) with parameters initialized at the given size."""
    model = MultiViewCNN(n_classes=n_classes)
    dummy = jnp.zeros((1, rescale[0], rescale[1], 3), dtype=jnp.float32)
    params = model.init({"params": key}, dummy, train=False)["params"]
    return model, params


def cnn_predict_proba(model: MultiViewCNN, params, views: jax.Array) -> jax.Array:
    return jax.nn.softmax(model.apply({"params": params}, views, train=False))
