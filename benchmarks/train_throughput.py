"""Honest training-throughput numbers for the NN families.

Measures the fused SGAN 4-phase step at the reference configuration
(128×128 inputs, batch 32; reference sgan.py:504-543 logs ~4.3 steps/s)
and the CNN epoch program (reference dnn.py trains 4868 samples in
~44 s total; dnn/train.log), using slope timing with forced
device→host fetches (utils/slopetime).

Usage:
    python benchmarks/train_throughput.py
Prints one JSON line.
"""

from __future__ import annotations

import json
import os
import sys
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def main():
    import jax

    from radarml_tpu.apps.common_cli import enable_compile_cache

    enable_compile_cache()

    import jax.numpy as jnp

    from radarml_tpu.train.sgan_trainer import (
        SGANConfig, make_sgan_step, sgan_init,
    )

    rng = np.random.default_rng(0)

    # ---- SGAN fused 4-phase step, reference config --------------------
    rescale = (128, 128)
    scfg = SGANConfig(n_classes=3, n_batch=32, n_sup_samples=150)
    gen, disc, state = sgan_init(jax.random.PRNGKey(0), scfg, rescale)
    step = make_sgan_step(gen, disc, scfg)
    half = scfg.n_batch // 2
    sup_v = jnp.asarray(rng.normal(size=(half,) + rescale + (3,)), jnp.float32)
    sup_y = jnp.asarray(rng.integers(0, 3, size=(half,)), jnp.int32)
    real_v = jnp.asarray(rng.normal(size=(half,) + rescale + (3,)), jnp.float32)

    # Steps chain inside one lax.scan dispatch, matching the trainer's
    # fused-chunk schedule (train_sgan); per-step host dispatch would
    # measure dispatch gaps, not the device.
    import functools

    @functools.lru_cache(maxsize=None)
    def chunk_fn(k):
        @jax.jit
        def run(state, key):
            def body(carry, i):
                state, key = carry
                key, sk = jax.random.split(key)
                state, losses = step(state, sup_v, sup_y, real_v, sk)
                return (state, key), losses["c_loss"]

            (state, key), cl = jax.lax.scan(
                body, (state, key), jnp.arange(k)
            )
            return state, cl[-1]

        return run

    def run_steps(state, k, key):
        state, cl = chunk_fn(k)(state, key)
        _ = jax.device_get(cl)
        return state

    key = jax.random.PRNGKey(1)
    state = run_steps(state, 4, key)  # compile + warm
    state = run_steps(state, 24, key)
    times = {}
    for k in (4, 24):
        best = float("inf")
        for _ in range(3):
            t0 = time.perf_counter()
            state = run_steps(state, k, jax.random.fold_in(key, k))
            best = min(best, time.perf_counter() - t0)
        times[k] = best
    sgan_step_s = (times[24] - times[4]) / 20
    sgan_steps_per_sec = 1.0 / sgan_step_s

    # ---- CNN epoch program (448 samples, 80x80, batch 64) -------------
    from radarml_tpu.models.cnn import RESCALE, MultiViewCNN
    from radarml_tpu.train.trainer import TrainConfig, train_cnn

    n = 448
    Xtr = rng.normal(size=(n,) + RESCALE + (3,)).astype(np.float32)
    ytr = rng.integers(0, 3, size=(n,)).astype(np.int32)
    model = MultiViewCNN(n_classes=3)
    params = model.init(
        jax.random.PRNGKey(0), np.zeros((1,) + RESCALE + (3,), np.float32),
        train=False,
    )["params"]

    def cnn_wall(epochs):
        cfg = TrainConfig(epochs=epochs, patience=10**6)
        t0 = time.perf_counter()
        train_cnn(model, params, Xtr, ytr, Xtr[:64], ytr[:64],
                  w_classes=None, config=cfg)
        return time.perf_counter() - t0

    # The whole training run is ONE while_loop dispatch, so the
    # per-epoch marginal is tiny; spread the slope over 100 epochs to
    # resolve it above dispatch jitter. The fused program's shapes
    # depend on the epoch count, so each timed E needs its own
    # compile+warm pass (there is no shared cache entry across Es).
    cnn_wall(10)
    cnn_wall(110)
    t_lo = min(cnn_wall(10) for _ in range(2))
    t_hi = min(cnn_wall(110) for _ in range(2))
    cnn_epoch_s = (t_hi - t_lo) / 100

    print(
        json.dumps(
            {
                "metric": "training throughput (slope-timed)",
                "sgan_steps_per_sec": round(sgan_steps_per_sec, 1),
                "sgan_vs_reference_4.3": round(sgan_steps_per_sec / 4.3, 1),
                "sgan_config": "128x128 batch 32, fused 4-phase step",
                "cnn_epoch_s_448_samples": round(cnn_epoch_s, 4),
                "device": str(jax.devices()[0]),
            }
        )
    )


if __name__ == "__main__":
    main()
