"""Test fixtures: a small host-device mesh for sharding tests.

The CI matrix runs the suite at 4 AND 8 host devices (set via XLA_FLAGS;
8 is the default for local runs — the 512-device production mesh is only
ever created by launch/dryrun.py, never here). ``N_DEVICES`` below is the
single knob tests key off: the shared fixtures shrink their meshes to
fit, parametrized shape lists filter through ``fitting_shapes``, and
tests with a single hard-coded mesh branch on ``N_DEVICES`` inline.
"""
import math
import os

os.environ.setdefault("XLA_FLAGS", "--xla_force_host_platform_device_count=8")

import jax  # noqa: E402
import numpy as np  # noqa: E402
import pytest  # noqa: E402

N_DEVICES = jax.device_count()


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "gpu: needs a CUDA device (skips without one)")


def fitting_shapes(shapes):
    """Filter 4D mesh shapes to those the host's device count can hold."""
    return [s for s in shapes if math.prod(s) <= N_DEVICES]


@pytest.fixture(scope="session")
def mesh4():
    from repro.launch import mesh as LM
    return LM.make_smoke_mesh((2, 2, 2, 1) if N_DEVICES >= 8
                              else (1, 2, 2, 1))


@pytest.fixture(scope="session")
def axes4(mesh4):
    from repro.launch import mesh as LM
    return LM.bind_4d(mesh4)


@pytest.fixture(scope="session")
def meshz():
    from repro.launch import mesh as LM
    return LM.make_smoke_mesh((1, 2, 2, 2) if N_DEVICES >= 8
                              else (1, 1, 2, 2))


@pytest.fixture(scope="session")
def axesz(meshz):
    from repro.launch import mesh as LM
    return LM.bind_4d(meshz)


def train_smoke(arch: str, mesh, axes, *, steps=3, B=8, S=32,
                overdecompose=2, check_decreases=True):
    """Shared harness: a few real optimizer steps on the reduced config."""
    import jax.numpy as jnp
    from repro.configs import get_config
    from repro.core.partition import spec_tree_to_pspecs
    from repro.launch import steps as ST
    from repro.optim.adamw import AdamWConfig, init_state

    cfg = get_config(arch).reduced()
    params, specs = ST.init_model(cfg, axes, jax.random.PRNGKey(0),
                                  dtype=jnp.float32)
    params = ST.device_put_tree(mesh, params, spec_tree_to_pspecs(specs))
    state = init_state(params)
    step_fn, _, _ = ST.make_train_step(
        cfg, mesh, axes, AdamWConfig(lr=1e-3, warmup_steps=1, total_steps=50),
        ST.TrainOptions(overdecompose=overdecompose, dtype=jnp.float32))
    rng = np.random.RandomState(0)
    batch = {"tokens": jax.numpy.asarray(
        rng.randint(0, cfg.vocab_size, (B, S)), jax.numpy.int32),
        "labels": jax.numpy.asarray(
        rng.randint(0, cfg.vocab_size, (B, S)), jax.numpy.int32)}
    if cfg.arch_type == "vlm":
        batch["image_embeds"] = jax.numpy.asarray(
            rng.randn(B, cfg.encoder.n_ctx, cfg.encoder.input_dim),
            jax.numpy.float32)
    if cfg.arch_type == "audio":
        batch["frames"] = jax.numpy.asarray(
            rng.randn(B, cfg.encoder.n_ctx, cfg.d_model), jax.numpy.float32)
    losses = []
    for _ in range(steps):
        params, state, metrics = step_fn(params, state, batch)
        losses.append(float(metrics["loss"]))
        assert np.isfinite(losses[-1]), f"{arch}: non-finite loss"
    if check_decreases and steps >= 3:
        assert losses[-1] < losses[0], f"{arch}: loss did not decrease"
    return cfg, losses
