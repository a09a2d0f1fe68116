"""Shared set-up of the port's tests: one small TitaNet in both packages
with the same weights (JAX init, random BatchNorm statistics from numpy)."""

import jax
import jax.numpy as jnp
import numpy as np
import torch

from titanet_torch.models.titanet import TitaNet as TorchTitaNet
from titanet_torch.utils.weights import load_jax_variables
from titanet_tpu.models.titanet import TitaNet as JaxTitaNet

SMALL = dict(n_mega_blocks=2, encoder_hidden_size=128, encoder_output_size=256)


def small_titanet_pair(dtype=None, seed=0, **overrides):
    """(jax_model, jax_variables, torch_model) with identical weights; the
    BatchNorm running statistics are drawn from a seeded numpy generator so
    every BN does real work. ``overrides`` are constructor arguments both
    packages share (``simple_pool``, ``mega_block_kernel_size``, ...)."""
    rng = np.random.default_rng(seed)
    jdt = {None: None, torch.bfloat16: jnp.bfloat16}[dtype]
    cfg = {**SMALL, **overrides}
    jmodel = JaxTitaNet(dtype=jdt, **cfg)
    variables = jmodel.init(jax.random.key(seed), jnp.zeros((1, 16, 80), jnp.float32))
    variables = jax.tree_util.tree_map(np.asarray, dict(variables))

    def stats(tree):
        if "mean" in tree and "var" in tree and not isinstance(tree["mean"], dict):
            n = tree["mean"].shape
            return {
                "mean": (rng.standard_normal(n) * 0.1).astype(np.float32),
                "var": rng.uniform(0.5, 2.0, n).astype(np.float32),
            }
        return {k: stats(v) for k, v in tree.items()}

    variables["batch_stats"] = stats(variables["batch_stats"])
    tmodel = TorchTitaNet(dtype=dtype, **cfg).eval()
    load_jax_variables(tmodel, variables["params"], variables["batch_stats"])
    return jmodel, variables, tmodel


def cosine(a, b):
    a = np.asarray(a, np.float64)
    b = np.asarray(b, np.float64)
    return np.sum(a * b, -1) / (np.linalg.norm(a, axis=-1) * np.linalg.norm(b, axis=-1))
