"""The port's package surface vs the JAX package's: every name a JAX
``__init__`` exports (read with ``ast``, without importing JAX) imports from
the port's package of the same path, but for the names that stay JAX-only
under their ROADMAP items; ``LOSSES`` has the same keys; and
``make_sphereface``/``make_cosface``/``make_arcface`` return the three
head subclasses, which equal the JAX heads on the same weights."""

import ast
import importlib
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

# names that stay JAX-only, with the ROADMAP Queue 1 item that holds each:
# XLA compiler flags, which nothing in PyTorch takes (not ported, by decision)
JAX_ONLY = {
    "infer_xla_options": 9,
    "train_xla_options": 9,
}
PACKAGES = ["", "data", "losses", "models", "ops", "parallel", "train", "utils"]


def _exported(package: str):
    """Names the JAX package's ``__init__`` binds: its ``from titanet_tpu...
    import`` names and its own top-level functions and classes."""
    path = os.path.join(REPO, "titanet_tpu", *package.split("."), "__init__.py")
    names = []
    for node in ast.parse(open(path).read()).body:
        if isinstance(node, ast.ImportFrom) and (node.module or "").startswith("titanet_tpu"):
            names += [a.asname or a.name for a in node.names]
        elif isinstance(node, (ast.FunctionDef, ast.ClassDef)):
            names.append(node.name)
    return names


@pytest.mark.parametrize("package", PACKAGES, ids=lambda p: p or "titanet_torch")
def test_every_jax_export_imports_from_the_port(package):
    names = _exported(package)
    assert names
    port = importlib.import_module("titanet_torch" + (f".{package}" if package else ""))
    missing = [n for n in names if n not in JAX_ONLY and not hasattr(port, n)]
    assert missing == []


def test_jax_only_names_and_packages_are_the_listed_ones():
    """The JAX-only names are exactly those the JAX package exports and the
    port lacks; the one JAX-only package is ``ops.pallas``, whose kernels
    live in ``titanet_torch.ops.kernels``."""
    lacking = set()
    for package in PACKAGES:
        port = importlib.import_module("titanet_torch" + (f".{package}" if package else ""))
        lacking |= {n for n in _exported(package) if not hasattr(port, n)}
    assert lacking == set(JAX_ONLY)
    for package in ("ops.pallas",):
        assert os.path.isdir(os.path.join(REPO, "titanet_tpu", *package.split(".")))
        with pytest.raises(ImportError):
            importlib.import_module(f"titanet_torch.{package}")
    import titanet_torch.ops.kernels as kernels

    assert hasattr(kernels.melspec, "log_mel_spectrogram_pallas")


def test_losses_registry_has_the_jax_keys():
    from titanet_torch.losses import LOSSES, build_head
    from titanet_tpu.losses import LOSSES as JAX_LOSSES

    assert sorted(LOSSES) == sorted(JAX_LOSSES)
    assert all(v is build_head for v in LOSSES.values())


E, N, B = 16, 5, 8


@pytest.mark.parametrize("make,cls,margin", [
    ("make_sphereface", "SphereFaceHead", 2.0),
    ("make_cosface", "CosFaceHead", 0.2),
    ("make_arcface", "ArcFaceHead", 0.3),
])
def test_margin_heads_are_subclasses_and_match_jax(make, cls, margin):
    from titanet_torch.losses import heads as th
    from titanet_torch.utils.weights import load_jax_variables
    from titanet_tpu.losses import heads as jh

    head = getattr(th, make)(N, E, margin=margin)
    assert type(head) is getattr(th, cls) and isinstance(head, th.AngularMarginHead)
    jhead = getattr(jh, make)(N, E, margin=margin)
    assert type(jhead).__name__ == cls
    rng = np.random.default_rng(0)
    emb = rng.standard_normal((B, E)).astype(np.float32)
    targets = np.array([0, 0, 1, 1, 2, 2, 3, 4], np.int32)
    params = jhead.init(jax.random.key(0), jnp.asarray(emb), jnp.asarray(targets))["params"]
    load_jax_variables(head, jax.tree_util.tree_map(np.asarray, dict(params)))
    j_norm, j_preds, j_loss = jhead.apply({"params": params}, jnp.asarray(emb), jnp.asarray(targets))
    t_norm, t_preds, t_loss = head(torch.from_numpy(emb), torch.from_numpy(targets))
    np.testing.assert_allclose(t_loss.item(), float(j_loss), rtol=1e-5)
    np.testing.assert_array_equal(t_preds.numpy(), np.asarray(j_preds))
    np.testing.assert_allclose(t_norm.detach().numpy(), np.asarray(j_norm), rtol=0, atol=1e-6)
    built = th.build_head({"SphereFaceHead": "sphere", "CosFaceHead": "cos", "ArcFaceHead": "arc"}[cls],
                          E, N, device="cpu", margin=margin)
    assert type(built) is getattr(th, cls)
    if cls == "SphereFaceHead":
        with pytest.raises(ValueError, match="Margin"):
            th.SphereFaceHead(N, E, m1=1.0)
