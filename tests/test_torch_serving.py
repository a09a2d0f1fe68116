"""Port's serving path (embed_step, SpeakerEmbedder) vs the JAX package,
and the port's import hygiene (CPU)."""

import ast
import glob
import os
import subprocess
import sys
import textwrap

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.torch_port_helpers import cosine, small_titanet_pair
from titanet_torch.ops.frontend import FrontendConfig as TorchFrontend
from titanet_torch.train.extractor import SpeakerEmbedder as TorchEmbedder
from titanet_torch.train.state import embed_step as torch_embed_step
from titanet_tpu.ops.frontend import FrontendConfig as JaxFrontend
from titanet_tpu.train.extractor import SpeakerEmbedder as JaxEmbedder
from titanet_tpu.train.state import embed_step as jax_embed_step

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _batch(seed, lengths, t):
    rng = np.random.default_rng(seed)
    wav = np.zeros((len(lengths), t), np.float32)
    for i, n in enumerate(lengths):
        wav[i, :n] = rng.standard_normal(n) * 0.1
    return wav, np.asarray(lengths, np.int32)


@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("fused", [False, True])
def test_embed_step_matches_jax(masked, fused):
    jmodel, variables, tmodel = small_titanet_pair(None, seed=2)
    wav, lengths = _batch(3, [16000, 9000, 4000], 16000)
    ref = jax_embed_step(
        variables["params"], variables["batch_stats"], jnp.asarray(wav), jnp.asarray(lengths),
        model=jmodel, frontend=JaxFrontend.from_ms(), masked=masked,
    )
    out = torch_embed_step(
        tmodel, wav, lengths, frontend=TorchFrontend.from_ms(use_pallas_fused=fused),
        masked=masked, device="cpu",
    )
    assert out.shape == (3, 192)
    assert (1.0 - cosine(out.numpy(), np.asarray(ref))).max() < 1e-5


def test_embed_step_dequantizes_int16_pcm():
    _, _, tmodel = small_titanet_pair(None)
    wav, lengths = _batch(4, [8000, 8000], 8000)
    pcm = np.round(wav * 32768).astype(np.int16)
    fe = TorchFrontend.from_ms()
    a = torch_embed_step(tmodel, pcm, lengths, frontend=fe, device="cpu")
    b = torch_embed_step(tmodel, pcm.astype(np.float32) / 32768.0, lengths, frontend=fe, device="cpu")
    torch.testing.assert_close(a, b)


@pytest.mark.parametrize("dtype", [None, torch.bfloat16])
def test_speaker_embedder_padded_equals_solo_and_matches_jax(dtype):
    jmodel, variables, tmodel = small_titanet_pair(dtype, seed=5)
    rng = np.random.default_rng(6)
    reqs = [rng.standard_normal(n).astype(np.float32) * 0.1 for n in (5000, 12000, 16000, 37000)]
    buckets = [8000, 16000]
    fused = dtype is not None
    fe_t = TorchFrontend.from_ms(
        precision="default" if fused else "highest", use_pallas_fused=fused
    )
    emb = TorchEmbedder(tmodel, fe_t, buckets=buckets, batch_size=4, device="cpu")
    batched = emb.embed(reqs)
    assert batched.shape == (4, 192)
    np.testing.assert_allclose(np.linalg.norm(batched, axis=-1), 1.0, rtol=1e-5)
    solo = np.concatenate([emb.embed([r]) for r in reqs])
    assert cosine(batched, solo).min() > 0.9999
    jemb = JaxEmbedder(
        jmodel, variables["params"], variables["batch_stats"], JaxFrontend.from_ms(),
        buckets=buckets, batch_size=4,
    )
    ref = jemb.embed(reqs)
    assert (1.0 - cosine(batched, ref)).max() < (1e-5 if dtype is None else 1e-3)


def test_speaker_embedder_refuses_quantized():
    """The embedder no longer refuses ``quantized=True``: it builds the int8
    tree once and embeds through it (held against the JAX embedder in
    tests/test_torch_quantized.py). What it still refuses is CUDA without a
    card."""
    _, _, tmodel = small_titanet_pair(None)
    emb = TorchEmbedder(tmodel, buckets=[8000], batch_size=2, quantized=True, device="cpu")
    assert emb.qtree is not None and emb.qtree.decoder is tmodel.decoder
    wav = np.random.default_rng(7).standard_normal(6000).astype(np.float32) * 0.1
    out = emb.embed([wav])
    full = TorchEmbedder(tmodel, buckets=[8000], batch_size=2, device="cpu").embed([wav])
    assert out.shape == (1, 192) and cosine(out, full).min() > 0.99
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            TorchEmbedder(tmodel, quantized=True)


def test_port_imports_no_jax_and_needs_cuda_unless_cpu():
    """Every module of titanet_torch, chip_smoke.py and the bench_*.py of the
    port import with jax, flax, optax and titanet_tpu blocked; without a card the entry points raise unless
    device='cpu' is passed."""
    code = textwrap.dedent(
        """
        import sys
        for name in ("jax", "flax", "optax", "titanet_tpu"):
            sys.modules[name] = None
        import importlib, pkgutil
        import numpy as np, torch
        import titanet_torch
        names = [m.name for m in pkgutil.walk_packages(titanet_torch.__path__, "titanet_torch.")]
        for name in names:
            importlib.import_module(name)
        for name in ("models.fused_inference", "models.quantized", "ops.kernels.megablock"):
            assert "titanet_torch." + name in names, name
        import bench_logmel_tc, bench_torch, chip_smoke
        from titanet_torch.models import get_titanet
        from titanet_torch.ops.frontend import FrontendConfig
        from titanet_torch.train.extractor import SpeakerEmbedder
        from titanet_torch.train.state import embed_step, embed_step_quantized
        from titanet_torch.models.fused_inference import titanet_apply_fused
        from titanet_torch.models.quantized import quantize_titanet
        model = get_titanet(n_mega_blocks=1, device="cpu")
        fe = FrontendConfig.from_ms()
        wav, lens = np.zeros((1, 8000), np.float32), np.array([8000])
        assert embed_step(model, wav, lens, frontend=fe, device="cpu").shape == (1, 192)
        SpeakerEmbedder(model, device="cpu")
        qtree = quantize_titanet(model)
        assert embed_step_quantized(qtree, wav, lens, frontend=fe, device="cpu").shape == (1, 192)
        assert titanet_apply_fused(model, torch.zeros(1, 51, 80)).shape == (1, 192)
        if not torch.cuda.is_available():
            for call in (
                lambda: get_titanet(n_mega_blocks=1),
                lambda: embed_step(model, wav, lens, frontend=fe),
                lambda: SpeakerEmbedder(model),
                lambda: SpeakerEmbedder(model, quantized=True),
                lambda: embed_step_quantized(qtree, wav, lens, frontend=fe),
            ):
                try:
                    call()
                except RuntimeError as e:
                    assert "CUDA" in str(e)
                else:
                    raise AssertionError("entry point ran without CUDA")
        print("OK")
        """
    )
    env = {k: v for k, v in os.environ.items() if not k.startswith(("JAX", "XLA"))}
    res = subprocess.run(
        [sys.executable, "-c", code], cwd=REPO, env=env, capture_output=True, text=True, timeout=300
    )
    assert res.returncode == 0 and res.stdout.strip().endswith("OK"), res.stderr[-3000:]


def test_port_sources_hold_no_jax_import():
    """No import statement anywhere in titanet_torch/, chip_smoke.py or the
    port's bench_torch.py and bench_logmel_tc.py (inside functions too) names
    jax, flax, optax or the JAX package."""
    files = glob.glob(os.path.join(REPO, "titanet_torch", "**", "*.py"), recursive=True)
    files += [os.path.join(REPO, name) for name in ("chip_smoke.py", "bench_torch.py", "bench_logmel_tc.py")]
    assert len(files) > 20
    banned = ("jax", "flax", "optax", "titanet_tpu")
    for path in files:
        with open(path) as f:
            tree = ast.parse(f.read(), path)
        for node in ast.walk(tree):
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom):
                names = [node.module or ""]
            else:
                continue
            for name in names:
                assert name.split(".")[0] not in banned, f"{path}:{node.lineno} imports {name}"
