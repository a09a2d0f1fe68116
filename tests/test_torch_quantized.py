"""Port's int8 serving variant vs the JAX package (CPU): the quantized tree
leaf by leaf, the dynamic int8 product, the quantized forward and the
entry points."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.torch_port_helpers import cosine, small_titanet_pair
from titanet_torch.models import quantized as tq
from titanet_torch.ops.frontend import FrontendConfig as TorchFrontend
from titanet_torch.train.extractor import SpeakerEmbedder as TorchEmbedder
from titanet_torch.train.state import embed_step_quantized as torch_embed_q
from titanet_tpu.models import quantized as jq
from titanet_tpu.ops.frontend import FrontendConfig as JaxFrontend
from titanet_tpu.train.extractor import SpeakerEmbedder as JaxEmbedder
from titanet_tpu.train.state import embed_step_quantized as jax_embed_q


def _mel(seed, b=2, t=64):
    return np.random.default_rng(seed).standard_normal((b, t, 80)).astype(np.float32)


def _assert_quant_linear(port, ref, where):
    np.testing.assert_array_equal(port.w_q.numpy(), np.asarray(ref.w_q), err_msg=where)
    assert port.w_q.dtype == torch.int8 and port.w_q.is_contiguous()
    np.testing.assert_allclose(port.scale.numpy(), np.asarray(ref.scale), rtol=1e-6, err_msg=where)
    np.testing.assert_allclose(port.bias.numpy(), np.asarray(ref.bias), rtol=1e-6, atol=1e-7, err_msg=where)


@pytest.mark.parametrize("kw", [{}, {"simple_pool": True, "mega_block_kernel_size": 7}])
def test_quantize_titanet_leaves_match_jax(kw):
    """After the weight bridge both packages build the same tree: int8
    weights equal as integers, scales and biases to 1e-6."""
    jmodel, variables, tmodel = small_titanet_pair(None, seed=1, **kw)
    ref = jq.quantize_titanet(jmodel, variables)
    q = tq.quantize_titanet(tmodel)
    assert (q.n_sub_blocks, q.kernel_size, q.simple_pool) == (
        ref.n_sub_blocks, ref.kernel_size, ref.simple_pool
    )
    np.testing.assert_array_equal(
        q.prolog_kernel.numpy(), np.transpose(np.asarray(ref.prolog_kernel), (2, 1, 0))
    )
    np.testing.assert_array_equal(q.prolog_bias.numpy(), np.asarray(ref.prolog_bias))
    for a, b in zip(q.prolog_bn, ref.prolog_bn):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-6, atol=1e-7)
    assert len(q.mega_blocks) == len(ref.mega_blocks) == 2
    for i, (blk, rblk) in enumerate(zip(q.mega_blocks, ref.mega_blocks)):
        np.testing.assert_array_equal(blk.dw_w.numpy(), np.asarray(rblk.dw_w))
        np.testing.assert_array_equal(blk.dw_b.numpy(), np.asarray(rblk.dw_b))
        np.testing.assert_array_equal(blk.se_fc1.numpy(), np.asarray(rblk.se_fc1))
        np.testing.assert_array_equal(blk.se_fc2.numpy(), np.asarray(rblk.se_fc2))
        for s, (pw, rpw) in enumerate(zip(blk.pw, rblk.pw)):
            _assert_quant_linear(pw, rpw, f"mega_block_{i}/sub_block_{s}")
        _assert_quant_linear(blk.skip, rblk.skip, f"mega_block_{i}/skip")
    _assert_quant_linear(q.epilog, ref.epilog, "epilog")
    assert q.decoder is tmodel.decoder


@pytest.mark.parametrize("relu", [False, True])
@pytest.mark.parametrize("rows", [(8,), (3, 5)])
def test_quantized_matmul_matches_jax(rows, relu):
    rng = np.random.default_rng(2)
    w = (rng.standard_normal((96, 64)) * 0.1).astype(np.float32)
    b = (rng.standard_normal(64) * 0.01).astype(np.float32)
    x = rng.standard_normal(rows + (96,)).astype(np.float32)
    x[0] = 0.0  # an all-zero row takes the 1e-12 floor of its scale
    ref_q = jq._quantize_weight(jnp.asarray(w), jnp.asarray(b))
    q = tq._quantize_weight(torch.from_numpy(w), torch.from_numpy(b))
    _assert_quant_linear(q, ref_q, "weight")
    ref = np.asarray(jq.quantized_matmul(jnp.asarray(x), ref_q, relu=relu))
    out = tq.quantized_matmul(torch.from_numpy(x), q, relu=relu).numpy()
    assert out.shape == ref.shape == rows + (64,)
    np.testing.assert_allclose(out, ref, rtol=1e-6, atol=1e-6)
    exact = x @ w + b
    rms = float(np.sqrt(np.mean(exact**2)))
    err = out - (np.maximum(exact, 0) if relu else exact)
    assert np.sqrt(np.mean(err**2)) / rms < 0.02


def test_int8_product_is_exact_for_any_shape():
    rng = np.random.default_rng(3)
    for m, k, n in ((3, 20, 5), (40, 64, 24), (17, 7, 9)):
        a = torch.from_numpy(rng.integers(-127, 128, (m, k)).astype(np.int8))
        b = torch.from_numpy(rng.integers(-127, 128, (k, n)).astype(np.int8))
        out = tq._int8_product(a, b)
        assert out.dtype == torch.int32
        assert torch.equal(out, a.int() @ b.int())


@pytest.mark.parametrize(
    "kw,masked",
    [({}, False), ({}, True), ({"simple_pool": True}, False), ({"mega_block_kernel_size": 7}, True)],
)
def test_titanet_apply_quantized_matches_jax_and_f32(kw, masked):
    """Port vs JAX quantized forward: cosine > 0.9999 (a rounding that lands
    on the other side of .5 moves one int8 step); vs the f32 model > 0.99,
    the JAX package's own bound on random weights."""
    jmodel, variables, tmodel = small_titanet_pair(None, seed=4, **kw)
    x = _mel(5)
    mask = np.ones((2, 64), np.float32)
    mask[1, 40:] = 0.0
    mj = jnp.asarray(mask) if masked else None
    mt = torch.from_numpy(mask) if masked else None
    ref = np.asarray(
        jq.titanet_apply_quantized(jq.quantize_titanet(jmodel, variables), jnp.asarray(x), mask=mj)
    )
    out = tq.titanet_apply_quantized(tq.quantize_titanet(tmodel), torch.from_numpy(x), mask=mt)
    assert out.dtype == torch.float32 and out.shape == (2, 192)
    assert cosine(out.numpy(), ref).min() > 0.9999
    with torch.no_grad():
        full = tmodel(torch.from_numpy(x), mask=mt).numpy()
    assert cosine(out.numpy(), full).min() > 0.99


def _batch(seed, lengths, t):
    rng = np.random.default_rng(seed)
    wav = np.zeros((len(lengths), t), np.float32)
    for i, n in enumerate(lengths):
        wav[i, :n] = rng.standard_normal(n) * 0.1
    return wav, np.asarray(lengths, np.int32)


@pytest.mark.parametrize("masked", [False, True])
def test_embed_step_quantized_matches_jax(masked):
    jmodel, variables, tmodel = small_titanet_pair(None, seed=6)
    wav, lengths = _batch(7, [16000, 9000, 4000], 16000)
    ref = jax_embed_q(
        jq.quantize_titanet(jmodel, variables), jnp.asarray(wav), jnp.asarray(lengths),
        frontend=JaxFrontend.from_ms(), masked=masked,
    )
    out = torch_embed_q(
        tq.quantize_titanet(tmodel), wav, lengths, frontend=TorchFrontend.from_ms(),
        masked=masked, device="cpu",
    )
    assert out.shape == (3, 192)
    np.testing.assert_allclose(np.linalg.norm(out.numpy(), axis=-1), 1.0, rtol=1e-5)
    assert cosine(out.numpy(), np.asarray(ref)).min() > 0.9999


def test_embed_step_quantized_dequantizes_int16_pcm_and_checks_device():
    _, _, tmodel = small_titanet_pair(None)
    q = tq.quantize_titanet(tmodel)
    wav, lengths = _batch(8, [8000, 8000], 8000)
    pcm = np.round(wav * 32768).astype(np.int16)
    fe = TorchFrontend.from_ms()
    a = torch_embed_q(q, pcm, lengths, frontend=fe, device="cpu")
    b = torch_embed_q(q, pcm.astype(np.float32) / 32768.0, lengths, frontend=fe, device="cpu")
    torch.testing.assert_close(a, b)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            torch_embed_q(q, pcm, lengths, frontend=fe)


def test_speaker_embedder_quantized_padded_equals_solo_and_matches_jax():
    jmodel, variables, tmodel = small_titanet_pair(None, seed=9)
    rng = np.random.default_rng(10)
    reqs = [rng.standard_normal(n).astype(np.float32) * 0.1 for n in (5000, 12000, 16000, 37000)]
    buckets = [8000, 16000]
    emb = TorchEmbedder(
        tmodel, TorchFrontend.from_ms(), buckets=buckets, batch_size=4, quantized=True, device="cpu"
    )
    assert emb.qtree is not None
    batched = emb.embed(reqs)
    assert batched.shape == (4, 192)
    np.testing.assert_allclose(np.linalg.norm(batched, axis=-1), 1.0, rtol=1e-5)
    solo = np.concatenate([emb.embed([r]) for r in reqs])
    assert cosine(batched, solo).min() > 0.9999
    jemb = JaxEmbedder(
        jmodel, variables["params"], variables["batch_stats"], JaxFrontend.from_ms(),
        buckets=buckets, batch_size=4, quantized=True,
    )
    assert cosine(batched, jemb.embed(reqs)).min() > 0.9999
    plain = TorchEmbedder(tmodel, TorchFrontend.from_ms(), buckets=buckets, batch_size=4, device="cpu")
    assert cosine(batched, plain.embed(reqs)).min() > 0.99
