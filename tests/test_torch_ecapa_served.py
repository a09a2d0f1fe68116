"""ECAPA-TDNN served by the port, against the plain reference
(``tests/torch_ecapa_reference.py``) on the CPU at toy widths: the whole
model through ``SpeakerEmbedder`` on ragged requests, the context route's
plain version (against the reference's pooling and the JAX package's,
with each planted fault), the parameter count at the published width, and
the reference's independence from the port.

Card-side checks of the context route's kernels: ``tests/test_torch_ctx_pool.py``.
"""

import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import torch_ecapa_reference as ref
from titanet_torch.models.ecapa import EcapaTdnn
from titanet_torch.ops.frontend import FrontendConfig, log_mel_spectrogram
from titanet_torch.ops.kernels.pool import attentive_pool_fwd, context_stats
from titanet_torch.ops.norm import ema_update_batch_stats
from titanet_torch.train.extractor import SpeakerEmbedder

TOY = dict(n_mels=80, channels=64, mfa_channels=128, embedding_size=32, se_bottleneck=16,
           attention_hidden_size=32)
BUCKETS = [8000, 16000, 32000]
OVERLAP = 0.5


def _voices(lengths, seed):
    """Rows that differ as voices do (a tone and its harmonics each, plus
    noise), so that BatchNorm's calibration sees distinct rows."""
    rng = np.random.default_rng(seed)
    out = []
    for n in lengths:
        t = np.arange(n) / 16000.0
        f0 = rng.uniform(90, 250)
        y = sum(np.sin(2 * np.pi * k * f0 * t + rng.uniform(0, 6)) / k for k in range(1, 6))
        out.append((0.1 * y + 0.01 * rng.standard_normal(n)).astype(np.float32))
    return out


@pytest.fixture(scope="module")
def served():
    """A toy ECAPA-TDNN, seeded, its BatchNorm statistics calibrated as the
    batch statistics of a training forward over eight voices."""
    torch.manual_seed(0)
    model = EcapaTdnn(**TOY)
    fe = FrontendConfig()
    wav = torch.from_numpy(np.stack(_voices([16000] * 8, 1)))
    model.train()
    with torch.no_grad():
        mel, _ = log_mel_spectrogram(wav, fe)
        model(mel)
    ema_update_batch_stats(model, momentum=1.0)
    return model.eval(), fe


def _windows(n, cap):
    """``(start, length)`` of an utterance's windows: the whole utterance up
    to the largest bucket, else windows of it every half of it, the last one
    ending at the utterance's end."""
    if n <= cap:
        return [(0, n)]
    hop = int(cap * (1 - OVERLAP))
    starts = list(range(0, n - cap + 1, hop))
    if starts[-1] + cap < n:
        starts.append(n - cap)
    return [(s, cap) for s in starts]


def _unit(x):
    return x / np.linalg.norm(x, axis=-1, keepdims=True)


def test_served_matches_reference(served):
    """Ragged requests, one utterance past the largest bucket (four
    windows): every answer the reference's within f32 rounding."""
    model, fe = served
    waves = _voices([3000, 8001, 12345, 31000, 70000], 2)
    got = SpeakerEmbedder(model, fe, buckets=BUCKETS, batch_size=4, window_overlap=OVERLAP, device="cpu").embed(waves)
    p = {k: v.float() for k, v in model.state_dict().items()}
    want = []
    for w in waves:
        embs = []
        for start, n in _windows(len(w), BUCKETS[-1]):
            bucket = next(b for b in BUCKETS if n <= b)
            x = torch.zeros(1, bucket)
            x[0, :n] = torch.from_numpy(w[start:start + n])
            mel, mask = log_mel_spectrogram(x, fe, lengths=torch.tensor([n]))
            embs.append(_unit(ref.forward(p, mel, mask).numpy()[0]))
        want.append(_unit(np.mean(embs, axis=0)))
    # f32 on both sides; the convolutions sum in other orders (conv2d over a
    # [B, C, 1, T] view against conv1d) through twelve layers: unit
    # embeddings agree to ~1e-6, held at 1e-4
    np.testing.assert_allclose(got, np.stack(want), atol=1e-4, rtol=0)


def test_context_route_plain_matches_reference():
    """The route the card takes (context statistics, the context's product
    as a row's bias, the length-aware pool), in its plain version, against
    the reference's pooling; frames past a row's length hold noise."""
    g = torch.Generator().manual_seed(3)
    b, t, c, h = 5, 40, 128, 32
    lengths = torch.tensor([1, 40, 17, 2, 33], dtype=torch.int32)
    mask = (torch.arange(t)[None, :] < lengths[:, None].long()).float()
    x = torch.relu(torch.randn(b, t, c, generator=g))
    x = torch.where(mask[..., None] > 0, x, 50.0 * torch.randn(b, t, c, generator=g))
    p = {"pool.in_linear.weight": 0.05 * torch.randn(h, 3 * c, generator=g),
         "pool.in_linear.bias": 0.1 * torch.randn(h, generator=g),
         "pool.out_linear.weight": 0.1 * torch.randn(c, h, generator=g),
         "pool.out_linear.bias": 0.1 * torch.randn(c, generator=g)}
    w1 = p["pool.in_linear.weight"]
    ctx = context_stats(x, lengths)
    bias = ctx @ w1[:, c:].t() + p["pool.in_linear.bias"]
    zeros = torch.zeros(c)
    got = attentive_pool_fwd(x, zeros, zeros, w1[:, :c].t().contiguous(), bias, p["pool.out_linear.weight"].t().contiguous(),
                             p["pool.out_linear.bias"], 1e-6, False, lengths)
    want = ref.context_pool(p, x, mask)
    # f32 both; the route's variance is E[x^2] - mean^2 in one pass where the
    # reference takes two passes: f32 rounding only
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5)


def _jax_and_port_pools(seed, c, h):
    """The JAX package's ``ChannelContextAttentivePooling`` (its own init,
    W1 and W2 scaled by the configuration's init gains, 4x and 8x) and the
    port's, loaded with the same weights."""
    import jax

    from titanet_tpu.models import ecapa as je
    from titanet_torch.models import ecapa as te

    jmod = je.ChannelContextAttentivePooling(hidden_size=h)
    params = jax.tree_util.tree_map(np.array, jmod.init(jax.random.key(seed), np.zeros((1, 4, c), np.float32))["params"])
    params["in_linear"]["kernel"] *= 4.0
    params["out_linear"]["kernel"] *= 8.0
    pool = te.ChannelContextAttentivePooling(c, h).eval()
    with torch.no_grad():
        for name in ("in_linear", "out_linear"):
            getattr(pool, name).weight.copy_(torch.from_numpy(params[name]["kernel"].T.copy()))
            getattr(pool, name).bias.copy_(torch.from_numpy(params[name]["bias"]))
    return jmod, params, pool


def _ragged(seed, b=5, t=40, c=128, ragged=True):
    """``(x, mask)``: relu'd frames, ``50 N(0, 1)`` noise past each row's
    length (lengths 1, 40, 17, 2, 33), or every frame valid."""
    g = torch.Generator().manual_seed(seed)
    lengths = torch.tensor([1, 40, 17, 2, 33] if ragged else [t] * b)
    mask = (torch.arange(t)[None, :] < lengths[:, None]).float()
    x = torch.relu(torch.randn(b, t, c, generator=g))
    return torch.where(mask[..., None] > 0, x, 50.0 * torch.randn(b, t, c, generator=g)), mask


def _route_vs_jax(seed, ragged, context=None):
    """Max |route - JAX| over max |JAX|: the card's route composed in
    ``_kernel_route`` (``context_stats``, the context's product as a bias a
    row, ``attentive_pool_fwd`` with the rows' lengths), run in f32 on the
    CPU, where each kernel runs its plain version; ``context`` stands in for
    ``context_stats`` to plant a fault."""
    import jax.numpy as jnp

    from titanet_torch.models import ecapa as te

    x, mask = _ragged(seed, ragged=ragged)
    jmod, params, pool = _jax_and_port_pools(seed, 128, 32)
    want = np.asarray(jmod.apply({"params": params}, jnp.asarray(x.numpy()), mask=jnp.asarray(mask.numpy())))
    saved = te.context_stats
    te.context_stats = context or saved
    try:
        with torch.no_grad():
            got = pool._kernel_route(x, mask, torch.float32).numpy()
    finally:
        te.context_stats = saved
    return np.abs(got - want).max() / np.abs(want).max()


@pytest.mark.parametrize("seed,ragged", [(0, True), (1, True), (2, False)])
def test_context_route_matches_jax_pooling(seed, ragged):
    """The route against the JAX package's pooling, same weights, same
    mask, noise in the padded frames: f32 rounding only (the route's
    variance is E[x^2] - mean^2 in one pass, JAX's two passes; 1.4e-6 to
    4.9e-6 of the largest output), held at the zoo's forward tolerance."""
    assert _route_vs_jax(seed, ragged) <= 1e-4


@pytest.mark.parametrize("fault", ["no context", "context over the padded frames"])
def test_context_route_faults_read_far_past_the_tolerance(fault):
    """The same comparison sees each fault the card's check plants: the
    context left out (a zero context leaves the bias b1 alone) and the
    context taken over the padded frames (0.28-0.64 of the largest output
    on three seeds, over 2,000 times the tolerance)."""
    from titanet_torch.ops.kernels.pool import context_stats as stats

    planted = {"no context": lambda x, n=None, eps=1e-6: torch.zeros(x.shape[0], 2 * x.shape[2]),
               "context over the padded frames": lambda x, n=None, eps=1e-6: stats(x, None, eps)}[fault]
    assert _route_vs_jax(0, True, planted) > 100 * 1e-4


def test_parameter_count_at_published_width():
    with torch.device("meta"):
        model = EcapaTdnn(channels=1024)
    n = sum(p.numel() for p in model.parameters())
    assert abs(n / 14.7e6 - 1.0) < 0.01, n  # arXiv:2005.07143: C = 1024, 14.7 M


def test_references_import_nothing_of_the_port():
    root = Path(__file__).resolve().parents[1]
    code = ("import sys; import torch_ecapa_reference, perfbench.reference.ecapa; "
            "print(sorted(m for m in sys.modules if m.split('.')[0] in "
            "('titanet_torch', 'titanet_tpu', 'jax', 'jaxlib', 'flax')))")
    out = subprocess.run([sys.executable, "-c", code], cwd=root, capture_output=True, text=True, timeout=120,
                         env={"PYTHONPATH": f"{root / 'tests'}:{root}", "PATH": "/usr/bin:/bin"})
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "[]"
