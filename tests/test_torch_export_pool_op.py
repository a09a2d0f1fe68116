"""The attentive-pool forward as the registered operator
``titanet_torch::attentive_pool_fwd`` on the CPU: ``torch.library.opcheck``
(schema, fake tensor, tracing) in bf16 and f32 with the fold on and off,
and a bf16 TitaNet exported through it: the graph holds the operator node,
the artifact equals the live model bit for bit (both run the plain version
here) and agrees with the JAX package's exported bf16 embedder."""

import io

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.torch_port_helpers import cosine, small_titanet_pair
from titanet_torch.models import l2_normalize
from titanet_torch.ops.frontend import FrontendConfig as TorchFrontend
from titanet_torch.ops.frontend import log_mel_spectrogram
from titanet_torch.ops.kernels import pool
from titanet_torch.utils import export as tx
from titanet_tpu.ops.frontend import FrontendConfig as JaxFrontend
from titanet_tpu.utils.export import export_titanet_embedder as jax_export
from titanet_tpu.utils.export import load_embedder as jax_load


def _pool_operands(dtype, fold, b=2, t=9, c=128, hid=128, seed=0):
    rng = np.random.default_rng(seed)

    def f32(*shape, scale=1.0):
        return torch.from_numpy((rng.standard_normal(shape) * scale).astype(np.float32))

    return (
        f32(b, t, c).to(dtype),
        f32(c, scale=0.5) + 1.0 if fold else torch.zeros(c),
        f32(c, scale=0.3) if fold else torch.zeros(c),
        f32(c, hid, scale=c ** -0.5).to(dtype),
        f32(hid, scale=0.1),
        f32(hid, c, scale=hid ** -0.5).to(dtype),
        f32(c, scale=0.1),
    )


@pytest.mark.parametrize("fold", [False, True])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_pool_operator_passes_opcheck(dtype, fold):
    args = _pool_operands(dtype, fold)
    torch.library.opcheck(torch.ops.titanet_torch.attentive_pool_fwd.default, (*args, 1e-6, fold))
    out = torch.ops.titanet_torch.attentive_pool_fwd(*args, 1e-6, fold)
    assert out.shape == (2, 256) and out.dtype == dtype
    # on a CPU tensor the operator is the plain version, bit for bit
    torch.testing.assert_close(out, pool.attentive_pool_fwd_plain(*args, 1e-6, fold), rtol=0, atol=0)


def test_pool_operator_fake_checks_the_operands():
    from torch._subclasses.fake_tensor import FakeTensorMode

    args = _pool_operands(torch.bfloat16, True)
    with FakeTensorMode() as mode:
        fake = [mode.from_tensor(a) for a in args]
        out = torch.ops.titanet_torch.attentive_pool_fwd(*fake, 1e-6, True)
        assert out.shape == (2, 256) and out.dtype == torch.bfloat16
        bad = list(fake)
        bad[3] = bad[3].float()  # wa must have h's dtype
        with pytest.raises(TypeError):
            torch.ops.titanet_torch.attentive_pool_fwd(*bad, 1e-6, True)


def test_bf16_titanet_exports_through_the_pool_operator():
    """One mega-block, pool width 256, attention hidden 128: the bf16 pool
    takes the kernel route, so the exported graph holds the operator once;
    the artifact equals the live model bit for bit and the JAX package's
    bf16 artifact on the same weights within cosine drift 1e-3 (PARITY.md's
    bf16 budget)."""
    jmodel, variables, tmodel = small_titanet_pair(torch.bfloat16, n_mega_blocks=1)
    wav = (np.random.default_rng(2).standard_normal((2, 16000)) * 0.1).astype(np.float32)
    lengths = np.array([16000, 16000], np.int32)
    blob = tx.export_titanet_embedder(tmodel, None, TorchFrontend.from_ms(), batch_size=2, num_samples=16000)
    program = torch.export.load(io.BytesIO(blob))
    ops = [str(n.target) for n in program.graph.nodes if n.op == "call_function"]
    assert sum("titanet_torch.attentive_pool_fwd" in o for o in ops) == 1
    served = tx.load_embedder(blob)
    with torch.no_grad():
        out = served(torch.from_numpy(wav), torch.from_numpy(lengths))
        mel, _ = log_mel_spectrogram(torch.from_numpy(wav), TorchFrontend.from_ms(),
                                     lengths=torch.from_numpy(lengths))
        live = l2_normalize(tmodel(mel))
    assert out.dtype == torch.bfloat16 and out.shape == (2, 192)
    assert torch.equal(out, live)
    ref = np.asarray(jax_load(jax_export(jmodel, variables, JaxFrontend.from_ms(), batch_size=2,
                                         num_samples=16000))(jnp.asarray(wav), jnp.asarray(lengths)))
    drift = 1.0 - cosine(out.float().numpy(), np.asarray(ref, np.float32))
    print(f"bf16 artifact vs JAX bf16 artifact: cosine drift {drift.max():.3e}")
    assert np.all(drift < 1e-3)
