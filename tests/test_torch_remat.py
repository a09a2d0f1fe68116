"""``TitaNet(remat=..., remat_policy=...)`` on the CPU: the rematerialized
model against the plain one in the port (dropout on, one generator seed:
loss, every gradient, the published batch moments and the generator's
state, to the bit), the policies' recompute, a train step, and the port's
remat model against the JAX package's on the same weights."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from tests.torch_parallel_helpers import run_worker_ranks
from titanet_torch.models.titanet import REMAT_POLICIES, TitaNet
from titanet_torch.ops.norm import BatchNorm, ema_update_batch_stats
from titanet_torch.train import state as ts
from titanet_torch.utils.weights import load_jax_variables
from titanet_tpu.models.titanet import TitaNet as JaxTitaNet

TOY = dict(n_mega_blocks=2, encoder_hidden_size=32, encoder_output_size=48, embedding_size=16,
           attention_hidden_size=8)
POLICIES = [None, *REMAT_POLICIES]


def _mel(seed=1, b=3, t=101):
    return torch.from_numpy(np.random.default_rng(seed).standard_normal((b, t, 80)).astype(np.float32))


def _model(dropout=0.3, dtype=None, **kw):
    m = TitaNet(dropout=dropout, dtype=dtype, **TOY, **kw)
    m.reset_parameters(torch.Generator().manual_seed(0))
    return m.train()


def _loss_grads(model, mel, mask=None, seed=7):
    """sum(emb^2) of a training forward with dropout from a generator
    seeded ``seed``: (loss, gradients, the generator's state after it, the
    running statistics after one EMA update of the published moments)."""
    gen = torch.Generator().manual_seed(seed)
    emb = model(mel, mask=mask, generator=gen)
    loss = torch.sum(emb.float() ** 2)
    grads = torch.autograd.grad(loss, list(model.parameters()))
    n_sites = ema_update_batch_stats(model)
    return loss, grads, gen.get_state(), [b.clone() for b in model.buffers()], n_sites


@pytest.mark.parametrize("policy", POLICIES)
@pytest.mark.parametrize("variant", ["f32", "bf16", "masked"])
def test_remat_equals_plain_to_the_bit(policy, variant):
    """Remat is a schedule, not a change of result: with dropout 0.3 from
    one generator seed the loss, every gradient, the generator's state and
    the running statistics after the one EMA update equal the plain
    model's, bit for bit (the recompute runs the same kernels on the same
    inputs; the masks are drawn once, before the block)."""
    dtype = torch.bfloat16 if variant == "bf16" else None
    mel = _mel()
    mask = None
    if variant == "masked":
        mask = (torch.arange(mel.shape[1])[None, :] < torch.tensor([101, 80, 57])[:, None]).float()
    plain = _loss_grads(_model(dtype=dtype), mel, mask)
    remat = _loss_grads(_model(dtype=dtype, remat=True, remat_policy=policy), mel, mask)
    assert torch.equal(plain[0], remat[0])
    names = [n for n, _ in _model().named_parameters()]
    for name, a, b in zip(names, plain[1], remat[1]):
        assert torch.equal(a, b), name
    assert torch.equal(plain[2], remat[2])
    assert all(torch.equal(a, b) for a, b in zip(plain[3], remat[3]))
    # every site published once: the recompute published nothing
    assert plain[4] == remat[4] == sum(isinstance(m, BatchNorm) for m in _model().modules())


def test_unknown_policy_raises():
    with pytest.raises(ValueError, match="unsupported remat_policy 'offload_dots'"):
        TitaNet(remat=True, remat_policy="offload_dots", **TOY)
    for policy in POLICIES:
        TitaNet(remat=True, remat_policy=policy, **TOY)


class _CountProducts(TorchDispatchMode):
    def __init__(self):
        super().__init__()
        self.n = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        if func.overloadpacket in (torch.ops.aten.mm, torch.ops.aten.addmm):
            self.n += 1
        return func(*args, **(kwargs or {}))


@pytest.mark.parametrize("policy", POLICIES)
def test_policies_recompute_what_they_do_not_keep(policy):
    """The backward's matrix products: the plain model's, plus the
    mega-blocks' forward products where the policy keeps no product
    (full recompute), and no more where it keeps the products (the
    ``dots`` policies) or everything."""
    mel = _mel()

    def backward_products(model):
        emb = model(mel, generator=torch.Generator().manual_seed(3))
        with _CountProducts() as count:
            torch.autograd.grad(torch.sum(emb ** 2), list(model.parameters()))
        return count.n

    with _CountProducts() as count, torch.no_grad():
        _model().encoder.mega_block_0(torch.zeros(3, 101, TOY["encoder_hidden_size"]))
    block_fwd = count.n
    extra = TOY["n_mega_blocks"] * block_fwd if policy in (None, "nothing_saveable") else 0
    assert block_fwd > 0
    assert backward_products(_model(remat=True, remat_policy=policy)) == backward_products(_model()) + extra


def test_remat_outside_training_runs_the_plain_forward():
    """In eval mode and without grad nothing is checkpointed: the same
    embeddings as the plain model."""
    mel = _mel(2)
    plain, remat = _model(), _model(remat=True)
    with torch.no_grad():
        assert torch.equal(plain(mel, generator=torch.Generator().manual_seed(1)),
                           remat(mel, generator=torch.Generator().manual_seed(1)))
    assert torch.equal(plain.eval()(mel), remat.eval()(mel))


def test_remat_train_step_equals_the_plain_train_step():
    """Two ``train_step``s (dropout 0.5, SpecAugment and noise, Adam with
    clipping) of the remat model equal the plain model's: every parameter,
    running statistic, Adam moment and generator state, to the bit."""
    from titanet_torch.losses import build_head
    from titanet_torch.ops.augment import AugmentConfig
    from titanet_torch.ops.frontend import FrontendConfig

    rng = np.random.default_rng(4)
    wav = (rng.standard_normal((3, 8000)) * 0.1).astype(np.float32)
    lens, spk = np.array([8000, 7000, 5000], np.int32), np.array([0, 2, 1])
    out = []
    for remat in (False, True):
        model = _model(dropout=0.5, remat=remat, remat_policy="dots_saveable")
        head = build_head("ce", TOY["embedding_size"], 3, device="cpu", generator=torch.Generator().manual_seed(1))
        st = ts.create_train_state(model, head, ts.make_optimizer(grad_clip_norm=0.5), seed=3)
        for _ in range(2):
            st, met = ts.train_step(st, wav, lens, spk, frontend=FrontendConfig.from_ms(),
                                    augment=AugmentConfig(noise_prob=0.5))
        out.append([*model.state_dict().values(), *st.opt_state.mu, *st.opt_state.nu, met["loss"],
                    *(g.get_state() for g in st.generators().values())])
    assert all(torch.equal(a, b) for a, b in zip(*out))


def test_remat_under_a_mesh_runs_each_collective_once(tmp_path):
    """Two gloo ranks, global-batch BatchNorm, dropout 0.5 drawn over the
    global batch: two remat train steps (each policy that recomputes) equal
    the plain model's on each rank, bit for bit, and issue the same
    collectives (the recompute takes each site's first result: no second
    all-reduce, none out of step between the ranks)."""
    rng = np.random.default_rng(8)
    batches = [((rng.standard_normal((4, 8000)) * 0.1).astype(np.float32), rng.integers(0, 8, 4)) for _ in range(2)]
    policies = [None, "dots_saveable"]
    for out in run_worker_ranks("remat", {"batches": batches, "policies": policies}, tmp_path):
        plain = out[None, False]
        kinds = plain["stats"]["by_kind"]
        assert kinds["batchnorm"]["count"] == kinds["batchnorm_backward"]["count"] > 0
        for policy in policies:
            got = out[policy, True]
            assert got["stats"] == plain["stats"], policy
            assert all(torch.equal(a, b) for a, b in zip(got["losses"] + got["state"], plain["losses"] + plain["state"]))
            assert torch.equal(got["generator"], plain["generator"])


# the train-step tolerances of tests/test_torch_train.py: the loss 1e-4
# relative; each gradient within 1e-4 of its tensor's largest entry, plus
# 1e-5 of the largest gradient entry in the model (a gradient that is zero
# in exact arithmetic, as a conv bias before a BatchNorm has, is rounding
# noise of the larger ones)
LOSS_RTOL, GRAD_TOL, GRAD_FLOOR = 1e-4, 1e-4, 1e-5


@pytest.mark.parametrize("policy", [None, "dots_saveable"])
def test_remat_matches_jax_remat(policy):
    """The port's remat model against ``TitaNet(remat=True)`` of the JAX
    package on the same weights (``load_jax_variables``; the variable names
    are the plain model's), in a training forward at dropout 0 (the
    packages' dropout draws differ): loss and every gradient."""
    cfg = dict(TOY, dropout=0.0)
    jm = JaxTitaNet(remat=True, remat_policy=policy, **cfg)
    mel = np.random.default_rng(1).standard_normal((3, 101, 80)).astype(np.float32)
    variables = jax.tree_util.tree_map(np.asarray, dict(jm.init(jax.random.key(0), jnp.asarray(mel))))

    def loss_of(params):
        emb, _ = jm.apply({"params": params, "batch_stats": variables["batch_stats"]}, jnp.asarray(mel),
                          train=True, mutable=["batch_stats", "batch_moments"])
        return jnp.sum(emb ** 2)

    jl, jg = jax.jit(jax.value_and_grad(loss_of))(variables["params"])
    tm = TitaNet(remat=True, remat_policy=policy, **cfg).train()
    load_jax_variables(tm, variables["params"], variables["batch_stats"])
    loss = torch.sum(tm(torch.from_numpy(mel)) ** 2)
    grads = torch.autograd.grad(loss, list(tm.parameters()))
    np.testing.assert_allclose(loss.item(), float(jl), rtol=LOSS_RTOL)
    ref = TitaNet(**cfg)
    load_jax_variables(ref, jax.tree_util.tree_map(np.asarray, jg), variables["batch_stats"])
    refs = list(ref.parameters())
    floor = GRAD_FLOOR * max(r.abs().max().item() for r in refs)
    for (name, _), got, r in zip(tm.named_parameters(), grads, refs):
        assert (got - r).abs().max().item() <= GRAD_TOL * r.abs().max().item() + floor, name
