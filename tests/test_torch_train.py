"""The port's training path vs the JAX package on the CPU: train-mode
BatchNorm and its EMA, dropout, the optimizer vs optax, and whole
train_steps of a small TitaNet (2 mega-blocks, hidden 128, output 256,
B=4 x 1 s) from the same weights."""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from titanet_torch.losses import heads as th
from titanet_torch.models.titanet import TitaNet as TorchTitaNet
from titanet_torch.models.titanet import get_titanet
from titanet_torch.ops.frontend import FrontendConfig as TorchFrontend
from titanet_torch.ops.norm import BatchNorm as TorchBN
from titanet_torch.ops.norm import FastDropout, ema_update_batch_stats
from titanet_torch.train import state as ts
from titanet_torch.utils.weights import load_jax_train_state, load_jax_variables
from titanet_tpu.losses import heads as jh
from titanet_tpu.models.titanet import TitaNet as JaxTitaNet
from titanet_tpu.ops.frontend import FrontendConfig as JaxFrontend
from titanet_tpu.ops.norm import BatchNorm as JaxBN
from titanet_tpu.train import state as js

SMALL = dict(n_mega_blocks=2, encoder_hidden_size=128, encoder_output_size=256)
N_CLASSES = 6


def _tree_np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


# ------------------------------------------------------------- BatchNorm


@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_batchnorm_train_matches_jax(dtype, masked):
    """Output, fold vectors, gradients to x / scale / bias, the published
    batch moments and the EMA-updated running statistics. f32 1e-5; bf16
    outputs within 1e-2 (one bf16 ulp of values ~2), its statistics still
    f32 (1e-5)."""
    rng = np.random.default_rng(7)
    x = (rng.standard_normal((3, 11, 64)) * 2 + 0.5).astype(np.float32)
    mask = (np.arange(11)[None, :] < np.array([[11], [6], [3]])).astype(np.float32)
    g = rng.standard_normal(x.shape).astype(np.float32)
    jdt, tdt = getattr(jnp, dtype), getattr(torch, dtype)
    bn = JaxBN(use_running_average=False, dtype=jdt)
    v = _tree_np(dict(bn.init(jax.random.key(0), jnp.asarray(x))))
    v["params"] = {"scale": rng.uniform(0.5, 2, 64).astype(np.float32),
                   "bias": rng.standard_normal(64).astype(np.float32)}
    v["batch_stats"] = {"mean": rng.standard_normal(64).astype(np.float32),
                        "var": rng.uniform(0.5, 2, 64).astype(np.float32)}
    m_j = jnp.asarray(mask) if masked else None
    m_t = torch.from_numpy(mask) if masked else None
    xj = jnp.asarray(x).astype(jdt)

    def jloss(params, xx):
        out, _ = bn.apply({"params": params, "batch_stats": v["batch_stats"]}, xx, mask=m_j,
                          mutable=["batch_stats"])
        return jnp.sum(out.astype(jnp.float32) * g)

    ref, upd = bn.apply(v, xj, mask=m_j, mutable=["batch_stats"])
    (a_j, c_j), _ = bn.apply(v, xj, mask=m_j, return_scale_shift=True, mutable=["batch_stats"])
    g_p, g_x = jax.grad(jloss, argnums=(0, 1))(v["params"], xj)

    port = TorchBN(64, dtype=tdt).train()
    load_jax_variables(port, v["params"], v["batch_stats"])
    xt = torch.from_numpy(x).to(tdt).requires_grad_()
    out = port(xt, mask=m_t)
    (out.float() * torch.from_numpy(g)).sum().backward()
    tol = 1e-5 if dtype == "float32" else 1e-2
    np.testing.assert_allclose(out.detach().float().numpy(), np.asarray(ref.astype(jnp.float32)),
                               rtol=tol, atol=tol)
    np.testing.assert_allclose(xt.grad.float().numpy(), np.asarray(g_x.astype(jnp.float32)),
                               rtol=tol, atol=tol * np.abs(np.asarray(g_x, np.float32)).max())
    for t_grad, j_grad in ((port.weight.grad, g_p["scale"]), (port.bias.grad, g_p["bias"])):
        np.testing.assert_allclose(t_grad.numpy(), np.asarray(j_grad), rtol=tol,
                                   atol=tol * np.abs(np.asarray(j_grad)).max())
    with torch.no_grad():
        a_t, c_t = port(torch.from_numpy(x).to(tdt), mask=m_t, return_scale_shift=True)
    np.testing.assert_allclose(a_t.numpy(), np.asarray(a_j), rtol=1e-5)
    np.testing.assert_allclose(c_t.numpy(), np.asarray(c_j), rtol=1e-5, atol=1e-6)
    assert ema_update_batch_stats(port) == 1 and port.batch_moments is None
    np.testing.assert_allclose(port.running_mean.numpy(), np.asarray(upd["batch_stats"]["mean"]),
                               rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(port.running_var.numpy(), np.asarray(upd["batch_stats"]["var"]),
                               rtol=1e-5, atol=1e-6)
    assert ema_update_batch_stats(port) == 0  # nothing published since


def test_ema_update_is_one_update_over_all_sites():
    model = TorchTitaNet(dropout=0.0, **SMALL).train()
    with torch.no_grad():
        model(torch.randn(2, 9, 80))
    sites = [m for m in model.modules() if isinstance(m, TorchBN)]
    assert len(sites) == 1 + 2 * 4 + 1 + 2 and all(m.batch_moments is not None for m in sites)
    expect = [(0.9 * m.running_mean + 0.1 * m.batch_moments[0],
               0.9 * m.running_var + 0.1 * m.batch_moments[1]) for m in sites]
    assert ema_update_batch_stats(model) == len(sites)
    for m, (mean, var) in zip(sites, expect):
        torch.testing.assert_close(m.running_mean, mean, rtol=1e-6, atol=1e-7)
        torch.testing.assert_close(m.running_var, var, rtol=1e-6, atol=1e-7)


# --------------------------------------------------------------- dropout


@pytest.mark.parametrize("rate", [0.5, 0.3])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_fast_dropout_distribution(rate, dtype):
    """Keep fraction within 5 binomial standard deviations of 1 - rate;
    kept values are exactly x / (1 - rate) in x's dtype, dropped ones 0; the
    draws follow the generator."""
    drop = FastDropout(rate).train()
    x = torch.full((64, 64, 64), 1.5, dtype=dtype)
    out = drop(x, torch.Generator().manual_seed(1))
    n, keep = x.numel(), 1.0 - rate
    kept = out != 0
    frac = kept.float().mean().item()
    assert abs(frac - keep) <= 5 * np.sqrt(keep * (1 - keep) / n), frac
    assert torch.equal(out[kept], (x * (1.0 / keep))[kept])
    again = drop(x, torch.Generator().manual_seed(1))
    assert torch.equal(out, again)
    assert not torch.equal(out, drop(x, torch.Generator().manual_seed(2)))


def test_fast_dropout_identity_and_edges():
    x = torch.randn(4, 5, 6)
    assert FastDropout(0.5).eval()(x) is x
    assert FastDropout(0.0).train()(x) is x
    assert not FastDropout(1.0).train()(x).any()


def test_dropout_sites_follow_jax_layout():
    """4 sites a mega-block (3 sub-blocks + the block output), none in the
    prolog or the epilog: 68 for 17 blocks."""
    model = get_titanet(n_mega_blocks=17, device="cpu")
    sites = [n for n, m in model.named_modules() if isinstance(m, FastDropout) and m.rate > 0]
    assert len(sites) == 68 and all(s.startswith("encoder.mega_block_") for s in sites)
    assert all(m.rate == 0 for n, m in model.named_modules()
               if isinstance(m, FastDropout) and n.startswith(("encoder.prolog", "encoder.epilog")))


# ------------------------------------------------------------- optimizer

OPT_CASES = {
    "adam": dict(),
    "adam_cosine": dict(scheduler=True, total_epochs=2, steps_per_epoch=3, end_lr=1e-4),
    "adam_warmup_cosine": dict(scheduler=True, warmup_epochs=1, steps_per_epoch=2, total_epochs=3),
    "adam_clip_wd": dict(grad_clip_norm=0.5, weight_decay=1e-2),
    "adam_clip_untriggered": dict(grad_clip_norm=100.0),
    "adam_accumulate": dict(accumulate_steps=3, start_lr=1e-2),
    "sgd_accumulate_wd": dict(name="sgd", start_lr=0.5, accumulate_steps=2, weight_decay=1e-3),
}


@pytest.mark.parametrize("case", sorted(OPT_CASES))
def test_make_optimizer_matches_optax(case):
    """Seven updates on the same gradients: parameters within 1e-6 of
    optax's (f32 rounding of the same formulas)."""
    kw = OPT_CASES[case]
    rng = np.random.default_rng(0)
    shapes = [(5, 3), (7,), ()]
    p0 = [np.asarray(rng.standard_normal(s), np.float32) for s in shapes]
    grads = [[np.asarray(rng.standard_normal(s) * 0.3, np.float32) for s in shapes] for _ in range(7)]
    jopt = js.make_optimizer(**kw)
    jp = [jnp.asarray(p) for p in p0]
    jstate = jopt.init(jp)
    topt = ts.make_optimizer(**kw)
    tp = [torch.from_numpy(p.copy()) for p in p0]
    tstate = topt.init(tp)
    for g in grads:
        upd, jstate = jopt.update([jnp.asarray(x) for x in g], jstate, jp)
        jp = optax.apply_updates(jp, upd)
        tu = topt.update([torch.from_numpy(x) for x in g], tstate, tp)
        if tu is not None:
            torch._foreach_add_(tp, tu)
        for a, b in zip(tp, jp):
            np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-6, atol=1e-6)


# ----------------------------------------------------------- train steps


def _wave(seed=0, b=4, n=16000):
    """Rows that differ in spectrum and level (a tone of its own over noise),
    so that the batch statistics of the pooled features are not all noise."""
    rng = np.random.default_rng(seed)
    t = np.arange(n) / 16000.0
    tones = np.stack([np.sin(2 * np.pi * (150.0 * 2 ** i) * t) * 0.3 / (i + 1) for i in range(b)])
    return (tones + rng.standard_normal((b, n)) * 0.05).astype(np.float32)


def _states(head_name="ce", opt_kw=None, ema=False, dtype=None, head_kw=None, seed=0):
    """A JAX train state and a port train state with the same weights."""
    opt_kw = opt_kw or {}
    head_kw = head_kw or {}
    jdt = {None: None, torch.bfloat16: jnp.bfloat16}[dtype]
    jm = JaxTitaNet(dropout=0.0, dtype=jdt, **SMALL)
    jhd = jh.build_head(head_name, 192, N_CLASSES, **head_kw)
    jopt = js.make_optimizer(**opt_kw)
    jst = js.create_train_state(jax.random.key(seed), jm, jhd, jopt, jnp.zeros((2, 101, 80)),
                                N_CLASSES, ema=ema)
    tm = TorchTitaNet(dropout=0.0, dtype=dtype, **SMALL)
    thd = th.build_head(head_name, 192, N_CLASSES, device="cpu", **head_kw)
    load_jax_train_state(tm, thd, _tree_np(jst.params), _tree_np(jst.batch_stats))
    tst = ts.create_train_state(tm, thd, ts.make_optimizer(**opt_kw), ema=ema)
    return (jm, jhd, jopt, jst), tst


def _adam_mu(opt_state):
    """Adam's first moment in an optax state (a tree like the params)."""
    is_adam = lambda x: isinstance(x, optax.ScaleByAdamState)  # noqa: E731
    return next(s for s in jax.tree_util.tree_leaves(opt_state, is_leaf=is_adam) if is_adam(s)).mu


def _loaded_copy(params, batch_stats, head_name="ce", head_kw=None):
    tm = TorchTitaNet(dropout=0.0, **SMALL)
    thd = th.build_head(head_name, 192, N_CLASSES, device="cpu", **(head_kw or {}))
    load_jax_train_state(tm, thd, _tree_np(params), _tree_np(batch_stats))
    return tm, thd


def _assert_modules_close(got, ref, tol, floor=1e-6):
    """Every parameter and buffer: max |got - ref| <= tol * max |ref| + floor."""
    pairs = []
    for g, r in zip(got, ref):
        pairs += zip(g.state_dict().items(), r.state_dict().items())
    for (name, a), (_, b) in pairs:
        a, b = a.float(), b.float()
        assert (a - b).abs().max().item() <= tol * b.abs().max().item() + floor, name


# Tolerances of the f32 step comparisons. From the same weights the first
# step's loss agrees to ~2e-7 and its grad_norm to ~3e-5 relative: the two
# frameworks sum BatchNorm moments, convolutions and gradients over B*T in
# other orders, and the decoder's BatchNorms over 4 rows divide by a small
# batch deviation, which magnifies that rounding. Over three steps: loss
# 1e-4 and grad_norm 5e-4 relative; every parameter and running statistic
# within 5e-5 of its tensor's largest entry, +1e-6 (the floor matters for a
# tensor that starts at zero and moves only by lr x its gradients, a
# BatchNorm bias). SGD at a small lr keeps the update proportional to the
# gradient, so gradient rounding stays rounding in the parameters (Adam's
# first step moves a parameter by ~lr whatever its gradient's size, so a
# gradient that is zero in exact arithmetic, as a conv bias before a
# BatchNorm has, moves by +-lr at random; Adam is held below through its
# first moment, 0.1 x the gradient).
LOSS_RTOL, NORM_RTOL, PARAM_TOL = 1e-4, 5e-4, 5e-5


def test_three_f32_train_steps_match_jax():
    (jm, jhd, jopt, jst), tst = _states(opt_kw=dict(name="sgd", start_lr=3e-4))
    wav, lens, spk = _wave(), np.full(4, 16000, np.int32), np.array([0, 1, 2, 3], np.int32)
    for _ in range(3):
        jst, jmet = js.train_step(jst, jnp.asarray(wav), jnp.asarray(lens), jnp.asarray(spk),
                                  model=jm, head=jhd, optimizer=jopt, frontend=JaxFrontend.from_ms())
        tst, tmet = ts.train_step(tst, wav, lens, spk, frontend=TorchFrontend.from_ms())
        np.testing.assert_allclose(tmet["loss"].item(), float(jmet["loss"]), rtol=LOSS_RTOL)
        np.testing.assert_allclose(tmet["grad_norm"].item(), float(jmet["grad_norm"]), rtol=NORM_RTOL)
        np.testing.assert_array_equal(tmet["preds"].numpy(), np.asarray(jmet["preds"]))
        # unit-norm rows: entries within 2e-4 (the BatchNorm over 4 rows)
        np.testing.assert_allclose(tmet["embeddings"].numpy(), np.asarray(jmet["embeddings"]),
                                   rtol=0, atol=2e-4)
    assert tst.step == int(jst.step) == 3
    _assert_modules_close((tst.model, tst.head), _loaded_copy(jst.params, jst.batch_stats), PARAM_TOL)


def test_masked_ema_renorm_arc_distill_steps_match_jax():
    """masked statistics, weight EMA, angular-head renorm with margin warmup,
    distillation from a frozen teacher, and cosine + warmup + weight decay +
    clipping in the optimizer, three steps."""
    opt_kw = dict(name="sgd", start_lr=3e-4, scheduler=True, warmup_epochs=1, steps_per_epoch=2,
                  total_epochs=4, weight_decay=1e-3, grad_clip_norm=1.0)
    (jm, jhd, jopt, jst), tst = _states("arc", opt_kw, ema=True)
    teacher = JaxTitaNet(dropout=0.0, **SMALL)
    t_vars = _tree_np(dict(teacher.init(jax.random.key(5), jnp.zeros((2, 101, 80)))))
    t_torch = TorchTitaNet(dropout=0.0, **SMALL)
    load_jax_variables(t_torch, t_vars["params"], t_vars["batch_stats"])
    wav = _wave(1)
    lens = np.array([16000, 12000, 9000, 16000], np.int32)
    spk = np.array([0, 1, 1, 4], np.int32)
    kw = dict(masked=True, renorm_head=True, ema_decay=0.9, margin_warmup_steps=2, distill_alpha=0.3)
    for _ in range(3):
        jst, jmet = js.train_step(jst, jnp.asarray(wav), jnp.asarray(lens), jnp.asarray(spk),
                                  model=jm, head=jhd, optimizer=jopt, frontend=JaxFrontend.from_ms(),
                                  teacher_model=teacher, teacher_variables=t_vars, **kw)
        tst, tmet = ts.train_step(tst, wav, lens, spk, frontend=TorchFrontend.from_ms(),
                                  teacher_model=t_torch, **kw)
        np.testing.assert_allclose(tmet["loss"].item(), float(jmet["loss"]), rtol=LOSS_RTOL)
        np.testing.assert_allclose(tmet["grad_norm"].item(), float(jmet["grad_norm"]), rtol=NORM_RTOL)
    _assert_modules_close((tst.model, tst.head),
                          _loaded_copy(jst.params, jst.batch_stats, "arc"), PARAM_TOL)
    ema = ts.ema_eval_state(tst)
    assert ema.model is not tst.model
    _assert_modules_close((ema.model, ema.head),
                          _loaded_copy(jst.ema_params, jst.batch_stats, "arc"), PARAM_TOL)
    w = tst.head.weight.detach()
    torch.testing.assert_close(torch.linalg.vector_norm(w, dim=0), torch.ones(N_CLASSES))


def test_adam_first_step_gradients_match_jax():
    """One Adam step from the same weights: loss, grad_norm, the running
    statistics, and every parameter's gradient through Adam's first moment
    (mu = 0.1 g) within 1e-4 of its tensor's largest entry (+ a floor)."""
    (jm, jhd, jopt, jst), tst = _states(opt_kw=dict(start_lr=1e-3))
    wav, lens, spk = _wave(2), np.full(4, 16000, np.int32), np.array([5, 1, 2, 1], np.int32)
    jst, jmet = js.train_step(jst, jnp.asarray(wav), jnp.asarray(lens), jnp.asarray(spk),
                              model=jm, head=jhd, optimizer=jopt, frontend=JaxFrontend.from_ms())
    tst, tmet = ts.train_step(tst, wav, lens, spk, frontend=TorchFrontend.from_ms())
    np.testing.assert_allclose(tmet["loss"].item(), float(jmet["loss"]), rtol=LOSS_RTOL)
    np.testing.assert_allclose(tmet["grad_norm"].item(), float(jmet["grad_norm"]), rtol=NORM_RTOL)
    mu = _adam_mu(jst.opt_state)
    ref_model, ref_head = _loaded_copy(mu, jst.batch_stats)
    ref = list(ref_model.parameters()) + list(ref_head.parameters())
    names = [n for n, _ in tst.model.named_parameters()] + [n for n, _ in tst.head.named_parameters()]
    # a gradient that is zero in exact arithmetic (a conv bias before a
    # BatchNorm) is rounding noise of the larger ones: the floor is 1e-5 of
    # the largest gradient entry in the model
    floor = 1e-5 * max(r.abs().max().item() for r in ref)
    for name, got, r in zip(names, tst.opt_state.mu, ref):
        assert (got - r).abs().max().item() <= 1e-4 * r.abs().max().item() + floor, name
    for (name, a), (_, b) in zip(tst.model.named_buffers(), ref_model.named_buffers()):
        torch.testing.assert_close(a, b, rtol=PARAM_TOL, atol=1e-7, msg=name)


def test_bf16_step_fused_route_matches_jax_unfused():
    """bf16: the port pools through the autograd Function with the epilog
    BatchNorm folded in (its CPU route: plain forward and backward), the
    JAX package on the CPU through its unfused path. One Adam step: loss
    within 5e-3, grad_norm within 2e-2 (activations rounded to bf16 at other
    places: one bf16 ulp is 2^-8), and Adam's first moment (0.1 x the
    gradient) in cosine > 0.99."""
    (jm, jhd, jopt, jst), tst = _states(opt_kw=dict(start_lr=1e-3), dtype=torch.bfloat16)
    calls = []
    from titanet_torch.ops import pooling

    real = pooling.attentive_pool_fused
    pooling.attentive_pool_fused = lambda *a, **k: calls.append(1) or real(*a, **k)
    try:
        wav, lens, spk = _wave(3), np.full(4, 16000, np.int32), np.array([0, 1, 2, 3], np.int32)
        jst, jmet = js.train_step(jst, jnp.asarray(wav), jnp.asarray(lens), jnp.asarray(spk),
                                  model=jm, head=jhd, optimizer=jopt, frontend=JaxFrontend.from_ms())
        tst, tmet = ts.train_step(tst, wav, lens, spk,
                                  frontend=TorchFrontend.from_ms(use_pallas_fused=True))
    finally:
        pooling.attentive_pool_fused = real
    assert calls == [1]
    np.testing.assert_allclose(tmet["loss"].item(), float(jmet["loss"]), rtol=5e-3)
    np.testing.assert_allclose(tmet["grad_norm"].item(), float(jmet["grad_norm"]), rtol=2e-2)
    ref_model, ref_head = _loaded_copy(_adam_mu(jst.opt_state), jst.batch_stats)
    ref = torch.cat([p.flatten() for p in list(ref_model.parameters()) + list(ref_head.parameters())])
    got = torch.cat([m.flatten() for m in tst.opt_state.mu])
    assert torch.nn.functional.cosine_similarity(got, ref, dim=0).item() > 0.99


def test_accumulated_train_steps_update_every_kth_step():
    (_, _, _, _), tst = _states(opt_kw=dict(start_lr=1e-2, accumulate_steps=2))
    before = [p.detach().clone() for p in tst.params()]
    wav, spk = _wave(4), np.array([0, 1, 2, 3], np.int32)
    fe = TorchFrontend.from_ms()
    tst, _ = ts.train_step(tst, wav, None, spk, frontend=fe)
    assert all(torch.equal(a, b) for a, b in zip(before, tst.params()))
    tst, _ = ts.train_step(tst, wav, None, spk, frontend=fe)
    assert not all(torch.equal(a, b) for a, b in zip(before, tst.params()))
    assert tst.step == 2 and tst.opt_state.count == 1


def test_train_step_lengths_none_equals_full_lengths_and_refuses_augment():
    wav, spk = _wave(5), np.array([0, 1, 2, 3], np.int32)
    fe = TorchFrontend.from_ms()
    losses = []
    for lens in (None, np.full(4, 16000, np.int32)):
        _, tst = _states(opt_kw=dict(start_lr=1e-3))
        _, met = ts.train_step(tst, wav, lens, spk, frontend=fe)
        losses.append(met["loss"].item())
    assert losses[0] == losses[1]
    # augmentation is ported: the legacy 5-tuple runs the SpecAugment branch
    _, met = ts.train_step(tst, wav, None, spk, frontend=fe, augment=(0.1, 1, 0.1, 1, 0.5))
    assert np.isfinite(met["loss"].item())


def test_eval_step_and_metrics_match_jax():
    (jm, jhd, jopt, jst), tst = _states()
    wav, lens = _wave(6), np.array([16000, 11000, 16000, 8000], np.int32)
    spk = np.array([0, 1, 2, 3], np.int32)
    jout = js.eval_step(jst, jnp.asarray(wav), jnp.asarray(lens), jnp.asarray(spk), model=jm,
                        head=jhd, frontend=JaxFrontend.from_ms(), masked=True)
    tout = ts.eval_step(tst, wav, lens, spk, frontend=TorchFrontend.from_ms(), masked=True)
    np.testing.assert_allclose(tout["loss"].item(), float(jout["loss"]), rtol=1e-5)
    np.testing.assert_array_equal(tout["preds"].numpy(), np.asarray(jout["preds"]))
    np.testing.assert_allclose(tout["embeddings"].numpy(), np.asarray(jout["embeddings"]),
                               rtol=1e-4, atol=1e-5)
    jacc = js.init_metrics_acc(N_CLASSES)
    tacc = ts.init_metrics_acc(N_CLASSES, device="cpu")
    steps = [(1.5, [0, 1, 2, 2], [0, 1, 1, 2]), (float("nan"), [3, 3, 5, 0], [3, 4, 5, 1]),
             (0.5, None, [0, 0, 0, 0])]
    for loss, preds, tgt in steps:
        jp = None if preds is None else jnp.asarray(preds, jnp.int32)
        jacc = js.accumulate_metrics(jacc, jnp.float32(loss), jp, jnp.asarray(tgt, jnp.int32))
        tp = None if preds is None else torch.tensor(preds)
        tacc = ts.accumulate_metrics(tacc, torch.tensor(loss), tp, torch.tensor(tgt))
    for name in ("loss_sum", "steps", "nonfinite", "correct", "n_examples", "tp", "pred_count",
                 "true_count"):
        np.testing.assert_array_equal(getattr(tacc, name).numpy(), np.asarray(getattr(jacc, name)),
                                      err_msg=name)


def test_load_jax_train_state_rejects_mismatched_trees():
    (_, _, _, jst), tst = _states()
    params = _tree_np(jst.params)
    with pytest.raises(ValueError):
        load_jax_train_state(tst.model, tst.head, {"backbone": params["backbone"]},
                             _tree_np(jst.batch_stats))
    bad = dict(params)
    bad["head"] = {"fc": {"kernel": np.zeros((192, N_CLASSES + 1), np.float32),
                          "bias": np.zeros(N_CLASSES + 1, np.float32)}}
    with pytest.raises(ValueError):
        load_jax_train_state(tst.model, tst.head, bad, _tree_np(jst.batch_stats))
