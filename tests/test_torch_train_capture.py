"""The train step's capture on the CPU: the optimizer's device side
against the update it replaced (Python scalars read on the host), to the
bit; the counters the host keeps; the routing (``capture=None`` runs
eagerly here and equals ``capture=False``, ``capture=True`` raises); and
the key of the step's graph. The graph itself runs on the card
(``tests/test_torch_cuda.py``, ``chip_smoke.py`` phase 19)."""

import math

import numpy as np
import pytest
import torch

from titanet_torch.losses import build_head
from titanet_torch.models.titanet import TitaNet
from titanet_torch.ops.augment import AugmentConfig
from titanet_torch.ops.frontend import FrontendConfig
from titanet_torch.train import capture
from titanet_torch.train import state as ts

TOY = dict(n_mega_blocks=2, encoder_hidden_size=32, encoder_output_size=48, embedding_size=16,
           attention_hidden_size=8)
N_CLASSES = 5
FE = FrontendConfig.from_ms(use_pallas_fused=True)


class ScalarOptimizer(ts.Optimizer):
    """The update as it was before the device side: the clip decided by a
    host read of the norm, the step's learning rate, bias corrections and
    accumulation divisor as Python floats, the accumulator rebound."""

    @torch.no_grad()
    def update(self, grads, state, params):
        if self.accumulate_steps > 1:
            n = state.mini_step
            delta = torch._foreach_sub(grads, state.acc)
            torch._foreach_div_(delta, float(n + 1))
            torch._foreach_add_(state.acc, delta)
            state.mini_step = (n + 1) % self.accumulate_steps
            if state.mini_step != 0:
                return None
            grads, state.acc = state.acc, [torch.zeros_like(a) for a in state.acc]
        updates = list(grads)
        if self.grad_clip_norm:
            norm = ts.global_norm(updates)
            if bool(norm >= self.grad_clip_norm):
                updates = torch._foreach_div(updates, norm)
                torch._foreach_mul_(updates, self.grad_clip_norm)
        if self.weight_decay:
            updates = torch._foreach_add(updates, params, alpha=self.weight_decay)
        lr = self.lr(state.count)
        if self.name == "adam":
            b1, b2 = 0.9, 0.999
            torch._foreach_mul_(state.mu, b1)
            torch._foreach_add_(state.mu, updates, alpha=1.0 - b1)
            torch._foreach_mul_(state.nu, b2)
            torch._foreach_addcmul_(state.nu, updates, updates, value=1.0 - b2)
            t = state.count + 1
            mu_hat = torch._foreach_div(state.mu, 1.0 - b1 ** t)
            nu_hat = torch._foreach_div(state.nu, 1.0 - b2 ** t)
            denom = torch._foreach_sqrt(nu_hat)
            torch._foreach_add_(denom, 1e-8)
            updates = torch._foreach_div(mu_hat, denom)
        else:
            updates = [u.clone() for u in updates]
        torch._foreach_mul_(updates, -lr)
        state.count += 1
        return updates


# (make_optimizer arguments, gradient scale): a scale of 3 puts the
# global norm near 6.5, a scale of 0.05 near 0.1
OPT_CASES = {
    "adam": (dict(start_lr=3e-3), 1.0),
    "sgd": (dict(name="sgd", start_lr=0.1), 1.0),
    "adam_clip_triggered": (dict(grad_clip_norm=1.0), 3.0),
    "adam_clip_untriggered": (dict(grad_clip_norm=1.0), 0.05),
    "sgd_clip_sometimes": (dict(name="sgd", start_lr=0.05, grad_clip_norm=2.0), "mixed"),
    "adam_warmup_cosine": (dict(scheduler=True, warmup_epochs=2, steps_per_epoch=2, total_epochs=5,
                                end_lr=1e-5), 1.0),
    "adam_accumulate3_wd": (dict(accumulate_steps=3, weight_decay=1e-2, grad_clip_norm=1.5), 1.0),
    "sgd_accumulate3_warmup": (dict(name="sgd", accumulate_steps=3, scheduler=True, warmup_epochs=1,
                                    steps_per_epoch=2, total_epochs=3, start_lr=0.2), 1.0),
}


@pytest.mark.parametrize("case", sorted(OPT_CASES))
def test_device_scalar_optimizer_equals_the_host_scalar_update(case):
    """Twelve updates on the same gradients: the parameters, Adam's
    moments, the accumulator and the counters equal the replaced update's
    to the bit (an f32 tensor of the f64 scalar rounds as the scalar
    argument of a ``_foreach`` op does; u / 1 * 1 is u)."""
    kw, scale = OPT_CASES[case]
    rng = np.random.default_rng(3)
    shapes = [(6, 4), (9,), ()]
    p0 = [np.asarray(rng.standard_normal(s), np.float32) for s in shapes]
    new, old = ts.make_optimizer(**kw), ScalarOptimizer(**vars(ts.make_optimizer(**kw)))
    params = {k: [torch.from_numpy(p.copy()) for p in p0] for k in ("new", "old")}
    states = {"new": new.init(params["new"]), "old": old.init(params["old"])}
    clipped = set()
    for i in range(12):
        s = (3.0 if i % 2 else 0.05) if scale == "mixed" else scale
        g = [torch.from_numpy(np.asarray(rng.standard_normal(sh) * s, np.float32)) for sh in shapes]
        if kw.get("grad_clip_norm"):
            clipped.add(bool(ts.global_norm(g) >= kw["grad_clip_norm"]))
        for name, opt in (("new", new), ("old", old)):
            upd = opt.update([x.clone() for x in g], states[name], params[name])
            if upd is not None:
                torch._foreach_add_(params[name], upd)
        for a, b in zip(params["new"], params["old"]):
            assert torch.equal(a, b), (case, i)
        got, want = states["new"], states["old"]
        assert (got.count, got.mini_step) == (want.count, want.mini_step)
        for field in ("mu", "nu", "acc"):
            for a, b in zip(getattr(got, field) or [], getattr(want, field) or []):
                assert torch.equal(a, b), (case, i, field)
    if case == "sgd_clip_sometimes":
        assert clipped == {True, False}
    elif kw.get("grad_clip_norm") and not kw.get("accumulate_steps"):
        assert clipped == {scale > 1}


def test_accumulator_is_zeroed_in_place():
    """Under accumulation the update zeroes the accumulator's own tensors:
    a captured step's key (their addresses) stays the same."""
    opt = ts.make_optimizer(accumulate_steps=2)
    params = [torch.ones(3), torch.ones(2)]
    state = opt.init(params)
    ptrs = [a.data_ptr() for a in state.acc]
    for _ in range(4):
        opt.update([torch.full_like(p, 0.5) for p in params], state, params)
    assert [a.data_ptr() for a in state.acc] == ptrs
    assert all(not a.any() for a in state.acc)


def _wave(seed=0, b=3, n=8000):
    rng = np.random.default_rng(seed)
    t = np.arange(n) / 16000.0
    tones = np.stack([np.sin(2 * np.pi * (200.0 * 2 ** i) * t) * 0.3 / (i + 1) for i in range(b)])
    return (tones + rng.standard_normal((b, n)) * 0.05).astype(np.float32)


def _state(head="ce", dropout=0.3, remat=False, ema=True, **opt_kw):
    model = TitaNet(dropout=dropout, remat=remat, **TOY)
    model.reset_parameters(torch.Generator().manual_seed(0))
    hd = build_head(head, TOY["embedding_size"], N_CLASSES, device="cpu",
                    generator=torch.Generator().manual_seed(1))
    opt = ts.make_optimizer(**{"start_lr": 1e-2, **opt_kw})
    return ts.create_train_state(model, hd, opt, seed=2, ema=ema)


def _record(state, metrics):
    tensors = [t for _, t in state.model.state_dict().items()] + [t for _, t in state.head.state_dict().items()]
    opt = state.opt_state
    for name in ("mu", "nu", "acc"):
        tensors += getattr(opt, name) or []
    tensors += state.ema or []
    tensors += [g.get_state() for g in state.generators().values()]
    tensors += [metrics[k] for k in ("loss", "grad_norm", "preds", "embeddings") if metrics[k] is not None]
    return tensors, (state.step, opt.count, opt.mini_step)


STEP_CASES = {
    "plain": ({}, {}),
    "augment_ema": (dict(augment=AugmentConfig(noise_prob=0.5), ema_decay=0.9), {}),
    "arc_margin_warmup_renorm": (dict(margin_warmup_steps=3, renorm_head=True), dict(head="arc")),
    "accumulate_clip_cosine": ({}, dict(accumulate_steps=2, grad_clip_norm=0.5, scheduler=True,
                                        warmup_epochs=1, steps_per_epoch=2, total_epochs=3)),
}


@pytest.mark.parametrize("case", sorted(STEP_CASES))
def test_cpu_train_step_runs_eagerly_and_equals_capture_false(case):
    """``capture=None`` on the CPU is the eager step: three steps of each
    route from one state, every tensor, generator state, metric and
    counter to the bit, and no graph captured."""
    step_kw, state_kw = STEP_CASES[case]
    wav, spk = _wave(), np.array([0, 3, 1])
    lengths = np.array([8000, 6000, 4500], np.int32)
    captures = capture.GRAPHS.captures
    got = []
    for route in (None, False):
        st = _state(**state_kw)
        for _ in range(3):
            st, met = ts.train_step(st, wav, lengths, spk, frontend=FE, capture=route, **step_kw)
        got.append(_record(st, met))
    (a, ca), (b, cb) = got
    assert ca == cb
    assert len(a) == len(b) and all(torch.equal(x, y) for x, y in zip(a, b))
    assert capture.GRAPHS.captures == captures


def test_capture_true_on_the_cpu_raises():
    st = _state()
    with pytest.raises(ValueError, match="step capture needs a CUDA device"):
        ts.train_step(st, _wave(), None, np.array([0, 1, 2]), frontend=FE, capture=True)
    assert st.step == 0 and st.opt_state.count == 0


def test_counters_advance_once_a_call():
    """``step`` every call, ``mini_step`` modulo k, ``count`` on every k-th
    call (the host keeps them; the step reads its scalars from them)."""
    st = _state(accumulate_steps=3)
    seen = []
    for _ in range(7):
        ts.train_step(st, _wave(), None, np.array([0, 1, 2]), frontend=FE)
        seen.append((st.step, st.opt_state.mini_step, st.opt_state.count))
    assert seen == [(1, 1, 0), (2, 2, 0), (3, 0, 1), (4, 1, 1), (5, 2, 1), (6, 0, 2), (7, 1, 2)]


def test_step_scalars_are_the_host_values_in_f32():
    opt = ts.make_optimizer(start_lr=1e-3, scheduler=True, warmup_epochs=1, steps_per_epoch=3, total_epochs=4,
                            accumulate_steps=2)
    state = ts.OptState(count=5, mini_step=1)
    want = [-opt.lr(5), 1.0 - 0.9 ** 6, 1.0 - 0.999 ** 6, 2.0]
    assert opt.scalars(state, "cpu") == want
    # on the card the divisors go as reciprocals: the product torch's CUDA
    # _foreach_div by a Python scalar computes
    assert opt.scalars(state, "cuda") == [want[0]] + [1.0 / d for d in want[1:]]
    assert opt.applies(state) and not opt.applies(ts.OptState(count=5, mini_step=0))
    got = ts.device_scalars(want + [0.25], "cpu")
    assert got.dtype == torch.float32 and got.tolist() == [float(np.float32(v)) for v in want + [0.25]]
    assert ts.margin_scale(3, 4) == 0.75 and ts.margin_scale(9, 4) == 1.0 and ts.margin_scale(3, None) is None


def test_margin_scale_as_a_tensor_equals_the_float():
    """The captured step hands the head its margin scale as a 0-dim f32
    tensor (no host copy inside the step): the same loss, to the bit."""
    hd = build_head("arc", 16, N_CLASSES, device="cpu", generator=torch.Generator().manual_seed(4))
    emb = torch.from_numpy(np.random.default_rng(5).standard_normal((4, 16)).astype(np.float32))
    tgt = torch.tensor([0, 1, 4, 2])
    for s in (0.0, 1 / 3, 0.7, 1.0):
        a = hd(emb, tgt, margin_scale=s)[2]
        b = hd(emb, tgt, margin_scale=ts.device_scalars([s], "cpu")[0])[2]
        assert torch.equal(a, b), s


class _KeyRecorder:
    """Stands in for the graph cache: records each call's key and runs the
    step eagerly."""

    def __init__(self):
        self.keys = []

    def run(self, name, static, owners, fn, inputs):
        self.keys.append(capture.StepGraphs.key(name, static, owners, inputs))
        return fn(*inputs)


@pytest.fixture
def recorded(monkeypatch):
    rec = _KeyRecorder()
    monkeypatch.setattr(ts, "GRAPHS", rec)
    monkeypatch.setattr(ts, "wanted", lambda capture, device: capture is not False)
    return rec


def test_key_is_stable_across_steps_and_tells_accumulate_from_update(recorded):
    """One key for every call of a shape (no capture a step), one more for
    the call that completes the accumulation."""
    st = _state(accumulate_steps=3)
    for _ in range(6):
        ts.train_step(st, _wave(), None, np.array([0, 1, 2]), frontend=FE)
    k = recorded.keys
    assert k[0] == k[1] == k[3] == k[4] and k[2] == k[5] and k[0] != k[2]


def test_key_tells_uniform_from_ragged_and_a_new_generator(recorded):
    st = _state()
    spk = np.array([0, 1, 2])
    ts.train_step(st, _wave(), None, spk, frontend=FE)
    ts.train_step(st, _wave(), np.array([8000, 5000, 8000], np.int32), spk, frontend=FE)
    ts.train_step(st, _wave(), None, spk, frontend=FE)
    st.aug_generator = torch.Generator().manual_seed(9)
    ts.train_step(st, _wave(), None, spk, frontend=FE)
    ts.train_step(st, _wave(n=7000), None, spk, frontend=FE)
    k = recorded.keys
    assert k[0] == k[2]
    assert len({k[0], k[1], k[3], k[4]}) == 4


def test_key_holds_the_state_optimizer_teacher_and_generators(recorded):
    """The owners: the state (model, head, optimizer state, EMA), the
    optimizer, the teacher and the three generators."""
    st = _state()
    teacher = TitaNet(dropout=0.0, **TOY)
    ts.train_step(st, _wave(), None, np.array([0, 1, 2]), frontend=FE, teacher_model=teacher, distill_alpha=0.3)
    owners = recorded.keys[0][-1]
    ids = [o[0] for o in owners]
    assert ids == [id(st), id(st.optimizer), id(teacher), id(st.generator), id(st.aug_generator),
                   id(st.noise_generator)]
    n_state = len(capture.owned_tensors(st))
    assert n_state == (len(st.model.state_dict()) + len(st.head.state_dict()) + 2 * len(st.params())
                       + len(st.ema))
    assert len(owners[0][1]) == n_state


def test_recorded_route_equals_the_eager_step(recorded):
    """The step the graph cache is handed, run eagerly, is the eager step."""
    wav, spk = _wave(1), np.array([2, 0, 1])
    a = _state(grad_clip_norm=0.5)
    for _ in range(2):
        a, ma = ts.train_step(a, wav, None, spk, frontend=FE)
    b = _state(grad_clip_norm=0.5)
    for _ in range(2):
        b, mb = ts.train_step(b, wav, None, spk, frontend=FE, capture=False)
    assert len(recorded.keys) == 2
    (ra, ca), (rb, cb) = _record(a, ma), _record(b, mb)
    assert ca == cb and all(torch.equal(x, y) for x, y in zip(ra, rb))
    assert math.isfinite(ma["loss"].item())
