"""One rank of the port's data-parallel CPU tests (tests/test_torch_parallel*.py).

    python tests/torch_parallel_worker.py <task> <rank> <world> <port> <inputs.pkl> <out.pt>

Joins a gloo group on 127.0.0.1:<port> (60 s timeout on every collective),
runs every case of ``task`` on this rank's rows of the inputs the test
wrote, and saves what each case computed. Imports torch and the port only.
"""

import datetime
import hashlib
import os
import pickle
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np  # noqa: E402
import torch  # noqa: E402
import torch.distributed as dist  # noqa: E402

from titanet_torch.losses.heads import build_head  # noqa: E402
from titanet_torch.models import common  # noqa: E402
from titanet_torch.models.titanet import TitaNet  # noqa: E402
from titanet_torch.ops.frontend import FrontendConfig  # noqa: E402
from titanet_torch.ops.kernels.pool import attentive_pool_fused  # noqa: E402
from titanet_torch.ops.norm import BatchNorm, ema_update_batch_stats  # noqa: E402
from titanet_torch.parallel import make_mesh  # noqa: E402
from titanet_torch.parallel.distributed import (  # noqa: E402
    collective_stats,
    destroy_process_group,
    reset_collective_stats,
)
from titanet_torch.train import state as ts  # noqa: E402
from titanet_torch.utils.weights import load_jax_train_state  # noqa: E402

TOY = dict(n_mega_blocks=1, encoder_hidden_size=32, encoder_output_size=48, embedding_size=16,
           attention_hidden_size=8)
N_CLASSES = 8


def toy_state(seed=0, dropout=0.5, opt=None, head="ce", **model_kw):
    """A toy TitaNet + ``head`` from ``seed``, and its train state."""
    model = TitaNet(dropout=dropout, **{**TOY, **model_kw})
    common.finish(model, "cpu", torch.Generator().manual_seed(seed))
    head = build_head(head, model.embedding_size, N_CLASSES, device="cpu",
                      generator=torch.Generator().manual_seed(seed + 1))
    return ts.create_train_state(model, head, opt or ts.make_optimizer(name="sgd", start_lr=3e-4), seed=3)


def rows(a, mesh):
    return a[mesh.rows(a.shape[0])]


def bn_case(inp, mesh, axis_name, cls=BatchNorm):
    """One BatchNorm (``cls``) training forward and backward on this rank's rows."""
    bn = cls(inp["x"].shape[-1], axis_name=axis_name).train()
    with torch.no_grad():
        bn.weight.copy_(torch.from_numpy(inp["scale"]))
        bn.bias.copy_(torch.from_numpy(inp["bias"]))
        bn.running_mean.copy_(torch.from_numpy(inp["mean"]))
        bn.running_var.copy_(torch.from_numpy(inp["var"]))
    x = torch.from_numpy(rows(inp["x"], mesh)).requires_grad_()
    mask = None if inp["mask"] is None else torch.from_numpy(rows(inp["mask"], mesh))
    with mesh.active():
        y = bn(x, mask=mask)
        (y * torch.from_numpy(rows(inp["g"], mesh))).sum().backward()
        ema_update_batch_stats(bn)
        with torch.no_grad():
            a, c = bn(x, mask=mask, return_scale_shift=True)
    return {"y": y.detach(), "dx": x.grad, "dscale": bn.weight.grad, "dbias": bn.bias.grad,
            "running_mean": bn.running_mean.clone(), "running_var": bn.running_var.clone(), "a": a, "c": c}


def task_norm(inp, mesh):
    out = {}
    for name, case in inp["bn"].items():
        out[name] = bn_case(case, mesh, None)
        out[name + "/axis_name"] = bn_case(case, mesh, "data")
    return out


def task_steps(inp, mesh):
    out = {}
    fe = FrontendConfig.from_ms()

    # train_step on this rank's loader batches, dropout 0.5, SGD
    st = toy_state()
    losses, norms, consumed = [], [], []
    for wav, spk in inp["batches"][mesh.rank]:
        consumed.append(hashlib.sha1(wav.tobytes()).hexdigest())
        st, m = ts.train_step(st, wav, None, spk, frontend=fe, mesh=mesh)
        losses.append(m["loss"].item())
        norms.append(m["grad_norm"].item())
    out["train"] = {"losses": losses, "grad_norms": norms, "consumed": consumed,
                    "state": {k: v.clone() for k, v in list(st.model.state_dict().items())
                              + [("head." + k, v) for k, v in st.head.state_dict().items()]},
                    "checksum": sum(float(p.detach().double().abs().sum()) for p in st.params()),
                    "eval_loss": ts.eval_step(st, wav, None, spk, frontend=fe, mesh=mesh)["loss"].item()}

    # GE2E, whose loss couples the rows: the head sees the gathered batch
    st = toy_state(head="ge2e")
    ge2e = [ts.train_step(st, wav, None, spk, frontend=fe, mesh=mesh)[1]["loss"].item()
            for wav, spk in inp["batches"][mesh.rank]]
    out["ge2e"] = {"losses": ge2e, "state": {k: v.clone() for k, v in st.model.state_dict().items()}}

    # the shard_map counterpart from the JAX weights
    from titanet_torch.parallel.shard_map_step import make_shard_map_train_step, replicate_state

    sm = inp["shard_map"]
    model = TitaNet(dropout=0.0, axis_name="data", **sm["model"])
    head = build_head("ce", sm["model"]["embedding_size"], N_CLASSES, device="cpu")
    load_jax_train_state(model, head, sm["params"], sm["batch_stats"])
    state = ts.create_train_state(model, head, ts.make_optimizer(start_lr=1e-3))
    replicate_state(state, mesh)
    step = make_shard_map_train_step(mesh, model=model, head=head, optimizer=state.optimizer, frontend=fe)
    sm_losses = []
    for _ in range(2):
        state, m = step(state, rows(sm["wav"], mesh), rows(sm["lengths"], mesh), rows(sm["speakers"], mesh))
        sm_losses.append(m["loss"].item())
    out["shard_map"] = {"losses": sm_losses, "step": state.step}

    # the pool fold's (a, c) from global statistics, and their gradients
    pf = inp["fold"]
    bn = BatchNorm(pf["h"].shape[-1]).train()
    with torch.no_grad():
        bn.weight.copy_(torch.from_numpy(pf["scale"]))
        bn.bias.copy_(torch.from_numpy(pf["bias"]))
    h = torch.from_numpy(rows(pf["h"], mesh)).requires_grad_()
    with mesh.active():
        a, c = bn(h, return_scale_shift=True)
        a.retain_grad()
        c.retain_grad()
        pooled = attentive_pool_fused(h, a, c, *(torch.from_numpy(pf[k]) for k in ("wa", "ba", "wb", "bb")),
                                      1e-6, True)
        (pooled * torch.from_numpy(rows(pf["g"], mesh))).sum().backward()
    out["fold"] = {"pooled": pooled.detach(), "dh": h.grad, "da": a.grad, "dc": c.grad,
                   "dscale": bn.weight.grad, "dbias": bn.bias.grad}

    # a value each rank computed on its own: every rank reads rank 0's
    out["decision"] = mesh.rank0_value(0.5 + 0.25 * mesh.rank)

    # the collectives of one step at the JAX dry run's shape
    st = toy_state(dropout=0.1, n_mega_blocks=2)
    dr = inp["dryrun"]
    reset_collective_stats()
    ts.train_step(st, rows(dr["wav"], mesh), rows(dr["lengths"], mesh), rows(dr["speakers"], mesh),
                  frontend=fe, augment=(0.35, 1, 0.15, 1, 0.5), mesh=mesh)
    out["collectives"] = {"stats": collective_stats(),
                          "param_bytes": sum(p.numel() * p.element_size() for p in st.params()),
                          "batchnorm_sites": sum(isinstance(m, BatchNorm) for m in st.model.modules())}
    return out


def task_remat(inp, mesh):
    """Two train steps of the plain model and of the rematerialized one
    under each policy: the states, the losses, the dropout generator and
    the collectives each route issued."""
    fe = FrontendConfig.from_ms()
    out = {}
    for policy, remat in [(None, False)] + [(p, True) for p in inp["policies"]]:
        st = toy_state(n_mega_blocks=2, remat=remat, remat_policy=policy)
        reset_collective_stats()
        losses = []
        for wav, spk in inp["batches"]:
            st, m = ts.train_step(st, rows(wav, mesh), None, rows(spk, mesh), frontend=fe, mesh=mesh)
            losses.append(m["loss"])
        out[policy, remat] = {"stats": collective_stats(), "losses": losses, "generator": st.generator.get_state(),
                              "state": [t.clone() for t in st.model.state_dict().values()]}
    return out


class FormerCountBatchNorm(BatchNorm):
    """BatchNorm with the global-batch rule's frame count made as it was
    before the count moved to the device: a host tensor copied over."""

    def _global_stats(self, xf, m, axes, mesh):
        from titanet_torch.parallel import distributed as pd

        if m is not None:
            n = m.sum()
            mean = (xf * m).sum(dim=axes) / torch.clamp(n, min=1.0)
            m2 = ((xf - mean) ** 2 * m).sum(dim=axes)
        else:
            n = torch.tensor(float(xf[..., 0].numel()), device=xf.device)
            mean = xf.mean(dim=axes)
            m2 = ((xf - mean) ** 2).sum(dim=axes)
        c = mean.shape[0]
        packed = torch.cat([n.reshape(1), mean, m2])[None]
        g = self._collective(
            lambda: pd.all_gather_rows(packed, mesh.rank, mesh.size, mesh.group, "batchnorm"))
        ns, means, m2s = g[:, :1], g[:, 1:1 + c], g[:, 1 + c:]
        count = torch.clamp(ns.sum(), min=1.0)
        mean = (ns * means).sum(dim=0) / count
        m2 = m2s.sum(dim=0) + (ns * (means - mean) ** 2).sum(dim=0)
        return mean, m2 / count, count.detach()


def former_shard_map_train_step(mesh, *, model, head, optimizer, frontend, augment=None):
    """The ``shard_map`` step as it was before its capture: a fresh
    generator a stream and step, ``optimizer.update`` inside the step."""
    from titanet_torch.ops.augment import spec_augment
    from titanet_torch.ops.frontend import log_mel_spectrogram
    from titanet_torch.train.state import _dequantize_waveform, mean_over_ranks

    def rank_generator(state, stream):
        seed = np.random.SeedSequence([state.generator.initial_seed(), state.step, stream, mesh.rank])
        return torch.Generator(device=state.generator.device).manual_seed(
            int(seed.generate_state(1, np.uint64)[0] >> np.uint64(1)))

    def step(state, waveform, lengths, speakers):
        dev = mesh.device
        wav = _dequantize_waveform(torch.as_tensor(waveform, device=dev))
        lens = None if lengths is None else torch.as_tensor(lengths, device=dev)
        spk = torch.as_tensor(speakers, device=dev).long()
        with mesh.active(global_batch=False), torch.no_grad():
            mel, mask = log_mel_spectrogram(wav, frontend, lengths=lens)
            if augment is not None:
                fr, fn, tr, tn, prob = augment
                mel = spec_augment(rank_generator(state, 1), mel, freq_mask_ratio=fr, freq_mask_num=fn,
                                   time_mask_ratio=tr, time_mask_num=tn, probability=prob, frames_mask=mask)
        model.train()
        head.train()
        with mesh.active(global_batch=False):
            emb = model(mel, generator=rank_generator(state, 2))
        _, preds, loss = head(emb, spk)
        params = state.params()
        grads = torch.autograd.grad(loss, params, allow_unused=True)
        grads = [torch.zeros_like(p) if g is None else g for p, g in zip(params, grads)]
        if mesh.size > 1:
            grads = mean_over_ranks(grads, mesh)
            loss = mean_over_ranks([loss.detach()], mesh, "loss")[0]
        ema_update_batch_stats(model)
        updates = optimizer.update(grads, state.opt_state, params)
        with torch.no_grad():
            if updates is not None:
                torch._foreach_add_(params, updates)
        state.step += 1
        return state, {"loss": loss.detach(), "preds": preds}

    return step


def state_record(st) -> dict:
    """Every tensor a train step advances, cloned to the CPU, and the
    counters and the generators' states."""
    opt = st.opt_state
    rec = {f"model.{k}": v.detach().cpu().clone() for k, v in st.model.state_dict().items()}
    rec.update({f"head.{k}": v.detach().cpu().clone() for k, v in st.head.state_dict().items()})
    for name in ("mu", "nu", "acc"):
        rec.update({f"opt.{name}.{i}": t.cpu().clone() for i, t in enumerate(getattr(opt, name) or [])})
    rec.update({f"ema.{i}": t.cpu().clone() for i, t in enumerate(st.ema or [])})
    rec["counters"] = (st.step, opt.count, opt.mini_step)
    rec.update({f"generator.{k}": g.get_state() for k, g in st.generators().items()})
    return rec


def shard_map_run(sm, mesh, steps, make_step, dropout=0.0, augment=None, capture=None):
    """``steps`` shard_map steps (``make_step``'s) from the JAX weights in
    ``sm`` on this rank's rows: the losses and predictions, and
    :func:`state_record`."""
    from titanet_torch.parallel.shard_map_step import replicate_state

    model = TitaNet(dropout=dropout, axis_name="data", **sm["model"])
    head = build_head("ce", sm["model"]["embedding_size"], N_CLASSES, device="cpu")
    load_jax_train_state(model, head, sm["params"], sm["batch_stats"])
    state = ts.create_train_state(model, head, ts.make_optimizer(start_lr=1e-3, grad_clip_norm=1.0))
    replicate_state(state, mesh)
    kw = dict(model=model, head=head, optimizer=state.optimizer, frontend=FrontendConfig.from_ms(), augment=augment)
    if capture is not None:
        kw["capture"] = capture
    step = make_step(mesh, **kw)
    losses, preds = [], []
    for _ in range(steps):
        state, m = step(state, rows(sm["wav"], mesh), None, rows(sm["speakers"], mesh))
        losses.append(m["loss"].cpu().clone())
        preds.append(m["preds"].cpu().clone())
    return {"losses": losses, "preds": preds, "state": state_record(state)}


class _Recorder:
    """A graph cache that records the steps sent to it and runs them eagerly."""

    def __init__(self):
        self.calls = []

    def run(self, name, static, owners, fn, inputs):
        self.calls.append(name)
        return fn(*inputs)


def task_capture(inp, mesh):
    """The CPU half of the data-parallel capture: the device-made frame
    count against the former host-made one, the shard_map step against its
    former self and for JAX's comparison, and the gloo rule."""
    from titanet_torch.parallel.shard_map_step import make_shard_map_train_step

    out = {}
    for name, case in inp["bn"].items():
        got = bn_case(case, mesh, None)
        former = bn_case(case, mesh, None, cls=FormerCountBatchNorm)
        out["bn/" + name] = (got, former)
    sm, aug = inp["shard_map"], (0.35, 1, 0.15, 1, 0.5)
    out["shard_map/split"] = shard_map_run(sm, mesh, 3, make_shard_map_train_step, dropout=0.5, augment=aug)
    out["shard_map/former"] = shard_map_run(sm, mesh, 3, former_shard_map_train_step, dropout=0.5, augment=aug)
    out["shard_map/jax"] = shard_map_run(sm, mesh, 3, make_shard_map_train_step)

    # the gloo rule, with the steps told they run on the card: capture None
    # runs eagerly (no graph is asked for), True raises
    fe = FrontendConfig.from_ms()
    wanted, graphs = ts.wanted, ts.GRAPHS
    ts.wanted = lambda capture, device: capture is not False
    ts.GRAPHS = rec = _Recorder()
    try:
        runs = {}
        for capture in (None, False):
            st = toy_state(dropout=0.5)
            for wav, spk in inp["batches"][mesh.rank]:
                st, m = ts.train_step(st, wav, None, spk, frontend=fe, mesh=mesh, capture=capture)
            runs[capture] = state_record(st)
        sm_runs = {c: shard_map_run(sm, mesh, 2, make_shard_map_train_step, dropout=0.5, augment=aug, capture=c)
                   for c in (None, False)}
        errors = {}
        wav0, spk0 = inp["batches"][mesh.rank][0]
        for what, fn in (("train_step", lambda: ts.train_step(toy_state(), wav0, None, spk0, frontend=fe, mesh=mesh,
                                                              capture=True)),
                         ("shard_map", lambda: shard_map_run(sm, mesh, 1, make_shard_map_train_step, capture=True))):
            try:
                fn()
                errors[what] = None
            except ValueError as e:
                errors[what] = str(e)
    finally:
        ts.wanted, ts.GRAPHS = wanted, graphs
    out["gloo"] = {"graph_calls": list(rec.calls), "train_step": runs, "shard_map": sm_runs, "errors": errors}
    return out


def card_state(dev, axis_name=None, accumulate=1):
    """TitaNet-S widths with 2 mega-blocks, bf16, dropout 0.5, on ``dev``
    (the card tests' train state), Adam with clipping, a warm-up and a
    cosine, weight EMA."""
    model = common.finish(TitaNet(n_mega_blocks=2, dropout=0.5, dtype=torch.bfloat16, axis_name=axis_name), dev,
                          torch.Generator().manual_seed(0))
    head = build_head("ce", 192, N_CLASSES, device=dev, generator=torch.Generator().manual_seed(1))
    opt = ts.make_optimizer(grad_clip_norm=1.0, scheduler=True, total_epochs=4, steps_per_epoch=2, warmup_epochs=1,
                            accumulate_steps=accumulate)
    return ts.create_train_state(model, head, opt, seed=0, ema=True)


def task_nccl_capture(inp, mesh):
    """On NCCL ranks, one card each: the captured steps against eager
    (``capture=False``) from one state, to the bit: the global-batch step
    (noise and SpecAugment on ragged rows), with ``accumulate_steps=2``
    (two graphs), and the shard_map step; ``collective_stats()`` after the
    captured steps against after the eager ones; the graphs captured over
    two bucket widths."""
    from titanet_torch.ops.augment import AugmentConfig
    from titanet_torch.parallel.distributed import collective_stats, reset_collective_stats
    from titanet_torch.parallel.shard_map_step import make_shard_map_train_step
    from titanet_torch.train import capture as cap

    torch.backends.cudnn.deterministic = True
    dev = mesh.device
    fe = FrontendConfig.from_ms(use_pallas_fused=True)
    wav, lengths, spk = (torch.from_numpy(rows(inp[k], mesh)).to(dev) for k in ("wav", "lengths", "speakers"))
    out = {}

    def run(capture, steps, accumulate=1, widths=None, shard_map=False):
        st = card_state(dev, "data" if shard_map else None, accumulate)
        if shard_map:
            step = make_shard_map_train_step(mesh, model=st.model, head=st.head, optimizer=st.optimizer, frontend=fe,
                                             augment=(0.35, 1, 0.15, 1, 0.5), capture=capture)
        reset_collective_stats()
        losses = []
        for i in range(steps):
            w, ln = (wav, lengths) if widths is None else (wav[:, :widths[i % len(widths)]], None)
            if shard_map:
                st, m = step(st, w, ln, spk)
            else:
                st, m = ts.train_step(st, w, ln, spk, frontend=fe, mesh=mesh, augment=AugmentConfig(noise_prob=0.5),
                                      ema_decay=0.99, capture=capture)
            losses.append(m["loss"].cpu().clone())
        torch.cuda.synchronize()
        return {"losses": losses, "state": state_record(st), "stats": collective_stats()}

    saved = ts.GRAPHS
    try:
        for case, kw in (("global", {}), ("accumulate", dict(accumulate=2)), ("shard_map", dict(shard_map=True))):
            ts.GRAPHS = graphs = cap.StepGraphs()
            out[case] = {"eager": run(False, 4, **kw), "graph": run(None, 4, **kw)}
            out[case]["captures"] = graphs.captures
        ts.GRAPHS = graphs = cap.StepGraphs()
        run(None, 4, widths=inp["widths"])
        out["widths_captures"] = graphs.captures
    finally:
        ts.GRAPHS = saved
    return out


def task_nccl_lost(inp, mesh):
    """Captured steps on NCCL ranks; the last rank kills itself right after
    launching the replay of step ``kill_after``: every other rank must
    fail within the timeout."""
    import signal

    dev = mesh.device
    fe = FrontendConfig.from_ms(use_pallas_fused=True)
    wav, spk = (torch.from_numpy(rows(inp[k], mesh)).to(dev) for k in ("wav", "speakers"))
    st = card_state(dev)
    for i in range(inp["steps"]):
        st, m = ts.train_step(st, wav, None, spk, frontend=fe, mesh=mesh)
        if i == inp["kill_after"] and mesh.rank == mesh.size - 1:
            os.kill(os.getpid(), signal.SIGKILL)
        m["loss"].item()
    return {"steps": inp["steps"]}


def main():
    task, rank, world, port, inp_path, out_path = sys.argv[1:]
    torch.set_num_threads(1)
    nccl = task.startswith("nccl")
    if nccl:
        torch.cuda.set_device(int(rank))
    timeout = float(os.environ.get("TITANET_DIST_TIMEOUT", 60))
    dist.init_process_group("nccl" if nccl else "gloo", init_method=f"tcp://127.0.0.1:{port}",
                            world_size=int(world), rank=int(rank), timeout=datetime.timedelta(seconds=timeout))
    try:
        mesh = make_mesh(int(world), device="cuda" if nccl else "cpu")
        with open(inp_path, "rb") as f:
            inp = pickle.load(f)
        out = {"norm": task_norm, "steps": task_steps, "remat": task_remat, "capture": task_capture,
               "nccl_capture": task_nccl_capture, "nccl_lost": task_nccl_lost}[task](inp, mesh)
        torch.save(out, out_path)
    finally:
        destroy_process_group()  # the graphs that hold collectives first


if __name__ == "__main__":
    main()
