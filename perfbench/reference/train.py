"""Plain training steps: frontend, TitaNet in training mode, the ArcFace
loss, the gradients, Adam, and the head's renormalization, in float32.

ArcFace (additive angular margin m, scale s): with unit embeddings and
unit weight columns, the target logit is ``s * cos(theta_y + m)``, every
other logit ``s * cos(theta_j)``, cosines clamped to ``1 - 1e-7``, and the
loss ``-mean(target - log(exp(target) + sum_other exp(other) + 1e-6))``.
Adam is optax's (b1 0.9, b2 0.999, eps 1e-8, bias corrections at the step
count). After each update the head's weight columns are scaled to unit
norm, as the trainer does for angular heads.

A data-parallel step over P ranks computes what one step over the global
batch computes, so the reference runs the global batch.

Plain torch only: nothing of the measured program is imported.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence

import torch

from perfbench.reference.frontend import log_mel
from perfbench.reference.titanet import Net

ADAM_B1, ADAM_B2, ADAM_EPS = 0.9, 0.999, 1e-8
HEAD = "head.weight"


def arc_loss(emb: torch.Tensor, w: torch.Tensor, targets: torch.Tensor, scale: float, margin: float,
             rnd=lambda x: x) -> torch.Tensor:
    emb = emb.float()
    x = emb / torch.clamp(torch.linalg.vector_norm(emb, dim=-1, keepdim=True), min=1e-12)
    wn = w / torch.clamp(torch.linalg.vector_norm(w, dim=0, keepdim=True), min=1e-12)
    lim = 1.0 - 1e-7
    cos = torch.clamp(rnd(x) @ rnd(wn), -lim, lim)
    tgt = targets.long()
    target = scale * torch.cos(torch.arccos(cos.gather(1, tgt[:, None])[:, 0]) + margin)
    onehot = torch.nn.functional.one_hot(tgt, cos.shape[1]).bool()
    others = torch.where(onehot, torch.zeros_like(cos), torch.exp(scale * cos)).sum(dim=-1)
    return -torch.mean(target - torch.log(torch.exp(target) + others + 1e-6))


def train_steps(weights: Dict[str, torch.Tensor], batches: List[tuple], cfg: dict, traffic: dict,
                seed: int, rnd=lambda x: x, fault: Optional[str] = None, ranks: int = 1,
                act=lambda x: x, dtype: torch.dtype = torch.float32, keep: Sequence[str] = ()) -> dict:
    """Run ``len(batches)`` steps from ``weights`` (the model's parameters
    under the program's names, and ``head.weight``) on ``batches`` of
    ``(int16 waveform [B, T], speaker ids [B])`` on one device.

    The dropout masks are drawn from a generator on that device seeded
    with ``seed``, one uniform draw per element of each site in forward
    order, as the stated draw of the configuration. ``dtype`` is the
    network's compute dtype; ``rnd`` and ``act`` round the products'
    operands and the stored activations
    (:class:`~perfbench.reference.titanet.Net`). ``fault`` plants a
    fault the benchmark must catch: ``half_batch`` (each step sees the
    first half of its rows), ``no_exchange`` (the global batch of ``ranks``
    ranks, but the statistics, the loss and the gradient of rank 0's rows
    alone). Returns the losses, the norm of each leaf's gradient at step
    1, the norm of each leaf's change over the steps, and step 1's unit
    embeddings; for the leaves named in ``keep`` also their step-1
    gradient (``grad1_t``) and their change after each step
    (``delta_t``), whole."""
    fe, rate = cfg["frontend"], traffic["dropout"]
    dev = batches[0][0].device
    names = list(weights)
    p = {n: weights[n].detach().clone().float().requires_grad_(True) for n in names}
    start = {n: weights[n].detach().clone().float() for n in names}
    mu = {n: torch.zeros_like(p[n]) for n in names}
    nu = {n: torch.zeros_like(p[n]) for n in names}
    gen = torch.Generator(device=dev).manual_seed(int(seed))
    rows = None

    def drop(shape):
        keep = torch.rand(shape, generator=gen, device=dev) < (1.0 - rate)
        return keep if rows is None else keep[rows]

    losses, grad1, emb1 = [], None, None
    grad1_t, delta_t = {}, []
    remat = batches[0][0].shape[0] > 128
    for t, (wav, spk) in enumerate(batches, start=1):
        if fault == "half_batch":
            wav, spk = wav[: wav.shape[0] // 2], spk[: spk.shape[0] // 2]
        global_shape = wav.shape[0]
        if fault == "no_exchange":
            rows = slice(0, global_shape // ranks)
            wav, spk = wav[rows], spk[rows]
        with torch.no_grad():
            mel, _ = log_mel(wav.float() * (1.0 / 32768.0), fe)
        if rows is not None:
            net_drop = lambda shape: drop((global_shape,) + tuple(shape[1:]))  # noqa: E731
        else:
            net_drop = drop
        net = Net(p, cfg, train=True, drop=net_drop if rate > 0 else None, rate=rate, rnd=rnd, remat=remat, act=act,
                  dtype=dtype)
        emb = net(mel)
        loss = arc_loss(emb, p[HEAD], spk, traffic["loss"]["scale"], traffic["loss"]["margin"], rnd)
        grads = torch.autograd.grad(loss, [p[n] for n in names], allow_unused=True)
        grads = {n: torch.zeros_like(p[n]) if g is None else g for n, g in zip(names, grads)}
        losses.append(float(loss.detach()))
        if t == 1:
            grad1 = {n: float(torch.linalg.vector_norm(g)) for n, g in grads.items()}
            grad1_t = {n: grads[n].detach().clone() for n in keep}
            e = emb.detach().float()
            emb1 = (e / torch.clamp(torch.linalg.vector_norm(e, dim=-1, keepdim=True), min=1e-12)).cpu().numpy()
        lr = traffic["optimizer"]["lr"]
        with torch.no_grad():
            for n in names:
                g = grads[n]
                mu[n].mul_(ADAM_B1).add_(g, alpha=1.0 - ADAM_B1)
                nu[n].mul_(ADAM_B2).addcmul_(g, g, value=1.0 - ADAM_B2)
                update = (mu[n] / (1.0 - ADAM_B1 ** t)) / (torch.sqrt(nu[n] / (1.0 - ADAM_B2 ** t)) + ADAM_EPS)
                p[n].add_(update, alpha=-lr)
            w = p[HEAD]
            w.copy_(w / torch.clamp(torch.linalg.vector_norm(w, dim=0, keepdim=True), min=1e-12))
            delta_t.append({n: p[n].detach() - start[n] for n in keep})
        del emb, loss, grads, net
    delta = {n: float(torch.linalg.vector_norm(p[n].detach() - start[n])) for n in names}
    out = {"losses": losses, "grad1": grad1, "delta": delta, "emb1": emb1}
    if keep:
        out.update(grad1_t=grad1_t, delta_t=delta_t)
    return out
