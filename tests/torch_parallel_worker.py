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
from titanet_torch.parallel.distributed import collective_stats, reset_collective_stats  # noqa: E402
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


def bn_case(inp, mesh, axis_name):
    """One BatchNorm training forward and backward on this rank's rows."""
    bn = BatchNorm(inp["x"].shape[-1], axis_name=axis_name).train()
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


def main():
    task, rank, world, port, inp_path, out_path = sys.argv[1:]
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{port}", world_size=int(world),
                            rank=int(rank), timeout=datetime.timedelta(seconds=60))
    try:
        mesh = make_mesh(int(world), device="cpu")
        with open(inp_path, "rb") as f:
            inp = pickle.load(f)
        out = {"norm": task_norm, "steps": task_steps, "remat": task_remat}[task](inp, mesh)
        torch.save(out, out_path)
    finally:
        dist.destroy_process_group()


if __name__ == "__main__":
    main()
