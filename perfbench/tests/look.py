"""The look behind a training cell's compared numbers: where, at the cell's
own size, the gap between the program's and the reference's leaf norms
comes from. On the card, per seed, one JSON line:

    python -m perfbench.tests.look --workload titanet_s.train_b128 --seeds 3

- ``gates``: for each mega-block, the share of squeeze-excitation gates
  that round to 1.0 (and to 0.0) in the stated precision at step 1, and
  the largest gate input;
- ``fc1_rows``: for each mega-block, how many of the SE bottleneck's rows
  are alive for every utterance, for none, or for some (its relu), and
  how many (utterance, row) pairs change side between the stated and the
  float32 reference;
- ``worst``: the five leaves with the largest gap of gradient and of change
  between the program and each reference variant: ``stated``, ``gate_f32``
  (the SE gate's input kept in float32: sigmoid and its backward in
  float32), ``se_f32`` (the whole SE in float32), and the float32
  reference against the stated one (no program);
- ``rows``: for the worst SE ``fc1`` leaf, its rows' step-1 gradient (rows
  exactly zero, the share of entries that share their row's sign), the
  change of each row after steps 1 and 3 in the program and the stated
  reference, and the gap of the leaf's change after step 1 and step 3.
"""

from __future__ import annotations

import argparse
import gc
import json
import os
import sys

import numpy as np
import torch
import torch.nn.functional as F

CHECKOUT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
if CHECKOUT not in sys.path:
    sys.path.insert(0, CHECKOUT)

from perfbench.core import bench  # noqa: E402
from perfbench.core.bench import derive, moving_leaves  # noqa: E402
from perfbench.reference import titanet as ref_titanet  # noqa: E402
from perfbench.reference import train as ref_train  # noqa: E402


class ProbeNet(ref_titanet.Net):
    """The reference network that records each SE product's output at its
    first call (step 1) and can keep the SE in float32."""

    record = None  # {prefix: float32 tensor} while recording
    se_mode = "stated"  # or "gate_f32", "se_f32"

    def linear(self, x, prefix, bias=True):
        mode = ProbeNet.se_mode
        if ".se." in prefix and self.dt != torch.float32 and mode != "stated":
            w = self.p[f"{prefix}.weight"]
            if mode == "se_f32":
                out = F.linear(x.float(), w.float())
            elif prefix.endswith("fc2"):  # bf16 operands, the product's result kept in float32
                out = F.linear(self.rnd(x.to(self.dt)).float(), self.rnd(w.to(self.dt)).float())
            else:
                out = super().linear(x, prefix, bias)
        else:
            out = super().linear(x, prefix, bias)
        if ProbeNet.record is not None and ".se." in prefix and prefix not in ProbeNet.record:
            ProbeNet.record[prefix] = out.detach().float()
        return out


def _free():
    from titanet_torch.train.capture import GRAPHS

    gc.collect()
    GRAPHS._collect_dead()
    torch.cuda.empty_cache()


def _gap(a: float, b: float, med: float) -> float:
    return abs(a - b) / max(b, med, 1e-30)


def _worst(prog: dict, ref: dict, keep, top=5):
    med = float(np.median([ref[n] for n in keep]))
    gaps = sorted(((_gap(prog[n], ref[n], med), n) for n in keep), reverse=True)[:top]
    return [[n, round(g, 4)] for g, n in gaps]


def program_steps(cell, seed, device, se):
    from perfbench.generators import train as train_gen
    from titanet_torch.train.state import ADAM_B1

    rank = train_gen.Rank(cell, seed, device, None)
    start = {n: t.detach().clone() for n, t in rank.params().items()}
    losses = [float(rank.step())]
    grad1 = {n: (m.float() / (1.0 - ADAM_B1)).clone() for n, m in zip(rank.names, rank.state.opt_state.mu)}
    d1 = {n: (rank.params()[n].detach() - start[n]).float() for n in se}
    for _ in range(cell.traffic["check_steps"] - 1):
        losses.append(float(rank.step()))
    d3 = {n: (t.detach() - start[n]).float() for n, t in rank.params().items()}
    out = {"losses": losses, "grad1": {n: float(torch.linalg.vector_norm(g)) for n, g in grad1.items()},
           "delta": {n: float(torch.linalg.vector_norm(d)) for n, d in d3.items()},
           "grad1_t": {n: grad1[n] for n in se}, "delta_t": [d1, {n: d3[n] for n in se}]}
    batches = rank.check_batches()
    weights = {n: rank.weights[n] for n in rank.names}
    del rank
    _free()
    return out, batches, weights


def reference(cell, weights, batches, seed, dtype, se, mode="stated"):
    ProbeNet.record, ProbeNet.se_mode = {}, mode
    saved = ref_train.Net
    ref_train.Net = ProbeNet
    try:
        out = ref_train.train_steps(weights, batches, cell.config, cell.traffic, derive(seed, "dropout"),
                                    dtype=dtype, keep=se)
        out["se_out"] = ProbeNet.record
    finally:
        ref_train.Net = saved
        ProbeNet.record, ProbeNet.se_mode = None, "stated"
    return out


def look(cell, seed, device) -> dict:
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
    cfg = cell.config
    se = [n for n, *_ in ref_titanet.param_spec(cfg) if ".se." in n]
    prog, batches, weights = program_steps(cell, seed, device, se)
    stated = getattr(torch, cfg["compute_dtype"])
    refs = {"stated": reference(cell, weights, batches, seed, stated, se),
            "gate_f32": reference(cell, weights, batches, seed, stated, se, "gate_f32"),
            "se_f32": reference(cell, weights, batches, seed, stated, se, "se_f32"),
            "f32": reference(cell, weights, batches, seed, torch.float32, se)}
    keep = moving_leaves(refs["stated"]["grad1"])
    out = {"seed": seed, "losses": {"program": prog["losses"], **{k: r["losses"] for k, r in refs.items()}}}

    gates, rows = [], []
    for i in range(cfg["n_mega_blocks"]):
        blk = f"encoder.mega_block_{i}.se"
        z = refs["stated"]["se_out"][f"{blk}.fc2"]
        g = torch.sigmoid(z.to(stated))
        gates.append([i, float((g == 1).float().mean()), float((g == 0).float().mean()), float(z.abs().max())])
        s, s32 = refs["stated"]["se_out"][f"{blk}.fc1"], refs["f32"]["se_out"][f"{blk}.fc1"]
        alive = s > 0
        rows.append([i, int(alive.all(0).sum()), int((~alive).all(0).sum()),
                     int((alive.any(0) & ~alive.all(0)).sum()), int((alive != (s32 > 0)).sum())])
    out["gates"] = gates  # [block, share == 1, share == 0, max |input|]
    out["fc1_rows"] = rows  # [block, rows alive for all, for none, for some, pairs that flip vs f32]

    worst = {}
    for name, ref in refs.items():
        other = prog if name != "f32" else refs["stated"]
        against = ref if name != "f32" else refs["f32"]
        label = name if name != "f32" else "stated_vs_f32"
        worst[label] = {k: _worst(other[k], against[k], keep) for k in ("grad1", "delta")}
    out["worst"] = worst

    # each side against the stated reference, by the check's own measure:
    # the worst SE fc1 leaf, the worst other leaf, and the median leaf
    base = refs["stated"]
    fc1s = [n for n in se if "fc1" in n and n in keep]
    others = [n for n in keep if ".se." not in n]
    step1 = {n: float(base["delta_t"][0][n].norm()) for n in fc1s}
    pairs = {}
    for name, side in (("program", prog), ("f32", refs["f32"]), ("se_f32", refs["se_f32"]),
                       ("gate_f32", refs["gate_f32"])):
        row = {}
        for key in ("grad1", "delta"):
            med = float(np.median([base[key][n] for n in keep]))
            gap = {n: _gap(side[key][n], base[key][n], med) for n in keep}
            rel = [abs(side[key][n] - base[key][n]) / base[key][n] for n in keep]
            row[key] = {"fc1_max": max(gap[n] for n in fc1s), "other_max": max((gap[n], n) for n in others)[::-1],
                        "median_leaf": float(np.median(rel))}
        med = float(np.median([base["delta"][n] for n in keep]))
        row["delta_step1_fc1_max"] = max(_gap(float(side["delta_t"][0][n].norm()), step1[n], med) for n in fc1s)
        pairs[name] = row
    out["pairs"] = pairs

    med1 = float(np.median([refs["stated"]["delta"][n] for n in keep]))
    fc1 = max((n for n in se if "fc1" in n and n in keep),
              key=lambda n: _gap(prog["delta"][n], refs["stated"]["delta"][n], med1))
    gp, gr = prog["grad1_t"][fc1], refs["stated"]["grad1_t"][fc1]

    def coherence(g):
        return float((torch.sign(g) == torch.sign(g.sum(1, keepdim=True))).float().mean())

    def adam1(g):
        return float(torch.linalg.vector_norm(g / (g.abs() + ref_train.ADAM_EPS)))

    per_row = {}
    for step, at in ((1, 0), (3, -1)):
        dp, dr = prog["delta_t"][at][fc1], refs["stated"]["delta_t"][at][fc1]
        per_row[f"step{step}"] = [[round(float(a) * 1e3, 3), round(float(b) * 1e3, 3)]
                                      for a, b in zip(dp.norm(dim=1), dr.norm(dim=1))]
        per_row[f"gap{step}"] = _gap(float(dp.norm()), float(dr.norm()), 0.0)
        d32 = refs["f32"]["delta_t"][at][fc1]
        per_row[f"gap{step}_stated_vs_f32"] = _gap(float(dr.norm()), float(d32.norm()), 0.0)
    out["rows"] = {"leaf": fc1, "zero_rows": [int((gp == 0).all(1).sum()), int((gr == 0).all(1).sum())],
                   "row_sign_share": [coherence(gp), coherence(gr)],
                   "grad_abs_median": [float(gp.abs().median()), float(gr.abs().median())],
                   "adam1_norm": [adam1(gp), adam1(gr)],
                   "row_grad_norm": [[round(float(a), 9), round(float(b), 9)]
                                     for a, b in zip(gp.norm(dim=1), gr.norm(dim=1))],
                   **per_row}
    return out


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", default="titanet_s.train_b128")
    p.add_argument("--seeds", type=int, default=3)
    p.add_argument("--seed0", type=int, default=3_100_000_000)
    args = p.parse_args(argv)
    from titanet_torch.utils import enable_compilation_cache

    enable_compilation_cache(os.path.join(bench.PERFBENCH, ".cache", "kernels"))
    device = torch.device("cuda", 0)
    torch.cuda.set_device(device)
    cell = bench.load_cell(CHECKOUT, args.workload)
    for i in range(args.seeds):
        print(json.dumps(look(cell, args.seed0 + 7919 * i, device)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
