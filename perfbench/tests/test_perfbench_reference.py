"""The plain reference against the measured program at toy widths on the
CPU, in float32, where the two should agree to rounding."""

import numpy as np
import pytest
import torch

from perfbench.core import program
from perfbench.core.bench import derive
from perfbench.core.weights import draw_weights, synth
from perfbench.generators import train as train_gen
from perfbench.reference import embed as ref_embed
from perfbench.reference import frontend as ref_frontend
from perfbench.reference import titanet as ref_titanet
from perfbench.reference.train import HEAD, train_steps
from perfbench.tests import toy

CFG = dict(toy._load(toy.PERFBENCH, "configs", "titanet_l.json"), compute_dtype="float32", **toy.TOY_MODEL)


def _weights(seed=11):
    w = draw_weights(ref_titanet.param_spec(CFG), seed, "cpu")
    gen = torch.Generator().manual_seed(seed)
    for name, c in ref_titanet.norm_sites(CFG):
        w[f"{name}.running_mean"] = 0.1 * torch.randn(c, generator=gen)
        w[f"{name}.running_var"] = 0.5 + torch.rand(c, generator=gen)
    return w


def _wav(rows, n, seed=5):
    return synth(np.full(rows, n), np.arange(rows), rows, seed, "cpu").view(rows, n)


def test_frontend_matches_program():
    from titanet_torch.ops.frontend import log_mel_spectrogram

    x = _wav(3, 8000)
    lengths = torch.tensor([8000, 5000, 3001])
    x[1, 5000:] = 0
    x[2, 3001:] = 0
    for fused in (False, True):
        cfg = program.frontend(dict(CFG, frontend=dict(CFG["frontend"], fused=fused)))
        got, mask = log_mel_spectrogram(x, cfg, lengths=lengths)
        ref, ref_mask = ref_frontend.log_mel(x, CFG["frontend"], lengths=lengths)
        assert torch.equal(mask, ref_mask)
        assert float((got - ref).abs().max()) < 2e-5
    got, _ = log_mel_spectrogram(x[:1], program.frontend(CFG))
    assert float((got - ref_frontend.log_mel(x[:1], CFG["frontend"])[0]).abs().max()) < 2e-5


def test_eval_forward_matches_program():
    w = _weights()
    model = program.titanet(CFG, w, "cpu").eval()
    mel = torch.randn(3, 60, 80)
    mask = torch.ones(3, 60)
    mask[1, 40:] = 0
    mask[2, 21:] = 0
    with torch.no_grad():
        got = model(mel, mask=mask)
        ref = ref_titanet.Net(w, CFG)(mel, mask)
    assert float((got - ref).abs().max() / ref.abs().max()) < 1e-5


def test_embedder_matches_program():
    from titanet_torch.train.extractor import SpeakerEmbedder

    w = _weights()
    model = program.titanet(CFG, w, "cpu")
    buckets = ref_embed.geometric_buckets(8000, 32000, 2.0)
    emb = SpeakerEmbedder(model, program.frontend(CFG), buckets=buckets, batch_size=2, device="cpu")
    audio = synth(np.array([9000, 4000, 70000]), np.array([0, 1, 2]), 3, 9, "cpu").numpy()
    waves = np.split(audio, [9000, 13000])
    got = emb.embed(waves)
    ref = ref_embed.embed_utterances(w, CFG, waves, buckets, 0.5, "cpu", 2)
    assert np.abs(got - ref).max() < 1e-5


def test_training_steps_match_program():
    from perfbench.core.bench import Cell

    root_traffic = toy._shrink("toy.train", toy._load(toy.PERFBENCH, "traffic", "train_b128.json"), 1)
    cell = Cell("toy", 1, CFG, dict(root_traffic, check_steps=2), {}, [], [])
    rank = train_gen.Rank(cell, 2**31 + 3, torch.device("cpu"), None)
    got = rank.check_steps()
    ref = train_steps({n: rank.weights[n] for n in rank.names}, rank.check_batches(), CFG, cell.traffic,
                      derive(2**31 + 3, "dropout"))
    # step 1 to rounding; Adam turns the round-off of the leaves that the
    # BatchNorms make nought into whole steps, so step 2 drifts a little
    assert got["losses"][0] == pytest.approx(ref["losses"][0], rel=1e-5)
    assert got["losses"][1] == pytest.approx(ref["losses"][1], rel=1e-4)
    moving = [n for n, g in ref["grad1"].items() if g > 1e-3 * np.median(list(ref["grad1"].values()))]
    assert max(abs(got["grad1"][n] / ref["grad1"][n] - 1) for n in moving) < 1e-3
    assert max(abs(got["delta"][n] / ref["delta"][n] - 1) for n in moving) < 1e-2
    assert HEAD in got["delta"]


def test_stated_rounding_points_come_from_the_configuration():
    """Below float32 the reference rounds where the configuration's
    ``precision`` says, whatever the shapes: the pooling takes the float32
    epilog exactly where ``pool_epilog`` is float32, masked or not."""
    w = _weights()
    mel = torch.randn(2, 40, 80)
    mask = torch.ones(2, 40)
    mask[1, 25:] = 0
    for pool_epilog in ("float32", "bfloat16"):
        cfg = dict(CFG, compute_dtype="bfloat16", precision={"bn_apply": "bfloat16", "pool_epilog": pool_epilog})
        for train, m in ((True, None), (False, mask)):
            net = ref_titanet.Net(w, cfg, train=train, dtype=torch.bfloat16)
            fused = []
            plain_fused = net.pool_fused
            net.pool_fused = lambda *a: fused.append(1) or plain_fused(*a)
            with torch.no_grad():
                out = net(mel, m)
            assert bool(fused) == (pool_epilog == "float32") and torch.isfinite(out.float()).all()
    stateless = {k: v for k, v in CFG.items() if k != "precision"}
    with pytest.raises(ValueError, match="precision"):
        ref_titanet.Net(w, dict(stateless, compute_dtype="bfloat16"), dtype=torch.bfloat16)
    ref_titanet.Net(w, stateless)  # float32 reads no rounding points
