"""The port's data-parallel train step (``titanet_torch.parallel``) on the
CPU: two ranks (gloo, spawned once for the module) against one process fed
the concatenated batch, and the port's steps against the JAX package's.

- ``train_step(..., mesh=)`` on each rank's loader share, dropout 0.5, three
  SGD steps: the global loss of each step equals the one process's to
  1e-5 relative, every parameter is within 5e-5 of its tensor's largest
  entry (+1e-6: a conv bias before a BatchNorm has a gradient that is zero
  in exact arithmetic, so its rounding moves it), the ranks agree to 1e-6
  (their losses and parameter checksums), and their batches are disjoint;
  ``eval_step(..., mesh=)`` gives the global loss; with the GE2E head,
  whose loss couples the rows, the same holds;
- that one process's f32 step equals JAX's ``train_step`` on the same
  weights and batches (dropout 0: the draws differ), at the tolerances of
  ``tests/test_torch_train.py``;
- ``make_shard_map_train_step`` equals JAX's on ``make_mesh(2)`` (loss
  rtol 2e-5, as ``tests/test_shard_map_step.py`` holds JAX's own);
- the pool fold's ``(a, c)``, made from global statistics: the pooled rows
  and the gradients of the input, ``a``, ``c``, scale and bias, summed
  over the ranks, equal the one process's;
- the collectives of one step at the JAX dry run's shape
  (``__graft_entry__._dryrun_body``): one forward and one backward
  all-reduce a BatchNorm site, one gradient bucket that carries exactly
  the parameter bytes (JAX's ``param_bytes``), one for the loss.
"""

import os
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.torch_parallel_helpers import REPO, run_worker_ranks
from tests.torch_parallel_worker import N_CLASSES, TOY, toy_state
from titanet_torch.data import ChunkConfig, DataLoader, SyntheticSpeakerDataset
from titanet_torch.losses import heads as th
from titanet_torch.models.titanet import TitaNet as TorchTitaNet
from titanet_torch.ops.frontend import FrontendConfig as TorchFrontend
from titanet_torch.ops.kernels.pool import attentive_pool_fused
from titanet_torch.ops.norm import BatchNorm
from titanet_torch.train import state as ts
from titanet_torch.utils.weights import load_jax_train_state
from titanet_tpu.losses import heads as jh
from titanet_tpu.models.titanet import TitaNet as JaxTitaNet
from titanet_tpu.ops.frontend import FrontendConfig as JaxFrontend
from titanet_tpu.parallel import make_mesh as jax_make_mesh
from titanet_tpu.parallel.shard_map_step import make_shard_map_train_step, replicate_state
from titanet_tpu.train import state as js

N_STEPS, LOCAL_B = 3, 4
LOSS_RTOL, RANK_RTOL, PARAM_TOL = 1e-5, 1e-6, 5e-5
JAX_LOSS_RTOL, JAX_NORM_RTOL = 1e-4, 5e-4  # tests/test_torch_train.py
SM = dict(n_mega_blocks=1, encoder_hidden_size=32, encoder_output_size=48, embedding_size=16,
          attention_hidden_size=8)


def _tree_np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _loader_batches():
    """Each rank's first N_STEPS batches of the round-robin sharded loader
    (the JAX multi-process test's corpus: 8 speakers x 6 utterances of 1 s)."""
    ds = SyntheticSpeakerDataset(n_speakers=8, utterances_per_speaker=6, min_seconds=1.0, max_seconds=1.0,
                                 seed=7)
    out = []
    for shard in range(2):
        loader = DataLoader(ds, batch_size=LOCAL_B, shuffle=True, chunk=ChunkConfig(enabled=False), seed=3,
                            num_workers=0, prefetch=0, shard_id=shard, num_shards=2)
        loader.set_epoch(0)
        it = iter(loader)
        out.append([(b.waveform, b.speaker_ids) for b in (next(it) for _ in range(N_STEPS))])
    return out


def _shard_map_inputs():
    rng = np.random.default_rng(0)
    jm = JaxTitaNet(dropout=0.0, **SM)
    jst = js.create_train_state(jax.random.key(0), jm, jh.build_head("ce", 16, N_CLASSES),
                                js.make_optimizer(start_lr=1e-3), jnp.zeros((2, 101, 80)), N_CLASSES)
    return {"model": SM, "params": _tree_np(jst.params), "batch_stats": _tree_np(jst.batch_stats),
            "wav": (rng.standard_normal((16, 16000)) * 0.1).astype(np.float32),
            "lengths": np.full(16, 16000, np.int32),
            "speakers": rng.integers(0, N_CLASSES, 16).astype(np.int32)}


def _fold_inputs():
    rng = np.random.default_rng(5)
    c, h = 128, 16
    return {"h": (rng.standard_normal((4, 7, c)) + 0.5).astype(np.float32),
            "scale": rng.uniform(0.5, 2, c).astype(np.float32), "bias": rng.standard_normal(c).astype(np.float32),
            "wa": (rng.standard_normal((c, h)) * 0.1).astype(np.float32),
            "ba": (rng.standard_normal(h) * 0.1).astype(np.float32),
            "wb": (rng.standard_normal((h, c)) * 0.1).astype(np.float32),
            "bb": (rng.standard_normal(c) * 0.1).astype(np.float32),
            "g": rng.standard_normal((4, 2 * c)).astype(np.float32)}


def _dryrun_inputs():
    b, t = 4, 16000
    return {"wav": np.random.default_rng(1).standard_normal((b, t)).astype(np.float32) * 0.1,
            "lengths": np.full((b,), t, np.int32), "speakers": np.arange(b, dtype=np.int32) % N_CLASSES}


@pytest.fixture(scope="module")
def inputs():
    return {"batches": _loader_batches(), "shard_map": _shard_map_inputs(), "fold": _fold_inputs(),
            "dryrun": _dryrun_inputs()}


@pytest.fixture(scope="module")
def ranks(inputs, tmp_path_factory):
    return run_worker_ranks("steps", inputs, tmp_path_factory.mktemp("steps"))


def _concatenated(inputs):
    parts = inputs["batches"]
    return [(np.concatenate([parts[0][i][0], parts[1][i][0]]), np.concatenate([parts[0][i][1], parts[1][i][1]]))
            for i in range(N_STEPS)]


def test_two_rank_steps_equal_one_process_on_the_concatenated_batch(inputs, ranks):
    st = toy_state()
    fe = TorchFrontend.from_ms()
    for i, (wav, spk) in enumerate(_concatenated(inputs)):
        st, m = ts.train_step(st, wav, None, spk, frontend=fe)
        for r in ranks:
            np.testing.assert_allclose(r["train"]["losses"][i], m["loss"].item(), rtol=LOSS_RTOL)
            np.testing.assert_allclose(r["train"]["grad_norms"][i], m["grad_norm"].item(), rtol=1e-4)
    ref = {**st.model.state_dict(), **{"head." + k: v for k, v in st.head.state_dict().items()}}
    for name, want in ref.items():
        got = ranks[0]["train"]["state"][name]
        assert (got - want).abs().max().item() <= PARAM_TOL * want.abs().max().item() + 1e-6, name
    wav, spk = _concatenated(inputs)[-1]
    eval_loss = ts.eval_step(st, wav, None, spk, frontend=fe)["loss"].item()
    for r in ranks:
        np.testing.assert_allclose(r["train"]["eval_loss"], eval_loss, rtol=LOSS_RTOL)


def test_two_rank_ge2e_steps_gather_the_rows_the_loss_couples(inputs, ranks):
    st = toy_state(head="ge2e")
    fe = TorchFrontend.from_ms()
    for i, (wav, spk) in enumerate(_concatenated(inputs)):
        st, m = ts.train_step(st, wav, None, spk, frontend=fe)
        for r in ranks:
            np.testing.assert_allclose(r["ge2e"]["losses"][i], m["loss"].item(), rtol=LOSS_RTOL)
    for name, want in st.model.state_dict().items():
        got = ranks[0]["ge2e"]["state"][name]
        assert (got - want).abs().max().item() <= PARAM_TOL * want.abs().max().item() + 1e-6, name


def test_ranks_agree_and_consume_disjoint_batches(ranks):
    r0, r1 = (r["train"] for r in ranks)
    assert len(r0["losses"]) == len(r1["losses"]) == N_STEPS
    np.testing.assert_allclose(r0["losses"], r1["losses"], rtol=RANK_RTOL)
    np.testing.assert_allclose(r0["checksum"], r1["checksum"], rtol=RANK_RTOL)
    assert not set(r0["consumed"]) & set(r1["consumed"])


def test_ranks_take_rank_zeros_value_for_their_decisions(ranks):
    """The trainer's best-checkpoint and early-stop decisions read rank 0's
    validation value on every rank (``Mesh.rank0_value``), so no rank waits
    at a save's barrier that the other skipped."""
    assert [r["decision"] for r in ranks] == [0.5, 0.5]


def test_one_process_concatenated_step_matches_jax(inputs):
    """The reference of the test above vs the JAX step (dropout 0, SGD)."""
    jm = JaxTitaNet(dropout=0.0, **TOY)
    jhd = jh.build_head("ce", TOY["embedding_size"], N_CLASSES)
    jopt = js.make_optimizer(name="sgd", start_lr=3e-4)
    jst = js.create_train_state(jax.random.key(0), jm, jhd, jopt, jnp.zeros((2, 101, 80)), N_CLASSES)
    tm = TorchTitaNet(dropout=0.0, **TOY)
    thd = th.build_head("ce", TOY["embedding_size"], N_CLASSES, device="cpu")
    load_jax_train_state(tm, thd, _tree_np(jst.params), _tree_np(jst.batch_stats))
    tst = ts.create_train_state(tm, thd, ts.make_optimizer(name="sgd", start_lr=3e-4))
    for wav, spk in _concatenated(inputs):
        jst, jm_ = js.train_step(jst, jnp.asarray(wav), None, jnp.asarray(spk), model=jm, head=jhd,
                                 optimizer=jopt, frontend=JaxFrontend.from_ms())
        tst, tm_ = ts.train_step(tst, wav, None, spk, frontend=TorchFrontend.from_ms())
        np.testing.assert_allclose(tm_["loss"].item(), float(jm_["loss"]), rtol=JAX_LOSS_RTOL)
        np.testing.assert_allclose(tm_["grad_norm"].item(), float(jm_["grad_norm"]), rtol=JAX_NORM_RTOL)
    ref_m = TorchTitaNet(dropout=0.0, **TOY)
    ref_h = th.build_head("ce", TOY["embedding_size"], N_CLASSES, device="cpu")
    load_jax_train_state(ref_m, ref_h, _tree_np(jst.params), _tree_np(jst.batch_stats))
    for got, ref in ((tst.model, ref_m), (tst.head, ref_h)):
        for (name, a), (_, b) in zip(got.state_dict().items(), ref.state_dict().items()):
            assert (a - b).abs().max().item() <= PARAM_TOL * b.abs().max().item() + 1e-6, name


def test_shard_map_step_matches_jax_on_a_two_device_mesh(inputs, ranks):
    sm = inputs["shard_map"]
    model = JaxTitaNet(dropout=0.0, axis_name="data", **SM)
    head = jh.build_head("ce", 16, N_CLASSES)
    opt = js.make_optimizer(start_lr=1e-3)
    plain = JaxTitaNet(dropout=0.0, **SM)
    state = js.create_train_state(jax.random.key(0), plain, head, opt, jnp.zeros((2, 101, 80)), N_CLASSES)
    mesh = jax_make_mesh(2)
    step = make_shard_map_train_step(mesh, model=model, head=head, optimizer=opt, frontend=JaxFrontend.from_ms())
    shard = jax.sharding.NamedSharding(mesh, jax.sharding.PartitionSpec("data"))
    state = replicate_state(state, mesh)
    losses = []
    for _ in range(2):
        state, m = step(state, *(jax.device_put(sm[k], shard) for k in ("wav", "lengths", "speakers")))
        losses.append(float(m["loss"]))
    for r in ranks:
        assert r["shard_map"]["step"] == 2
        np.testing.assert_allclose(r["shard_map"]["losses"], losses, rtol=2e-5)


def test_pool_fold_vectors_and_their_gradients_across_ranks(inputs, ranks):
    pf = inputs["fold"]
    bn = BatchNorm(pf["h"].shape[-1]).train()
    with torch.no_grad():
        bn.weight.copy_(torch.from_numpy(pf["scale"]))
        bn.bias.copy_(torch.from_numpy(pf["bias"]))
    h = torch.from_numpy(pf["h"]).requires_grad_()
    a, c = bn(h, return_scale_shift=True)
    a.retain_grad()
    c.retain_grad()
    pooled = attentive_pool_fused(h, a, c, *(torch.from_numpy(pf[k]) for k in ("wa", "ba", "wb", "bb")), 1e-6, True)
    (pooled * torch.from_numpy(pf["g"])).sum().backward()
    got = [r["fold"] for r in ranks]
    for key, want in (("pooled", pooled.detach()), ("dh", h.grad)):
        torch.testing.assert_close(torch.cat([g[key] for g in got]), want, rtol=1e-5, atol=1e-5 * want.abs().max())
    for key, want in (("da", a.grad), ("dc", c.grad), ("dscale", bn.weight.grad), ("dbias", bn.bias.grad)):
        torch.testing.assert_close(sum(g[key] for g in got), want, rtol=1e-5, atol=1e-5 * want.abs().max())


def test_collectives_of_a_step_at_the_jax_dry_run_shape(ranks):
    # the JAX dry run's own record of its parameter bytes at this shape
    with open(os.path.join(REPO, "MULTICHIP_r05.json")) as f:
        jax_param_bytes = int(re.search(r'\\?"param_bytes\\?": (\d+)', f.read()).group(1))
    assert jax_param_bytes == 88_704
    for r in ranks:
        col = r["collectives"]
        kinds, sites = col["stats"]["by_kind"], col["batchnorm_sites"]
        assert col["param_bytes"] == jax_param_bytes == kinds["gradients"]["bytes"]
        assert sites == 12
        assert kinds["batchnorm"]["count"] == kinds["batchnorm_backward"]["count"] == sites
        assert kinds["gradients"]["count"] == kinds["loss"]["count"] == 1
        assert col["stats"]["count"] == 2 * sites + 2 and set(kinds) == {
            "batchnorm", "batchnorm_backward", "gradients", "loss"}
